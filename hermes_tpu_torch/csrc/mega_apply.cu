// mega_apply: the arbiter scatter-max and the post-arbiter verdict
// read-back of one batched round, for Hopper (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/core/megaround.py:_apply_kernel
// (wrapper megaround.mega_apply, grid (2,)).  Over N rows:
//   phase 0: vpts[key] = max(vpts[key], pts)  for mask != 0, 0 <= key < K
//            (a key outside the column drops from the max);
//   phase 1: post[m] = vpts[clip(key, 0, K-1)]  for every row.
//
// What bounds it: memory.  Per row an int32 key and pts and a bool mask
// in, an int32 post out; the (K,) int32 column read and written (4 MB at
// 2^20 keys).  At the bench shape (N = 8 x 65,792) about 15 MB, ~4.5 us at
// 3.35 TB/s.  In practice the column's random accesses bound it: each
// 4-byte atomic and each 4-byte gather costs a 32-byte L2 sector, about
// 0.9 M of them at the bench shape (three quarters of the rows masked
// in, every row read back), whatever the launch does around them.  The
// Pallas kernel keeps the column in VMEM and walks the rows serially,
// twice.  The first port here was two launches of one
// thread per row with 4-byte loads, ordered by the stream: the second
// paid its own launch ramp and tail and read the 2.1 MB of keys again.
// This design is one cooperative launch:
//   * a persistent grid, never more CTAs than co-reside on the card (the
//     occupancy query, made once per device and kept) and no more than
//     the rows need;
//   * each thread owns a fixed set of rows, in 16-byte units of four
//     (keys and pts as int4, the four mask bytes as one word): unit
//     t + j*T for j < kHeld, T the grid's threads.  It applies their
//     maxima with integer atomicMax on the signed int32 words (exact in
//     any order, so the result is the serial loop's bit for bit) and
//     keeps their clamped keys in registers;
//   * cg::this_grid().sync() between the phases: every maximum has landed
//     in L2 before any read-back;
//   * phase 1 gathers vpts[clamped key] with __ldcg (L2, never the SM's
//     own L1, which is not coherent across SMs; vpts is not
//     const __restrict__, so the compiler may not take the read-only
//     path either) and writes post in 16-byte stores.
// Units past the held ones (N beyond kHeld units a thread) and the rows
// of the scalar tail re-read their keys in phase 1.  Inputs whose
// pointers are not aligned for the 16-byte units take the scalar path
// for every row.
// Two variants were timed on the card and dropped: holding one or four
// units a thread in place of two changed the time by a few per cent; and
// reducing the maxima within a warp before the atomic (__match_any_sync)
// made the kernel more than twice as slow, while a round's masked keys
// never repeat from one row to the next.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).  The keys are
// an untrusted 29-bit wire field, so the drop in phase 0 and the clamp in
// phase 1 are what keeps them inside the column; a checked build with
// -DHERMES_BROKEN_NO_CLAMP leaves both out, for the red test that the
// guard catches exactly that.  It is refused outside the checked build.
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns the first CUDA error of the queries
// and the launch (0 = launched); a refused cooperative launch is an
// error, never two launches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

#if defined(HERMES_BROKEN_NO_CLAMP) && !defined(HERMES_CHECKED)
#error "HERMES_BROKEN_NO_CLAMP is for the bound-checked build only"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 2;  // 16-byte units a thread holds across the barrier
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int clamp_key(int k, int K) {
#if defined(HERMES_BROKEN_NO_CLAMP)
  return k;
#else
  return k < 0 ? 0 : (k > K - 1 ? K - 1 : k);
#endif
}

__device__ __forceinline__ bool keeps(int k, int K) {
#if defined(HERMES_BROKEN_NO_CLAMP)
  return true;
#else
  return k >= 0 && k < K;
#endif
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(int32_t* vpts, const int32_t* __restrict__ keys,
             const int32_t* __restrict__ pts,
             const uint8_t* __restrict__ mask, int32_t* __restrict__ post,
             int K, int64_t n, int vec) {
  const int64_t T = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int64_t nv = vec ? n / 4 : 0;  // 16-byte units of four rows
  const int64_t n4 = n / 4;            // the extent of a unit view
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  const int4* pts4 = reinterpret_cast<const int4*>(pts);
  const uint32_t* mask4 = reinterpret_cast<const uint32_t*>(mask);
  int4* post4 = reinterpret_cast<int4*>(post);

  // phase 0, the held units
  int kc[kHeld][4];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int64_t v = gt + j * T;
    if (v >= nv) continue;
    const int4 k4 = HG_LD(keys4, v, n4);
    const int4 p4 = HG_LD(pts4, v, n4);
    const uint32_t m4 = HG_LD(mask4, v, n4);
    const int kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kc[j][e] = clamp_key(kk[e], K);
      if (((m4 >> (8 * e)) & 0xffu) != 0 && keeps(kk[e], K))
        HG_ATOMIC_MAX(vpts, kk[e], K, pp[e]);
    }
  }
  // phase 0, units past the held ones and the scalar rows
  for (int64_t v = gt + kHeld * T; v < nv; v += T) {
    const int4 k4 = HG_LD(keys4, v, n4);
    const int4 p4 = HG_LD(pts4, v, n4);
    const uint32_t m4 = HG_LD(mask4, v, n4);
    const int kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const int pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (((m4 >> (8 * e)) & 0xffu) != 0 && keeps(kk[e], K))
        HG_ATOMIC_MAX(vpts, kk[e], K, pp[e]);
  }
  for (int64_t i = 4 * nv + gt; i < n; i += T) {
    const int k = HG_LD(keys, i, n);
    if (HG_LD(mask, i, n) != 0 && keeps(k, K)) {
      const int p = HG_LD(pts, i, n);
      HG_ATOMIC_MAX(vpts, k, K, p);
    }
  }

  cg::this_grid().sync();  // every maximum landed before any read-back

  // phase 1: vpts through L2 (__ldcg), never a stale line of L1
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int64_t v = gt + j * T;
    if (v < nv) {
      int4 out;
      out.x = HG_LD_CG(vpts, kc[j][0], K);
      out.y = HG_LD_CG(vpts, kc[j][1], K);
      out.z = HG_LD_CG(vpts, kc[j][2], K);
      out.w = HG_LD_CG(vpts, kc[j][3], K);
      HG_ST(post4, v, n4, out);
    }
  }
  for (int64_t v = gt + kHeld * T; v < nv; v += T) {
    const int4 k4 = HG_LD(keys4, v, n4);
    int4 out;
    out.x = HG_LD_CG(vpts, clamp_key(k4.x, K), K);
    out.y = HG_LD_CG(vpts, clamp_key(k4.y, K), K);
    out.z = HG_LD_CG(vpts, clamp_key(k4.z, K), K);
    out.w = HG_LD_CG(vpts, clamp_key(k4.w, K), K);
    HG_ST(post4, v, n4, out);
  }
  for (int64_t i = 4 * nv + gt; i < n; i += T) {
    const int k = clamp_key(HG_LD(keys, i, n), K);
    HG_ST(post, i, n, HG_LD_CG(vpts, k, K));
  }
}

// CTAs of apply_kernel that co-reside on `dev`, queried once per device
// and kept; 0 until queried.
int co_resident[kMaxDevices];

}  // namespace

extern "C" {

// vpts (K,) int32, updated in place; keys, pts (N,) int32; mask (N,) bool
// bytes; post (N,) int32 output.  K >= 1, N >= 1.  threads and held must
// be this file's kThreads and kHeld (the wrapper's APPLY_THREADS and
// APPLY_HELD, which its tests replay).
int hermes_mega_apply(void* vpts, const void* keys, const void* pts,
                      const void* mask, void* post, int K, int N,
                      int threads, int held HG_ENTRY_ARG, void* stream) {
  if (K < 1 || N < 1 || threads != kThreads || held != kHeld)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cap = co_resident[dev];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, apply_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap = per_sm * sms;
  }
  err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, int b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  const int vec = aligned(keys, 16) && aligned(pts, 16) &&
                  aligned(post, 16) && aligned(mask, 4);
  // units of work: 16-byte units (kHeld a thread) or single rows
  const int64_t per_cta =
      vec ? static_cast<int64_t>(kThreads) * kHeld : kThreads;
  const int64_t units = vec ? (static_cast<int64_t>(N) + 3) / 4 : N;
  int64_t grid = (units + per_cta - 1) / per_cta;
  if (grid > cap) grid = cap;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, apply_kernel, static_cast<int32_t*>(vpts),
                           static_cast<const int32_t*>(keys),
                           static_cast<const int32_t*>(pts),
                           static_cast<const uint8_t*>(mask),
                           static_cast<int32_t*>(post), K,
                           static_cast<int64_t>(N), vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
