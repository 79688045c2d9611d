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
// 3.35 TB/s.  The Pallas kernel keeps the column in VMEM and walks the
// rows serially, twice.  Here the column stays in device memory -- 4 MB
// fits in the 50 MB L2 between the phases -- and each phase is one launch
// of one thread per row: phase 0 an integer atomicMax on the signed int32
// word (exact in any order, so the result is bit-for-bit the serial
// loop's), phase 1 a clamped gather.  The two launches are ordered by the
// stream, so phase 1 sees every update of phase 0.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).  The keys are
// an untrusted 29-bit wire field, so the drop in phase 0 and the clamp in
// phase 1 are what keeps them inside the column; a checked build with
// -DHERMES_BROKEN_NO_CLAMP leaves both out, for the red test that the
// guard catches exactly that.  It is refused outside the checked build.
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns cudaGetLastError() after the
// launches (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

#if defined(HERMES_BROKEN_NO_CLAMP) && !defined(HERMES_CHECKED)
#error "HERMES_BROKEN_NO_CLAMP is for the bound-checked build only"
#endif

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
max_kernel(int32_t* __restrict__ vpts, const int32_t* __restrict__ keys,
           const int32_t* __restrict__ pts, const uint8_t* __restrict__ mask,
           int K, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int k = HG_LD(keys, i, n);
#if defined(HERMES_BROKEN_NO_CLAMP)
    const bool keep = true;
#else
    const bool keep = k >= 0 && k < K;
#endif
    if (HG_LD(mask, i, n) != 0 && keep) HG_ATOMIC_MAX(vpts, k, K, HG_LD(pts, i, n));
  }
}

__global__ void __launch_bounds__(kThreads)
post_kernel(const int32_t* __restrict__ vpts, const int32_t* __restrict__ keys,
            int32_t* __restrict__ post, int K, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int k = HG_LD(keys, i, n);
#if !defined(HERMES_BROKEN_NO_CLAMP)
    k = k < 0 ? 0 : (k > K - 1 ? K - 1 : k);
#endif
    HG_ST(post, i, n, HG_LD(vpts, k, K));
  }
}

}  // namespace

extern "C" {

// vpts (K,) int32, updated in place; keys, pts (N,) int32; mask (N,) bool
// bytes; post (N,) int32 output.  K >= 1, N >= 1.
int hermes_mega_apply(void* vpts, const void* keys, const void* pts,
                      const void* mask, void* post, int K,
                      int N HG_ENTRY_ARG, void* stream) {
  if (K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t began = HG_BEGIN(st);
  if (began != cudaSuccess) return static_cast<int>(began);
  int64_t blocks = (static_cast<int64_t>(N) + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  const unsigned g = static_cast<unsigned>(blocks);
  max_kernel<<<g, kThreads, 0, st>>>(
      static_cast<int32_t*>(vpts), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(pts), static_cast<const uint8_t*>(mask), K,
      N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  post_kernel<<<g, kThreads, 0, st>>>(static_cast<const int32_t*>(vpts),
                                      static_cast<const int32_t*>(keys),
                                      static_cast<int32_t*>(post), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
