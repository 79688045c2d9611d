// mega_route: the fused sort's route-back scatter of one batched round,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/core/megaround.py:_route_kernel
// (wrapper megaround.mega_route).  For each replica r and sorted position
// p, over outputs that start at zero:
//   lane = clip(si[r, p], 0, L-1)
//   lane_word[r, lane] = word[r, p]
//   slot_lane[r, srank[r, p]] = lane      when 0 <= srank[r, p] < C
//
// What bounds it: memory.  Three int32 reads per (r, p), one int32 store
// per lane and per slot, nothing to compute: at the bench shape (R=8,
// L=65,792, C=49,152) about 10 MB, 2.98 us at 3.35 TB/s.  The Pallas
// kernel walks p serially on one core, one replica per grid step.  The
// first port here zero-filled both outputs with two memsets and then
// stored one lane a thread straight to global memory: about 920 K
// scattered 4-byte stores, each a partial-sector write.  This design
// lands the scatter in shared memory instead:
//   * one thread-block cluster per replica row (gridDim.y = R), its CTAs
//     (gridDim.x = the cluster size Q) each owning an equal window of the
//     row's lane_word and of its slot_lane, held in shared memory;
//   * each CTA zeroes its windows, then cluster.sync(), so that no zero
//     lands on top of another CTA's store;
//   * each CTA reads a contiguous share of the positions (16-byte loads
//     where the three inputs are aligned, a scalar head and tail) and
//     stores word and lane into the owning CTA's window through
//     distributed shared memory;
//   * a second cluster.sync(), then each CTA writes its windows to global
//     memory in one coalesced pass of 16-byte stores.
// One device operation a call: no memset, no 64-bit divide per element.
// A cluster of one CTA (a small row) takes the CTA's own barrier and its
// own shared memory.
// A row larger than a cluster's shared memory is walked in passes: pass k
// holds windows k*Q .. k*Q+Q-1, each pass rescans the CTA's positions and
// keeps the targets inside its windows.  The window plan (Q, passes,
// window sizes, shared bytes) is the wrapper's
// (hermes_tpu_torch/core/megaround.py:route_plan), checked here.
//
// On the round's inputs (si a permutation of each row, srank a bijection
// onto [0, L)) every target is written once and the result is the
// reference's bit for bit.  On inputs with a repeated target an element
// holds one of its writers' values (the CTAs' stores land in no fixed
// order), and an element no position writes holds 0.
//
// Every global access goes through guard.cuh's guard, and every store
// into a window through its shared-memory form HG_SMEM_ST (the bare access
// in the release build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns the first CUDA error of the
// attribute calls and the launch (0 = launched).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;          // non-portable above 8
constexpr int kMaxSmemBytes = 232448;    // 227 KB, a CTA's most

struct Plan {
  int L, C, wl, wc, ps, passes;
  int64_t n_lw, n_sl;  // the outputs' extents, R * L and R * C
};

// [lo, hi) of a CTA's span that 16-byte accesses can take: from the first
// multiple of 4 at or after g0 to the last one at or before g1; empty when
// vector access is off.
__device__ __forceinline__ void vec_span(int64_t g0, int64_t g1, bool vec,
                                         int64_t* lo, int64_t* hi) {
  if (!vec) {
    *lo = *hi = g1;
    return;
  }
  int64_t a = (g0 + 3) & ~int64_t{3};
  if (a > g1) a = g1;
  int64_t b = g1 & ~int64_t{3};
  if (b < a) b = a;
  *lo = a;
  *hi = b;
}

// The barrier of a row's CTAs: the cluster's, or for a cluster of one CTA
// the CTA's own, which is all it needs and cheaper.
__device__ __forceinline__ void row_sync(cg::cluster_group& cluster, int Q) {
  if (Q > 1)
    cluster.sync();
  else
    __syncthreads();
}

__device__ __forceinline__ void route_one(cg::cluster_group& cluster,
                                          int32_t* lw_s, int32_t* sl_s,
                                          const Plan& pl, int pass, int Q,
                                          int si, int word, int s) {
  const int lane = si < 0 ? 0 : (si > pl.L - 1 ? pl.L - 1 : si);
  // pass `pass` holds windows [pass * Q, pass * Q + Q) of each output
  const uint32_t lo = static_cast<uint32_t>(pass) * Q * pl.wl;
  const uint32_t off = static_cast<uint32_t>(lane) - lo;
  if (lane >= static_cast<int>(lo) &&
      off < static_cast<uint32_t>(Q) * pl.wl) {
    const uint32_t q = off / pl.wl;
    int32_t* win = Q > 1 ? cluster.map_shared_rank(lw_s, q) : lw_s;
    HG_SMEM_ST(win, off - q * pl.wl, pl.wl, word);
  }
  if (s >= 0 && s < pl.C) {
    const uint32_t slo = static_cast<uint32_t>(pass) * Q * pl.wc;
    const uint32_t soff = static_cast<uint32_t>(s) - slo;
    if (s >= static_cast<int>(slo) &&
        soff < static_cast<uint32_t>(Q) * pl.wc) {
      const uint32_t q = soff / pl.wc;
      int32_t* win = Q > 1 ? cluster.map_shared_rank(sl_s, q) : sl_s;
      HG_SMEM_ST(win, soff - q * pl.wc, pl.wc, lane);
    }
  }
}

// Writes `count` words of window `win` to out[g0 ..): a scalar head up to
// 16-byte alignment, 16-byte stores, a scalar tail.
__device__ __forceinline__ void write_window(int32_t* __restrict__ out,
                                             int64_t n, int64_t g0,
                                             int count, int32_t* win,
                                             bool vec) {
  const int64_t g1 = g0 + count;
  int64_t a, b;
  vec_span(g0, g1, vec, &a, &b);
  for (int64_t g = g0 + threadIdx.x; g < a; g += blockDim.x)
    HG_ST(out, g, n, win[g - g0]);
  int4* ov = reinterpret_cast<int4*>(out);
  for (int64_t g = a + 4 * static_cast<int64_t>(threadIdx.x); g < b;
       g += 4 * static_cast<int64_t>(blockDim.x)) {
    const int i = static_cast<int>(g - g0);
    HG_ST(ov, g / 4, n / 4, make_int4(win[i], win[i + 1], win[i + 2],
                                      win[i + 3]));
  }
  for (int64_t g = b + threadIdx.x; g < g1; g += blockDim.x)
    HG_ST(out, g, n, win[g - g0]);
}

__global__ void __launch_bounds__(kThreads)
route_kernel(const int32_t* __restrict__ si, const int32_t* __restrict__ word,
             const int32_t* __restrict__ srank, int32_t* __restrict__ lane_word,
             int32_t* __restrict__ slot_lane, Plan pl, int vec_in,
             int vec_out) {
  extern __shared__ int4 smem4[];
  int32_t* lw_s = reinterpret_cast<int32_t*>(smem4);  // wl words
  int32_t* sl_s = lw_s + pl.wl;                       // then wc words
  cg::cluster_group cluster = cg::this_cluster();
  const int Q = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  const int64_t r = blockIdx.y;
  const int64_t n = static_cast<int64_t>(gridDim.y) * pl.L;  // inputs
  // this CTA's positions [p0, p1) of row r
  int64_t p0 = static_cast<int64_t>(q) * pl.ps, p1 = p0 + pl.ps;
  if (p0 > pl.L) p0 = pl.L;
  if (p1 > pl.L) p1 = pl.L;
  const int64_t g0 = r * pl.L + p0, g1 = r * pl.L + p1;
  int64_t a, b;
  vec_span(g0, g1, vec_in != 0, &a, &b);
  const int4* siv = reinterpret_cast<const int4*>(si);
  const int4* wv = reinterpret_cast<const int4*>(word);
  const int4* sv = reinterpret_cast<const int4*>(srank);

  for (int pass = 0; pass < pl.passes; ++pass) {
    for (int i = threadIdx.x; i < (pl.wl + pl.wc) / 4; i += blockDim.x)
      smem4[i] = make_int4(0, 0, 0, 0);  // both windows: wl + wc words
    row_sync(cluster, Q);  // every window zeroed (and written out) first
    for (int64_t g = g0 + threadIdx.x; g < a; g += blockDim.x)
      route_one(cluster, lw_s, sl_s, pl, pass, Q, HG_LD(si, g, n),
                HG_LD(word, g, n), HG_LD(srank, g, n));
    for (int64_t g = a + 4 * static_cast<int64_t>(threadIdx.x); g < b;
         g += 4 * static_cast<int64_t>(blockDim.x)) {
      const int4 s4 = HG_LD(siv, g / 4, n / 4);
      const int4 w4 = HG_LD(wv, g / 4, n / 4);
      const int4 k4 = HG_LD(sv, g / 4, n / 4);
      route_one(cluster, lw_s, sl_s, pl, pass, Q, s4.x, w4.x, k4.x);
      route_one(cluster, lw_s, sl_s, pl, pass, Q, s4.y, w4.y, k4.y);
      route_one(cluster, lw_s, sl_s, pl, pass, Q, s4.z, w4.z, k4.z);
      route_one(cluster, lw_s, sl_s, pl, pass, Q, s4.w, w4.w, k4.w);
    }
    for (int64_t g = b + threadIdx.x; g < g1; g += blockDim.x)
      route_one(cluster, lw_s, sl_s, pl, pass, Q, HG_LD(si, g, n),
                HG_LD(word, g, n), HG_LD(srank, g, n));
    row_sync(cluster, Q);  // every store of this pass landed
    const int w = pass * Q + q;  // this CTA's window of this pass
    const int64_t l0 = static_cast<int64_t>(w) * pl.wl;
    if (l0 < pl.L)
      write_window(lane_word, pl.n_lw, r * pl.L + l0,
                   static_cast<int>(pl.L - l0 < pl.wl ? pl.L - l0 : pl.wl),
                   lw_s, vec_out != 0);
    const int64_t c0 = static_cast<int64_t>(w) * pl.wc;
    if (c0 < pl.C)
      write_window(slot_lane, pl.n_sl, r * pl.C + c0,
                   static_cast<int>(pl.C - c0 < pl.wc ? pl.C - c0 : pl.wc),
                   sl_s, vec_out != 0);
    __syncthreads();  // the windows are read before the next pass zeroes
  }
}

}  // namespace

extern "C" {

// si, word, srank: (R, L) int32; lane_word (R, L) and slot_lane (R, C)
// int32 outputs.  R, L >= 1, C >= 0.  The plan: a cluster of Q CTAs a row;
// windows of wl lanes and wc slots, Q of them a pass, passes * Q * wl >= L
// and passes * Q * wc >= C, wl and wc multiples of 4, 4 * (wl + wc) <=
// 232,448 shared bytes; ps positions a CTA, Q * ps >= L.
int hermes_mega_route(const void* si, const void* word, const void* srank,
                      void* lane_word, void* slot_lane, int R, int L, int C,
                      int Q, int passes, int wl, int wc,
                      int ps HG_ENTRY_ARG, void* stream) {
  if (R < 1 || R > 65535 || L < 1 || C < 0 || Q < 1 || Q > kMaxCluster ||
      passes < 1 || wl < 4 || wc < 0 || wl % 4 || wc % 4 || ps < 1 ||
      static_cast<int64_t>(passes) * Q * wl < L ||
      static_cast<int64_t>(passes) * Q * wc < C ||
      static_cast<int64_t>(Q) * ps < L ||
      4 * (static_cast<int64_t>(wl) + wc) > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 4 * (wl + wc);
  // the largest shared size allowed so far, and the (shared size, cluster)
  // last checked: the round calls with one plan, so it checks once
  static int allowed_smem = -1, checked_smem = -1, checked_q = -1;
  if (smem > allowed_smem) {
    err = cudaFuncSetAttribute(
        route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          route_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem = smem;
  }
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16;
  };
  Plan pl{L, C, wl, wc, ps, passes, static_cast<int64_t>(R) * L,
          static_cast<int64_t>(R) * C};
  const int vec_in = !addr(si) && !addr(word) && !addr(srank);
  const int vec_out = !addr(lane_word) && !addr(slot_lane);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, R, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem != checked_smem || Q != checked_q) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, route_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return cudaErrorInvalidConfiguration;
    checked_smem = smem;
    checked_q = Q;
  }
  err = cudaLaunchKernelEx(&cfg, route_kernel,
                           static_cast<const int32_t*>(si),
                           static_cast<const int32_t*>(word),
                           static_cast<const int32_t*>(srank),
                           static_cast<int32_t*>(lane_word),
                           static_cast<int32_t*>(slot_lane), pl, vec_in,
                           vec_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
