// stats_block: completion codes, op counters and the commit-latency
// histogram of one protocol round, for Hopper (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/core/kernels.py:_stats_kernel
// (wrapper kernels.stats_block).  For each (replica r, session s):
//   code = C_RMW_ABORT if abort, else C_RMW / C_WRITE if commit (by op),
//          else C_READ if read_done, else C_NONE;
// per replica: ctr[r] = [read, write, rmw, abort, lat_sum, lat_cnt, 0, 0]
// (rows of layouts.STATS_CTR) and hist[r][clip(step - invoke, 0, 63)] += 1
// for committed sessions.
//
// What bounds it: memory.  Each lane reads 2 int32 + 3 bool bytes and
// writes one int32 code, ~15 bytes; there is no arithmetic to speak of.
// At the bench shape (8 x 65536 lanes, ~7.9 MB) that is ~2.4 us at
// 3.35 TB/s, about what a launch and one trip to memory take.  The first
// port here read the lanes one at a time (three byte loads and two
// 4-byte loads a lane) and added each block's partial sums into ctr and
// hist with global atomics, so the caller had to zero both first: three
// device operations a call.  This design is one launch that writes every
// output whole:
//   * one thread-block cluster a replica: grid (Q, R), cluster (Q, 1, 1),
//     Q from the wrapper's plan (hermes_tpu_torch/core/kernels.py:
//     stats_plan, re-checked here); CTA q walks its span of ps lanes of
//     the row.  One CTA a replica (Q = 1) is a plain launch;
//   * a thread takes four lanes a step: a 16-byte load each of op and
//     invoke, a 4-byte word of each bool array (a warp's 32 words are one
//     128-byte line), a 16-byte store of the codes; a thread for every
//     four lanes of the span, from 96 up to 512.  Few lanes a thread and
//     many warps matter more than wide loads: sixteen lanes a thread left
//     each SM a few warps with long serial chains, and the kernel took
//     longer than the first port's.  At the bench shape, clusters of 16
//     with 512 threads a CTA beat clusters of 8 and CTAs of 256 or 1,024
//     threads (timed on the card);
//   * a scalar head and tail where a span is not 4-lane aligned (a row
//     starts at r*S), or everywhere when a pointer is not aligned;
//   * counters reduce in registers and one __reduce_add_sync a warp, the
//     histogram in shared memory with shared atomics, but for bin 0
//     (nearly all of a round's commits), which counts in a register;
//   * the cluster's barrier is split: each CTA arrives once its shared
//     memory is zeroed and waits only after its own lanes; then it adds
//     its 72 partial words into rank 0's shared memory (distributed
//     shared memory atomics), one full cluster barrier, and rank 0
//     writes the replica's whole ctr row (the two pad words 0) and its 64
//     bins with plain stores.  A cluster of one CTA writes its sums
//     straight out.
// No global atomics and no zero-fill: in the checked build, whose outputs
// start poisoned, every element of ctr and hist must be written.  The
// order of the sums differs from the reference's serial walk, but they
// are integer adds, so the result is bit-exact.  The round step is read
// from a device pointer, so a round needs no host sync.  Counters
// accumulate as uint32: the same bits as the reference's wrapping int32
// sums.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/kernels.py): every pointer
// and the stream are void*-sized; returns the first CUDA error of the
// attribute calls and the launch (0 = launched).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLatBins = 64;   // core/state.py LAT_BINS
constexpr int kCtrWidth = 8;   // layouts.STATS_CTR.width
constexpr int kNumCtr = 6;     // read, write, rmw, abort, lat_sum, lat_cnt
constexpr int kThreads = 512;  // at most; fewer when a span is short
constexpr int kMaxWarps = kThreads / 32;
constexpr int kUnit = 4;       // lanes a thread takes a step: one int4
constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int32_t kOpRmw = 3;  // types.OP_RMW
constexpr int32_t kCNone = 0, kCRead = 1, kCWrite = 2, kCRmw = 3,
                  kCRmwAbort = 4;  // types.C_*
// the register sums: the six counters, then bin 0 of the histogram
constexpr int kSums = kNumCtr + 1;
constexpr int kRow = kLatBins + kCtrWidth;  // a replica's output words
constexpr int kMinThreads = (kRow + 31) / 32 * 32;  // a thread a word

// The two halves of a cluster barrier (PTX barrier.cluster): the arrive
// releases this CTA's shared-memory writes, the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One lane: its code, and its share of the sums and the histogram.
__device__ __forceinline__ int32_t lane_stats(uint32_t* v, uint32_t* sh_hist,
                                              uint32_t step, int32_t op,
                                              int32_t invoke, bool c, bool a,
                                              bool rd) {
  const bool is_rmw = op == kOpRmw;
  v[0] += rd;
  v[3] += a;
  if (c) {
    const int32_t lat = static_cast<int32_t>(step - static_cast<uint32_t>(invoke));
    v[1] += !is_rmw;
    v[2] += is_rmw;
    v[4] += static_cast<uint32_t>(lat);
    v[5] += 1;
    const int bin = lat < 0 ? 0 : (lat > kLatBins - 1 ? kLatBins - 1 : lat);
    if (bin == 0)
      v[6] += 1;
    else
      atomicAdd(&sh_hist[bin], 1u);
  }
  return a ? kCRmwAbort : (c ? (is_rmw ? kCRmw : kCWrite) : (rd ? kCRead : kCNone));
}

__global__ void __launch_bounds__(kThreads)
stats_block_kernel(const int32_t* __restrict__ step_ptr,
                   const int32_t* __restrict__ op,
                   const int32_t* __restrict__ invoke,
                   const uint8_t* __restrict__ commit,
                   const uint8_t* __restrict__ abort_,
                   const uint8_t* __restrict__ read_done,
                   int32_t* __restrict__ code,
                   int32_t* __restrict__ ctr,
                   int32_t* __restrict__ hist,
                   int S, int ps, int vec) {
  __shared__ uint32_t sh_hist[kLatBins];  // this CTA's bins
  __shared__ uint32_t sh_warp[kMaxWarps][kSums];
  __shared__ uint32_t sh_row[kRow];  // rank 0: the row's bins, then ctr
  cg::cluster_group cluster = cg::this_cluster();
  const int Q = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  for (int i = threadIdx.x; i < kRow; i += blockDim.x) {
    if (i < kLatBins) sh_hist[i] = 0;
    sh_row[i] = 0;
  }
  __syncthreads();
  // rank 0's row is zeroed before any CTA of the cluster adds into it;
  // the wait comes after this CTA's own lanes, so it rarely waits
  if (Q > 1) cluster_arrive();

  const int R = gridDim.y;
  const int64_t r = blockIdx.y;
  const int64_t n = static_cast<int64_t>(R) * S;  // lanes: R x S
  const uint32_t step = static_cast<uint32_t>(HG_LD(step_ptr, 0, 1));
  // this CTA's lanes [g0, g1) of row r: head [g0, a), body [a, b) in
  // units of four lanes, tail [b, g1)
  int64_t s0 = static_cast<int64_t>(q) * ps, s1 = s0 + ps;
  if (s0 > S) s0 = S;
  if (s1 > S) s1 = S;
  const int64_t g0 = r * S + s0, g1 = r * S + s1;
  int64_t a = g1, b = g1;
  if (vec) {
    a = (g0 + kUnit - 1) / kUnit * kUnit;
    if (a > g1) a = g1;
    b = g1 / kUnit * kUnit;
    if (b < a) b = a;
  }
  uint32_t v[kSums] = {0, 0, 0, 0, 0, 0, 0};
  // one lane of the head or the tail, with 4-byte and byte accesses
  const auto scalar_lane = [&](int64_t g) {
    const int32_t o = HG_LD(op, g, n);
    const int32_t iv = HG_LD(invoke, g, n);
    const bool c = HG_LD(commit, g, n) != 0;
    const bool ab = HG_LD(abort_, g, n) != 0;
    const bool rd = HG_LD(read_done, g, n) != 0;
    HG_ST(code, g, n, lane_stats(v, sh_hist, step, o, iv, c, ab, rd));
  };
  for (int64_t g = g0 + threadIdx.x; g < a; g += blockDim.x) scalar_lane(g);
  const int4* op4 = reinterpret_cast<const int4*>(op);
  const int4* inv4 = reinterpret_cast<const int4*>(invoke);
  const uint32_t* c4 = reinterpret_cast<const uint32_t*>(commit);
  const uint32_t* a4 = reinterpret_cast<const uint32_t*>(abort_);
  const uint32_t* rd4 = reinterpret_cast<const uint32_t*>(read_done);
  int4* code4 = reinterpret_cast<int4*>(code);
  [[maybe_unused]] const int64_t n4 = n / kUnit;  // the guards' extent
  for (int64_t u = a / kUnit + threadIdx.x; u < b / kUnit; u += blockDim.x) {
    const int4 o = HG_LD(op4, u, n4);
    const int4 iv = HG_LD(inv4, u, n4);
    const uint32_t cw = HG_LD(c4, u, n4);
    const uint32_t aw = HG_LD(a4, u, n4);
    const uint32_t rw = HG_LD(rd4, u, n4);
    const auto at = [](uint32_t w, int e) {
      return ((w >> (8 * e)) & 0xffu) != 0;
    };
    int4 out;
    out.x = lane_stats(v, sh_hist, step, o.x, iv.x, at(cw, 0), at(aw, 0),
                       at(rw, 0));
    out.y = lane_stats(v, sh_hist, step, o.y, iv.y, at(cw, 1), at(aw, 1),
                       at(rw, 1));
    out.z = lane_stats(v, sh_hist, step, o.z, iv.z, at(cw, 2), at(aw, 2),
                       at(rw, 2));
    out.w = lane_stats(v, sh_hist, step, o.w, iv.w, at(cw, 3), at(aw, 3),
                       at(rw, 3));
    HG_ST(code4, u, n4, out);
  }
  for (int64_t g = b + threadIdx.x; g < g1; g += blockDim.x) scalar_lane(g);

  // the CTA's sums: one warp reduction each, then one slot a warp
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const uint32_t w = __reduce_add_sync(0xffffffffu, v[k]);
    if ((threadIdx.x & 31) == 0) sh_warp[warp][k] = w;
  }
  __syncthreads();
  // the CTA's part of the row: its bins (bin 0 from the register sums,
  // which had no shared atomic) and its six counters, the pad words 0
  const int warps = blockDim.x / 32;
  uint32_t part = 0;
  const int t = threadIdx.x;
  if (t < kRow) {
    if (t > 0 && t < kLatBins) {
      part = sh_hist[t];
    } else if (t == 0 || t < kLatBins + kNumCtr) {
      const int k = t == 0 ? kNumCtr : t - kLatBins;
      for (int w = 0; w < warps; ++w) part += sh_warp[w][k];
    }
  }
  // the row: every CTA adds its part into rank 0's shared memory
  // (distributed shared memory), one cluster barrier, and rank 0 writes
  // ctr and hist whole; a cluster of one CTA writes its part straight out
  if (Q > 1) {
    cluster_wait();
    if (t < kRow && part) atomicAdd(cluster.map_shared_rank(sh_row + t, 0),
                                    part);
    cluster.sync();  // every part landed; the others may leave
    if (q != 0) return;
    if (t < kRow) part = sh_row[t];
  }
  if (t < kLatBins)
    HG_ST(hist, r * kLatBins + t, static_cast<int64_t>(R) * kLatBins,
          static_cast<int32_t>(part));
  else if (t < kRow)
    HG_ST(ctr, r * kCtrWidth + (t - kLatBins),
          static_cast<int64_t>(R) * kCtrWidth, static_cast<int32_t>(part));
}

}  // namespace

extern "C" {

// The constants the kernel was compiled with, for the wrapper to hold
// against core/types.py and core/layouts.py before the first launch.
int hermes_stats_block_abi(int32_t* out, int n) {
  const int32_t abi[] = {kLatBins, kCtrWidth, kNumCtr, kOpRmw, kCNone,
                         kCRead,   kCWrite,   kCRmw,   kCRmwAbort};
  const int len = static_cast<int>(sizeof(abi) / sizeof(abi[0]));
  for (int i = 0; i < len && i < n; ++i) out[i] = abi[i];
  return len;
}

// Launch on `stream`: code (R, S), ctr (R, 8) and hist (R, 64) are written
// whole.  R >= 1, S >= 1, R <= 65535 (the grid's y extent).  The plan: a
// cluster of Q CTAs a replica, Q in {1, 2, 4, 8, 16}; ps lanes a CTA, a
// multiple of 4, Q * ps >= S.
int hermes_stats_block(const void* step, const void* op, const void* invoke,
                       const void* commit, const void* abort_,
                       const void* read_done, void* code, void* ctr,
                       void* hist, int R, int S, int Q,
                       int ps HG_ENTRY_ARG, void* stream) {
  if (R < 1 || S < 1 || R > 65535 || Q < 1 || Q > kMaxCluster ||
      (Q & (Q - 1)) != 0 || ps < kUnit || ps % kUnit != 0 ||
      static_cast<int64_t>(Q) * ps < S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the cluster sizes whose first launch was checked: the round calls
  // with one plan, so it checks once
  static bool allowed = false;
  static bool checked[kMaxCluster + 1] = {};
  if (!allowed) {
    err = cudaFuncSetAttribute(
        stats_block_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16;
  };
  const auto word = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 4;
  };
  const int vec = !addr(op) && !addr(invoke) && !addr(code) &&
                  !word(commit) && !word(abort_) && !word(read_done);
  // a warp for each 32 units of a span, at least a thread for each
  // output word of the row and at most kThreads: a short row (S = 600)
  // leaves no idle warps holding registers
  int threads = ((ps / kUnit + 31) / 32) * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kThreads) threads = kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, R, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Q > 1 ? 1 : 0;  // one CTA a replica: a plain launch
  if (Q > 1 && !checked[Q]) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, stats_block_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return cudaErrorInvalidConfiguration;
    checked[Q] = true;
  }
  err = cudaLaunchKernelEx(&cfg, stats_block_kernel,
                           static_cast<const int32_t*>(step),
                           static_cast<const int32_t*>(op),
                           static_cast<const int32_t*>(invoke),
                           static_cast<const uint8_t*>(commit),
                           static_cast<const uint8_t*>(abort_),
                           static_cast<const uint8_t*>(read_done),
                           static_cast<int32_t*>(code),
                           static_cast<int32_t*>(ctr),
                           static_cast<int32_t*>(hist), S, ps, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
