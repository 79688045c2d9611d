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
// 3.35 TB/s, so the launch itself dominates.  The design keeps every
// reduction on chip: one block per (replica, chunk of sessions) walks its
// chunk in a grid-stride loop with coalesced loads, counters reduce in
// registers and warp shuffles, the histogram in shared memory with
// shared-memory atomics, and each block adds its partial sums into the
// zeroed ctr/hist rows with one global atomicAdd per nonzero counter and
// bin.  The Pallas kernel instead walked session blocks in order on one
// core, accumulating into one revisited output block; blocks here run in
// no order, and integer atomics make the result order-independent, so it
// is bit-exact.  The round step is read from a device pointer, so a round
// needs no host sync.  Counters accumulate as uint32: the same bits as
// the reference's wrapping int32 sums.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/kernels.py): every pointer
// and the stream are void*-sized; returns cudaGetLastError() after the
// launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kLatBins = 64;   // core/state.py LAT_BINS
constexpr int kCtrWidth = 8;   // layouts.STATS_CTR.width
constexpr int kNumCtr = 6;     // read, write, rmw, abort, lat_sum, lat_cnt
constexpr int kThreads = 256;
constexpr int32_t kOpRmw = 3;  // types.OP_RMW
constexpr int32_t kCNone = 0, kCRead = 1, kCWrite = 2, kCRmw = 3,
                  kCRmwAbort = 4;  // types.C_*

__global__ void __launch_bounds__(kThreads)
stats_block_kernel(const int32_t* __restrict__ step_ptr,
                   const int32_t* __restrict__ op,
                   const int32_t* __restrict__ invoke,
                   const uint8_t* __restrict__ commit,
                   const uint8_t* __restrict__ abort_,
                   const uint8_t* __restrict__ read_done,
                   int32_t* __restrict__ code,
                   uint32_t* __restrict__ ctr,
                   uint32_t* __restrict__ hist,
                   int S) {
  __shared__ uint32_t sh_hist[kLatBins];
  __shared__ uint32_t sh_ctr[kNumCtr];
  for (int i = threadIdx.x; i < kLatBins; i += blockDim.x) sh_hist[i] = 0;
  if (threadIdx.x < kNumCtr) sh_ctr[threadIdx.x] = 0;
  __syncthreads();

  const int r = blockIdx.y;
  const int64_t n = static_cast<int64_t>(gridDim.y) * S;  // lanes: R x S
  const uint32_t step = static_cast<uint32_t>(HG_LD(step_ptr, 0, 1));
  const int64_t row = static_cast<int64_t>(r) * S;
  uint32_t v[kNumCtr] = {0, 0, 0, 0, 0, 0};
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += gridDim.x * blockDim.x) {
    const int64_t i = row + s;
    const bool c = HG_LD(commit, i, n) != 0;
    const bool a = HG_LD(abort_, i, n) != 0;
    const bool rd = HG_LD(read_done, i, n) != 0;
    const bool is_rmw = HG_LD(op, i, n) == kOpRmw;
    HG_ST(code, i, n, a ? kCRmwAbort : (c ? (is_rmw ? kCRmw : kCWrite) : (rd ? kCRead : kCNone)));
    v[0] += rd;
    v[3] += a;
    if (c) {
      const int32_t lat = static_cast<int32_t>(
          step - static_cast<uint32_t>(HG_LD(invoke, i, n)));
      v[1] += !is_rmw;
      v[2] += is_rmw;
      v[4] += static_cast<uint32_t>(lat);
      v[5] += 1;
      const int bin = lat < 0 ? 0 : (lat > kLatBins - 1 ? kLatBins - 1 : lat);
      atomicAdd(&sh_hist[bin], 1u);
    }
  }
#pragma unroll
  for (int k = 0; k < kNumCtr; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kNumCtr; ++k)
      if (v[k]) atomicAdd(&sh_ctr[k], v[k]);
  }
  __syncthreads();
  if (threadIdx.x < kNumCtr && sh_ctr[threadIdx.x])
    HG_ATOMIC_ADD(ctr, r * kCtrWidth + threadIdx.x, gridDim.y * kCtrWidth, sh_ctr[threadIdx.x]);
  for (int i = threadIdx.x; i < kLatBins; i += blockDim.x)
    if (sh_hist[i]) HG_ATOMIC_ADD(hist, r * kLatBins + i, gridDim.y * kLatBins, sh_hist[i]);
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

// Launch on `stream`; ctr (R, 8) and hist (R, 64) must be zeroed by the
// caller.  R >= 1, S >= 1, R <= 65535 (the grid's y extent).
int hermes_stats_block(const void* step, const void* op, const void* invoke,
                       const void* commit, const void* abort_,
                       const void* read_done, void* code, void* ctr,
                       void* hist, int R, int S HG_ENTRY_ARG, void* stream) {
  if (R < 1 || S < 1 || R > 65535) return cudaErrorInvalidValue;
  const cudaError_t began = HG_BEGIN(static_cast<cudaStream_t>(stream));
  if (began != cudaSuccess) return static_cast<int>(began);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about two blocks per SM over the whole grid, each walking its chunk
  const int per_row = (2 * sms + R - 1) / R;
  const int needed = (S + kThreads - 1) / kThreads;
  const int bx = per_row < needed ? (per_row > 0 ? per_row : 1) : needed;
  stats_block_kernel<<<dim3(bx, R), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(step), static_cast<const int32_t*>(op),
      static_cast<const int32_t*>(invoke),
      static_cast<const uint8_t*>(commit),
      static_cast<const uint8_t*>(abort_),
      static_cast<const uint8_t*>(read_done), static_cast<int32_t*>(code),
      static_cast<uint32_t*>(ctr), static_cast<uint32_t*>(hist), S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
