// mega_route: the fused sort's route-back scatter of one batched round,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/core/megaround.py:_route_kernel
// (wrapper megaround.mega_route).  For each replica r and sorted position
// p, over outputs zero-filled first:
//   lane = clip(si[r, p], 0, L-1)
//   lane_word[r, lane] = word[r, p]
//   slot_lane[r, srank[r, p]] = lane      when 0 <= srank[r, p] < C
//
// What bounds it: memory.  Three int32 reads per (r, p), one or two int32
// stores, nothing to compute: at the bench shape (R=8, L=65,792,
// C=49,152) about 10 MB, ~3 us at 3.35 TB/s.  The Pallas kernel walks p
// serially on one core, one replica per grid step; here one thread per
// (r, p) loads its three words coalesced and stores to the two scattered
// targets.  The targets are unique -- si is a permutation of [0, L) and
// srank a bijection onto [0, L) -- so no two threads write one element,
// plain stores are exact and no atomics are needed.  (On inputs with a
// repeated target the result would depend on thread order; the round
// never makes such inputs, and the plain version and the tests hold the
// kernel on permutations only.)  Both outputs are zero-filled first with
// cudaMemsetAsync on the same stream, as the reference's kernel does;
// on permutation inputs every element is then overwritten.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns cudaGetLastError() after the
// launches (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
route_kernel(const int32_t* __restrict__ si, const int32_t* __restrict__ word,
             const int32_t* __restrict__ srank, int32_t* __restrict__ lane_word,
             int32_t* __restrict__ slot_lane, int L, int C, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / L;
    int lane = HG_LD(si, i, n);
    lane = lane < 0 ? 0 : (lane > L - 1 ? L - 1 : lane);
    HG_ST(lane_word, r * L + lane, n, HG_LD(word, i, n));
    const int s = HG_LD(srank, i, n);
    if (s >= 0 && s < C) HG_ST(slot_lane, r * C + s, n / L * C, lane);
  }
}

}  // namespace

extern "C" {

// si, word, srank: (R, L) int32; lane_word (R, L) and slot_lane (R, C)
// int32 outputs.  R, L >= 1, C >= 0.
int hermes_mega_route(const void* si, const void* word, const void* srank,
                      void* lane_word, void* slot_lane, int R, int L,
                      int C HG_ENTRY_ARG, void* stream) {
  if (R < 1 || L < 1 || C < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(R) * L;
  cudaError_t err = HG_BEGIN(st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(lane_word, 0, n * sizeof(int32_t), st);
  if (err == cudaSuccess && C > 0)
    err = cudaMemsetAsync(slot_lane, 0,
                          static_cast<int64_t>(R) * C * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  route_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(si), static_cast<const int32_t*>(word),
      static_cast<const int32_t*>(srank), static_cast<int32_t*>(lane_word),
      static_cast<int32_t*>(slot_lane), L, C, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
