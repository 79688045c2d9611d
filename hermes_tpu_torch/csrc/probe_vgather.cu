// probe_vgather: the table-step probe's row gather, for Hopper (sm_90a).
//
// Replaces the Pallas kernel scripts/pallas_probe.py:_vgather_kernel
// (candidate_step.vgather_fn, pallas_call at :205):
//   out[m, :] = table[row(keys[m]), :]
// from a (K, W) int32 table into (M, W) int32.  row(k) is where the
// reference's interpret mode reads a key outside [0, K): a negative key
// counts from the end (k + K), then the index is clamped to [0, K-1].  No
// load ever leaves the table.
//
// What bounds it: memory.  Per message a 4-byte key read and a W-word row
// written, per distinct key one W-word table row read: at the bench table
// shape (K = 2^20, M = 49,152, W = 10) about 4 MB, ~1.2 us at 3.35 TB/s,
// less than the launch itself.  On the TPU, Mosaic refused to lower the
// vectorized gather at all.  Here it is one launch of one thread per
// (message, word), neighbouring threads on neighbouring words of a row:
// the stores to out are fully coalesced and each row's load is 40
// contiguous bytes.  Rows are 8-byte but not 16-byte aligned, so the
// kernel moves 4-byte words and no 16-byte vectors.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/probe_kernels.py): pointers
// and the stream are void*-sized; returns cudaGetLastError() after the
// launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__device__ __forceinline__ int row_of(int k, int K) {
  if (k < 0) k += K;  // K >= 1, so this cannot overflow
  return k < 0 ? 0 : (k > K - 1 ? K - 1 : k);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ keys,
              const int32_t* __restrict__ table, int K, int W, int64_t n) {
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       j < n; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t m = j / W;
    const int k = row_of(HG_LD(keys, m, n / W), K);
    HG_ST(out, j, n, HG_LD(table, static_cast<int64_t>(k) * W + (j - m * W), static_cast<int64_t>(K) * W));
  }
}

}  // namespace

extern "C" {

// keys (M,) int32; table (K, W) int32; out (M, W) int32 output.
// K, M, W >= 1.
int hermes_probe_vgather(const void* keys, const void* table, void* out,
                         int K, int M, int W HG_ENTRY_ARG, void* stream) {
  if (K < 1 || M < 1 || W < 1) return cudaErrorInvalidValue;
  const cudaError_t began = HG_BEGIN(static_cast<cudaStream_t>(stream));
  if (began != cudaSuccess) return static_cast<int>(began);
  const int64_t n = static_cast<int64_t>(M) * W;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(table), K, W, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
