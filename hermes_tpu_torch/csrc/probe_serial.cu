// probe_serial: the table-step probe's serial scatter, for Hopper (sm_90a).
//
// Replaces the Pallas kernel scripts/pallas_probe.py:_serial_kernel
// (candidate_step.serial_fn, pallas_call at :163).  Over M messages, in
// message order:
//   table[row(keys[i]), :] = rows[i, :]
// in place on the (K, W) int32 table, so the last message on a key wins
// and untouched rows keep their values.  row(k) is where the reference's
// interpret mode stores a key outside [0, K): a negative key counts from
// the end (k + K), then the index is clamped to [0, K-1].  No store ever
// leaves the table.
//
// What bounds it: memory.  Per message a 4-byte key read; per distinct key
// only the last message's W-word row matters, so one row read and one
// written: at the bench table shape (K = 2^20, M = 49,152, W = 10, about
// 48,000 distinct keys) about 4 MB, ~1.2 us at 3.35 TB/s, less than the
// launches themselves.  The Pallas kernel walks the messages in
// order, one dynamic row store per iteration, with the table in VMEM.
// Hopper blocks run in no order, so the order becomes data, in two
// launches on one stream after a memset:
//   memset: the int32 (K,) column win = -1 (bytes 0xFF);
//   phase 0: one thread per message, atomicMax(&win[row(key)], i).  Integer
//            maxima commute, so win[k] ends as the last message on k
//            whatever order the blocks ran in;
//   phase 1: one thread per (message, word), neighbouring threads on
//            neighbouring words of a row (coalesced loads of rows), stores
//            rows[i] only where win[row(key_i)] == i.
// Each row is written by one message only, so the table is bit-for-bit the
// serial loop's.  Rows are 40 bytes, 8-byte but not 16-byte aligned, so
// the kernel moves 4-byte words and no 16-byte vectors.  The (K,) column
// costs a 4K-byte memset a call (4 MB at 2^20 keys), not counted in the
// bound, which counts what the function itself must move.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build).
//
// C interface (ctypes, hermes_tpu_torch/core/probe_kernels.py): pointers
// and the stream are void*-sized; returns cudaGetLastError() after the
// launches (0 = launched).

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

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
win_kernel(int32_t* __restrict__ win, const int32_t* __restrict__ keys,
           int K, int M) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < M; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    HG_ATOMIC_MAX(win, row_of(HG_LD(keys, i, M), K), K, static_cast<int32_t>(i));
  }
}

__global__ void __launch_bounds__(kThreads)
store_kernel(int32_t* __restrict__ table, const int32_t* __restrict__ keys,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ win, int K, int W, int64_t n) {
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       j < n; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = j / W;
    const int k = row_of(HG_LD(keys, i, n / W), K);
    if (HG_LD(win, k, K) == i)
      HG_ST(table, static_cast<int64_t>(k) * W + (j - i * W), static_cast<int64_t>(K) * W, HG_LD(rows, j, n));
  }
}

}  // namespace

extern "C" {

// table (K, W) int32, updated in place; keys (M,) int32; rows (M, W)
// int32; win (K,) int32 scratch.  K, M, W >= 1.
int hermes_probe_serial(void* table, const void* keys, const void* rows,
                        void* win, int K, int M, int W HG_ENTRY_ARG,
                        void* stream) {
  if (K < 1 || M < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(win, 0xFF, sizeof(int32_t) * K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  win_kernel<<<grid_for(M), kThreads, 0, st>>>(
      static_cast<int32_t*>(win), static_cast<const int32_t*>(keys), K, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(M) * W;
  store_kernel<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(win), K,
      W, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
