// scan_acc: the kernel matrix's scan-accumulate sentinel, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/analysis/diffcheck.py:
// _scan_acc_cell._kern (pallas_call at :99): the (1, W) int32 output is
// zeroed, then a 16-step loop adds row i of the (16, W) int32 input to it.
// The function is the column sums, out[0, w] = sum_i x[i, w], with int32
// arithmetic that wraps.
//
// What bounds it: memory, 4 bytes read per element and 4 written per
// column; at the sentinel's shape (16, 8) that is 544 bytes, so the launch
// itself is all of its time.  The Pallas kernel is a serial loop over rows
// because the TPU walks a block's rows one at a time and carries the sum in
// the output block.  Integer sums commute, so here one thread per column
// sums its M rows in a register (neighbouring threads read neighbouring
// words of a row, so every row read is coalesced) and stores once: no
// zero-fill, no atomics, no second pass.  General in (M, W).
//
// C interface (ctypes, hermes_tpu_torch/analysis/fixture_kernels.py):
// pointers and the stream are void*-sized; returns cudaGetLastError() after
// the launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
scan_acc_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int M, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t n = static_cast<int64_t>(M) * W;
  uint32_t acc = 0;  // the bits of a wrapping int32 sum
  for (int i = 0; i < M; ++i)
    acc += static_cast<uint32_t>(HG_LD(x, static_cast<int64_t>(i) * W + w, n));
  HG_ST(out, w, W, static_cast<int32_t>(acc));
}

}  // namespace

extern "C" {

// x (M, W) int32; out (1, W) int32 output.  M, W >= 1.
int hermes_scan_acc(const void* x, void* out, int M, int W HG_ENTRY_ARG,
                    void* stream) {
  if (M < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_acc_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), M, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
