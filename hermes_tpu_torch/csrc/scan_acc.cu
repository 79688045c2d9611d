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
// column (at (4096, 256) 4.2 MB, 1.25 us at 3.35 TB/s).  The Pallas kernel
// is a serial loop over rows because the TPU walks a block's rows one at a
// time and carries the sum in the output block.  Integer sums commute, so
// here the rows are split instead:
//   * the columns are cut into tiles of tpr * VEC columns, one thread-block
//     cluster a tile (gridDim.y tiles);
//   * each CTA of the cluster sums a contiguous share of the rows: tpr
//     neighbouring threads read one row's tile (VEC = 4: one 16-byte load
//     of 4 columns a thread, where W and the pointer allow it; VEC = 1: one
//     column a thread), the CTA's other threads the next rows, every load
//     coalesced, the sums in registers;
//   * the CTA's warps reduce with shuffles, then across warps in shared
//     memory, into the CTA's partial row of the tile;
//   * rank 0 of the cluster adds the other CTAs' partials through
//     distributed shared memory and stores each column once.  A second
//     cluster.sync() keeps every CTA alive until its partial is read (a
//     cluster of one CTA takes the CTA's own barrier instead).
// One device operation a call: no zero-fill, no global atomics, no second
// pass.  The geometry (VEC, tpr, cluster size, rows a CTA) is planned by
// the wrapper (hermes_tpu_torch/analysis/fixture_kernels.py:scan_acc_plan)
// and checked here.  At the sentinel's (16, 8) one CTA, a cluster of one,
// does the work.
//
// Every global access is a guard site (guard.cuh), none inside a serial
// loop longer than a CTA's row share.
//
// C interface (ctypes, hermes_tpu_torch/analysis/fixture_kernels.py):
// pointers and the stream are void*-sized; returns the first CUDA error of
// the attribute calls and the launch (0 = launched).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;     // tpr * VEC <= 8 * 4
constexpr int kMaxCluster = 16;  // non-portable above 8

template <int VEC>
__global__ void __launch_bounds__(kThreads)
scan_acc_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                int M, int W, int tpr, int rows_per_cta) {
  __shared__ uint32_t part[kWarps][kMaxTile];
  __shared__ uint32_t cta_sum[kMaxTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = tpr * VEC;
  const int tx = threadIdx.x % tpr;  // this thread's VEC columns
  const int ty = threadIdx.x / tpr;  // its first row in the share
  const int rows_in_flight = kThreads / tpr;
  const int col0 = blockIdx.y * tile + tx * VEC;
  const int64_t r0 = static_cast<int64_t>(rank) * rows_per_cta;
  const int64_t r1 = r0 + rows_per_cta < M ? r0 + rows_per_cta : M;
  const int64_t n = static_cast<int64_t>(M) * W;

  uint32_t acc[VEC] = {};  // the bits of wrapping int32 sums
  if (col0 < W) {
    if constexpr (VEC == 4) {
      const int4* xv = reinterpret_cast<const int4*>(x);
#pragma unroll 4
      for (int64_t i = r0 + ty; i < r1; i += rows_in_flight) {
        const int4 v = HG_LD(xv, (i * W + col0) / 4, n / 4);
        acc[0] += static_cast<uint32_t>(v.x);
        acc[1] += static_cast<uint32_t>(v.y);
        acc[2] += static_cast<uint32_t>(v.z);
        acc[3] += static_cast<uint32_t>(v.w);
      }
    } else {
#pragma unroll 4
      for (int64_t i = r0 + ty; i < r1; i += rows_in_flight)
        acc[0] += static_cast<uint32_t>(HG_LD(x, i * W + col0, n));
    }
  }
  // lanes l and l ^ o (o a multiple of tpr) hold the same columns
  for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < tpr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[warp][lane * VEC + j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < tile) {
    uint32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    cta_sum[threadIdx.x] = s;
  }
  // a cluster of one CTA needs only the CTA's own barrier, and is cheaper
  const int Q = static_cast<int>(cluster.num_blocks());
  if (Q > 1)
    cluster.sync();  // every CTA's partial is in its shared memory
  else
    __syncthreads();
  if (rank == 0 && threadIdx.x < tile) {
    uint32_t s = cta_sum[threadIdx.x];
    for (int q = 1; q < Q; ++q)
      s += cluster.map_shared_rank(&cta_sum[0], q)[threadIdx.x];
    const int col = blockIdx.y * tile + threadIdx.x;
    if (col < W) HG_ST(out, col, W, static_cast<int32_t>(s));
  }
  if (Q > 1) cluster.sync();  // no CTA leaves while rank 0 reads its partial
}

template <int VEC>
cudaError_t launch(const int32_t* x, int32_t* out, int M, int W, int tpr,
                   int cluster, int tiles, int rows_per_cta,
                   cudaStream_t st) {
  auto kernel = scan_acc_kernel<VEC>;
  static int checked = 0;  // the largest cluster size checked so far
  if (!checked) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > checked) {
    int active = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    checked = cluster;
  }
  return cudaLaunchKernelEx(&cfg, kernel, x, out, M, W, tpr, rows_per_cta);
}

}  // namespace

extern "C" {

// x (M, W) int32; out (1, W) int32 output.  M, W >= 1.  The plan:
// vec 4 (W % 4 == 0 and x 16-byte aligned) or 1; tpr threads a row, a
// power of two with tpr * vec <= 32; cluster CTAs a tile, each summing
// rows_per_cta rows, cluster * rows_per_cta >= M; tiles * tpr * vec >= W.
int hermes_scan_acc(const void* x, void* out, int M, int W, int vec, int tpr,
                    int cluster, int tiles, int rows_per_cta HG_ENTRY_ARG,
                    void* stream) {
  if (M < 1 || W < 1 || tpr < 1 || tpr > 8 || (tpr & (tpr - 1)) ||
      cluster < 1 || cluster > kMaxCluster || rows_per_cta < 1 ||
      tiles < 1 || tiles > 65535 ||
      static_cast<int64_t>(cluster) * rows_per_cta < M ||
      static_cast<int64_t>(tiles) * tpr * vec < W)
    return cudaErrorInvalidValue;
  if (vec == 4 && (W % 4 || reinterpret_cast<uintptr_t>(x) % 16))
    return cudaErrorInvalidValue;
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  err = vec == 4
            ? launch<4>(xi, o, M, W, tpr, cluster, tiles, rows_per_cta, st)
            : launch<1>(xi, o, M, W, tpr, cluster, tiles, rows_per_cta, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
