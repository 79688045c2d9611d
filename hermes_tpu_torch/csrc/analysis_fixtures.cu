// analysis_fixtures: the seven small kernels the kernel analysis's red
// tests are built on, for Hopper (sm_90a).
//
// Each replaces a Pallas fixture kernel of tests/test_pallas_analysis.py
// (the line of its pl.pallas_call in brackets) and computes the same
// function; none is carried over block by block:
//
//   fx_pack        [:128, :146]  out = (a << 29) | b, elementwise int32
//   fx_store_at    [:174]  out = 0, then out[idx, :] = v[0, :], the row
//                          index read from device memory
//   fx_acc_revisit [:215]  out[r] = sum of row r of x, formed by one block
//                          per 128-column block adding its partial sums
//                          into the one (R, 1) output
//   fx_block_copy  [:249]  column block j of x copied to column block
//                          j + offset of out
//   fx_serial_scan [:279, :315]  table[keys[i], :] = rows[i, :] in message
//                          order, in place, the last message on a key
//                          winning
//   fx_async_copy  [:350]  out = x through an asynchronous copy
//   fx_loop_inc    [:405]  out = 0, then +1 n times
//
// What bounds them: at their fixture shapes (a few KB) nothing but the
// launch.  Their point is what the bound-checked build (guard.cuh) sees:
// every global access goes through a guard, so an index, a key or a block
// offset outside its extent is recorded and skipped, and a kernel that
// accumulates into an output nobody initialised shows in the poisoned
// output.  Inputs that leave an extent (fx_store_at's index, fx_serial_scan's
// keys, fx_block_copy's offset) are for the checked build only: the release
// build does not clamp and would write outside the tensor.
//
// Design notes, where the TPU kernel's shape does not carry over:
//   * fx_acc_revisit: the Pallas grid revisits one output block in order
//     and zero-fills it on the first visit.  Blocks here run in no order,
//     so the zero-fill is a cudaMemsetAsync before the launch (`init`), the
//     row sums reduce by warp shuffle and land with one integer atomicAdd a
//     row and block: order-free, so exact.  Without `init` the output keeps
//     whatever it held: the fixture of a dropped initialisation.
//   * fx_serial_scan: the ordered loop becomes data, as in probe_serial.cu:
//     a memset of an int32 (K,) column to -1, an integer atomicMax of the
//     message index per key, and a store pass in which only the winner of
//     a key writes its row.
//   * fx_block_copy: the Pallas grid walks the column blocks in order, a
//     (R, 128) block a step.  Here every thread moves one unit and no
//     thread loops: a grid of (row tile, column block) CTAs of 256
//     threads, each thread one 16-byte int4 (32 a block row, 8 rows a
//     CTA) where C is a multiple of 4 and both pointers are 16-byte
//     aligned (the wrapper chooses, fixture_kernels.block_copy_access, and
//     the entry re-checks), else one word (128 a block row, 2 rows a CTA).
//     At (8, 256) that is 2 CTAs of one 16-byte copy a thread; what bounds
//     it is the launch.  Each store is guarded against its own row's
//     extent in the units it moves, so an offset block past the row's end
//     is caught, not aliased into the next row.
//   * fx_async_copy: pltpu.make_async_copy and its DMA semaphore become
//     the Tensor Memory Accelerator's 1-D bulk copy and an mbarrier.  One
//     warp a CTA, a tile of kTileBytes a CTA (the last tile what remains, a
//     multiple of 16 bytes since n % 4 == 0); one thread initialises the
//     barrier, arms it with the tile's byte count, asks for the tile
//     (cp.async.bulk global -> shared, completing on the barrier), waits
//     for phase 0, asks for the bulk store (shared -> global) and waits
//     until shared memory has been read.  The data never passes through
//     registers; no thread loops.  The hardware forms both copies'
//     addresses, so no guard wraps them: each is declared HG_UNGUARDED.
//     The checked build checks each tile's store once, as a range against
//     out's extent (HG_ST_RANGE), and skips a tile that leaves it.  A tile
//     of 4 KB: with one tile in flight a CTA, more CTAs move more at once;
//     a 16 KB tile was slower at 256 KB and at 4 MB (PERF.md §6).
//   * fx_loop_inc: each thread forms the value with the register loop and
//     stores one 16-byte int4 where n is a multiple of 4 and out is 16-byte
//     aligned (the wrapper chooses, fixture_kernels.loop_inc_access, and
//     the entry re-checks), else one word: one CTA at the fixture's 1,024
//     words.  Each store is guarded in the units it writes.
//
// C interface (ctypes, hermes_tpu_torch/analysis/fixture_kernels.py):
// pointers and the stream are void*-sized; each entry returns
// cudaGetLastError() after its launches (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockCols = 128;  // the fixtures' column block
constexpr int kGridYMax = 65535;  // column blocks of fx_block_copy
constexpr int kTileBytes = 4096;  // fx_async_copy's tile, a multiple of 16
constexpr int kTileWords = kTileBytes / 4;

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = static_cast<uint32_t>(HG_LD(a, i, n)) << 29;
  HG_ST(out, i, n, static_cast<int32_t>(hi | static_cast<uint32_t>(HG_LD(b, i, n))));
}

// One warp: lane l stores words l, l + 32, ... of row 0 of v at row idx.
__global__ void store_at_kernel(const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ v,
                                int32_t* __restrict__ out, int rows, int W) {
  const int64_t n = static_cast<int64_t>(rows) * W;
  const int64_t row = HG_LD(idx, 0, 1);
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    HG_ST(out, row * W + w, n, HG_LD(v, w, n));  // w < W: exact in the row
}

// Block j: rows of column block j; warp r sums row r and adds it to out[r].
__global__ void acc_revisit_kernel(const int32_t* __restrict__ x,
                                   int32_t* __restrict__ out, int R, int C) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t n = static_cast<int64_t>(R) * C;
  uint32_t s = 0;
  for (int c = blockIdx.x * kBlockCols + lane;
       c < C && c < (blockIdx.x + 1) * kBlockCols; c += 32)
    s += static_cast<uint32_t>(HG_LD(x, static_cast<int64_t>(r) * C + c, n));
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) HG_ATOMIC_ADD(out, r, R, static_cast<int32_t>(s));
}

// Block (t, j) copies rows [t * rows, (t + 1) * rows) of column block j
// of x to column block j + offset of out, one unit a thread: an int4 (vec,
// 32 units a block row, 8 rows a CTA) or a word (128 units, 2 rows).
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int R, int C, int offset, int vec) {
  const int shift = vec ? 5 : 7;  // log2 of the units of a block row
  const int r = blockIdx.x * (kThreads >> shift) + (threadIdx.x >> shift);
  const int u = threadIdx.x & ((1 << shift) - 1);
  const int cu = vec ? C >> 2 : C;  // units a row
  const int src = (blockIdx.y << shift) + u;
  if (r >= R || src >= cu) return;  // past the last row; the ragged block
  const int dst = (static_cast<int>(blockIdx.y) + offset) * (1 << shift) + u;
  const int64_t row = static_cast<int64_t>(r) * cu, n = static_cast<int64_t>(R) * cu;
  // guarded in its row: a flat index past the row's end would alias the
  // next row and pass
  if (vec)
    HG_ST(reinterpret_cast<int4*>(out) + row, dst, cu, HG_LD(reinterpret_cast<const int4*>(x), row + src, n));
  else
    HG_ST(out + row, dst, cu, HG_LD(x, row + src, n));
}

__global__ void __launch_bounds__(kThreads)
scan_win_kernel(int32_t* __restrict__ win, const int32_t* __restrict__ keys,
                int K, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) HG_ATOMIC_MAX(win, HG_LD(keys, i, M), K, i);
}

__global__ void __launch_bounds__(kThreads)
scan_store_kernel(int32_t* __restrict__ table, const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ win, int K, int M, int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M * W) return;
  const int i = j / W;
  const int64_t k = HG_LD(keys, i, M);
  if (HG_LD(win, k, K) == i)
    HG_ST(table, k * W + (j - i * W), static_cast<int64_t>(K) * W, HG_LD(rows, j, M * W));
}

// The shared-memory address of p, as the bulk copies and the barrier take it.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Block b copies words [b * kTileWords, b * kTileWords + words) of x to
// out, n words in all, out holding n_out: one thread drives the TMA, the
// data goes from global to shared memory and back without a register.
__global__ void __launch_bounds__(32)
async_copy_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int n, int n_out) {
  __shared__ __align__(128) int32_t stage[kTileWords];
  __shared__ __align__(8) uint64_t full;
  if (threadIdx.x != 0) return;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const int words = static_cast<int>(
      n - start < kTileWords ? n - start : kTileWords);
  if (!HG_ST_RANGE(start, words, n_out)) return;  // skip the tile
  const uint32_t bytes = 4u * words, bar = smem_addr(&full),
                 tile = smem_addr(stage);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  HG_UNGUARDED("cp.async.bulk (TMA) of a tile from x into shared memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(tile), "l"(x + start), "r"(bytes), "r"(bar)
      : "memory");
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");  // phase 0
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  HG_UNGUARDED("cp.async.bulk (TMA) of the tile from shared memory to out");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(out + start), "r"(tile), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Thread i stores unit i of out: an int4 (vec) or a word.
__global__ void __launch_bounds__(kThreads)
loop_inc_kernel(int32_t* __restrict__ out, int n, int times, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int units = vec ? n >> 2 : n;
  if (i >= units) return;
  int32_t v = 0;
  for (int t = 0; t < times; ++t) v += 1;
  if (vec)
    HG_ST(reinterpret_cast<int4*>(out), i, units, make_int4(v, v, v, v));
  else
    HG_ST(out, i, n, v);
}

}  // namespace

extern "C" {

// a, b, out: n int32 each.  n >= 1.
int hermes_fx_pack(const void* a, const void* b, void* out, int n HG_ENTRY_ARG,
                   void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// idx: one int32 on the device; v, out: (rows, W) int32.  rows, W >= 1.
int hermes_fx_store_at(const void* idx, const void* v, void* out, int rows,
                       int W HG_ENTRY_ARG, void* stream) {
  if (rows < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * rows * W, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  store_at_kernel<<<1, 32, 0, st>>>(static_cast<const int32_t*>(idx),
                                    static_cast<const int32_t*>(v),
                                    static_cast<int32_t*>(out), rows, W);
  return static_cast<int>(cudaGetLastError());
}

// x (R, C) int32; out (R,) int32, zero-filled first when init != 0.
// 1 <= R <= 32 (one warp a row), C >= 1.
int hermes_fx_acc_revisit(const void* x, void* out, int R, int C,
                          int init HG_ENTRY_ARG, void* stream) {
  if (R < 1 || R > 32 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err == cudaSuccess && init)
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * R, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  acc_revisit_kernel<<<(C + kBlockCols - 1) / kBlockCols, 32 * R, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (R, C) int32.  R, C >= 1, C <= 128 * 65535.  vec: 1 moves
// int4s (C a multiple of 4, x and out 16-byte aligned), 0 words; a vec the
// pointers or C do not allow is refused (cudaErrorInvalidValue).
int hermes_fx_block_copy(const void* x, void* out, int R, int C, int offset,
                         int vec HG_ENTRY_ARG, void* stream) {
  if (R < 1 || C < 1 || (C + kBlockCols - 1) / kBlockCols > kGridYMax ||
      (vec != 0 && vec != 1) ||
      (vec && !(C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = vec ? kThreads / 32 : kThreads / kBlockCols;  // a CTA
  const dim3 grid((R + rows - 1) / rows, (C + kBlockCols - 1) / kBlockCols);
  block_copy_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), R, C,
      offset, vec);
  return static_cast<int>(cudaGetLastError());
}

// table (K, W) int32, updated in place; keys (M,) int32; rows (M, W)
// int32; win (K,) int32 scratch.  K, M, W >= 1, M * W < 2^31.
int hermes_fx_serial_scan(void* table, const void* keys, const void* rows,
                          void* win, int K, int M, int W HG_ENTRY_ARG,
                          void* stream) {
  if (K < 1 || M < 1 || W < 1 || static_cast<int64_t>(M) * W > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(win, 0xFF, sizeof(int32_t) * K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_win_kernel<<<grid_for(M), kThreads, 0, st>>>(
      static_cast<int32_t*>(win), static_cast<const int32_t*>(keys), K, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_store_kernel<<<grid_for(static_cast<int64_t>(M) * W), kThreads, 0, st>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(win), K,
      M, W);
  return static_cast<int>(cudaGetLastError());
}

// x: n int32, copied to out, which holds n_out int32 (n, from the
// wrapper); both 16-byte aligned, as a bulk copy needs, else refused
// (cudaErrorInvalidValue).  n >= 4, a multiple of 4.  An n_out below n only
// in the checked build, whose range check skips the tiles past it.
int hermes_fx_async_copy(const void* x, void* out, int n,
                         int n_out HG_ENTRY_ARG, void* stream) {
  if (n < 4 || n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  async_copy_kernel<<<(n + kTileWords - 1) / kTileWords, 32, 0, st>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n, n_out);
  return static_cast<int>(cudaGetLastError());
}

// out: n int32.  n >= 1, times >= 0.  vec: 1 stores int4s (n a multiple
// of 4, out 16-byte aligned), 0 words; a vec out or n do not allow is
// refused (cudaErrorInvalidValue).
int hermes_fx_loop_inc(void* out, int n, int times,
                       int vec HG_ENTRY_ARG, void* stream) {
  if (n < 1 || times < 0 || (vec != 0 && vec != 1) ||
      (vec && !(n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  loop_inc_kernel<<<grid_for(vec ? n / 4 : n), kThreads, 0, st>>>(
      static_cast<int32_t*>(out), n, times, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
