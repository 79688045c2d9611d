// analysis_fixtures: the seven small kernels the kernel analysis's red
// tests are built on, for Hopper (sm_90a).
//
// Each replaces a Pallas fixture kernel of tests/test_pallas_analysis.py
// (the line of its pl.pallas_call in brackets) and computes the same
// function; none is carried over block by block:
//
//   fx_pack        [:128, :146]  out = (a << 29) | b, elementwise int32
//   fx_store_at    [:174]  out = 0, then out[idx, :] = v[0, :], the row
//                          index read from device memory; one launch, the
//                          zero-fill in the kernel
//   fx_acc_revisit [:215]  out[r] = sum of row r of x, formed by the
//                          Pallas grid's two 128-column blocks adding their
//                          partial sums into the one (R, 1) output
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
// build does not clamp and may write outside the tensor (fx_serial_scan's
// and fx_store_at's release builds store no such key or row).
//
// Design notes, where the TPU kernel's shape does not carry over:
//   * fx_pack: an elementwise pass, bound by its bytes (two words read,
//     one written, an element).  Each thread loads one 16-byte int4 of a
//     and of b and stores one of out where n is a multiple of 4 and all
//     three pointers are 16-byte aligned (the wrapper chooses,
//     fixture_kernels.pack_access, and the entry re-checks), else one
//     word; no thread loops, so the fixture's 1,024 words are one CTA.
//     Each access is guarded in the units it moves.  Timed beside it: two
//     int4s a thread, all four loads before the two stores (PERF.md
//     section 6).
//   * fx_store_at: the Pallas kernel zero-fills its block, then stores
//     one row.  Here one plain launch does both, with no memset: thread i
//     owns unit i of the flat output (one int4 where rows * W is a
//     multiple of 4 and out is 16-byte aligned, fixture_kernels.
//     store_at_access, re-checked in the entry; else one word) and stores
//     v[j - lo] into each word j with lo <= j < lo + W, lo = idx * W, and
//     0 into the others.  An int4 may straddle two rows; the flat range
//     test needs no division by W.  Every word is written once, by one
//     thread, so the fill and the row need no order between them.  What
//     bounds it: the output's bytes, and at the fixture's few KB two
//     memory round trips (idx, then v) after the launch.  Inside the row
//     j - lo == j % W, so each thread loads v[j % W] (row 0, which does
//     not depend on idx) beside idx: one round trip, one division a
//     thread.  Timed beside it: the two-trip design that loads v only
//     after idx, in the row's threads alone (PERF.md section 6).  An idx
//     outside [0, rows) puts no word in the row: the release build
//     writes zeros and nothing outside out; the checked build records
//     the row's store range once (HG_ST_RANGE, thread 0).
//   * fx_acc_revisit: the Pallas grid revisits one output block in order
//     and zero-fills it on its first visit.  Blocks here run in no order,
//     so the first visit becomes the one visitor that stores: warp r sums
//     row r (one 16-byte int4 a lane where C is a multiple of 4 and x is
//     16-byte aligned, else one word; the wrapper chooses,
//     fixture_kernels.acc_revisit_access, and the entry re-checks), reduces
//     by shuffle, and lane 0 stores out[r] = (init ? 0 : out[r]) + sum.
//     `init` is an argument, not a memset; without it the kernel reads
//     out[r] through a guard, so a dropped initialisation still shows in
//     the checked build's poisoned output.  Wide rows take a thread-block
//     cluster along the columns (fixture_kernels.acc_revisit_plan, checked
//     here): each CTA sums its share into a shared (R,) partial, rank 0
//     adds the others' through distributed shared memory and makes the one
//     store a row, and a second cluster.sync() keeps every CTA alive until
//     its partial is read.  Integer sums commute, so the result is exact;
//     one device operation, no global atomic.  At (8, 256) one CTA.
//   * fx_serial_scan: the ordered loop becomes data, in one plain launch.
//     CTA b owns the table rows [b * kScanSlots, (b + 1) * kScanSlots) and
//     keeps their winner column in shared memory: it fills its slots with
//     -1, every thread walks the messages and takes a shared-memory
//     atomicMax of the message index on a key in its slice (integer maxima
//     commute, so each slot ends holding the last message on its row), and
//     after a barrier its warps walk the slice 32 slots at a time, list
//     the slots that won and copy the winners' rows, a word a lane,
//     neighbouring lanes on neighbouring words.  Each row is written by
//     its winner alone and untouched rows keep their values: the serial
//     loop's table bit for bit.  No global column, no memset, no state
//     between calls.  Every CTA reads every key, so the key reads grow
//     with K / kScanSlots (one CTA at K <= kScanSlots); a larger slice
//     means more chunks a warp, each a memory round trip, and a 216 KB
//     column was slower at the bench table than the 32 KB one kept.  A key
//     outside [0, K) is in no slice and never stored; the checked build
//     checks each message's row once, in CTA 0, as a store range against
//     the table.
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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlockCols = 128;  // the fixtures' column block
constexpr int kGridYMax = 65535;  // column blocks of fx_block_copy
constexpr int kTileBytes = 4096;  // fx_async_copy's tile, a multiple of 16
constexpr int kTileWords = kTileBytes / 4;
constexpr int kAccClusterMax = 16;  // fx_acc_revisit; non-portable above 8
constexpr int kAccLoads = 8;  // fx_acc_revisit's loads a lane in flight
constexpr int kScanThreads = 1024;  // fx_serial_scan's CTA
constexpr int kScanWarps = kScanThreads / 32;
// fx_serial_scan's table rows a CTA: a 32 KB winner column (a 216 KB one,
// 55,296 rows, walked 54 chunks a warp, was 3.4 times slower at the bench
// table: PERF.md section 6)
constexpr int kScanSlots = 8192;

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The pack of one word: the shift wraps, as int32's does in the fixture.
__device__ __forceinline__ int32_t pack29(int32_t a, int32_t b) {
  return static_cast<int32_t>((static_cast<uint32_t>(a) << 29) |
                              static_cast<uint32_t>(b));
}

// Thread i packs unit i of n words: an int4 of a, of b and of out (vec)
// or a word.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, int n, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const int units = n >> 2;
    if (i >= units) return;
    const int4 x = HG_LD(reinterpret_cast<const int4*>(a), i, units);
    const int4 y = HG_LD(reinterpret_cast<const int4*>(b), i, units);
    HG_ST(reinterpret_cast<int4*>(out), i, units,
          make_int4(pack29(x.x, y.x), pack29(x.y, y.y), pack29(x.z, y.z),
                    pack29(x.w, y.w)));
  } else if (i < n) {
    HG_ST(out, i, n, pack29(HG_LD(a, i, n), HG_LD(b, i, n)));
  }
}

// Thread i stores unit i of out, n = rows * W words: an int4 (vec) or a
// word.  Word j takes v[j - lo] where lo <= j < lo + W, lo = idx * W, and
// 0 elsewhere.  Inside the row j - lo is j % W, which does not depend on
// idx: the thread loads v[j % W] beside idx, one memory round trip.
__global__ void __launch_bounds__(kThreads)
store_at_kernel(const int32_t* __restrict__ idx,
                const int32_t* __restrict__ v, int32_t* __restrict__ out,
                int rows, int W, int vec) {
  const int n = rows * W;  // < 2^31 (the entry checks)
  const int unit = vec ? 4 : 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n / unit) return;
  const int64_t lo = static_cast<int64_t>(HG_LD(idx, 0, 1)) * W;
  // the checked build: a row outside out, recorded once
  if (i == 0) (void)HG_ST_RANGE(lo, W, n);
  const int j = i * unit;  // the unit's first word
  int c = static_cast<int>(static_cast<unsigned>(j) % static_cast<unsigned>(W));
  int32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < unit) {
      w[k] = HG_LD(v, c, W);  // row 0 of v
      c = c + 1 < W ? c + 1 : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (j + k < lo || j + k >= lo + W) w[k] = 0;  // outside the row
  if (vec)
    HG_ST(reinterpret_cast<int4*>(out), i, n / 4, make_int4(w[0], w[1], w[2], w[3]));
  else
    HG_ST(out, i, n, w[0]);
}

// Cluster rank q sums columns [q * cols, min(C, (q + 1) * cols)) of x,
// warp r row r (VEC columns a lane a load); the cluster's one store a row
// is out[r] = (init ? 0 : out[r]) + the row's sum.
template <int VEC>
__global__ void acc_revisit_kernel(const int32_t* __restrict__ x,
                                   int32_t* __restrict__ out, int R, int C,
                                   int cols, int init) {
  __shared__ uint32_t part[32];  // this CTA's sum of each row
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int Q = static_cast<int>(cluster.num_blocks());
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = q * cols, c1 = cols < C - c0 ? c0 + cols : C;
  uint32_t s = 0;  // the bits of a wrapping int32 sum
  // kAccLoads loads a lane in flight before the first add (a loop that
  // adds as it loads waits a round trip a load); each guarded in its row
  if constexpr (VEC == 4) {
    const int4* xr = reinterpret_cast<const int4*>(x) + static_cast<int64_t>(r) * (C / 4);
    for (int c = c0 + 4 * lane; c < c1; c += 128 * kAccLoads) {
      int4 v[kAccLoads];
#pragma unroll
      for (int u = 0; u < kAccLoads; ++u)
        v[u] = c + 128 * u < c1 ? HG_LD(xr, (c + 128 * u) / 4, C / 4) : int4{};
#pragma unroll
      for (int u = 0; u < kAccLoads; ++u)
        s += static_cast<uint32_t>(v[u].x) + static_cast<uint32_t>(v[u].y) +
             static_cast<uint32_t>(v[u].z) + static_cast<uint32_t>(v[u].w);
    }
  } else {
    const int32_t* xr = x + static_cast<int64_t>(r) * C;
    for (int c = c0 + lane; c < c1; c += 32 * kAccLoads) {
      int32_t v[kAccLoads];
#pragma unroll
      for (int u = 0; u < kAccLoads; ++u)
        v[u] = c + 32 * u < c1 ? HG_LD(xr, c + 32 * u, C) : 0;
#pragma unroll
      for (int u = 0; u < kAccLoads; ++u) s += static_cast<uint32_t>(v[u]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (Q > 1) {
    if (lane == 0) part[r] = s;
    cluster.sync();  // every CTA's partials are in its shared memory
    // rank 0, warp r: lane p < Q brings rank p's partial of row r
    if (q == 0) {
      uint32_t p = lane > 0 && lane < Q ? cluster.map_shared_rank(&part[0], lane)[r] : 0u;
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      s += p;
    }
  }
  if (q == 0 && lane == 0) {
    const uint32_t before = init ? 0u : static_cast<uint32_t>(HG_LD(out, r, R));
    HG_ST(out, r, R, static_cast<int32_t>(before + s));
  }
  if (Q > 1) cluster.sync();  // no CTA leaves while rank 0 reads its partials
}

template <int VEC>
cudaError_t launch_acc_revisit(const int32_t* x, int32_t* out, int R, int C,
                               int cluster, int cols, int init,
                               cudaStream_t st) {
  auto kernel = acc_revisit_kernel<VEC>;
  static int checked = 1;  // the largest cluster size checked so far
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(32 * R, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > checked) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int active = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidConfiguration;
    checked = cluster;
  }
  return cudaLaunchKernelEx(&cfg, kernel, x, out, R, C, cols, init);
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

// CTA b: the table rows [base, base + slots), base = b * kScanSlots, and
// their winner column `win` in shared memory; the last message on each
// row stores its row there.
__global__ void __launch_bounds__(kScanThreads)
serial_scan_kernel(int32_t* __restrict__ table,
                   const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ rows, int K, int M, int W) {
  extern __shared__ int32_t win[];  // slots of them
  __shared__ int2 won[kScanWarps][32];  // a warp's winning (slot, message)
  const int base = blockIdx.x * kScanSlots;
  const int slots = min(kScanSlots, K - base);
  const int64_t n_table = static_cast<int64_t>(K) * W, n_rows = static_cast<int64_t>(M) * W;
  for (int s = threadIdx.x; s < slots; s += kScanThreads) win[s] = -1;
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < M; i += kScanThreads) {
    const int k = HG_LD(keys, i, M);
    // the checked build: a message whose row leaves the table, once
    if (blockIdx.x == 0 && !HG_ST_RANGE(static_cast<int64_t>(k) * W, W, n_table))
      continue;
    if (k >= base && k - base < slots) HG_ATOMIC_MAX(win, k - base, slots, i);
  }
  __syncthreads();
  // warp w lists the winners of a chunk of 32 slots, then copies their
  // rows, word t of the list by lane t % 32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s0 = warp * 32; s0 < slots; s0 += kScanThreads) {
    const int i = s0 + lane < slots ? win[s0 + lane] : -1;
    const unsigned mask = __ballot_sync(0xffffffffu, i >= 0);
    if (i >= 0)
      HG_SMEM_ST(won[warp], __popc(mask & ((1u << lane) - 1)), 32, make_int2(s0 + lane, i));
    __syncwarp();
    const int words = __popc(mask) * W;
    for (int t = lane; t < words; t += 32) {
      const int j = t / W, c = t - j * W;
      const int2 e = won[warp][j];
      HG_ST(table, static_cast<int64_t>(base + e.x) * W + c, n_table,
            HG_LD(rows, static_cast<int64_t>(e.y) * W + c, n_rows));
    }
    __syncwarp();  // the list is read before the next chunk's is written
  }
}

}  // namespace

extern "C" {

// a, b, out: n int32 each.  n >= 1.  vec: 1 moves int4s (n a multiple
// of 4, all three pointers 16-byte aligned), 0 words; a vec the pointers
// or n do not allow is refused (cudaErrorInvalidValue).
int hermes_fx_pack(const void* a, const void* b, void* out, int n,
                   int vec HG_ENTRY_ARG, void* stream) {
  if (n < 1 || (vec != 0 && vec != 1) ||
      (vec && !(n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<grid_for(vec ? n / 4 : n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

// idx: one int32 on the device; v, out: (rows, W) int32.  rows, W >= 1,
// rows * W < 2^31.  vec: 1 stores int4s (rows * W a multiple of 4, out
// 16-byte aligned), 0 words; a vec out or the shape do not allow is
// refused (cudaErrorInvalidValue).  One launch, no memset.
int hermes_fx_store_at(const void* idx, const void* v, void* out, int rows,
                       int W, int vec HG_ENTRY_ARG, void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * W;
  if (rows < 1 || W < 1 || n > INT32_MAX || (vec != 0 && vec != 1) ||
      (vec && !(n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  store_at_kernel<<<grid_for(vec ? n / 4 : n), kThreads, 0, st>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(v),
      static_cast<int32_t*>(out), rows, W, vec);
  return static_cast<int>(cudaGetLastError());
}

// x (R, C) int32; out (R,) int32, out[r] = (init ? 0 : out[r]) + the sum
// of row r.  1 <= R <= 32 (one warp a row), 1 <= C < 2^31 - 1024.  The plan
// (fixture_kernels.acc_revisit_plan): vec 4 loads int4s (C a multiple of
// 4, x 16-byte aligned), 1 words; a cluster of `cluster` CTAs, each
// summing `cols` columns (a multiple of vec), covering C with no CTA
// empty.  A plan that breaks this is refused (cudaErrorInvalidValue).
int hermes_fx_acc_revisit(const void* x, void* out, int R, int C, int init,
                          int vec, int cluster, int cols HG_ENTRY_ARG,
                          void* stream) {
  if (R < 1 || R > 32 || C < 1 || C > INT32_MAX - 128 * kAccLoads ||
      (vec != 1 && vec != 4) || cluster < 1 ||
      cluster > kAccClusterMax || cols < 1 || cols % vec ||
      static_cast<int64_t>(cluster) * cols < C ||
      static_cast<int64_t>(cluster - 1) * cols >= C ||
      (vec == 4 && (C % 4 || reinterpret_cast<uintptr_t>(x) % 16)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  err = vec == 4 ? launch_acc_revisit<4>(xi, o, R, C, cluster, cols, init, st)
                 : launch_acc_revisit<1>(xi, o, R, C, cluster, cols, init, st);
  if (err != cudaSuccess) return static_cast<int>(err);
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
// int32.  K, M, W >= 1, M * W < 2^31, 32 * W < 2^31 (the words of a
// warp's list).  One launch of ceil(K / kScanSlots) CTAs, each with 4
// bytes of dynamic shared memory a row it owns.
int hermes_fx_serial_scan(void* table, const void* keys, const void* rows,
                          int K, int M, int W HG_ENTRY_ARG, void* stream) {
  if (K < 1 || M < 1 || W < 1 || static_cast<int64_t>(M) * W > INT32_MAX ||
      W > INT32_MAX / 32)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = K < kScanSlots ? K : kScanSlots;
  serial_scan_kernel<<<(K - 1) / kScanSlots + 1, kScanThreads,
                       sizeof(int32_t) * slots, st>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(rows), K, M, W);
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
