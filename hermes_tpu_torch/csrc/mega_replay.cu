// mega_replay: the gated stuck-key replay scan of one batched round, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel hermes_tpu/core/megaround.py:_replay_kernel
// (wrapper megaround.mega_replay).  What it computes, over the `rows`
// rows of the int8 bank (row = [pts | sst | val] bytes, little-endian):
//   * a row is stuck when its sst state is INVALID, TRANS or REPLAY and
//     step - (sst >> shift) > replay_age, both read from the pre-mark bytes;
//   * the candidates are the stuck rows in ascending row order, at most RS;
//   * candidate i goes to replica r's i-th free slot (active == 0, counted
//     from slot 0) unless r is frozen -- a frozen replica's free slot is
//     consumed all the same -- and a replica with fewer than i+1 free slots
//     does not take it.  A taken slot gets active = 1, key = row mod K,
//     pts = vpts[row], acks = 0 and the row's value bytes; every other slot
//     keeps its old fields (the outputs are new tensors);
//   * a candidate some replica took has its sst bytes rewritten to
//     (step << shift) | REPLAY, in place; no other byte changes.
//
// What bounds it: memory.  The scan must read every row's 4-byte sst word
// (4 MB at 2^20 rows); in the 40-byte bank row each such read costs one
// 32-byte sector (bytes 4..7 never cross one), ~34 MB, ~10 us at
// 3.35 TB/s (the whole rows are 42 MB; streaming them coalesced in
// 16-byte loads measured slower than the strided words, PERF.md).  The
// replay slots and candidate rows are under 0.5 MB.  The Pallas kernel walks VMEM-sized table blocks
// in order and carries a candidate cursor across grid steps in SMEM.
// Hopper blocks run in no order; the first port made the cursor three
// launches (count, place, assign).  This design is one cooperative launch
// of a persistent grid (never more CTAs than co-reside, queried once per
// device and kept), whose CTAs own contiguous spans of whole 1,024-row
// units (megaround.replay_plan, re-checked here), in three phases split
// by grid barriers:
//   A: each (replica, 256-slot chunk) task has a CTA of its own after the
//      span CTAs: it copies its slots' old fields to the new tensors,
//      counts the replica's free slots and ranks them with a block scan,
//      each thread keeping its slot's free rank for phase C.  In each span
//      CTA each thread reads the sst words of its rows (row lo + k*256 + t
//      of its CTA's span at step k, kBatch loads in flight) and keeps their stuck flags as a bitmask in a
//      register (kMaskSteps steps; rows past that re-read their word in
//      phase B); the CTA writes its stuck count to scratch.  A word is one
//      aligned 4-byte load a row, neighbouring threads on neighbouring
//      rows; a bank whose rows are not 4-byte aligned reads bytes;
//   B: every CTA reads all the per-CTA counts (a few hundred: its prefix,
//      the total, ncand = min(total, RS)) and the free counts (ntake =
//      min(ncand, max over unfrozen r of nfree[r])).  A CTA whose prefix
//      is below RS ranks its flags in row order (one ballot a step and
//      warp; warp 0 turns the counts into ranks, lane = step) and writes
//      cand[rank] = row for ranks below RS, without reading sst again;
//   C: the candidates below ntake get their sst word re-stamped (one
//      4-byte store each, spread over the grid), and each free slot of an
//      unfrozen replica whose free rank i is below ncand takes candidate
//      i: active 1, acks 0, the row's key, pts and value bytes (8-byte
//      loads and 16-byte stores where aligned) over the old copy.  The
//      fills read only value bytes and vpts, the marks write only sst
//      bytes, so no load covers bytes another CTA writes.
// Counts, free counts and cand are written by other CTAs before a
// barrier, so they are read with __ldcg (L2 only: L1 is not coherent
// across SMs); the bank is never read through the read-only path.  The
// round's step is read from a device pointer, so the round needs no host
// sync; bools are read and written as bytes.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build); a bank access
// is guarded by its index in units of its own width.
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns the first CUDA error of the checks,
// the queries and the launch (0 = launched); a refused cooperative launch
// is an error, never three launches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                     // REPLAY_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kUnitRows = 1024;                   // REPLAY_UNIT_ROWS
constexpr int kStepsPerUnit = kUnitRows / kThreads;
constexpr int kMaskSteps = 32;                    // flags held in a register
constexpr int kBatch = 8;                         // loads in flight a thread
constexpr int kCtasPerSm = 2;                     // REPLAY_CTAS_PER_SM
constexpr int kMaxDevices = 64;

struct Scan {
  const int32_t* step;
  const uint8_t* frozen;
  const int32_t* vpts;
  uint8_t* bank;
  const uint8_t* active;
  const int32_t* key;
  const int32_t* pts;
  const int32_t* acks;
  const int8_t* val;
  uint8_t* nact;
  int32_t* nkey;
  int32_t* npts;
  int32_t* nacks;
  int8_t* nval;
  int32_t* counts;  // spans: stuck rows of each span CTA's span
  int32_t* nfree;   // R: free slots of each replica
  int32_t* cand;    // RS: candidate rows in rank order, the first ncand
  int rows, w4, R, RS, K, age, shift, state_mask, s_invalid, s_trans,
      s_replay, sst_off, val_off, spans, per, words, vec;
  __device__ int64_t bank_bytes() const { return static_cast<int64_t>(rows) * w4; }
  __device__ int64_t slots() const { return static_cast<int64_t>(R) * RS; }
};

__device__ __forceinline__ bool stuck(const Scan& p, uint32_t word,
                                      int32_t step) {
  const int32_t sst = static_cast<int32_t>(word);
  const int32_t state = sst & p.state_mask;
  // int32 arithmetic that wraps, as the reference's
  const int32_t age = static_cast<int32_t>(static_cast<uint32_t>(step) -
                                           static_cast<uint32_t>(sst >> p.shift));
  return (state == p.s_invalid || state == p.s_trans ||
          state == p.s_replay) && age > p.age;
}

// The sst word of `row` from global memory: one aligned 4-byte load, or
// four bytes.
__device__ __forceinline__ uint32_t sst_word(const Scan& p, int row) {
  const int64_t b = static_cast<int64_t>(row) * p.w4 + p.sst_off;
  const int64_t nb = p.bank_bytes();
  if (p.words) {
    const uint32_t* bank4 = reinterpret_cast<const uint32_t*>(p.bank);
    return HG_LD(bank4, b / 4, nb / 4);
  }
  return static_cast<uint32_t>(HG_LD(p.bank, b, nb)) |
         (static_cast<uint32_t>(HG_LD(p.bank, b + 1, nb)) << 8) |
         (static_cast<uint32_t>(HG_LD(p.bank, b + 2, nb)) << 16) |
         (static_cast<uint32_t>(HG_LD(p.bank, b + 3, nb)) << 24);
}

// Stuck flags of this thread's rows at steps [k0, k1) (k1 - k0 <=
// kMaskSteps, a multiple of kStepsPerUnit) of the span [lo, hi): bit
// k - k0.
__device__ uint32_t flags(const Scan& p, int lo, int hi, int k0, int k1,
                          int32_t step) {
  uint32_t m = 0;
  for (int k = k0; k < k1; k += kBatch) {  // the batch's loads in flight together
    uint32_t w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = lo + (k + u) * kThreads + threadIdx.x;
      w[u] = k + u < k1 && row < hi ? sst_word(p, row) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = lo + (k + u) * kThreads + threadIdx.x;
      if (k + u < k1 && row < hi && stuck(p, w[u], step)) m |= 1u << (k + u - k0);
    }
  }
  return m;
}

// Sums of a and b over the block; every thread gets both.
__device__ int2 block_sum2(int a, int b) {
  __shared__ int2 part[kWarps];
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 all = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    all.x += part[w].x;
    all.y += part[w].y;
  }
  __syncthreads();
  return all;
}

// Maximum of v over the block; every thread gets it.
__device__ int block_max(int v) {
  __shared__ int part[kWarps];
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int all = part[0];
  for (int w = 1; w < kWarps; ++w) all = max(all, part[w]);
  __syncthreads();
  return all;
}

// Exclusive prefix sum of v in thread order; *total gets the block's sum.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? part[w] : 0;
    all += part[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Free slots (active == 0) among active[a, a + n), summed over the block:
// 4-byte words (p.vec >= 8 promises them aligned) or bytes.
__device__ int free_slots(const Scan& p, int64_t a, int n) {
  const int64_t ns = p.slots();
  int c = 0;
  if (p.vec >= 8 && a % 4 == 0 && n % 4 == 0) {
    const uint32_t* act4 = reinterpret_cast<const uint32_t*>(p.active);
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      c += __popc(__vcmpeq4(HG_LD(act4, a / 4 + i, ns / 4), 0u)) / 8;
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      c += HG_LD(p.active, a + i, ns) == 0;
  }
  return block_sum2(c, 0).x;
}

// n value bytes from src (byte s) to dst (byte d): 16-byte stores from
// 8-byte loads (vec 16), 8-byte loads and stores (vec 8) or bytes.
template <typename S>
__device__ __forceinline__ void copy_val(int8_t* dst, int64_t d, int64_t nd,
                                         const S* src, int64_t s, int64_t ns,
                                         int n, int vec) {
  if (vec >= 8) {
    const unsigned long long* src8 =
        reinterpret_cast<const unsigned long long*>(src);
    if (vec == 16) {
      ulonglong2* dst16 = reinterpret_cast<ulonglong2*>(dst);
      for (int q = 0; q < n / 16; ++q) {
        ulonglong2 v;
        v.x = HG_LD(src8, s / 8 + 2 * q, ns / 8);
        v.y = HG_LD(src8, s / 8 + 2 * q + 1, ns / 8);
        HG_ST(dst16, d / 16 + q, nd / 16, v);
      }
    } else {
      unsigned long long* dst8 = reinterpret_cast<unsigned long long*>(dst);
      for (int q = 0; q < n / 8; ++q)
        HG_ST(dst8, d / 8 + q, nd / 8, HG_LD(src8, s / 8 + q, ns / 8));
    }
    return;
  }
  for (int j = 0; j < n; ++j)
    HG_ST(dst, d + j, nd, static_cast<int8_t>(HG_LD(src, s + j, ns)));
}

// Slot task `task`: replica task / chunks, its slots from
// (task % chunks) * kThreads, a slot a thread.  Every slot's old fields go
// to the new tensors (fill() overwrites a slot a candidate takes, from the
// same thread, once cand is complete) and the chunk-0 task writes the
// replica's free count to nfree.  Returns the thread's slot's free rank
// where it is a free slot of an unfrozen replica (else -1), and sets
// *slot_out.  Every thread of the block calls it.
__device__ int slot_task(const Scan& p, int task, int chunks,
                         int64_t* slot_out) {
  const int r = task / chunks, s0 = (task % chunks) * kThreads;
  const int64_t row0 = static_cast<int64_t>(r) * p.RS;
  const int64_t ns = p.slots();
  const int v4 = p.w4 - p.val_off;
  const int s = s0 + threadIdx.x;
  const int64_t slot = row0 + s;
  const bool frozen = HG_LD(p.frozen, r, p.R) != 0;
  uint8_t act = 1;
  if (s < p.RS) {
    act = HG_LD(p.active, slot, ns);
    HG_ST(p.nact, slot, ns, act);
    HG_ST(p.nkey, slot, ns, HG_LD(p.key, slot, ns));
    HG_ST(p.npts, slot, ns, HG_LD(p.pts, slot, ns));
    HG_ST(p.nacks, slot, ns, HG_LD(p.acks, slot, ns));
    copy_val(p.nval, slot * v4, ns * v4, p.val, slot * v4, ns * v4, v4, p.vec);
  }
  const int before = s0 ? free_slots(p, row0, s0) : 0;
  const int is_free = act == 0 ? 1 : 0;
  int total;
  const int i = before + block_excl_scan(is_free, &total);  // free rank
  if (s0 == 0) {
    const int nf = chunks == 1 ? total : free_slots(p, row0, p.RS);
    if (threadIdx.x == 0) HG_ST(p.nfree, r, p.R, nf);
  }
  *slot_out = slot;
  return is_free && !frozen ? i : -1;
}

// Slot `slot` taken by candidate i: active 1, acks 0, and the row's key,
// pts and value bytes.
__device__ __forceinline__ void fill(const Scan& p, int64_t slot, int i) {
  const int64_t ns = p.slots();
  const int v4 = p.w4 - p.val_off;
  const int row = HG_LD_CG(p.cand, i, p.RS);
  HG_ST(p.nact, slot, ns, 1);
  HG_ST(p.nacks, slot, ns, 0);
  HG_ST(p.nkey, slot, ns, row % p.K);
  HG_ST(p.npts, slot, ns, HG_LD(p.vpts, row, p.rows));
  copy_val(p.nval, slot * v4, ns * v4, p.bank,
           static_cast<int64_t>(row) * p.w4 + p.val_off, p.bank_bytes(), v4,
           p.vec);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm) replay_kernel(Scan p) {
  __shared__ int base[kMaskSteps][kWarps];  // phase B: ranks of (step, warp)
  __shared__ int chunk_total;
  const int b = blockIdx.x, ctas = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t step = HG_LD(p.step, 0, 1);
  // a span CTA's rows; the slot CTAs after the spans have none
  const int lo = min(p.rows, b * p.per * kUnitRows);
  const int hi = min(p.rows, lo + p.per * kUnitRows);
  const int steps = b < p.spans ? p.per * kStepsPerUnit : 0;

  // phase A: a slot CTA runs its slot task (the free rank kept in
  // registers until phase C); a span CTA its stuck flags and count
  const int chunks = (p.RS + kThreads - 1) / kThreads;
  int64_t held_slot = 0;
  const int held = b >= p.spans ? slot_task(p, b - p.spans, chunks, &held_slot) : -1;
  uint32_t mask = 0;
  int mine = 0;
  for (int k0 = 0; k0 < steps; k0 += kMaskSteps) {
    const uint32_t m = flags(p, lo, hi, k0, min(steps, k0 + kMaskSteps), step);
    if (k0 == 0) mask = m;
    mine += __popc(m);
  }
  mine = block_sum2(mine, 0).x;
  if (b < p.spans && threadIdx.x == 0) HG_ST(p.counts, b, p.spans, mine);

  cg::this_grid().sync();

  // phase B: the CTA's prefix, ncand and ntake (candidate i is taken when
  // some unfrozen replica has more than i free slots)
  int pre = 0, tot = 0, most = 0;
  for (int i = threadIdx.x; i < p.spans; i += kThreads) {
    const int c = HG_LD_CG(p.counts, i, p.spans);
    tot += c;
    pre += i < b ? c : 0;
  }
  for (int r = threadIdx.x; r < p.R; r += kThreads) {
    const int nf = HG_LD_CG(p.nfree, r, p.R);
    if (HG_LD(p.frozen, r, p.R) == 0 && nf > most) most = nf;
  }
  const int2 sums = block_sum2(pre, tot);
  pre = sums.x;
  const int ncand = min(sums.y, p.RS);
  const int ntake = min(block_max(most), ncand);
  // ranks in row order: base[k][w] counts the flags of the steps before k
  // and of the warps before w at step k
  if (mine > 0 && pre < p.RS) {  // the same in every thread of the CTA
    int carry = pre;
    for (int k0 = 0; k0 < steps && carry < p.RS; k0 += kMaskSteps) {
      const int k1 = min(steps, k0 + kMaskSteps);
      const uint32_t m = k0 == 0 ? mask : flags(p, lo, hi, k0, k1, step);
      for (int k = k0; k < k1; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, (m >> (k - k0)) & 1u);
        if (lane == 0) base[k - k0][warp] = __popc(bal);
      }
      __syncthreads();
      if (warp == 0) {  // lane = step
        int run = 0;
        if (lane < k1 - k0)
          for (int w = 0; w < kWarps; ++w) {
            const int c = base[lane][w];
            base[lane][w] = run;
            run += c;
          }
        int x = run;  // inclusive scan of the steps' counts
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (lane < k1 - k0)
          for (int w = 0; w < kWarps; ++w) base[lane][w] += carry + x - run;
        if (lane == 31) chunk_total = x;
      }
      __syncthreads();
      for (int k = k0; k < k1; ++k) {
        const unsigned bal = __ballot_sync(0xffffffffu, (m >> (k - k0)) & 1u);
        if ((m >> (k - k0)) & 1u) {
          const int rank = base[k - k0][warp] + __popc(bal & ((1u << lane) - 1u));
          if (rank < p.RS)
            HG_ST(p.cand, rank, p.RS, lo + k * kThreads + static_cast<int>(threadIdx.x));
        }
      }
      carry += chunk_total;
      __syncthreads();
    }
  }

  cg::this_grid().sync();

  // phase C: the marks, spread over the grid, and the taken slots
  const int64_t nb = p.bank_bytes();
  const uint32_t mark = (static_cast<uint32_t>(step) << p.shift) |
                        static_cast<uint32_t>(p.s_replay);
  for (int i = b * kThreads + threadIdx.x; i < ntake; i += ctas * kThreads) {
    const int64_t at = static_cast<int64_t>(HG_LD_CG(p.cand, i, p.RS)) * p.w4 + p.sst_off;
    if (p.words) {
      uint32_t* bank4 = reinterpret_cast<uint32_t*>(p.bank);
      HG_ST(bank4, at / 4, nb / 4, mark);
    } else {
      HG_ST(p.bank, at, nb, static_cast<uint8_t>(mark));
      HG_ST(p.bank, at + 1, nb, static_cast<uint8_t>(mark >> 8));
      HG_ST(p.bank, at + 2, nb, static_cast<uint8_t>(mark >> 16));
      HG_ST(p.bank, at + 3, nb, static_cast<uint8_t>(mark >> 24));
    }
  }
  if (held >= 0 && held < ncand) fill(p, held_slot, held);
}

// CTAs of replay_kernel that co-reside on `dev`, queried once per device
// and kept; 0 until queried.
int co_resident[kMaxDevices];

bool aligned(const void* ptr, int n) {
  return reinterpret_cast<uintptr_t>(ptr) % n == 0;
}

}  // namespace

extern "C" {

// step: one int32 on the device; frozen (R,) bool; vpts (rows,) int32;
// bank (rows, w4) int8, updated in place; active (R, RS) bool; key, pts,
// acks (R, RS) int32; val (R, RS, w4 - val_off) int8; the n* outputs are
// shaped as their inputs; scratch holds n_scratch >= ctas + R + RS int32.
// rows, R, RS, K >= 1.  The plan: ctas span CTAs of `per` 1,024-row units
// each, exactly the CTAs the rows need; the grid adds one slot CTA a
// (replica, 256-slot chunk) task; words: 1 reads and writes the sst
// words as 4-byte words, 0 as bytes; vec: the value copies' width (16, 8
// or 1).  A plan, words or vec the pointers and shapes do not allow is
// refused.
int hermes_mega_replay(const void* step, const void* frozen, const void* vpts,
                       void* bank, const void* active, const void* key,
                       const void* pts, const void* acks, const void* val,
                       void* nact, void* nkey, void* npts, void* nacks,
                       void* nval, void* scratch, int n_scratch, int rows,
                       int w4, int R, int RS, int K, int replay_age, int shift,
                       int state_mask, int s_invalid, int s_trans,
                       int s_replay, int sst_off, int val_off, int ctas,
                       int per, int words, int vec HG_ENTRY_ARG,
                       void* stream) {
  const int v4 = w4 - val_off;
  if (rows < 1 || R < 1 || RS < 1 || K < 1 || val_off < sst_off + 4 ||
      v4 < 1 || per < 1 || ctas < 1 || n_scratch < ctas + R + RS)
    return cudaErrorInvalidValue;
  const int64_t span = static_cast<int64_t>(per) * kUnitRows;
  if ((ctas - 1) * span >= rows || ctas * span < rows)
    return cudaErrorInvalidValue;  // not the CTAs the rows need
  if ((words && !(aligned(bank, 4) && w4 % 4 == 0 && sst_off % 4 == 0)) ||
      (words != 0 && words != 1))
    return cudaErrorInvalidValue;
  const bool v8 = aligned(bank, 8) && aligned(val, 8) && aligned(nval, 8) &&
                  aligned(active, 4) && w4 % 8 == 0 && val_off % 8 == 0 &&
                  v4 % 8 == 0;
  if ((vec == 8 && !v8) ||
      (vec == 16 && !(v8 && aligned(val, 16) && aligned(nval, 16) && v4 % 16 == 0)) ||
      (vec != 1 && vec != 8 && vec != 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cap = co_resident[dev];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, replay_kernel,
                                                        kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap = per_sm * sms;
  }
  const int64_t grid = ctas + static_cast<int64_t>(R) * ((RS + kThreads - 1) / kThreads);
  if (grid > cap) return cudaErrorCooperativeLaunchTooLarge;
  Scan p;
  p.step = static_cast<const int32_t*>(step);
  p.frozen = static_cast<const uint8_t*>(frozen);
  p.vpts = static_cast<const int32_t*>(vpts);
  p.bank = static_cast<uint8_t*>(bank);
  p.active = static_cast<const uint8_t*>(active);
  p.key = static_cast<const int32_t*>(key);
  p.pts = static_cast<const int32_t*>(pts);
  p.acks = static_cast<const int32_t*>(acks);
  p.val = static_cast<const int8_t*>(val);
  p.nact = static_cast<uint8_t*>(nact);
  p.nkey = static_cast<int32_t*>(nkey);
  p.npts = static_cast<int32_t*>(npts);
  p.nacks = static_cast<int32_t*>(nacks);
  p.nval = static_cast<int8_t*>(nval);
  p.counts = static_cast<int32_t*>(scratch);
  p.nfree = p.counts + ctas;
  p.cand = p.nfree + R;
  p.rows = rows;
  p.w4 = w4;
  p.R = R;
  p.RS = RS;
  p.K = K;
  p.age = replay_age;
  p.shift = shift;
  p.state_mask = state_mask;
  p.s_invalid = s_invalid;
  p.s_trans = s_trans;
  p.s_replay = s_replay;
  p.sst_off = sst_off;
  p.val_off = val_off;
  p.spans = ctas;
  p.per = per;
  p.words = words;
  p.vec = vec;
  err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, replay_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
