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
// 3.35 TB/s.  The replay slots and candidate rows are under 0.5 MB.
// The Pallas kernel walks VMEM-sized table blocks in order and carries a
// candidate cursor across grid steps in SMEM.  Hopper blocks run in no
// order, so the cursor becomes three launches on one stream:
//   (a) count:  one block per 1024 rows forms the stuck flags and writes
//       its count (block 0 also clears the candidate list);
//   (b) place:  a block with stuck rows sums the earlier blocks' counts
//       (its offset; it stops when that reaches RS), ranks its stuck rows
//       with a block scan in row order, and writes rank -> row for the
//       ranks below RS;
//   (c) assign: one block per replica ranks its free slots with a block
//       scan and fills the new slot tensors; one more block computes how
//       many candidates some unfrozen replica takes and re-stamps those
//       rows.  The replica blocks read only value bytes and vpts, the mark
//       block writes only sst bytes, so they need no ordering.
// The round's step is read from a device pointer, so the round needs no
// host sync; bools are read and written as bytes; the sst word is read
// and written byte by byte, by arithmetic.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build); a bank byte is
// guarded by its byte index row * w4 + offset, not by its row.
//
// C interface (ctypes, hermes_tpu_torch/core/megaround.py): pointers and
// the stream are void*-sized; returns cudaGetLastError() after the
// launches (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;  // REPLAY_ROWS_PER_BLOCK
constexpr int kWarps = kThreads / 32;

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
  int32_t* counts;  // one per row block
  int32_t* cand;    // RS candidate rows, -1 past the last
  int rows, w4, R, RS, K, age, shift, state_mask, s_invalid, s_trans,
      s_replay, sst_off, val_off;
  __device__ int64_t bank_bytes() const { return static_cast<int64_t>(rows) * w4; }
  __device__ int64_t slots() const { return static_cast<int64_t>(R) * RS; }
};

__device__ __forceinline__ bool stuck(const Scan& p, int row, int32_t step) {
  const int64_t b = static_cast<int64_t>(row) * p.w4 + p.sst_off, nb = p.bank_bytes();
  const int32_t sst = static_cast<int32_t>(
      static_cast<uint32_t>(HG_LD(p.bank, b, nb)) |
      (static_cast<uint32_t>(HG_LD(p.bank, b + 1, nb)) << 8) |
      (static_cast<uint32_t>(HG_LD(p.bank, b + 2, nb)) << 16) |
      (static_cast<uint32_t>(HG_LD(p.bank, b + 3, nb)) << 24));
  const int32_t state = sst & p.state_mask;
  // int32 arithmetic that wraps, as the reference's
  const int32_t age = static_cast<int32_t>(static_cast<uint32_t>(step) -
                                           static_cast<uint32_t>(sst >> p.shift));
  return (state == p.s_invalid || state == p.s_trans ||
          state == p.s_replay) && age > p.age;
}

// Sum of v over the block; every thread gets it.
__device__ int block_sum(int v) {
  __shared__ int part[kWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int all = 0;
  for (int w = 0; w < kWarps; ++w) all += part[w];
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

__global__ void __launch_bounds__(kThreads) count_kernel(Scan p) {
  const int32_t step = HG_LD(p.step, 0, 1);
  const int base = blockIdx.x * kRowsPerBlock;
  int n = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = base + k * kThreads + threadIdx.x;
    n += __syncthreads_count(row < p.rows && stuck(p, row, step));
  }
  if (threadIdx.x == 0) HG_ST(p.counts, blockIdx.x, gridDim.x, n);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < p.RS; i += kThreads) HG_ST(p.cand, i, p.RS, -1);
}

__global__ void __launch_bounds__(kThreads) place_kernel(Scan p) {
  const int b = blockIdx.x;
  if (HG_LD(p.counts, b, gridDim.x) == 0) return;  // the same for the whole block
  int part = 0;
  for (int i = threadIdx.x; i < b; i += kThreads) part += HG_LD(p.counts, i, gridDim.x);
  int carry = block_sum(part);  // candidates of the earlier blocks
  const int32_t step = HG_LD(p.step, 0, 1);
  const int base = b * kRowsPerBlock;
  // carry is the same in every thread, so the loop and its scans are too
  for (int k = 0; k < kRowsPerThread && carry < p.RS; ++k) {
    const int row = base + k * kThreads + threadIdx.x;
    const int f = (row < p.rows && stuck(p, row, step)) ? 1 : 0;
    int total;
    const int rank = carry + block_excl_scan(f, &total);
    if (f && rank < p.RS) HG_ST(p.cand, rank, p.RS, row);
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads) assign_kernel(Scan p) {
  // the placed candidates are a prefix of cand
  int ncand = 0;
  for (int i0 = 0; i0 < p.RS; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    ncand += __syncthreads_count(i < p.RS && HG_LD(p.cand, i, p.RS) >= 0);
  }
  const int v4 = p.w4 - p.val_off;
  const int64_t ns = p.slots(), nv = ns * v4, nb = p.bank_bytes();
  if (blockIdx.x < p.R) {
    const int r = blockIdx.x;
    const bool frozen = HG_LD(p.frozen, r, p.R) != 0;
    int carry = 0;  // free slots before this chunk
    for (int s0 = 0; s0 < p.RS; s0 += kThreads) {
      const int s = s0 + threadIdx.x;
      const int64_t slot = static_cast<int64_t>(r) * p.RS + s;
      const int is_free = (s < p.RS && HG_LD(p.active, slot, ns) == 0) ? 1 : 0;
      int total;
      const int i = carry + block_excl_scan(is_free, &total);  // free rank
      carry += total;
      if (s >= p.RS) continue;
      const int64_t dst = slot * v4;
      if (is_free && i < ncand && !frozen) {
        const int row = HG_LD(p.cand, i, p.RS);
        HG_ST(p.nact, slot, ns, 1);
        HG_ST(p.nkey, slot, ns, row % p.K);
        HG_ST(p.npts, slot, ns, HG_LD(p.vpts, row, p.rows));
        HG_ST(p.nacks, slot, ns, 0);
        const int64_t src = static_cast<int64_t>(row) * p.w4 + p.val_off;
        for (int j = 0; j < v4; ++j)
          HG_ST(p.nval, dst + j, nv, static_cast<int8_t>(HG_LD(p.bank, src + j, nb)));
      } else {
        HG_ST(p.nact, slot, ns, HG_LD(p.active, slot, ns));
        HG_ST(p.nkey, slot, ns, HG_LD(p.key, slot, ns));
        HG_ST(p.npts, slot, ns, HG_LD(p.pts, slot, ns));
        HG_ST(p.nacks, slot, ns, HG_LD(p.acks, slot, ns));
        for (int j = 0; j < v4; ++j) HG_ST(p.nval, dst + j, nv, HG_LD(p.val, dst + j, nv));
      }
    }
  } else {
    // candidate i is taken when some unfrozen replica has > i free slots
    int ntake = 0;
    for (int r = 0; r < p.R; ++r) {
      int nfree = 0;
      for (int s0 = 0; s0 < p.RS; s0 += kThreads) {
        const int s = s0 + threadIdx.x;
        nfree += __syncthreads_count(
            s < p.RS && HG_LD(p.active, static_cast<int64_t>(r) * p.RS + s, ns) == 0);
      }
      if (HG_LD(p.frozen, r, p.R) == 0 && nfree > ntake) ntake = nfree;
    }
    if (ntake > ncand) ntake = ncand;
    const uint32_t mark = (static_cast<uint32_t>(HG_LD(p.step, 0, 1)) << p.shift) |
                          static_cast<uint32_t>(p.s_replay);
    for (int i = threadIdx.x; i < ntake; i += kThreads) {
      const int64_t b = static_cast<int64_t>(HG_LD(p.cand, i, p.RS)) * p.w4 + p.sst_off;
      HG_ST(p.bank, b, nb, static_cast<uint8_t>(mark));
      HG_ST(p.bank, b + 1, nb, static_cast<uint8_t>(mark >> 8));
      HG_ST(p.bank, b + 2, nb, static_cast<uint8_t>(mark >> 16));
      HG_ST(p.bank, b + 3, nb, static_cast<uint8_t>(mark >> 24));
    }
  }
}

}  // namespace

extern "C" {

// step: one int32 on the device; frozen (R,) bool; vpts (rows,) int32;
// bank (rows, w4) int8, updated in place; active (R, RS) bool; key, pts,
// acks (R, RS) int32; val (R, RS, w4 - val_off) int8; the n* outputs are
// shaped as their inputs; scratch holds n_scratch int32, at least one per
// kRowsPerBlock rows plus RS.  rows, R, RS, K >= 1.
int hermes_mega_replay(const void* step, const void* frozen, const void* vpts,
                       void* bank, const void* active, const void* key,
                       const void* pts, const void* acks, const void* val,
                       void* nact, void* nkey, void* npts, void* nacks,
                       void* nval, void* scratch, int n_scratch, int rows,
                       int w4, int R, int RS, int K, int replay_age, int shift,
                       int state_mask, int s_invalid, int s_trans,
                       int s_replay, int sst_off, int val_off HG_ENTRY_ARG,
                       void* stream) {
  const int nblk = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (rows < 1 || R < 1 || RS < 1 || K < 1 || val_off < sst_off + 4 ||
      w4 < val_off || n_scratch < nblk + RS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  p.cand = p.counts + nblk;
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
  cudaError_t err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<nblk, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  place_kernel<<<nblk, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_kernel<<<R + 1, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
