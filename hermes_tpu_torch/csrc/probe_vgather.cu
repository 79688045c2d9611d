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
// less than the launch itself.  A 40-byte row always spans two 32-byte
// sectors, so the sectors the gather touches come to ~5.3 MB (~1.6 us).
// On the TPU, Mosaic refused to lower the vectorized gather at all.
//
// The design: one warp a tile of 32 messages.
//   * Lane l loads key l of the tile (one coalesced 128-byte load) and
//     forms its row; the next tile's key is loaded before this tile's rows
//     move, so the key -> row chain overlaps the stores.
//   * The warp fetches the tile's 32 rows as 8-byte pieces (int2: W/2 a
//     row, 5 a lane at W = 10), every load issued before the first store;
//     a piece's row number reaches its lane by __shfl_sync.  The index
//     math is 32-bit, and the piece's row within the tile is a multiply-
//     high by a reciprocal the entry computes once (p / d = umulhi(p, m),
//     m = ceil(2^32 / d), exact for p * (m * d - 2^32) < 2^32, which
//     W <= kMaxW ensures): on an H100 a division per piece cost about
//     0.35 us a call.
//   * The pieces pass through a shared-memory stage of kStage words a
//     warp (the whole 32 x W tile up to W = 16, else in passes), and the
//     warp writes its contiguous 128*W-byte output tile with 16-byte
//     stores (int4).  Only the words past the last whole int4 of a ragged
//     last tile are stored one word at a time.
//   * A persistent grid: at most the CTAs that co-reside (the occupancy
//     query, made once per device and kept), no more than the tiles need;
//     warps take tiles by grid stride.  No grid barrier: a plain launch.
// Alignment picks the path from the pointers alone (the wrapper chooses,
// core/probe_kernels.py:vgather_access, and the entry re-checks): 8-byte
// pieces need the table 8-byte aligned and W even, else 4-byte words;
// 16-byte stores need out 16-byte aligned, else words.  Both are exact.
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build); vector
// accesses are guarded in vector units.
//
// C interface (ctypes, hermes_tpu_torch/core/probe_kernels.py): pointers
// and the stream are void*-sized; returns cudaGetLastError() after the
// launch (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // messages a tile, one a lane
constexpr int kStage = 512;  // words a warp stages a pass (2 KB)
constexpr int kPieces = kStage / 64;  // int2 pieces a lane a pass
constexpr int kWords = kStage / 32;   // words a lane a pass
constexpr int kMaxW = 8192;  // keeps the reciprocal division exact
constexpr int kMaxDevices = 64;

int co_resident[kMaxDevices];  // CTAs that co-reside, per device; 0 unknown

__device__ __forceinline__ int row_of(int k, int K) {
  if (k < 0) k += K;  // K >= 1, so this cannot overflow
  return k < 0 ? 0 : (k > K - 1 ? K - 1 : k);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ keys,
              const int32_t* __restrict__ table, int K, int M, int W,
              int tiles, int vec_ld, int vec_st, unsigned recip) {
  __shared__ __align__(16) int32_t stages[kWarps][kStage];
  int32_t* stage = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const unsigned H = static_cast<unsigned>(W) >> 1;  // pieces a row
  // the row of a tile's piece (vec_ld) or word: p / H or p / W
  const unsigned d = vec_ld ? H : static_cast<unsigned>(W);
  const auto row_in_tile = [d, recip](unsigned p) {
    return d == 1 ? p : __umulhi(p, recip);
  };
  const int64_t KW = static_cast<int64_t>(K) * W;
  const int64_t MW = static_cast<int64_t>(M) * W;
  const int2* table2 = reinterpret_cast<const int2*>(table);
  int4* out4 = reinterpret_cast<int4*>(out);
  int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int key = 0;
  if (tile < tiles && static_cast<int64_t>(tile) * kTile + lane < M)
    key = HG_LD(keys, static_cast<int64_t>(tile) * kTile + lane, M);
  for (; tile < tiles; tile += warps) {
    const int row = row_of(key, K);
    const int64_t m0 = static_cast<int64_t>(tile) * kTile;
    const int64_t m1 = m0 + static_cast<int64_t>(warps) * kTile + lane;
    if (tile + warps < tiles && m1 < M)  // the next tile's key, in flight
      key = HG_LD(keys, m1, M);
    const int n = M - m0 < kTile ? static_cast<int>(M - m0) : kTile;
    const int words = n * W;  // the tile's output words
    for (int base = 0; base < words; base += kStage) {
      const int cnt = words - base < kStage ? words - base : kStage;
      if (vec_ld) {  // W even: a row is H pieces of 8 bytes
        int2 v[kPieces];
#pragma unroll
        for (int j = 0; j < kPieces; ++j) {
          const unsigned p = (base >> 1) + lane + 32 * j;  // tile's piece
          const unsigned r = row_in_tile(p);
          const int src = __shfl_sync(0xffffffffu, row, r & 31);
          if (2 * (lane + 32 * j) < cnt)
            v[j] = HG_LD(table2, static_cast<int64_t>(src) * H + (p - r * H), KW >> 1);
        }
#pragma unroll
        for (int j = 0; j < kPieces; ++j)
          if (2 * (lane + 32 * j) < cnt)
            reinterpret_cast<int2*>(stage)[lane + 32 * j] = v[j];
      } else {  // 4-byte words
        int32_t v[kWords];
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const unsigned p = base + lane + 32 * j;  // tile's word
          const unsigned r = row_in_tile(p);
          const int src = __shfl_sync(0xffffffffu, row, r & 31);
          if (lane + 32 * j < cnt)
            v[j] = HG_LD(table, static_cast<int64_t>(src) * W + (p - r * W), KW);
        }
#pragma unroll
        for (int j = 0; j < kWords; ++j)
          if (lane + 32 * j < cnt) stage[lane + 32 * j] = v[j];
      }
      __syncwarp();
      const int64_t o = m0 * W + base;  // a multiple of 4: m0 % 32 == 0
      const int nv = vec_st ? cnt >> 2 : 0;
      for (int i = lane; i < nv; i += 32)
        HG_ST(out4, (o >> 2) + i, MW >> 2, reinterpret_cast<const int4*>(stage)[i]);
      for (int i = 4 * nv + lane; i < cnt; i += 32)
        HG_ST(out, o + i, MW, stage[i]);
      __syncwarp();  // the stage is read before the next pass writes it
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// keys (M,) int32; table (K, W) int32; out (M, W) int32 output.
// K, M >= 1, 1 <= W <= 8192.  vec_ld: 1 moves the rows as 8-byte pieces
// (table 8-byte aligned, W even), 0 as words; vec_st: 1 stores the output
// tiles in 16 bytes (out 16-byte aligned), 0 in words.  A vec_ld or vec_st
// the pointers do not allow is refused (cudaErrorInvalidValue).
int hermes_probe_vgather(const void* keys, const void* table, void* out,
                         int K, int M, int W, int vec_ld,
                         int vec_st HG_ENTRY_ARG, void* stream) {
  if (K < 1 || M < 1 || W < 1 || W > kMaxW) return cudaErrorInvalidValue;
  if ((vec_ld != 0 && vec_ld != 1) || (vec_st != 0 && vec_st != 1) ||
      (vec_ld && !(aligned(table, 8) && W % 2 == 0)) ||
      (vec_st && !aligned(out, 16)))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cap = co_resident[dev];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    cap = per_sm * sms;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = static_cast<int>((static_cast<int64_t>(M) + kTile - 1) / kTile);
  int grid = (tiles + kWarps - 1) / kWarps;
  if (grid > cap) grid = cap;
  const uint64_t d = vec_ld ? W / 2 : W;  // the divisor of row_in_tile
  const unsigned recip =
      d == 1 ? 0u : static_cast<unsigned>(((1ull << 32) + d - 1) / d);
  gather_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(table), K, M, W, tiles, vec_ld, vec_st,
      recip);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
