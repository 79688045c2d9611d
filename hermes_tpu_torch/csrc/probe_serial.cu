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
// 48,000 distinct keys) about 4 MB, ~1.2 us at 3.35 TB/s, less than a
// launch.  The Pallas kernel walks the messages in order, one dynamic row
// store per iteration, with the table in VMEM.  Hopper blocks run in no
// order, so the order becomes data: an int32 (K,) winner column `win`.
// The first port cleared it with a memset every call and ran two more
// launches.  This design keeps the column clean instead: the wrapper
// allocates it once, filled with -1, per (device, stream, K), and each
// call is one cooperative launch of a persistent grid (never more CTAs
// than co-reside, queried once per device and kept), a message a group
// of lanes:
//   phase 0: atomicMax(&win[row(k_i)], i) for each message.  Integer
//            maxima commute, so win[k] ends as the last message on k
//            whatever order the CTAs ran in;
//   cg::this_grid().sync();
//   phase 1: a group of kGroup lanes per message: its first lane reads
//            win[row(k_i)] once (through L2, __ldcg: L1 is not coherent
//            across SMs) and hands it to the group; if the message won,
//            the group stores its W-word row (lane l the units l, l + 4,
//            ...; 8-byte units where W is even and the pointers allow,
//            else 4-byte words; neighbouring groups on neighbouring
//            messages, so the rows are read coalesced) and the first
//            lane then resets win[row(k_i)] = -1.
// Why that is exact: each row is written by its winner only, so the table
// is the serial loop's bit for bit; the reset comes only from the winner,
// after its one read, so a loser compares against the winner's index or
// against -1, never against its own; and every entry the call raised is
// reset, so the column is all -1 again when the call ends.  Each group
// keeps its first message's row index, and each lane its first unit of
// that message's row, in registers across the barrier (the loads overlap
// phase 0); messages past one a group read their key and row again.  (One thread a message,
// each storing its 40-byte row in five scattered 8-byte stores, took 8.7
// us at the bench shape on an H100, more than the three launches.)
//
// Every global access goes through guard.cuh's guard (the bare access in
// this build, bound-checked in the -DHERMES_CHECKED build): the column's
// atomics, loads and resets included.
//
// C interface (ctypes, hermes_tpu_torch/core/probe_kernels.py): pointers
// and the stream are void*-sized; returns the first CUDA error of the
// queries and the launch (0 = launched); a refused cooperative launch is
// an error.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // lanes that share a message in phase 1
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int row_of(int k, int K) {
  if (k < 0) k += K;  // K >= 1, so this cannot overflow
  return k < 0 ? 0 : (k > K - 1 ? K - 1 : k);
}

// Message i's row into table row k if i won it, then the column reset;
// every lane of the message's group calls it (gmask: the group's lanes).
// With `held`, the lane's first unit of the row (unit l) is h2 or h1,
// loaded before the barrier.
template <bool held>
__device__ __forceinline__ void store_if_won(int32_t* table,
                                             const int32_t* rows,
                                             int32_t* win, int64_t i, int k,
                                             int K, int M, int W, int vec,
                                             int l, unsigned gmask, int2 h2,
                                             int h1) {
  int w = 0;
  if (l == 0) w = HG_LD_CG(win, k, K);
  if (__shfl_sync(gmask, w, 0, kGroup) != i) return;
  const int64_t d = static_cast<int64_t>(k) * W, s = i * W;
  if (vec) {
    int2* table2 = reinterpret_cast<int2*>(table);
    const int2* rows2 = reinterpret_cast<const int2*>(rows);
    for (int j = l; j < W / 2; j += kGroup)
      HG_ST(table2, d / 2 + j, static_cast<int64_t>(K) * W / 2,
            held && j == l ? h2
                           : HG_LD(rows2, s / 2 + j, static_cast<int64_t>(M) * W / 2));
  } else {
    for (int j = l; j < W; j += kGroup)
      HG_ST(table, d + j, static_cast<int64_t>(K) * W,
            held && j == l ? h1 : HG_LD(rows, s + j, static_cast<int64_t>(M) * W));
  }
  if (l == 0) HG_ST(win, k, K, -1);
}

__global__ void __launch_bounds__(kThreads)
serial_kernel(int32_t* __restrict__ table, const int32_t* __restrict__ keys,
              const int32_t* __restrict__ rows, int32_t* win, int K, int M,
              int W, int vec) {
  const int64_t G = static_cast<int64_t>(gridDim.x) * kGroups;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kGroups +
                    threadIdx.x / kGroup;
  const int l = threadIdx.x % kGroup;
  const unsigned gmask = ((1u << kGroup) - 1u)
                         << ((threadIdx.x & 31) & ~(kGroup - 1));
  // message g's row index and this lane's first unit of its row, kept
  // across the barrier
  int held = 0, h1 = 0;
  int2 h2 = make_int2(0, 0);
  if (g < M) {
    held = row_of(HG_LD(keys, g, M), K);
    if (l == 0) HG_ATOMIC_MAX(win, held, K, static_cast<int32_t>(g));
    if (vec && l < W / 2)
      h2 = HG_LD(reinterpret_cast<const int2*>(rows), g * W / 2 + l,
                 static_cast<int64_t>(M) * W / 2);
    else if (!vec && l < W)
      h1 = HG_LD(rows, g * W + l, static_cast<int64_t>(M) * W);
  }
  for (int64_t i = g + G; i < M; i += G)
    if (l == 0)
      HG_ATOMIC_MAX(win, row_of(HG_LD(keys, i, M), K), K, static_cast<int32_t>(i));

  cg::this_grid().sync();  // every message's maximum landed

  if (g < M)
    store_if_won<true>(table, rows, win, g, held, K, M, W, vec, l, gmask, h2,
                       h1);
  for (int64_t i = g + G; i < M; i += G)
    store_if_won<false>(table, rows, win, i, row_of(HG_LD(keys, i, M), K), K,
                        M, W, vec, l, gmask, h2, h1);
}

// CTAs of serial_kernel that co-reside on `dev`, queried once per device
// and kept; 0 until queried.
int co_resident[kMaxDevices];

}  // namespace

extern "C" {

// table (K, W) int32, updated in place; keys (M,) int32; rows (M, W)
// int32; win (K,) int32, all -1 on entry and again on return.  K, M,
// W >= 1.
int hermes_probe_serial(void* table, const void* keys, const void* rows,
                        void* win, int K, int M, int W HG_ENTRY_ARG,
                        void* stream) {
  if (K < 1 || M < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cap = co_resident[dev];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, serial_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cap = per_sm * sms;
  }
  err = HG_BEGIN(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, int b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  const int vec = W % 2 == 0 && aligned(table, 8) && aligned(rows, 8);
  int64_t grid = (static_cast<int64_t>(M) + kGroups - 1) / kGroups;
  if (grid > cap) grid = cap;
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
  err = cudaLaunchKernelEx(&cfg, serial_kernel, static_cast<int32_t*>(table),
                           static_cast<const int32_t*>(keys),
                           static_cast<const int32_t*>(rows),
                           static_cast<int32_t*>(win), K, M, W, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
