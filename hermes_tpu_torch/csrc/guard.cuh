// guard.cuh: the one guard every global-memory access of the port's CUDA
// kernels goes through, and the report it fills in the bound-checked
// build.
//
// Each csrc/*.cu is compiled twice (hermes_tpu_torch/build.py): the
// release build, and a second library with -DHERMES_CHECKED.  A kernel
// never indexes device memory directly; it writes
//   HG_LD(p, i, n)              p[i]                   (a load)
//   HG_LD_CG(p, i, n)           __ldcg(p + i)          (a load through L2
//                                                       only, past L1)
//   HG_ST(p, i, n, v)           p[i] = v               (a store)
//   HG_ATOMIC_MAX(p, i, n, v)   atomicMax(&p[i], v)    (counted as a store)
//   HG_ATOMIC_ADD(p, i, n, v)   atomicAdd(&p[i], v)    (counted as a store)
// with n the extent of p in elements.  A store into a window of shared
// memory whose index the kernel computes from its data (a scatter, local
// or through distributed shared memory) is a guard site too:
//   HG_SMEM_ST(p, i, n, v)      p[i] = v, n the window's extent
// checked and reported like HG_ST.  A store of a whole range in one
// instruction that the hardware addresses (a bulk copy, cp.async.bulk) is
// checked once, as a range, before it issues:
//   if (HG_ST_RANGE(i, count, n)) { the store of [i, i + count) }
// true in the release build; in the checked build false, with the first
// index of the range outside [0, n) recorded as HG_ST records its index,
// when the range leaves the extent.  In the release build these are the
// bare accesses on the right: the guard costs nothing.  In the checked
// build each one first tests 0 <= i < n.  On a violation it adds one to
// the report's count, records the first one (source line, index, extent,
// load or store) with an atomic compare-and-swap, and SKIPS the access: a
// load gives 0, a store does nothing.  It never traps: a device-side
// assert would destroy the CUDA context and every later launch with it.
// The source line is the site id; core/dispatch.py finds the kernel's
// name from the line.
//
// An access no guard can wrap (an asynchronous copy whose addresses the
// hardware forms) is declared on its own line with
//   HG_UNGUARDED("what it is");
// which records its line in the checked build, so the analysis can name
// it: never silent.
//
// The report is kWords int64 words on the device (one row of the tensor
// core/dispatch.py allocates, zeroed before use):
//   [kCount]     violations seen
//   [kLine]      source line of the first one, 0 while there is none
//   [kIndex]     its index        [kExtent]  its extent
//   [kStore]     1 a store, 0 a load
//   [kUnguarded] source line of the first HG_UNGUARDED reached, else 0
// A checked entry point takes the report's pointer as one more argument
// before the stream (HG_ENTRY_ARG) and hands it to the kernels with
// HG_BEGIN(stream) before its first launch.
//
// check() and check_range() also compile for the host (g++,
// native/guard_host.cpp), so the CPU tests hold their arithmetic.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define HG_HD __host__ __device__ __forceinline__
#else
#define HG_HD inline
#endif

namespace hermes_guard {

enum : int {
  kCount = 0,
  kLine = 1,
  kIndex = 2,
  kExtent = 3,
  kStore = 4,
  kUnguarded = 5,
  kWords = 8
};

// Sets *word to value if it is 0; true if this call set it.
HG_HD bool claim(long long* word, long long value) {
#if defined(__CUDA_ARCH__)
  return atomicCAS(reinterpret_cast<unsigned long long*>(word), 0ULL,
                   static_cast<unsigned long long>(value)) == 0ULL;
#else
  if (*word != 0) return false;
  *word = value;
  return true;
#endif
}

// True when index lies in [0, extent).  Otherwise counts the violation,
// records it if it is the first, and returns false: the caller skips the
// access.
HG_HD bool check(long long* rep, long long index, long long extent, int line,
                 int is_store) {
  if (index >= 0 && index < extent) return true;
#if defined(__CUDA_ARCH__)
  atomicAdd(reinterpret_cast<unsigned long long*>(rep + kCount), 1ULL);
#else
  rep[kCount] += 1;
#endif
  if (claim(rep + kLine, line)) {
    rep[kIndex] = index;
    rep[kExtent] = extent;
    rep[kStore] = is_store;
  }
  return false;
}

// True when [start, start + count) lies in [0, extent), count >= 0.
// Otherwise records, as check() does, the range's first index outside the
// extent, and returns false: the caller skips the whole range.
HG_HD bool check_range(long long* rep, long long start, long long count,
                       long long extent, int line, int is_store) {
  if (start >= 0 && start <= extent - count) return true;
  return check(rep, start < 0 || start >= extent ? start : extent, extent,
               line, is_store);
}

}  // namespace hermes_guard

#if defined(__CUDACC__)

#if defined(HERMES_CHECKED)

#include <cuda_runtime.h>

namespace hermes_guard {

// The report of the launches that follow on the stream; one per library
// (each .cu is its own library and includes this header once).
static __device__ long long* report;

template <typename T>
__device__ __forceinline__ T load(const T* p, long long i, long long n,
                                  int line) {
  return check(report, i, n, line, 0) ? p[i] : T{};
}

template <typename T>
__device__ __forceinline__ T load_cg(const T* p, long long i, long long n,
                                     int line) {
  return check(report, i, n, line, 0) ? __ldcg(p + i) : T{};
}

template <typename T, typename V>
__device__ __forceinline__ void store(T* p, long long i, long long n, V v,
                                      int line) {
  if (check(report, i, n, line, 1)) p[i] = static_cast<T>(v);
}

template <typename T>
__device__ __forceinline__ void atomic_max(T* p, long long i, long long n,
                                           T v, int line) {
  if (check(report, i, n, line, 1)) atomicMax(p + i, v);
}

template <typename T>
__device__ __forceinline__ void atomic_add(T* p, long long i, long long n,
                                           T v, int line) {
  if (check(report, i, n, line, 1)) atomicAdd(p + i, v);
}

// Stream-ordered: the kernels launched after it on `st` see `rep`.
inline cudaError_t begin(void* rep, cudaStream_t st) {
  return cudaMemcpyToSymbolAsync(report, &rep, sizeof(rep), 0,
                                 cudaMemcpyHostToDevice, st);
}

}  // namespace hermes_guard

#define HG_LD(p, i, n) hermes_guard::load((p), (i), (n), __LINE__)
#define HG_LD_CG(p, i, n) hermes_guard::load_cg((p), (i), (n), __LINE__)
#define HG_ST(p, i, n, v) hermes_guard::store((p), (i), (n), (v), __LINE__)
#define HG_SMEM_ST(p, i, n, v) \
  hermes_guard::store((p), (i), (n), (v), __LINE__)
#define HG_ST_RANGE(i, count, n)                                       \
  hermes_guard::check_range(hermes_guard::report, (i), (count), (n), \
                            __LINE__, 1)
#define HG_ATOMIC_MAX(p, i, n, v) \
  hermes_guard::atomic_max((p), (i), (n), (v), __LINE__)
#define HG_ATOMIC_ADD(p, i, n, v) \
  hermes_guard::atomic_add((p), (i), (n), (v), __LINE__)
#define HG_UNGUARDED(what)                                                  \
  ((void)hermes_guard::claim(hermes_guard::report + hermes_guard::kUnguarded, \
                             __LINE__))
#define HG_ENTRY_ARG , void* hg_report_arg
#define HG_BEGIN(st) hermes_guard::begin(hg_report_arg, (st))

#else  // release: the bare access

#define HG_LD(p, i, n) ((p)[(i)])
#define HG_LD_CG(p, i, n) __ldcg((p) + (i))
#define HG_ST(p, i, n, v) ((p)[(i)] = (v))
#define HG_SMEM_ST(p, i, n, v) ((p)[(i)] = (v))
#define HG_ST_RANGE(i, count, n) true
#define HG_ATOMIC_MAX(p, i, n, v) atomicMax((p) + (i), (v))
#define HG_ATOMIC_ADD(p, i, n, v) atomicAdd((p) + (i), (v))
#define HG_UNGUARDED(what) ((void)0)
#define HG_ENTRY_ARG
#define HG_BEGIN(st) cudaSuccess

#endif  // HERMES_CHECKED

#endif  // __CUDACC__
