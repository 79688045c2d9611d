// guard_host: a host build of csrc/guard.cuh's check() and check_range(),
// for the CPU tests of the guard's arithmetic (first violation wins; index,
// extent, site and load/store recorded; every violation counted).  Built
// with g++ by hermes_tpu_torch/build.py:load_cxx; the device build of the
// same functions differs only in using atomics.

#include "../csrc/guard.cuh"

extern "C" {

// The report's length in int64 words.
int hermes_guard_words() { return hermes_guard::kWords; }

// One guarded access against the report `rep`; 1 if it may proceed.
int hermes_guard_check(long long* rep, long long index, long long extent,
                       int line, int is_store) {
  return hermes_guard::check(rep, index, extent, line, is_store) ? 1 : 0;
}

// One guarded range [start, start + count) against `rep`; 1 if it may
// proceed.
int hermes_guard_check_range(long long* rep, long long start, long long count,
                             long long extent, int line, int is_store) {
  return hermes_guard::check_range(rep, start, count, extent, line, is_store)
             ? 1
             : 0;
}

}  // extern "C"
