// Native linearizability witness checker (SURVEY.md §2 "Linearizability
// checker" row: C++ core for bench-scale histories).
//
// Port of checker/linearizability.py::_check_witness over packed columns:
// per key, updates ordered by protocol timestamp form a candidate
// linearization (each read placed after the update that wrote its value);
// verifying it is O(n log n).  Keys whose witness fails — or where it does
// not apply — are returned as "suspects" for the exact (Wing&Gong) Python
// search, so the shortcut can never produce a false PASS or a false FAIL.
//
// Keys are independent, so the keys are split over ``threads`` workers by
// key modulo the count; each builds and checks its own keys' groups.  The
// suspect SET does not depend on the split (their order does).
//
// Build: g++ -O2 -shared -fPIC -pthread -o libhermes_checker.so
//        checker_core.cpp
// ABI (ctypes, checker/fast.py):
//   kind: 0=read, 1=write, 2=rmw, 3=maybe_w (incomplete update)
//   inv/resp: doubled step times (read resp=2s, update resp=2s+1),
//             resp=INT64_MAX for incomplete
//   wuid/ruid: (uint32(hi)<<32)|uint32(lo); ruid=INT64_MIN when absent
//   ts: (int64(ver)<<32)|uint32(fc); INT64_MIN when absent

#include <algorithm>
#include <cstdint>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int64_t kNone = INT64_MIN;

struct Group {
  std::vector<int64_t> ops;  // indices into the column arrays
};

// The witness over the keys with ``key mod shards == shard`` (a key's
// ops in index order, as in one pass); appends the suspect keys.
void check_shard(int64_t n, const int32_t* key, const int8_t* kind,
                 const int64_t* inv, const int64_t* resp,
                 const int64_t* wuid, const int64_t* ruid,
                 const int64_t* ts, int64_t shard, int64_t shards,
                 std::vector<int32_t>* suspects) {
  std::unordered_map<int32_t, Group> by_key;
  by_key.reserve(static_cast<size_t>(n / shards) / 4 + 16);
  for (int64_t i = 0; i < n; ++i) {
    int64_t m = key[i] % shards;
    if ((m < 0 ? m + shards : m) == shard) by_key[key[i]].ops.push_back(i);
  }

  for (auto& [k, g] : by_key) {
    bool suspect = false;

    // observed read-values (for admitting maybe_w updates) and reads-by-uid
    std::unordered_set<int64_t> observed;
    std::unordered_map<int64_t, std::vector<int64_t>> reads_by_uid;
    for (int64_t i : g.ops) {
      if (ruid[i] != kNone) observed.insert(ruid[i]);
      if (kind[i] == 0) reads_by_uid[ruid[i]].push_back(i);
    }

    // updates: w/rmw always; maybe_w only if its value was observed
    std::vector<int64_t> updates;
    for (int64_t i : g.ops) {
      if (kind[i] == 1 || kind[i] == 2 ||
          (kind[i] == 3 && observed.count(wuid[i]))) {
        if (ts[i] == kNone) {
          suspect = true;  // witness inapplicable
          break;
        }
        updates.push_back(i);
      }
    }
    if (!suspect) {
      std::sort(updates.begin(), updates.end(),
                [&](int64_t a, int64_t b) { return ts[a] < ts[b]; });
      for (size_t j = 1; j < updates.size(); ++j) {
        if (ts[updates[j]] == ts[updates[j - 1]]) {
          suspect = true;  // duplicate timestamps: protocol bug
          break;
        }
      }
    }

    if (!suspect) {
      for (auto& [uid, rl] : reads_by_uid) {
        std::sort(rl.begin(), rl.end(),
                  [&](int64_t a, int64_t b) { return inv[a] < inv[b]; });
      }
      // candidate order: reads(initial), then per ts-ordered update: the
      // update then reads of its value; greedy real-time feasibility
      const uint64_t hi = static_cast<uint32_t>(-1);
      const int64_t initial =
          static_cast<int64_t>((hi << 32) | static_cast<uint32_t>(k));
      std::unordered_set<int64_t> known{initial};
      int64_t cur = initial;
      int64_t p = INT64_MIN;
      auto feed = [&](int64_t i) {
        p = std::max(p, inv[i]);
        if (p > resp[i]) suspect = true;
      };
      auto feed_reads = [&](int64_t uid) {
        auto it = reads_by_uid.find(uid);
        if (it == reads_by_uid.end()) return;
        for (int64_t i : it->second) {
          feed(i);
          if (suspect) return;
        }
      };
      feed_reads(initial);
      for (int64_t u : updates) {
        if (suspect) break;
        if (kind[u] == 2 && ruid[u] != cur) {
          suspect = true;  // RMW observed a value other than its predecessor
          break;
        }
        feed(u);
        if (suspect) break;
        cur = wuid[u];
        known.insert(cur);
        feed_reads(cur);
      }
      if (!suspect) {
        for (auto& [uid, rl] : reads_by_uid) {
          if (!known.count(uid)) {
            suspect = true;  // read of an unknown value
            break;
          }
        }
      }
    }

    if (suspect) suspects->push_back(k);
  }
}

}  // namespace

extern "C" {

// Returns the number of suspect keys (written to out_keys, up to max_out;
// the count may exceed max_out — callers should size generously).
// ``threads`` workers split the keys (1: one pass in this thread).
// A negative return value signals invalid arguments.
int64_t hc_check_witness(int64_t n, const int32_t* key, const int8_t* kind,
                         const int64_t* inv, const int64_t* resp,
                         const int64_t* wuid, const int64_t* ruid,
                         const int64_t* ts, int32_t* out_keys,
                         int64_t max_out, int64_t threads) {
  if (n < 0 || max_out < 0 || threads < 1) return -1;

  std::vector<std::vector<int32_t>> found(threads);
  if (threads == 1) {
    check_shard(n, key, kind, inv, resp, wuid, ruid, ts, 0, 1, &found[0]);
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < threads; ++t)
      pool.emplace_back(check_shard, n, key, kind, inv, resp, wuid, ruid,
                        ts, t, threads, &found[t]);
    for (auto& th : pool) th.join();
  }

  int64_t total = 0;
  for (const auto& f : found) {
    for (int32_t k : f) {
      if (total < max_out) out_keys[total] = k;
      ++total;
    }
  }
  return total;
}

}  // extern "C"
