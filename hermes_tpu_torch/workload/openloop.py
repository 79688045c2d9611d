"""Client load shapes of the serving front end: the port of
``hermes_tpu/workload/openloop.py``.

Every generator is seeded and replay-deterministic: the same seed and
parameters give a byte-identical arrival schedule and op mix
(``tobytes()`` equality, held against the reference by
``tests/test_torch_workload.py`` and ``tests/test_torch_serving.py``),
so an overload soak replays exactly like a chaos schedule does.

  * ``poisson_arrivals`` — open-loop arrival times: the client sends on
    ITS schedule whatever the server's progress (a closed loop
    self-throttles and can never overrun the server);
  * ``ShapedArrivals`` — the same schedule through a live rate shaper:
    the chaos ``overload x=N`` verb (``ChaosRunner(load=arrivals)``)
    compresses the remaining inter-arrival gaps by N;
  * ``make_mix`` — the op mix beside the arrivals: kinds by read
    fraction, keys uniform / zipfian(theta) / hot-key / latest, tenants
    round-robin, payload words seeded;
  * ``scenario_matrix`` — the serving bench scenarios, seed anchored to
    the CHECKED_ZIPFIAN.json data file when present;
  * ``ClosedLoop`` — the capacity-measurement load.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from hermes_tpu_torch.workload.ycsb import (latest_ages, scrambled_zipfian,
                                            value_sizes)


def poisson_arrivals(rate_per_s: float, n: int, seed: int) -> np.ndarray:
    """``n`` open-loop arrival times (seconds, float64, strictly
    cumulative) of a Poisson process at ``rate_per_s``.  Same seed =>
    byte-identical schedule."""
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be > 0")
    rng = np.random.default_rng(
        (int(seed) * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return np.cumsum(gaps)


class ShapedArrivals:
    """An arrival schedule with a live, deterministic rate shaper.

    Base inter-arrival gaps come from ``poisson_arrivals``; a chaos
    ``overload`` window calls ``set_rate_x(x)`` and every gap consumed
    AFTER that point is divided by ``x`` (x > 1 = burst, x < 1 = lull).
    Because the multiplier applies to the deterministic gap stream at a
    deterministic cursor, the executed schedule replays byte-identically
    given the same seed and the same (seeded) window program."""

    def __init__(self, rate_per_s: float, n: int, seed: int):
        base = poisson_arrivals(rate_per_s, n, seed)
        self._gaps = np.diff(np.concatenate([[0.0], base]))
        self._i = 0
        self._t = 0.0
        self.rate_x = 1.0
        self._next: Optional[float] = None

    def set_rate_x(self, x: float) -> None:
        if x <= 0:
            raise ValueError("rate multiplier must be > 0")
        self.rate_x = float(x)

    def __len__(self) -> int:
        return self._gaps.shape[0]

    def peek(self) -> Optional[float]:
        """Next arrival time, None when exhausted."""
        if self._next is None:
            if self._i >= self._gaps.shape[0]:
                return None
            self._t += self._gaps[self._i] / self.rate_x
            self._next = self._t
            self._i += 1
        return self._next

    def due(self, now: float) -> int:
        """Arrivals due at ``now`` (consumes them); returns the count."""
        k = 0
        while True:
            t = self.peek()
            if t is None or t > now:
                return k
            self._next = None
            k += 1


@dataclasses.dataclass(frozen=True)
class MixSpec:
    """One serving scenario: arrival mix shape (keys/kinds/tenants)."""

    name: str = "uniform"
    read_frac: float = 0.5
    rmw_frac: float = 0.0            # of the update half
    # uniform | zipfian | hotkey | latest (YCSB-D: reads skew to the most
    # recently WRITTEN keys of this same mix — ycsb.latest_ages)
    distribution: str = "uniform"
    zipf_theta: float = 0.99
    hot_frac: float = 0.8            # hotkey mode: share of ops on hot set
    hot_keys: int = 4                # hotkey mode: size of the hot set
    tenants: int = 4
    # value heap: > 0 adds a seeded memcached-shaped per-op
    # value-size column (``vlen``, ycsb.value_sizes) capped here; the
    # per-op bytes derive from ycsb.value_payload(seed, i, vlen[i])
    value_bytes: int = 0
    size_theta: float = 0.99


def make_mix(spec: MixSpec, n_keys: int, n: int, seed: int,
             value_words: int = 1) -> dict:
    """The op mix beside an arrival schedule: dict of numpy columns
    (kind: 0=get 1=put 2=rmw, key, tenant, value) — same seed =>
    byte-identical columns."""
    rng = np.random.default_rng(
        (int(seed) * 0xC2B2AE3D27D4EB4F + 2) & 0xFFFFFFFFFFFFFFFF)
    u = rng.random(n)
    kind = np.where(u < spec.read_frac, 0, 1).astype(np.int8)
    if spec.rmw_frac > 0:
        rmw = (kind == 1) & (rng.random(n) < spec.rmw_frac)
        kind[rmw] = 2
    if spec.distribution == "uniform":
        key = rng.integers(0, n_keys, size=n, dtype=np.int64)
    elif spec.distribution == "zipfian":
        key = scrambled_zipfian(rng, n_keys, spec.zipf_theta, seed,
                                n).astype(np.int64)
    elif spec.distribution == "hotkey":
        hot = rng.random(n) < spec.hot_frac
        key = rng.integers(0, n_keys, size=n, dtype=np.int64)
        key[hot] = rng.integers(0, max(1, spec.hot_keys),
                                size=int(hot.sum()), dtype=np.int64)
    elif spec.distribution == "latest":
        # YCSB-D: reads target the most recently written keys of THIS
        # mix — a Zipfian(theta)-over-age draw against the running write
        # log (ycsb.LATEST_WINDOW horizon), clamped to the writes that
        # exist yet; reads before the first write fall back to uniform.
        # Pure cursor arithmetic over seeded draws => byte-identical
        # replays like every other distribution here.
        key = rng.integers(0, n_keys, size=n, dtype=np.int64)
        ages = latest_ages(rng, n, spec.zipf_theta)
        written: list = []
        for i in range(n):
            if kind[i] == 0:
                if written:
                    key[i] = written[-1 - min(int(ages[i]),
                                              len(written) - 1)]
            else:
                written.append(int(key[i]))
    else:
        raise ValueError(f"unknown distribution {spec.distribution!r}")
    tenant = (np.arange(n, dtype=np.int64) % spec.tenants).astype(np.int32)
    value = rng.integers(1, 1 << 20, size=(n, value_words),
                         dtype=np.int64).astype(np.int32)
    mix = dict(kind=kind, key=key, tenant=tenant, value=value)
    if spec.value_bytes > 0:
        # heap mode: per-op byte LENGTHS ride the mix
        # (memcached-shaped, seeded — ycsb.value_sizes); the bytes
        # themselves derive from ycsb.value_payload so a soak never
        # materializes n * max_value_bytes of payload up front
        mix["vlen"] = value_sizes(
            dict(n=n, max_bytes=spec.value_bytes, theta=spec.size_theta),
            seed)
    return mix


def hot_set(spec: MixSpec) -> tuple:
    """The keys the shed ladder's rung 2 keeps serving for this mix."""
    if spec.distribution == "hotkey":
        return tuple(range(spec.hot_keys))
    return ()


_ANCHOR = "CHECKED_ZIPFIAN.json"


def scenario_seed(repo_root: Optional[str] = None) -> int:
    """Scenario-matrix seed, anchored to the committed CHECKED_ZIPFIAN
    data file at the repo root (read as data): the matrix is pinned to a
    recorded run, not to an arbitrary constant.  Falls back to a fixed
    seed when the file is absent."""
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, _ANCHOR)
    try:
        with open(path) as f:
            art = json.load(f)
        return int(art.get("writes_committed", 0)) % (1 << 31) or 14
    except (OSError, ValueError):
        return 14


def scenario_matrix(tenants: int = 4, value_bytes: int = 0) -> List[MixSpec]:
    """The serving bench scenarios: uniform, zipfian hot-rank and
    explicit hot-key mixes (the anchored seed picks the draws; the
    SHAPES are fixed), plus the read-heavy YCSB B/C/D cells
    (ycsb.READ_MIXES — B = 95/5 zipfian, C = read-only zipfian, D = 95/5
    latest-distribution reads).  ``value_bytes > 0`` (heap-mode stores)
    appends the memcached-shaped variable-size value scenario."""
    from hermes_tpu_torch.workload.ycsb import READ_MIXES

    out = [
        MixSpec(name="uniform", distribution="uniform", tenants=tenants),
        MixSpec(name="zipfian", distribution="zipfian", zipf_theta=0.99,
                tenants=tenants),
        MixSpec(name="hotkey", distribution="hotkey", hot_frac=0.8,
                hot_keys=4, tenants=tenants),
    ]
    for name, kw in READ_MIXES.items():
        out.append(MixSpec(name=f"ycsb_{name}", tenants=tenants, **kw))
    if value_bytes > 0:
        out.append(MixSpec(name="values", distribution="zipfian",
                           zipf_theta=0.99, tenants=tenants,
                           value_bytes=value_bytes))
    return out


class ClosedLoop:
    """Closed-loop load: the next op is drawn (deterministically) when
    the previous resolves or the door refuses — ops offered as fast as
    the server's admission refills, so throughput is service-bound,
    never arrival-bound (``serving.soak.measure_capacity`` drives it)."""

    def __init__(self, spec: MixSpec, n_keys: int, n: int, seed: int,
                 value_words: int = 1):
        self.mix = make_mix(spec, n_keys, n, seed, value_words)
        self.n = n
        self.cursor = 0
        self._seed = int(seed)

    def next_op(self) -> Optional[dict]:
        if self.cursor >= self.n:
            return None
        i = self.cursor
        self.cursor += 1
        m = self.mix
        op = dict(kind=("get", "put", "rmw")[int(m["kind"][i])],
                  key=int(m["key"][i]), tenant=int(m["tenant"][i]),
                  value=m["value"][i].tolist())
        if "vlen" in m:
            # heap mode: the op's byte payload, derived not stored
            from hermes_tpu_torch.workload.ycsb import value_payload

            op["data"] = value_payload(self._seed, i, int(m["vlen"][i]))
        return op
