"""The op mix of a client drive: the port's copy of ``MixSpec`` and
``make_mix`` from ``hermes_tpu/workload/openloop.py`` (the arrival
schedules wait for the serving slice, ROADMAP A13).

Every column is seeded: the same seed and spec give byte-identical
columns (``tobytes()`` equality, held against the reference by
``tests/test_torch_workload.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hermes_tpu_torch.workload.ycsb import (latest_ages, scrambled_zipfian,
                                            value_sizes)


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
