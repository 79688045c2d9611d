"""Elastic drills: rolling restarts and rolling resizes, the port of
``hermes_tpu/elastic/drill.py`` (the migration drill is ROADMAP A11b).

Each is a scripted production exercise of the chaos, recovery and resize
machinery under load, the checker gating it and the throughput dip
measured: every drill samples cumulative committed writes at a fixed
round cadence (``RateSampler``) and reports the worst window's rate
against a clean baseline as ``dip_pct``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np


class RateSampler:
    """Cumulative committed-write samples at a fixed round cadence.

    Install as a ``ChaosRunner`` ``on_step`` (or call ``note(step)`` from
    a drive loop); each boundary makes one ``counters()`` poll."""

    def __init__(self, rt, window: int):
        if window < 1:
            raise ValueError("window must be >= 1 round")
        self.rt = rt
        self.window = window
        # (round, wall_s, cumulative committed writes)
        self.samples: List[Tuple[int, float, int]] = []
        self._mark()

    def _mark(self) -> None:
        c = self.rt.counters()
        self.samples.append((self.rt.step_idx, time.perf_counter(),
                             int(c["n_write"] + c["n_rmw"])))

    def note(self, step: int) -> None:
        if (step + 1) % self.window == 0:
            self._mark()

    def finish(self) -> None:
        if self.samples and self.rt.step_idx > self.samples[-1][0]:
            self._mark()

    def windows(self) -> List[dict]:
        out = []
        for (r0, t0, w0), (r1, t1, w1) in zip(self.samples, self.samples[1:]):
            if r1 == r0:
                continue
            out.append(dict(
                rounds=(r0, r1),
                writes=w1 - w0,
                wall_s=round(t1 - t0, 4),
                writes_per_sec=round((w1 - w0) / max(1e-9, t1 - t0), 1),
            ))
        return out

    def report(self, clean_rate: Optional[float] = None) -> dict:
        """The worst window's rate and ``dip_pct`` against ``clean_rate``
        (the drill's own best window when no clean rate is given, which
        the record says)."""
        wins = self.windows()
        if not wins:
            return dict(windows=0, dip_pct=None)
        worst = min(wins, key=lambda w: w["writes_per_sec"])
        baseline = clean_rate
        src = "clean_cell"
        if baseline is None:
            baseline = max(w["writes_per_sec"] for w in wins)
            src = "best_window"
        dip = 100.0 * (1.0 - worst["writes_per_sec"] / max(1e-9, baseline))
        return dict(
            windows=len(wins),
            window_rounds=self.window,
            worst_window=worst,
            clean_rate=round(float(baseline), 1),
            clean_rate_source=src,
            dip_pct=round(max(0.0, dip), 1),
        )


def _rt_of(target):
    return target.rt if (hasattr(target, "rt")
                         and hasattr(target, "index")) else target


def run_rolling_restart(target, start: int = 4, spacing: int = 12,
                        steps: Optional[int] = None,
                        window: Optional[int] = None,
                        check: bool = False, heal: bool = True,
                        clean_rate: Optional[float] = None,
                        min_healthy: int = 2, warmup: int = 2,
                        snapshot_path: Optional[str] = None) -> dict:
    """Crash-restart every replica in sequence under load: replica i at
    round ``start + i * spacing`` through ``chaos.restart_replica`` (lost
    in-flight ops folded as maybe_w, fence + remove, snapshot or peer
    restore, rejoin), while the workload keeps issuing.  Returns the
    ChaosRunner result with ``restarts`` (n_replicas for a whole drill)
    and the measured ``dip`` report."""
    from hermes_tpu_torch import chaos

    rt = _rt_of(target)
    cfg = rt.cfg
    sched = chaos.Schedule.rolling_restart(cfg, start=start, spacing=spacing)
    if steps is None:
        steps = start + spacing * cfg.n_replicas + spacing
    # rounds before the first sampled window: a first call's warm-up
    # (the kernels' build and load) must not read as the drill's dip
    step = target.step if hasattr(target, "step") else rt.step_once
    for _ in range(warmup):
        step()
    sampler = RateSampler(rt, window or spacing)
    runner = chaos.ChaosRunner(
        target, sched, spec=chaos.ChaosSpec(min_healthy=min_healthy),
        snapshot_path=snapshot_path, on_step=sampler.note)
    res = runner.run(steps, heal=heal, check=check)
    sampler.finish()
    res["restarts"] = sum(1 for e in runner.log
                          if e["kind"] == "crash_restart")
    res["dip"] = sampler.report(clean_rate)
    return res


def submit_drill_mix(kvs, n_ops: int, seed: int = 0,
                     read_frac: float = 0.5, lo: int = 0,
                     hi: Optional[int] = None):
    """Enqueue a seeded get/put mix over dense keys ``[lo, hi)`` through
    ``submit_batch``: the standing load every drill runs under (the same
    draws as the JAX package's).  Returns the BatchFutures; the drill
    steps the KVS."""
    from hermes_tpu_torch.kvs import KVS

    cfg = kvs.cfg
    hi = cfg.n_keys if hi is None else hi
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, size=n_ops).astype(np.int64)
    kinds = np.where(rng.random(n_ops) < read_frac,
                     KVS.GET, KVS.PUT).astype(np.int32)
    u = cfg.value_words - 2
    values = rng.integers(0, 1 << 20, size=(n_ops, u)).astype(np.int32)
    return kvs.submit_batch(kinds, keys, values)


def rolling_resize(kvs, hold_steps: int = 8, window: Optional[int] = None,
                   check: bool = False,
                   clean_rate: Optional[float] = None) -> dict:
    """Live resize drill: every replica is shrunk out of the group (retire,
    drain its client ops, remove from quorums) and grown back (value sync
    through the join) in sequence, while the other replicas' sessions
    keep issuing.  Shrink drains to normal completion, so nothing is
    salvaged or lost."""
    from hermes_tpu_torch.kvs import KVS

    if not isinstance(kvs, KVS):
        raise TypeError("rolling_resize drives the client layer (kvs.KVS)")
    rt = kvs.rt
    for _ in range(2):  # warm-up outside the first sampled window
        kvs.step()
    sampler = RateSampler(rt, window or hold_steps)
    cycles = []
    for r in range(rt.cfg.n_replicas):
        t0 = rt.step_idx
        kvs.shrink(r)
        for _ in range(hold_steps):
            kvs.step()
            sampler.note(rt.step_idx - 1)
        kvs.grow(r)
        for _ in range(hold_steps):
            kvs.step()
            sampler.note(rt.step_idx - 1)
        cycles.append(dict(replica=r, rounds=rt.step_idx - t0))
    sampler.finish()
    res: dict = dict(cycles=cycles, resizes=len(cycles),
                     rejected_ops=kvs.rejected_ops,
                     dip=sampler.report(clean_rate))
    if check:
        v = rt.check()
        res["checked_ok"] = bool(v.ok)
        res["check_failures"] = [
            getattr(f, "reason", str(f))[:200]
            for f in (v.failures + v.undecided)[:3]]
    return res
