"""Elastic drills: rolling restarts, rolling resizes and the migration
drill, the port of ``hermes_tpu/elastic/drill.py``.

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


def migration_drill(cfg, backend: str = "batched", record=True,
                    lo: Optional[int] = None, hi: Optional[int] = None,
                    load_ops: int = 256, seed: int = 0,
                    drain_steps: int = 2000, check: bool = True,
                    device="cuda", src=None, dst=None,
                    live_ops: Optional[int] = None) -> dict:
    """The live-migration drill (``cli --drill migrate``): two KVS groups
    and a RangeRouter, a seed load then a standing mix on the source, the
    middle range migrated under that load, then verified — post-flip
    reads on the destination answer, mid-drain ops landed as rejected
    (counted, never dropped), routing is exact at ``lo``/``hi-1``, and
    BOTH groups' histories pass the checker.  ``load_ops`` sizes the seed
    load and the standing mix (``live_ops``, when given, the mix alone).
    ``src``/``dst``: KVSs to use instead of building two from ``cfg`` (the
    caller's own instrumentation).  Returns the migration summary with the
    drill's counts and ``dst_read_values`` (the payloads the destination
    read at ``lo``, the midpoint and ``hi-1``)."""
    from hermes_tpu_torch import kvs as kvs_lib
    from hermes_tpu_torch.elastic.migrate import migrate_range
    from hermes_tpu_torch.keyindex import RangeRouter

    if lo is None:
        lo = cfg.n_keys // 3
    if hi is None:
        hi = 2 * cfg.n_keys // 3
    if src is None:
        src = kvs_lib.KVS(cfg, backend=backend, record=record, device=device)
    if dst is None:
        dst = kvs_lib.KVS(cfg, backend=backend, record=record, device=device)
    router = RangeRouter(cfg.n_keys, default_group=0)

    # seed the range with known values, then keep a mixed load running
    seed_bf = submit_drill_mix(src, load_ops, seed=seed, read_frac=0.0)
    if not src.run_batch(seed_bf):
        raise RuntimeError("migration drill: seed load did not drain")
    live_bf = submit_drill_mix(src, load_ops if live_ops is None else live_ops,
                               seed=seed + 1)
    for _ in range(4):
        src.step()

    res = migrate_range(src, dst, lo, hi, router=router, dst_group=1,
                        drain_steps=drain_steps)
    # the standing load keeps issuing around the moved range
    src.run_batch(live_bf)
    src.flush()

    codes = np.asarray(live_bf.code)
    res["live_rejected"] = int((codes == kvs_lib.C_REJECTED).sum())
    res["live_lost"] = int((codes == kvs_lib.C_LOST).sum())
    res["live_done"] = int(live_bf.done_count())
    if not live_bf.all_done():
        raise RuntimeError("migration drill: standing load stranded "
                           f"{len(live_bf) - live_bf.done_count()} op(s)")

    # boundary exactness + post-flip service
    if not (int(router.owner(lo)) == 1 and int(router.owner(hi - 1)) == 1):
        raise AssertionError("migration drill: the range did not flip")
    if lo > 0 and int(router.owner(lo - 1)) != 0:
        raise AssertionError("migration drill: slot lo-1 moved")
    if hi < cfg.n_keys and int(router.owner(hi)) != 0:
        raise AssertionError("migration drill: slot hi moved")
    probe = [lo, (lo + hi) // 2, hi - 1]
    futs = [dst.get(0, i % cfg.n_sessions, k) for i, k in enumerate(probe)]
    if not dst.run_until(futs):
        raise RuntimeError("migration drill: destination reads stalled")
    res["dst_reads"] = len(probe)
    res["dst_read_values"] = [f.result().value for f in futs]
    rej = src.get(0, 0, lo)
    if not (rej.done() and rej.result().kind == "rejected"):
        raise AssertionError("migration drill: the source served a "
                             "migrated key")

    if check and record:
        for name, g in (("src", src), ("dst", dst)):
            v = g.rt.check()
            res[f"{name}_checked_ok"] = bool(v.ok)
            if not v.ok:
                res[f"{name}_check_failures"] = [
                    getattr(f, "reason", str(f))[:200]
                    for f in (v.failures + v.undecided)[:3]]
    return res


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
