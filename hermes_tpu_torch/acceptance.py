"""The five BASELINE acceptance configurations as runnable scenarios: the
port's copy of ``hermes_tpu/acceptance.py``.

BASELINE.json:7-11 names the runs:

  1. 3-replica single-process KVS, YCSB-A (50/50), 1M keys, uniform
  2. 5-replica write-heavy YCSB-F (read-modify-write), uniform
  3. 7-replica Zipfian-0.99 hotspot (contended-key INV conflict + Replay)
  4. 8-replica with an injected replica stall -> Write->Replay recovery
  5. 8-replica membership reconfiguration (leave, then join) mid-workload

``run_config(n, scale=..., device=...)`` runs scenario ``n`` on
``FastRuntime`` with history recording and returns (counters, Verdict).
``scale`` shrinks keys, sessions and ops (1.0 is the full BASELINE shape,
2^20 keys, for the card).  ``group=`` takes the reference's ``mesh=``:
with ``backend="sharded"`` the replicas' table copies move through that
replica group (default a ``LocalGroup`` on ``device``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
from hermes_tpu_torch.membership import MembershipService
from hermes_tpu_torch.runtime import FastRuntime


def _sz(base: int, scale: float, lo: int = 4) -> int:
    return max(lo, int(base * scale))


def _cfg(n, scale: float) -> HermesConfig:
    keys = _sz(1 << 20, scale, lo=64)
    sessions = _sz(1024, scale, lo=8)
    ops = _sz(128, min(1.0, scale * 4), lo=8)
    base = dict(
        n_keys=keys, n_sessions=sessions, replay_slots=max(8, sessions // 16),
        ops_per_session=ops, value_words=8, replay_age=8, replay_scan_every=4,
    )
    if n == 1:
        return HermesConfig(n_replicas=3,
                            workload=WorkloadConfig(read_frac=0.5, seed=1),
                            **base)
    if n in (2, "2r"):
        # "2r": the same scenario with RMW retry in place (rmw_retries):
        # nacked RMWs re-read and re-issue instead of aborting
        retr = dict(rmw_retries=16) if n == "2r" else {}
        return HermesConfig(
            n_replicas=5, **retr,
            workload=WorkloadConfig(read_frac=0.3, rmw_frac=1.0, seed=2),
            **base)
    if n in (3, "3c"):
        # "3c": the same scenario under the sort arbiter with write
        # chaining (the hot-key mitigation); one ts a committed write all
        # the same, the hot key's queue drains in fewer rounds
        arb = dict(arb_mode="sort", chain_writes=64) if n == "3c" else {}
        return HermesConfig(
            n_replicas=7, **arb,
            workload=WorkloadConfig(read_frac=0.5, distribution="zipfian",
                                    zipf_theta=0.99, seed=3), **base)
    if n in (4, 5):
        return HermesConfig(n_replicas=8,
                            workload=WorkloadConfig(read_frac=0.5, seed=n),
                            **base)
    raise ValueError(f"config {n} not in 1..5 / '2r' / '3c'")


def run_config(n, scale: float = 0.01, max_steps: int = 5000,
               backend: str = "batched", group=None, check: bool = True,
               check_keys: Optional[int] = 512, pipeline_depth: int = 1,
               log: Optional[Callable[[str], None]] = None,
               device="cuda") -> Tuple[Dict, object]:
    """Run acceptance scenario ``n``; returns (counters, Verdict|None).
    ``check_keys`` samples the checked keys (None: every touched key).
    ``pipeline_depth >= 2`` runs the scenario through the harvest ring;
    the outcomes and verdicts are unchanged."""
    from hermes_tpu_torch.checker.fast import default_record

    say = log or (lambda s: None)
    cfg = _cfg(n, scale)
    if pipeline_depth != 1:
        cfg = dataclasses.replace(cfg, pipeline_depth=pipeline_depth)
    rt = FastRuntime(cfg, backend=backend, group=group,
                     record=default_record(check), device=device)
    say(f"config {n}: R={cfg.n_replicas} K={cfg.n_keys} S={cfg.n_sessions} "
        f"G={cfg.ops_per_session} wl={cfg.workload}")

    if n == 4:
        # a replica stalls mid-workload; the lease detector removes it
        # (epoch bump), waiting writes re-evaluate their quorum and stuck
        # Invalid keys recover through Replay
        svc = MembershipService(cfg)
        rt.attach_membership(svc)
        rt.run(6)
        rt.freeze(7)
        say("config 4: froze replica 7 (stall injection)")
        drained = rt.drain(max_steps)
        say(f"config 4: membership events: "
            f"{[dataclasses.asdict(e) for e in svc.events]}")
        detected = any(e.kind == "remove" and e.replica == 7
                       for e in svc.events)
    elif n == 5:
        # leave mid-workload, progress without the replica, then join it
        # back by state transfer from a live donor
        rt.run(5)
        rt.remove(6)
        say("config 5: removed replica 6")
        rt.run(10)
        rt.join(6, from_replica=0)
        say("config 5: re-joined replica 6 (state transfer from 0)")
        drained = rt.drain(max_steps)
    else:
        drained = rt.drain(max_steps)

    counters = {k: int(v) for k, v in rt.counters().items()
                if k.startswith("n_")}
    counters["drained"] = bool(drained)
    if n == 4:
        # the lease detector must find the stall by itself
        counters["failure_detected"] = detected
        counters["drained"] = counters["drained"] and detected
    verdict = rt.check(max_keys=check_keys) if check else None
    return counters, verdict


def run_sparse_variant(scale: float = 0.01, ops: Optional[int] = None,
                       max_steps: int = 50_000,
                       check_keys: Optional[int] = None,
                       backend: str = "batched", n_replicas: int = 3,
                       log: Optional[Callable[[str], None]] = None,
                       device="cuda") -> Tuple[Dict, object]:
    """Config-1-shaped YCSB-A through the client KVS in sparse-key mode:
    scale x 2^20 distinct 64-bit client keys bulk-preloaded into the key
    index, then a 50/50 get/put mix over (replica, session) future slots,
    recorded and checked.  Returns (counters, Verdict) like run_config."""
    import time

    import numpy as np

    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.kvs import KVS, drive_mix

    say = log or (lambda s: None)
    keys = _sz(1 << 20, scale, lo=64)
    sessions = _sz(1024, scale, lo=8)
    cfg = HermesConfig(
        n_replicas=n_replicas, n_keys=keys, n_sessions=sessions,
        replay_slots=max(8, min(sessions // 2, 64)), value_words=8,
        workload=WorkloadConfig(read_frac=0.5, seed=1),
    )
    kvs = KVS(cfg, backend=backend, record=default_record(),
              sparse_keys=True, device=device)
    rng = np.random.default_rng(1)
    # an odd-constant multiply mod 2^64 is a bijection: `keys` distinct
    # 64-bit client ids; the all-ones bucket sentinel, should it appear,
    # becomes 0, the image of 0, which {1..keys} never maps to
    universe = (rng.permutation(np.arange(1, keys + 1, dtype=np.uint64))
                * np.uint64(0x9E3779B97F4A7C15))
    universe[universe == np.uint64(0xFFFFFFFFFFFFFFFF)] = np.uint64(0)
    t0 = time.perf_counter()
    kvs.index.get_slots(universe)
    preload_s = time.perf_counter() - t0
    if len(kvs.index) != keys:
        raise RuntimeError(
            f"sparse preload invariant broken: index holds "
            f"{len(kvs.index)} slots for {keys} distinct client keys")
    say(f"sparse variant: preloaded {keys} 64-bit keys in {preload_s:.2f}s")

    n_ops = ops if ops is not None else 4 * cfg.n_replicas * sessions
    is_get = rng.random(n_ops) < 0.5
    op_keys = universe[rng.integers(0, keys, n_ops)]
    bf, drained, enq_s, run_s = drive_mix(
        kvs, op_keys, is_get, lambda i: [i & 0x7FFF], max_steps=max_steps)
    drive_s = enq_s + run_s
    completed = bf.done_count()
    counters = {k: int(v) for k, v in kvs.counters().items()
                if k.startswith("n_")}
    counters.update(
        drained=bool(drained) and completed == n_ops,
        preload_keys=keys, preload_s=round(preload_s, 3),
        client_ops=n_ops, completed=completed,
        client_ops_per_s=round(completed / drive_s, 1),
    )
    verdict = kvs.rt.check(max_keys=check_keys)
    return counters, verdict


def run_all(scale: float = 0.01, log=None, device="cuda"):
    """All five scenarios; returns {n: (counters, verdict)}."""
    return {n: run_config(n, scale=scale, log=log, device=device)
            for n in range(1, 6)}
