"""The chaos gate, the port's ``scripts/check_chaos.py``: fault injection
and recovery hold their contracts.

  1. ``check_soak`` -- a seeded schedule of freeze, thaw, join,
     crash-restart and heartbeat skew (``Schedule.random(...,
     p_crash=0.03)`` over 220 rounds) with the failure detector attached
     (``confirm_steps=3``), FastRuntime at ``pipeline_depth=2`` on both
     engines: the checker green, op totals conserved against the crash
     losses, no ``membership_fetch`` event (the detector reads the
     harvested ages, never the dispatch path), ``suspect``, ``remove``
     and ``crash_restart`` all seen;
  2. ``check_determinism`` -- the same seed and config replay to a
     byte-identical executed log and an equal final state;
  3. ``check_torn_snapshot`` -- a bit flip is refused by the manifest
     checksum, a missing member by the completeness checks, no temp file
     is left, and a clean archive restores the table exactly;
  4. ``check_net_chaos_sim`` -- drop, delay and duplicate windows
     (``NetChaos``) with a freeze on the phases engine over
     ``SimTransport``, checker-gated.

    python -m hermes_tpu_torch.checks.chaos [--device cpu] [--out FILE]
"""

from __future__ import annotations

import os
import sys
import tempfile
import zipfile

from hermes_tpu_torch import checks

SEED = 23
STEPS = 220


def _soak_cfg(pipeline_depth=2):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=5, n_keys=96, n_sessions=6, replay_slots=6,
        ops_per_session=24, replay_age=6, replay_scan_every=4,
        rebroadcast_every=2, lease_steps=6, pipeline_depth=pipeline_depth,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.25, seed=SEED),
    )


def _run_soak(backend, device="cuda"):
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.obs import Observability
    from hermes_tpu_torch.runtime import FastRuntime

    cfg = _soak_cfg()
    rt = FastRuntime(cfg, backend=backend, record=True, device=device)
    obs = rt.attach_obs(Observability())
    rt.attach_membership(MembershipService(cfg, confirm_steps=3))
    sched = chaos.Schedule.random(cfg, seed=SEED, steps=STEPS,
                                  spec=chaos.ChaosSpec(p_crash=0.03))
    runner = chaos.ChaosRunner(rt, sched)
    res = runner.run(STEPS, check=True)
    ev = [r.get("name") for r in obs.records if r.get("kind") == "event"]
    return rt, runner, res, ev


def check_soak(report: dict, device="cuda") -> None:
    for backend in ("batched", "sharded"):
        rt, runner, res, ev = _run_soak(backend, device)
        assert res["drained"], f"{backend}: cluster did not drain"
        assert res["checked_ok"], (
            f"{backend}: checker FAIL {res['check_failures']}")
        assert ev.count("membership_fetch") == 0, (
            f"{backend}: detector issued {ev.count('membership_fetch')} "
            "synchronous last_seen fetch(es) on the dispatch path")
        assert "suspect" in ev and "remove" in ev, (
            f"{backend}: detector never fired under the schedule ({ev})")
        applied = {e["kind"] for e in runner.log}
        assert "crash_restart" in applied, (
            f"{backend}: schedule applied no crash_restart ({applied})")
        c = rt.counters()
        total = c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"]
        expect = rt.cfg.n_replicas * rt.cfg.n_sessions * rt.cfg.ops_per_session
        assert total == expect - res["lost_ops"], (
            f"{backend}: totals {total} != {expect} - lost {res['lost_ops']}")
        report[f"{backend}_soak"] = dict(
            events=len(runner.log), lost_ops=res["lost_ops"],
            suspects=ev.count("suspect"), removes=ev.count("remove"),
            checked_ok=True, membership_fetches=0)


def check_determinism(report: dict, device="cuda") -> None:
    logs, states = [], []
    for _ in range(2):
        rt, runner, res, _ev = _run_soak("batched", device)
        assert res["checked_ok"]
        logs.append(runner.log_json())
        states.append(checks.fast_leaves(rt))
    assert logs[0] == logs[1], "executed-event logs differ across replays"
    assert checks.leaves_equal(*states), "final states differ across replays"
    report["deterministic_replay"] = True


def check_torn_snapshot(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch import convert, snapshot
    from hermes_tpu_torch.runtime import FastRuntime

    cfg = _soak_cfg(pipeline_depth=1)
    rt = FastRuntime(cfg, device=device)
    rt.run(6)
    with tempfile.TemporaryDirectory(prefix="hermes_chaos_gate_") as d:
        p = os.path.join(d, "snap.npz")
        snapshot.save(p, rt)
        assert not [f for f in os.listdir(d) if ".tmp" in f], (
            "temp file left")

        # a flipped payload byte inside a state member: checksum refusal
        def flip(name, data):
            if name.startswith("state.table.bank"):
                data = bytearray(data)
                data[len(data) // 2] ^= 0xFF
            return bytes(data)

        torn = os.path.join(d, "torn.npz")
        checks.rewrite_archive(p, torn, flip)
        try:
            snapshot.load(torn, FastRuntime(cfg, device=device))
            raise AssertionError("torn snapshot must be rejected")
        except ValueError as e:
            assert "checksum" in str(e) or "torn" in str(e), str(e)
        report["torn_snapshot_rejected"] = True

        # a missing member: the targeted incompleteness refusal
        with zipfile.ZipFile(p) as z:
            victim = [n for n in z.namelist() if n.startswith("state.sess")][0]
        trunc = os.path.join(d, "trunc.npz")
        checks.rewrite_archive(
            p, trunc, lambda n, data: None if n == victim else data)
        try:
            snapshot.load(trunc, FastRuntime(cfg, device=device))
            raise AssertionError("truncated snapshot must be rejected")
        except ValueError as e:
            assert "incomplete" in str(e), str(e)
        report["truncated_snapshot_rejected"] = True

        # and the clean archive restores the table exactly (its K rows:
        # the drop row past them is scratch, saved by no archive)
        tgt = FastRuntime(cfg, device=device)
        snapshot.load(p, tgt)
        vpts = [convert.fast_state_to_numpy(x.fs).table.vpts
                for x in (rt, tgt)]
        assert np.array_equal(*vpts), (
            "the restored table differs from the saved one")
        report["snapshot_roundtrip"] = True


def check_net_chaos_sim(report: dict, device="cuda") -> None:
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.runtime import Runtime
    from hermes_tpu_torch.transport.sim import SimTransport

    cfg = HermesConfig(
        n_replicas=4, n_keys=64, n_sessions=4, replay_slots=8,
        ops_per_session=20, replay_age=5, lease_steps=6,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=SEED),
    )
    net = chaos.NetChaos()
    rt = Runtime(cfg, backend="sim", record=True,
                 transport=SimTransport(cfg.n_replicas, net), device=device)
    sched = chaos.Schedule.parse("""
        @5  net_drop 0 dst=2 until=25
        @10 net_delay 1 skew=3 until=40
        @15 net_dup 2 until=35
        @20 freeze 3
        @30 thaw 3
    """)
    runner = chaos.ChaosRunner(rt, sched, net=net)
    res = runner.run(60, check=True)
    assert res["drained"], "sim net-chaos run did not drain"
    assert res["checked_ok"], f"sim net-chaos checker FAIL: {res}"
    applied = {e["kind"] for e in runner.log}
    assert {"net_drop", "net_delay", "net_dup"} <= applied, applied
    report["sim_net_chaos"] = dict(events=len(runner.log), checked_ok=True)


LEGS = (check_soak, check_determinism, check_torn_snapshot,
        check_net_chaos_sim)


def main(argv=None) -> int:
    return checks.run_legs("chaos", LEGS, argv, "chaos", __doc__)


if __name__ == "__main__":
    sys.exit(main())
