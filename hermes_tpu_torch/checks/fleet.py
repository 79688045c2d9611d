"""The fleet gate, the port's ``scripts/check_fleet.py``: key-sharded
protocol groups hold their contracts.

  1. ``check_soak`` -- a 4-group fleet at pipeline depth 2 serves a
     standing mix spanning every group's range on both engines (batched:
     the groups on ``device``; sharded: 4 groups x 2 replicas, one
     ``LocalGroup`` a fleet group, ``launch.fleet_replica_groups``).
     Every op resolves exactly once, none lost or rejected, the checker
     is green in every group and ``verify_fleet`` holds;
  2. ``check_group_drill`` -- group 0 is rolling-crash-restarted under
     fleet-wide load; groups 1-3 are never fenced and commit in every
     window; each group's dip is recorded;
  3. ``check_replay`` -- the same seed and FleetConfig replay a
     fleet-wide seeded chaos schedule to byte-identical executed logs
     and final states of every group;
  4. ``check_scaleout`` -- ``fleet.run_fleet_cells`` at the script's
     shape: the summed "alone" rate (``aggregate_writes_per_sec``, the
     reference's name; on one card the groups share it, so it is no
     capacity) is at least 3x the single group's; the concurrent cell is
     recorded beside it.

    python -m hermes_tpu_torch.checks.fleet [--device cpu] [--out FILE]
"""

from __future__ import annotations

import sys

from hermes_tpu_torch import checks

SEED = 13
GROUPS = 4
# the scale-out bar: the summed "alone" rate over the single group's
SCALEOUT_X = 3.0


def _fcfg(n_replicas=4, **over):
    from hermes_tpu_torch.config import (FleetConfig, HermesConfig,
                                         WorkloadConfig)

    kw = dict(
        n_replicas=n_replicas, n_keys=64, n_sessions=4, replay_slots=6,
        ops_per_session=96, value_words=6, replay_age=6,
        replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
        pipeline_depth=2,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=SEED),
    )
    kw.update(over)
    return FleetConfig(groups=GROUPS, base=HermesConfig(**kw))


def _mix(fcfg, n, seed=SEED):
    import numpy as np

    from hermes_tpu_torch.fleet import Fleet

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, fcfg.total_keys, size=n).astype(np.int64)
    kinds = np.where(rng.random(n) < 0.4, Fleet.GET, Fleet.PUT).astype(
        np.int32)
    values = rng.integers(0, 1 << 20, size=(
        n, fcfg.base.value_words - 2)).astype(np.int32)
    return kinds, keys, values


def check_soak(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch import launch
    from hermes_tpu_torch.fleet import Fleet, verify_fleet
    from hermes_tpu_torch.kvs import C_LOST, C_REJECTED

    for backend in ("batched", "sharded"):
        if backend == "batched":
            fcfg = _fcfg()
            fleet = Fleet(fcfg, record=True, detect=3, device=device)
        else:
            fcfg = _fcfg(n_replicas=2)
            fleet = Fleet(fcfg, backend="sharded",
                          replica_groups=launch.fleet_replica_groups(
                              GROUPS, device),
                          record=True, detect=3)
        n = 400
        kinds, keys, values = _mix(fcfg, n)
        fb = fleet.submit_batch(kinds, keys, values)
        spanned = sorted({int(g) for g in fb.group if g >= 0})
        assert spanned == list(range(GROUPS)), (
            f"{backend}: mix spanned only groups {spanned}")
        assert fleet.run_batch(fb), (f"{backend}: fleet mix stranded "
                                     f"{n - fb.done_count()} op(s)")
        assert fb.done_count() == n  # totals conservation
        codes = np.asarray(fb.code)
        assert not ((codes == C_LOST) | (codes == C_REJECTED)).any(), (
            f"{backend}: clean soak lost/rejected ops")
        v = fleet.check()
        assert v["ok"], f"{backend}: checker FAIL {v}"
        ev = verify_fleet(fleet)
        report[f"{backend}_soak"] = dict(
            ops=n, groups=GROUPS, checked_ok=True,
            group_verdicts=v["groups"], fleet_invariants=ev)


def check_group_drill(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.fleet import Fleet, FleetChaosRunner

    fcfg = _fcfg()
    fleet = Fleet(fcfg, record=True, detect=3, device=device)
    cfg0 = fcfg.group_cfg(0)
    start, spacing = 4, 10
    sched0 = chaos.Schedule.rolling_restart(cfg0, start=start,
                                            spacing=spacing)
    steps = start + spacing * cfg0.n_replicas + spacing
    n_ops = steps * GROUPS * cfg0.n_replicas * cfg0.n_sessions
    kinds, keys, values = _mix(fcfg, n_ops)
    fb = fleet.submit_batch(kinds, keys, values)
    runner = FleetChaosRunner(
        fleet, [sched0] + [chaos.Schedule([])] * (GROUPS - 1),
        spec=chaos.ChaosSpec(min_healthy=2))
    others_fenced, samples = [], []

    def commits():
        return [int(c["n_write"] + c["n_rmw"])
                for c in fleet.counters()["groups"]]

    def on_step(step):
        others_fenced.append(any(
            fleet.groups[g].rt.frozen.any()
            or int(fleet.groups[g].rt.live[0])
            != fleet.groups[g].cfg.full_mask
            for g in range(1, GROUPS)))
        if (step + 1) % spacing == 0:
            samples.append(commits())

    runner.on_step = on_step
    res = runner.run(steps, heal=True, check=True)
    fleet.run_batch(fb)

    assert not any(others_fenced), (
        "the group-0 drill fenced a replica in another group")
    restarts = sum(1 for e in runner.runners[0].log
                   if e["kind"] == "crash_restart")
    assert restarts == cfg0.n_replicas, (
        f"only {restarts}/{cfg0.n_replicas} group-0 restarts applied")
    assert res["checked_ok"], res.get("group_verdicts")
    deltas = np.diff(np.asarray(samples), axis=0)  # (windows, groups)
    assert (deltas[:, 1:] > 0).all(), (
        "a non-drilled group stopped committing during the drill: "
        f"{deltas.tolist()}")
    per_group_dip = []
    for g in range(GROUPS):
        best = int(deltas[:, g].max())
        worst = int(deltas[:, g].min())
        per_group_dip.append(dict(
            group=g, worst_window_commits=worst, best_window_commits=best,
            dip_pct=round(100.0 * (1 - worst / max(1, best)), 1)))
    report["group0_rolling_drill"] = dict(
        restarts=restarts, steps=steps, checked_ok=True,
        lost_ops=res["lost_ops"], per_group_dip=per_group_dip,
        others_never_fenced=True)


def _replay_run(device="cuda"):
    """One fleet-wide seeded chaos run: (executed log, each group's
    state leaves, the chaos result)."""
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.fleet import (Fleet, FleetChaosRunner,
                                        fleet_schedules)

    fcfg = _fcfg()
    fleet = Fleet(fcfg, record=True, detect=2, device=device)
    kinds, keys, values = _mix(fcfg, 120, seed=SEED + 1)
    fb = fleet.submit_batch(kinds, keys, values)
    runner = FleetChaosRunner(fleet, fleet_schedules(fcfg, seed=SEED,
                                                     steps=20),
                              spec=chaos.ChaosSpec(min_healthy=2))
    res = runner.run(20, check=True)
    fleet.run_batch(fb)
    return (runner.log_json(), [checks.fast_leaves(g.rt)
                                for g in fleet.groups], res)


def check_replay(report: dict, device="cuda") -> None:
    outs = []
    for _ in range(2):
        log, states, res = _replay_run(device)
        assert res["checked_ok"], res
        outs.append((log, states))
    assert outs[0][0] == outs[1][0], "fleet executed logs differ"
    for g, (a, b) in enumerate(zip(outs[0][1], outs[1][1])):
        assert checks.leaves_equal(a, b), f"group {g}'s final states differ"
    report["deterministic_replay"] = True


def scaleout_cfg():
    """The scale-out cells' fleet: the script's 4 groups of 8 replicas,
    2^14 keys and 1,024 sessions a replica, the sort arbiter."""
    from hermes_tpu_torch.config import (FleetConfig, HermesConfig,
                                         WorkloadConfig)

    base = HermesConfig(
        n_replicas=8, n_keys=1 << 14, n_sessions=1024, replay_slots=64,
        ops_per_session=256, value_words=8, wrap_stream=True,
        device_stream=True, arb_mode="sort", chain_writes=128,
        lane_budget_cfg=768, read_unroll=2, rebroadcast_every=4,
        replay_scan_every=32, workload=WorkloadConfig(read_frac=0.5))
    return FleetConfig(groups=GROUPS, base=base)


def check_scaleout(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.fleet import run_fleet_cells

    cells = run_fleet_cells(scaleout_cfg(), rounds=10, chunks=3,
                            device=device)
    assert cells["scaleout_x"] >= SCALEOUT_X, (
        f"4-group aggregate is only {cells['scaleout_x']}x the "
        f"single-group cell "
        f"({cells['aggregate_writes_per_sec']} vs "
        f"{cells['single_group']['writes_per_sec']} writes/s)")
    report["scaleout"] = cells


LEGS = (check_soak, check_group_drill, check_replay, check_scaleout)


def main(argv=None) -> int:
    return checks.run_legs("fleet", LEGS, argv, "fleet", __doc__)


if __name__ == "__main__":
    sys.exit(main())
