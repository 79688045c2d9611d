"""The elastic gate, the port's ``scripts/check_elastic.py``: live resize,
range migration and the rolling-restart drill hold their contracts.

  1. ``check_rolling`` -- every replica of an 8-replica group
     crash-restarted in sequence under depth-2 load
     (``elastic.run_rolling_restart``) on both engines: 8 restarts, the
     cluster drains, the checker passes, and the worst window's
     throughput dip is recorded (``dip_pct``);
  2. ``check_determinism`` -- the same seed and config replay the rolling
     program to a byte-identical executed log and an equal final state;
  3. ``check_resize`` -- every replica shrunk and grown through the KVS
     under a standing client mix, both engines, checker-gated; an op
     routed at a retired replica lands ``rejected``, and serves again
     after the grow;
  4. ``check_migration`` -- ``elastic.migration_drill`` on both engines
     (boundary routing exact at ``lo`` and ``hi-1``, mid-drain ops
     rejected or salvaged, both groups' checkers green), and a
     sparse-key (``KeyIndex``) move whose keys resolve on the
     destination.

    python -m hermes_tpu_torch.checks.elastic [--device cpu] [--out FILE]
"""

from __future__ import annotations

import sys

from hermes_tpu_torch import checks

SEED = 31
ROLL_START, ROLL_SPACING = 4, 10


def _drill_cfg(**over):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    kw = dict(
        n_replicas=8, n_keys=128, n_sessions=4, replay_slots=6,
        ops_per_session=96, value_words=6, replay_age=6,
        replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
        pipeline_depth=2,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=SEED),
    )
    kw.update(over)
    return HermesConfig(**kw)


def _rolling(backend, device="cuda"):
    from hermes_tpu_torch import elastic
    from hermes_tpu_torch.runtime import FastRuntime

    rt = FastRuntime(_drill_cfg(), backend=backend, record=True,
                     device=device)
    res = elastic.run_rolling_restart(
        rt, start=ROLL_START, spacing=ROLL_SPACING, check=True)
    return rt, res


def check_rolling(report: dict, device="cuda") -> None:
    for backend in ("batched", "sharded"):
        rt, res = _rolling(backend, device)
        assert res["restarts"] == rt.cfg.n_replicas, (
            f"{backend}: only {res['restarts']}/{rt.cfg.n_replicas} "
            "replicas restarted")
        assert res["drained"], f"{backend}: did not drain after the drill"
        assert res["checked_ok"], (
            f"{backend}: checker FAIL {res.get('check_failures')}")
        dip = res["dip"]
        assert dip["dip_pct"] is not None and dip["windows"] > 0, dip
        report[f"{backend}_rolling"] = dict(
            restarts=res["restarts"], lost_ops=res["lost_ops"],
            checked_ok=True, dip_pct=dip["dip_pct"],
            worst_window=dip["worst_window"])


def _rolling_program(device="cuda"):
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.runtime import FastRuntime

    cfg = _drill_cfg()
    rt = FastRuntime(cfg, record=True, device=device)
    sched = chaos.Schedule.rolling_restart(cfg, start=ROLL_START,
                                           spacing=ROLL_SPACING)
    runner = chaos.ChaosRunner(rt, sched, spec=chaos.ChaosSpec(min_healthy=2))
    res = runner.run(ROLL_START + ROLL_SPACING * (cfg.n_replicas + 1),
                     check=True)
    return rt, runner, res


def check_determinism(report: dict, device="cuda") -> None:
    logs, states = [], []
    for _ in range(2):
        rt, runner, res = _rolling_program(device)
        assert res["checked_ok"], res
        logs.append(runner.log_json())
        states.append(checks.fast_leaves(rt))
    assert logs[0] == logs[1], "rolling drill executed logs differ"
    assert checks.leaves_equal(*states), "rolling drill final states differ"
    report["deterministic_replay"] = True


def _resize(backend, device="cuda"):
    from hermes_tpu_torch import elastic
    from hermes_tpu_torch.kvs import KVS

    cfg = _drill_cfg()
    kvs = KVS(cfg, backend=backend, record=True, device=device)
    # a standing load that outlasts the whole drill (~R cycles of
    # 2 * hold_steps rounds and their drains, up to R * S completions a
    # round), so every window measures service under load
    rounds_est = cfg.n_replicas * (2 * 8 + 6) + 24
    bf = elastic.submit_drill_mix(
        kvs, rounds_est * cfg.n_replicas * cfg.n_sessions, seed=SEED)
    res = elastic.rolling_resize(kvs, check=True)
    return kvs, bf, res


def check_resize(report: dict, device="cuda") -> None:
    for backend in ("batched", "sharded"):
        kvs, bf, res = _resize(backend, device)
        assert kvs.run_batch(bf), f"{backend}: standing load stranded"
        assert res["resizes"] == kvs.cfg.n_replicas, res
        assert res["checked_ok"], (
            f"{backend}: resize checker FAIL {res.get('check_failures')}")
        # a retired replica rejects loudly, then serves again after grow
        kvs.shrink(0)
        f = kvs.put(0, 0, 1, [7])
        assert f.done() and f.result().kind == "rejected"
        kvs.grow(0)
        f = kvs.put(0, 0, 1, [7])
        assert kvs.run_until([f]) and f.result().kind == "put"
        report[f"{backend}_resize"] = dict(
            resizes=res["resizes"], rejected_ops=res["rejected_ops"],
            checked_ok=True, dip_pct=res["dip"]["dip_pct"])


def _sparse_move(device="cuda"):
    from hermes_tpu_torch import elastic
    from hermes_tpu_torch.config import WorkloadConfig
    from hermes_tpu_torch.kvs import KVS

    cfg = _drill_cfg(n_keys=64, n_replicas=4,
                     workload=WorkloadConfig(seed=SEED))
    src = KVS(cfg, record=True, sparse_keys=True, device=device)
    dst = KVS(cfg, record=True, sparse_keys=True, device=device)
    keys = [(i + 1) * 10**12 for i in range(12)]
    futs = [src.put(i % 4, i % 4, k, [i]) for i, k in enumerate(keys)]
    assert src.run_until(futs)
    res = elastic.migrate_range(src, dst, 4, 10)
    values = []
    for i in range(4, 10):
        g = dst.get(0, 0, keys[i])
        assert dst.run_until([g]) and g.result().value[:1] == [i], i
        values.append(g.result().value)
    return src, dst, res, values


def check_migration(report: dict, device="cuda") -> None:
    from hermes_tpu_torch import elastic

    for backend in ("batched", "sharded"):
        res = elastic.migration_drill(_drill_cfg(), backend=backend,
                                      record=True, seed=SEED, check=True,
                                      device=device)
        assert res["src_checked_ok"] and res["dst_checked_ok"], res
        report[f"{backend}_migration"] = dict(
            rows=res["rows"], rejected=res["live_rejected"],
            salvaged=res["salvaged"], drained=res["drained"],
            checked_ok=True)

    # the sparse-key cell (batched): client keys keep resolving through
    # the destination's KeyIndex after the flip
    src, dst, res, _values = _sparse_move(device)
    assert src.rt.check().ok and dst.rt.check().ok
    report["sparse_migration"] = dict(rows=res["rows"], checked_ok=True)


LEGS = (check_rolling, check_determinism, check_resize, check_migration)


def main(argv=None) -> int:
    return checks.run_legs("elastic", LEGS, argv, "elastic", __doc__)


if __name__ == "__main__":
    sys.exit(main())
