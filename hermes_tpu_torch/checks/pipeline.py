"""The pipeline gate, the port's ``scripts/check_pipeline.py``: the
harvest ring must be invisible to what the store computes.

  1. ``check_state_identity`` -- the same stream through FastRuntime at
     ``pipeline_depth`` 1 and 3 gives equal state trees (Meta included)
     on both engines (sharded on a ``LocalGroup``);
     ``check_kvs_pipelined`` -- a KVS at depth 2 resolves its futures and
     passes the linearizability checker;
  2. ``check_in_place_and_analysis`` -- the JAX package's leg 2 checks
     that the donated state is superseded (reading it raises) and that
     the donated program analyzes clean.  The port has no donation to
     check: its round updates the table in place (``cfg.donate_state``
     selects nothing and the CLI refuses ``--no-donate``), so what
     donation protected (no copy of the table a round) is checked
     directly: ``data_ptr()`` of ``fs.table.vpts`` and of the bank are
     unchanged across ``step_once()``.  The analysis half stands as it
     is: ``analysis.analyze_config(HermesConfig(), engines=("batched",),
     variants="as-is")`` gives no gating finding, and
     ``analysis/analysis_baseline.json`` grandfathers nothing;
  3. ``check_ctl_uploads`` -- exactly two ``ctl_upload`` events over 15
     rounds with one freeze: one at the first dispatch, one at the
     freeze (no control upload a round in the steady state).

    python -m hermes_tpu_torch.checks.pipeline [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import sys

from hermes_tpu_torch import checks


def _identity_cfg(depth: int, backend: str):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=8 if backend == "sharded" else 3,
        n_keys=64, n_sessions=4, replay_slots=2, ops_per_session=8,
        pipeline_depth=depth,
        workload=WorkloadConfig(read_frac=0.5, rmw_frac=0.3, seed=37),
    )


def check_state_identity(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.runtime import FastRuntime

    def run(depth, backend):
        rt = FastRuntime(_identity_cfg(depth, backend), backend=backend,
                         device=device)
        assert rt.drain(400), f"{backend} depth={depth} did not drain"
        return rt

    for backend in ("batched", "sharded"):
        a, b = run(1, backend), run(3, backend)
        assert checks.leaves_equal(checks.fast_leaves(a),
                                   checks.fast_leaves(b)), (
            f"{backend}: depth 1 and depth 3 states differ")
        report[f"{backend}_state_identical"] = True


def check_kvs_pipelined(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS

    cfg = HermesConfig(n_replicas=3, n_keys=128, value_words=6, n_sessions=8,
                       replay_slots=2, ops_per_session=1, pipeline_depth=2)
    kvs = KVS(cfg, record=True, device=device)
    futs = [kvs.put(i % 3, (i // 3) % 8, i % 11, [i, i + 1, 3, 4])
            for i in range(24)]
    futs += [kvs.rmw(i % 3, (i + 4) % 8, i % 11, [90 + i, 0, 0, 0])
             for i in range(6)]
    assert kvs.run_until(futs, 300), "pipelined KVS did not resolve"
    v = kvs.rt.check()
    assert v.ok, f"pipelined KVS checker FAIL: {v.failures[:2]}"
    report["kvs_depth2_checked"] = True


def check_in_place_and_analysis(report: dict, device="cuda") -> None:
    from hermes_tpu_torch import analysis as ana
    from hermes_tpu_torch.analysis import gate as ana_gate
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.runtime import FastRuntime

    rt = FastRuntime(HermesConfig(n_replicas=3, n_keys=64, n_sessions=4,
                                  replay_slots=2, ops_per_session=4),
                     device=device)
    before = (rt.fs.table.vpts.data_ptr(), rt.fs.table.bank.data_ptr())
    rt.step_once()
    after = (rt.fs.table.vpts.data_ptr(), rt.fs.table.bank.data_ptr())
    assert before == after, (
        f"the round moved the table (vpts, bank) from {before} to {after}: "
        "it must write the table in place")
    report["table_in_place"] = True

    with open(ana_gate.BASELINE_PATH) as f:
        base = json.load(f)
    grandfathered = base.get("grandfathered", {})
    assert not grandfathered, (
        "analysis/analysis_baseline.json must stay empty; found "
        f"{len(grandfathered)} grandfathered finding(s)")
    gating = []
    for rep in ana.analyze_config(HermesConfig(), engines=("batched",),
                                  variants="as-is", device=device):
        gating += [f for f in rep["findings"] if f.severity in ana.GATING]
    assert not gating, f"analyzer findings on the round: {gating[:3]}"
    report["analysis_clean"] = True


def check_ctl_uploads(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.obs import Observability
    from hermes_tpu_torch.runtime import FastRuntime

    rt = FastRuntime(HermesConfig(n_replicas=3, n_keys=64, n_sessions=4,
                                  replay_slots=2, ops_per_session=16),
                     device=device)
    obs = rt.attach_obs(Observability())
    rt.run(10)
    rt.freeze(1)
    rt.run(5)
    ups = sum(1 for r in obs.records
              if r.get("kind") == "event" and r.get("name") == "ctl_upload")
    assert ups == 2, f"expected 2 ctl uploads (init + freeze), saw {ups}"
    report["ctl_uploads_steady_state_zero"] = True


LEGS = (check_state_identity, check_kvs_pipelined,
        check_in_place_and_analysis, check_ctl_uploads)


def main(argv=None) -> int:
    return checks.run_legs("pipeline", LEGS, argv, "pipeline", __doc__)


if __name__ == "__main__":
    sys.exit(main())
