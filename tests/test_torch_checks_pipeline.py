"""The port's pipeline gate (hermes_tpu_torch/checks/pipeline.py) against
the JAX package's (scripts/check_pipeline.py).

The gate runs green on the CPU.  Its legs' reports equal the reference
legs' at the same configs (the reference settled at depth 2), the
drained states of the identity leg equal the reference's on both
engines, the pipelined KVS's completions equal the reference's, and the
control-upload leg's event names equal the reference's.  Red: a control
upload every round, a grandfathered analysis finding, and a round that
moves the table turn the gate red."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.config import WorkloadConfig as RefWL
from hermes_tpu_torch.checks import pipeline as gate
from torch_gatepair import (assert_fast_state_equal, load_script,
                            run_port_gate, settled_reference)  # noqa: F401

torch.set_num_threads(1)


def _ref_cfg(cfg):
    kw = dataclasses.asdict(cfg)
    kw["workload"] = RefWL(**kw["workload"])
    return RefConfig(**kw)


def test_torch_pipeline_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu"
    for k in ("batched_state_identical", "sharded_state_identical",
              "kvs_depth2_checked", "table_in_place", "analysis_clean",
              "ctl_uploads_steady_state_zero"):
        assert rep[k] is True, k


def test_torch_pipeline_legs_report_as_the_reference(settled_reference):
    ref = load_script("check_pipeline")
    want, got = {}, {}
    for name in ("check_state_identity", "check_kvs_pipelined",
                 "check_ctl_uploads"):
        getattr(ref, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert got == want


@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_torch_pipeline_identity_states_equal_the_reference(
        backend, settled_reference):
    from jax.sharding import Mesh

    import jax
    from hermes_tpu.runtime import FastRuntime as RefRuntime
    from hermes_tpu_torch.runtime import FastRuntime

    for depth in (1, 3):
        cfg = gate._identity_cfg(depth, backend)
        mesh = (Mesh(np.array(jax.devices()[:8]), ("replica",))
                if backend == "sharded" else None)
        ref = RefRuntime(_ref_cfg(cfg), backend=backend, mesh=mesh)
        rt = FastRuntime(cfg, backend=backend, device="cpu")
        assert ref.drain(400) and rt.drain(400)
        assert rt.step_idx == ref.step_idx
        assert_fast_state_equal(ref, rt)


def test_torch_pipeline_kvs_completions_equal_the_reference(
        settled_reference):
    from hermes_tpu.kvs import KVS as RefKVS
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS

    cfg = HermesConfig(n_replicas=3, n_keys=128, value_words=6, n_sessions=8,
                       replay_slots=2, ops_per_session=1, pipeline_depth=2)
    out = []
    for store in (RefKVS(_ref_cfg(cfg), record=True),
                  KVS(cfg, record=True, device="cpu")):
        futs = [store.put(i % 3, (i // 3) % 8, i % 11, [i, i + 1, 3, 4])
                for i in range(24)]
        futs += [store.rmw(i % 3, (i + 4) % 8, i % 11, [90 + i, 0, 0, 0])
                 for i in range(6)]
        assert store.run_until(futs, 300) and store.rt.check().ok
        out.append([(f.result().kind, f.result().value, f.result().uid)
                    for f in futs])
    assert out[0] == out[1]


def test_torch_pipeline_ctl_upload_events_equal_the_reference():
    from hermes_tpu.obs import Observability as RefObs
    from hermes_tpu.runtime import FastRuntime as RefRuntime
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.obs import Observability
    from hermes_tpu_torch.runtime import FastRuntime

    cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=4,
                       replay_slots=2, ops_per_session=16)
    names = []
    for rt, obs in ((RefRuntime(_ref_cfg(cfg)), RefObs()),
                    (FastRuntime(cfg, device="cpu"), Observability())):
        rt.attach_obs(obs)
        rt.run(10)
        rt.freeze(1)
        rt.run(5)
        names.append([(r.get("name"), r.get("step")) for r in obs.records
                      if r.get("kind") == "event"])
    assert names[0] == names[1]
    assert [n for n, _ in names[1]].count("ctl_upload") == 2


def test_torch_pipeline_red_on_a_ctl_upload_every_round(tmp_path,
                                                        monkeypatch):
    from hermes_tpu_torch.runtime import FastRuntime

    dispatch = FastRuntime.dispatch_round

    def dirty(self, *args, **kwargs):
        self._ctl_dirty = True  # a control upload every round
        return dispatch(self, *args, **kwargs)

    monkeypatch.setattr(FastRuntime, "dispatch_round", dirty)
    report = {}
    with pytest.raises(AssertionError, match="expected 2 ctl uploads"):
        gate.check_ctl_uploads(report, device="cpu")


def test_torch_pipeline_red_on_a_grandfathered_finding(tmp_path,
                                                       monkeypatch):
    from hermes_tpu_torch.analysis import gate as ana_gate

    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"grandfathered": {
        "scatter:batched:x": {"count": 1, "note": ""}}}))
    monkeypatch.setattr(ana_gate, "BASELINE_PATH", str(base))
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "must stay empty" in rep["error"]
    assert rep["table_in_place"] and "analysis_clean" not in rep


def test_torch_pipeline_red_on_a_round_that_moves_the_table(monkeypatch):
    from hermes_tpu_torch.core import faststep as fst

    real = fst.fast_round_batched

    def moving(cfg, ctl, fs, stream):
        fs = fs._replace(table=fs.table._replace(
            vpts=fs.table.vpts.clone()))
        return real(cfg, ctl, fs, stream)

    monkeypatch.setattr(fst, "fast_round_batched", moving)
    with pytest.raises(AssertionError, match="must write the table in place"):
        gate.check_in_place_and_analysis({}, device="cpu")
