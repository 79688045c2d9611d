"""The port's elastic gate (hermes_tpu_torch/checks/elastic.py) against the
JAX package's (scripts/check_elastic.py).

The gate runs green on the CPU.  Each leg's report equals the reference
leg's at the same seed (the reference settled at depth 2) but for the
wall-clock dip fields: restarts and lost ops of the rolling drill on both
engines, resizes and rejected ops of the resize drill, the migration's
rows, rejected, salvaged and drained ops on both engines, the sparse
move's rows.  The rolling program's executed log is the reference's byte
for byte, with an equal final state; the sparse move's destination reads
the reference's values.  Red: a rolling program that skips a replica and
a shrink that leaves a replica serving turn the gate red."""

import pytest
import torch

from hermes_tpu_torch.checks import elastic as gate
from torch_gatepair import (assert_fast_state_equal, drop, load_script,
                            run_port_gate, settled_reference)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return load_script("check_elastic")


def test_torch_elastic_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu" and rep["deterministic_replay"]
    for backend in ("batched", "sharded"):
        assert rep[f"{backend}_rolling"]["restarts"] == 8
        assert rep[f"{backend}_resize"]["resizes"] == 8


def test_torch_elastic_legs_report_as_the_reference(reference,
                                                    settled_reference):
    want, got = {}, {}
    for name in ("check_rolling", "check_resize", "check_migration"):
        getattr(reference, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert drop(got[key], "dip_pct", "worst_window") == drop(
            want[key], "dip_pct", "worst_window"), key


def test_torch_elastic_rolling_program_equals_the_reference(
        reference, settled_reference):
    from hermes_tpu import chaos as ref_chaos
    from hermes_tpu.runtime import FastRuntime as RefRuntime

    cfg = reference._drill_cfg()
    ref = RefRuntime(cfg, record=True)
    runner = ref_chaos.ChaosRunner(
        ref, ref_chaos.Schedule.rolling_restart(
            cfg, start=reference.ROLL_START, spacing=reference.ROLL_SPACING),
        spec=ref_chaos.ChaosSpec(min_healthy=2))
    want = runner.run(reference.ROLL_START
                      + reference.ROLL_SPACING * (cfg.n_replicas + 1),
                      check=True)
    rt, got_runner, got = gate._rolling_program(device="cpu")
    assert got_runner.log_json() == runner.log_json()
    assert (got["lost_ops"], got["checked_ok"]) == (want["lost_ops"],
                                                    want["checked_ok"])
    assert_fast_state_equal(ref, rt)


def test_torch_elastic_sparse_move_reads_the_references_values():
    from hermes_tpu import elastic as ref_elastic
    from hermes_tpu.config import WorkloadConfig as RefWL
    from hermes_tpu.kvs import KVS as RefKVS

    ref = load_script("check_elastic")
    cfg = ref._drill_cfg(n_keys=64, n_replicas=4,
                         workload=RefWL(seed=ref.SEED))
    src, dst = (RefKVS(cfg, record=True, sparse_keys=True) for _ in "ab")
    keys = [(i + 1) * 10**12 for i in range(12)]
    assert src.run_until([src.put(i % 4, i % 4, k, [i])
                          for i, k in enumerate(keys)])
    res = ref_elastic.migrate_range(src, dst, 4, 10)
    want = []
    for i in range(4, 10):
        g = dst.get(0, 0, keys[i])
        assert dst.run_until([g])
        want.append(g.result().value)
    _src, _dst, got, values = gate._sparse_move(device="cpu")
    assert values == want and got["rows"] == res["rows"] == 6


def test_torch_elastic_red_when_the_drill_skips_a_replica(tmp_path,
                                                          monkeypatch):
    from hermes_tpu_torch.chaos import schedule

    real = schedule.Schedule.rolling_restart.__func__

    def skip_last(cls, cfg, *args, **kwargs):
        sched = real(cls, cfg, *args, **kwargs)
        last = max(e.replica for e in sched.events
                   if e.kind == "crash_restart")
        return schedule.Schedule([e for e in sched.events
                                  if e.replica != last])

    monkeypatch.setattr(schedule.Schedule, "rolling_restart",
                        classmethod(skip_last))
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "7/8 replicas restarted" in rep["error"]


def test_torch_elastic_red_when_a_retired_replica_serves(monkeypatch):
    from hermes_tpu_torch.kvs import KVS

    real = KVS.shrink
    calls = []

    def shrink(self, replica, *args, **kwargs):
        calls.append(replica)
        if len(calls) > 8:  # the drill's eight, then the gate's own probe
            return None  # the replica stays in service
        return real(self, replica, *args, **kwargs)

    monkeypatch.setattr(KVS, "shrink", shrink)
    with pytest.raises(AssertionError):
        gate.check_resize({}, device="cpu")
    assert len(calls) == 9
