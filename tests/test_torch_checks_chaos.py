"""The port's chaos gate (hermes_tpu_torch/checks/chaos.py) against the JAX
package's (scripts/check_chaos.py).

The gate runs green on the CPU.  Each leg's report equals the reference
leg's at the same seed (the reference settled at depth 2): the soak's
events, lost ops, suspects and removes on both engines, the torn and
truncated snapshot refusals, the sim engine's net-chaos run.  The soak's
executed log is the reference's byte for byte on both engines, with the
same membership events and an equal final state; the sim run's log too.
Red: a detector that reads ``last_seen`` synchronously
(``membership_fetch``) and a schedule that never crash-restarts turn the
gate red."""

import pytest
import torch

from hermes_tpu_torch.checks import chaos as gate
from torch_gatepair import (assert_fast_state_equal, load_script,  # noqa: F401
                            run_port_gate, settled_reference,
                            temp_in_tmp_path)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return load_script("check_chaos")


def test_torch_chaos_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu" and rep["deterministic_replay"]
    assert rep["batched_soak"] == rep["sharded_soak"]


def test_torch_chaos_legs_report_as_the_reference(reference,
                                                  settled_reference,
                                                  temp_in_tmp_path):
    want, got = {}, {}
    for name in ("check_soak", "check_torn_snapshot",
                 "check_net_chaos_sim"):
        getattr(reference, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert got == want
    assert got["batched_soak"]["removes"] > 0


@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_torch_chaos_soak_log_and_state_equal_the_reference(
        reference, backend, settled_reference):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    mesh = (Mesh(np.array(jax.devices()[:5]), ("replica",))
            if backend == "sharded" else None)
    ref_rt, ref_runner, ref_res, ref_ev = reference._run_soak(backend, mesh)
    rt, runner, res, ev = gate._run_soak(backend, device="cpu")
    assert runner.log_json() == ref_runner.log_json()
    assert ev == ref_ev
    assert ([(e.step, e.kind, e.replica) for e in rt.membership.events]
            == [(e.step, e.kind, e.replica)
                for e in ref_rt.membership.events])
    assert (res["lost_ops"], res["drained"], res["checked_ok"]) == (
        ref_res["lost_ops"], ref_res["drained"], ref_res["checked_ok"])
    got, want = rt.counters(), ref_rt.counters()
    for k in ("n_read", "n_write", "n_rmw", "n_abort"):
        assert int(got[k]) == int(want[k]), k
    assert_fast_state_equal(ref_rt, rt)


def test_torch_chaos_net_chaos_log_equals_the_reference():
    """The sim engine's run through the reference's schedule text: the
    same executed log (the runner of ``check_net_chaos_sim``)."""
    from hermes_tpu import chaos as ref_chaos
    from hermes_tpu.config import HermesConfig as RefConfig
    from hermes_tpu.config import WorkloadConfig as RefWL
    from hermes_tpu.runtime import Runtime as RefRuntime
    from hermes_tpu.transport.sim import SimTransport as RefSim
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.runtime import Runtime
    from hermes_tpu_torch.transport.sim import SimTransport

    text = ("@5 net_drop 0 dst=2 until=25\n@10 net_delay 1 skew=3 until=40\n"
            "@15 net_dup 2 until=35\n@20 freeze 3\n@30 thaw 3\n")
    kw = dict(n_replicas=4, n_keys=64, n_sessions=4, replay_slots=8,
              ops_per_session=20, replay_age=5, lease_steps=6)
    logs = []
    for pkg, cfg, rt_cls, sim, extra in (
            (ref_chaos, RefConfig(**kw, workload=RefWL(
                read_frac=0.4, rmw_frac=0.2, seed=gate.SEED)),
             RefRuntime, RefSim, {}),
            (chaos, HermesConfig(**kw, workload=WorkloadConfig(
                read_frac=0.4, rmw_frac=0.2, seed=gate.SEED)),
             Runtime, SimTransport, {"device": "cpu"})):
        net = pkg.NetChaos()
        rt = rt_cls(cfg, backend="sim", record=True,
                    transport=sim(cfg.n_replicas, net), **extra)
        runner = pkg.ChaosRunner(rt, pkg.Schedule.parse(text), net=net)
        res = runner.run(60, check=True)
        assert res["drained"] and res["checked_ok"]
        logs.append(runner.log_json())
    assert logs[0] == logs[1]


def test_torch_chaos_red_on_a_synchronous_membership_fetch(tmp_path,
                                                          monkeypatch):
    from hermes_tpu_torch.membership import MembershipService

    ages = MembershipService._ages

    def stale(self, rt):
        rt.harvested_ages = None  # the detector reads last_seen itself
        return ages(self, rt)

    monkeypatch.setattr(MembershipService, "_ages", stale)
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "synchronous last_seen fetch" in rep["error"]
    assert "batched_soak" not in rep


def test_torch_chaos_red_when_no_crash_restart_applies(monkeypatch):
    from hermes_tpu_torch.chaos import schedule

    random = schedule.Schedule.random.__func__

    def no_crash(cls, cfg, seed, steps, spec=None):
        spec = schedule.ChaosSpec(p_crash=0.0)
        return random(cls, cfg, seed, steps, spec)

    monkeypatch.setattr(schedule.Schedule, "random", classmethod(no_crash))
    with pytest.raises(AssertionError, match="applied no crash_restart"):
        gate.check_soak({}, device="cpu")
