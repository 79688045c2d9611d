"""The port's fleet gate (hermes_tpu_torch/checks/fleet.py) against the
JAX package's (scripts/check_fleet.py).

The gate runs green on the CPU through its ``main``; its timed bar
(``scaleout_x`` >= 3) is the gate run's, not this file's: here it is set
to 0, since load from other test processes makes the "alone" cells
unsteady.  Each leg's deterministic fields equal the reference leg's at
the same seed (the reference settled at depth 2): the soak's per-group
verdicts and ``verify_fleet`` on both engines, the group-0 drill's
restarts, lost ops and per-window commits of every group, the seeded
chaos replay's executed log and every group's final state, and the
per-group and concurrent commits of ``run_fleet_cells`` at the gate's
shape.  Red: a soak that strands an op turns the gate red; so does a
drill that fences a replica of another group."""

import dataclasses

import numpy as np
import pytest
import torch

from hermes_tpu_torch.checks import fleet as gate
from torch_gatepair import (load_script, run_port_gate,
                            settled_reference)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return load_script("check_fleet")


def test_torch_fleet_gate_green_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(gate, "SCALEOUT_X", 0.0)
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["gate"] == "fleet" and rep["device"] == "cpu"
    assert rep["deterministic_replay"]
    for backend in ("batched", "sharded"):
        assert rep[f"{backend}_soak"]["checked_ok"]
        assert rep[f"{backend}_soak"]["fleet_invariants"]["groups"] == 4
    assert rep["group0_rolling_drill"]["restarts"] == 4
    cells = rep["scaleout"]
    assert cells["groups"] == 4 and cells["platform"] == "cpu"
    assert cells["shape"]["n_sessions"] == 1024
    assert all(c["commits"] > 0 for c in cells["per_group"])
    assert cells["concurrent"]["commits"] > 0


def test_torch_fleet_soak_and_drill_report_as_the_reference(
        reference, settled_reference):
    want, got = {}, {}
    for name in ("check_soak", "check_group_drill"):
        getattr(reference, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key] == want[key], key


def test_torch_fleet_replay_equals_the_reference(reference,
                                                 settled_reference):
    from hermes_tpu import chaos as ref_chaos
    from hermes_tpu.fleet import (Fleet as RefFleet,
                                  FleetChaosRunner as RefRunner,
                                  fleet_schedules as ref_schedules)

    fcfg = reference._fcfg()
    fleet = RefFleet(fcfg, record=True, detect=2)
    fb = fleet.submit_batch(*reference._mix(fcfg, 120,
                                            seed=reference.SEED + 1))
    runner = RefRunner(fleet, ref_schedules(fcfg, seed=reference.SEED,
                                            steps=20),
                       spec=ref_chaos.ChaosSpec(min_healthy=2))
    want = runner.run(20, check=True)
    fleet.run_batch(fb)
    log, states, got = gate._replay_run(device="cpu")
    assert log == runner.log_json()
    assert (got["checked_ok"], got["lost_ops"]) == (want["checked_ok"],
                                                   want["lost_ops"])
    # every group's final state, leaf for leaf
    from hermes_tpu_torch import checks

    for g, grp in enumerate(fleet.groups):
        import jax

        ref_leaves = checks.leaves(jax.device_get(grp.rt.fs))
        assert len(ref_leaves) == len(states[g])
        for a, b in zip(ref_leaves, states[g]):
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg=f"group {g}")


def test_torch_fleet_scaleout_commits_equal_the_reference(reference):
    from hermes_tpu.config import (FleetConfig as RefFleetConfig,
                                   HermesConfig as RefConfig,
                                   WorkloadConfig as RefWL)
    from hermes_tpu.fleet.bench import run_fleet_cells as ref_cells
    from hermes_tpu_torch.fleet import run_fleet_cells

    fcfg = gate.scaleout_cfg()
    base = dataclasses.asdict(fcfg.base)
    base["workload"] = RefWL(**base["workload"])
    want = ref_cells(RefFleetConfig(groups=gate.GROUPS,
                                    base=RefConfig(**base)),
                     rounds=10, chunks=3)
    got = run_fleet_cells(fcfg, rounds=10, chunks=3, device="cpu")
    assert [c["commits"] for c in got["per_group"]] == \
        [c["commits"] for c in want["per_group"]]
    assert got["concurrent"]["commits"] == want["concurrent"]["commits"]
    assert got["shape"] == want["shape"]
    assert got["one_card"] is False


def test_torch_fleet_red_when_the_soak_strands_an_op(tmp_path,
                                                     monkeypatch):
    from hermes_tpu_torch.fleet import Fleet

    real = Fleet.run_batch

    def short(self, fb, max_steps=50_000):
        return real(self, fb, max_steps=2)  # gives up with ops pending

    monkeypatch.setattr(Fleet, "run_batch", short)
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "batched: fleet mix stranded" in rep["error"]


def test_torch_fleet_red_when_the_drill_fences_another_group(monkeypatch):
    from hermes_tpu_torch.fleet import FleetChaosRunner

    real = FleetChaosRunner.run

    def fence_group_1(self, *args, **kwargs):
        self.fleet.groups[1].rt.freeze(2)
        try:
            return real(self, *args, **kwargs)
        finally:
            self.fleet.groups[1].rt.thaw(2)

    monkeypatch.setattr(FleetChaosRunner, "run", fence_group_1)
    with pytest.raises(AssertionError, match="fenced a replica"):
        gate.check_group_drill({}, device="cpu")
