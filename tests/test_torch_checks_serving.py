"""The port's serving gate (hermes_tpu_torch/checks/serving.py) against
the JAX package's (scripts/check_serving.py).

The gate runs green on the CPU through its ``main``, both floors'
cells measured (no error, the one-store label); the floors' timed bars
(50x the pinned scalar cell, 2x the loopback) are the gate run's, not
this file's: here they are set to 0, since load from other test
processes makes the timed cells unsteady.  Each leg's deterministic
fields equal the reference leg's at the same seed (the reference
settled at depth 2): the capacity probes' ``ops_per_vs``, every soak's
statuses and ``response_log_sha`` (both engines, the fleet facade, the
overload storm with its executed chaos log, the columnar soak and its
deadline sub-leg), the read soak's serving invariants and read
counters, and the shm soak's ``worker_log_sha`` and IPC counters.  Red:
a response log that differs across replays, a floor cell carrying
``error`` and a one-store cell without its ``one-store`` label each turn
the gate red."""

import json

import pytest
import torch

from hermes_tpu_torch.checks import serving as gate
from torch_gatepair import (drop, load_script, run_port_gate,
                            settled_reference)  # noqa: F401

torch.set_num_threads(1)

#: summary fields that follow a clock (none of a virtual-clock soak's)
TIMED = ("wall_s", "seconds")


@pytest.fixture(scope="module")
def reference():
    return load_script("check_serving")


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    """The gate through its ``main`` on the CPU, the timed bars at 0."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gate, "COLUMNAR_FLOOR_X", 0.0)
        mp.setattr(gate, "ONE_STORE_FLOOR_X", 0.0)
        return run_port_gate(gate, tmp_path_factory.mktemp("serving"))


def test_torch_serving_gate_green_on_cpu(port_report):
    rc, rep = port_report
    assert rc == 0 and rep["ok"], rep
    assert rep["gate"] == "serving" and rep["device"] == "cpu"
    for key in ("batched_replay_identical", "sharded_replay_identical",
                "overload_storm_replay_identical",
                "columnar_replay_identical", "shm_replay_identical"):
        assert rep[key] is True, key
    fl = rep["columnar_floor"]
    assert fl["scalar_baseline_ops_per_sec"] == 351.8
    assert fl["required_ops_per_sec"] == 0.0  # the bar is the gate run's
    assert fl["ops_per_sec"] > 0 and fl["current_scalar_ops_per_sec"] > 0
    assert fl["scalar_cell"]["answered"] == fl["scalar_cell"]["ops"]
    cells = rep["one_store_cells"]
    assert cells["one_store_workers_2"]["error"] is None
    assert cells["one_store_workers_2"]["topology"] == "one-store"
    assert rep["one_store_floor"]["topology"] == "one-store"
    topo = rep["one_store_topology"]
    assert topo["kill_survived"] >= 1
    assert topo["kill_survived"] + topo["kill_eof"] == 4
    assert topo["requests"] == topo["responses"]


def _soak_fields(rep: dict) -> dict:
    """A soak's summary without its clock-following fields."""
    return drop(rep, *TIMED)


def test_torch_serving_soak_legs_report_as_the_reference(
        reference, port_report, settled_reference):
    """Engines, fleet facade, overload storm and read soak: the reference
    legs' reports equal the port gate's, key for key."""
    want = {}
    for name in ("check_engines", "check_fleet", "check_overload_storm",
                 "check_read_soak"):
        getattr(reference, name)(want)
    _, got = port_report
    for key, value in want.items():
        assert key in got, key
        if isinstance(value, dict):
            assert _soak_fields(got[key]) == json.loads(json.dumps(
                _soak_fields(value), default=str)), key
        else:
            assert got[key] == value, key


def test_torch_serving_columnar_and_shm_equal_the_reference(
        reference, port_report, settled_reference):
    """The columnar soak, its deadline sub-leg and the shm soak, run as
    the reference's ``check_columnar`` and ``check_shm`` run them (their
    floors read the reference's recorded cells and are not run here)."""
    from hermes_tpu.serving import measure_capacity
    from hermes_tpu.serving.ipc import run_shm_soak
    from hermes_tpu.serving.soak import run_columnar_soak
    from hermes_tpu.workload.openloop import MixSpec

    _, got = port_report
    spec = MixSpec(name="uniform", tenants=4)
    cap = measure_capacity(reference._store("batched", record=False),
                           reference._scfg(), spec, n=240, seed=reference.SEED)
    rate = 2.0 * cap["ops_per_vs"]
    res = run_columnar_soak(reference._store("batched"), reference._scfg(),
                            spec, rate_per_s=rate, n=500,
                            seed=reference.SEED,
                            deadline_us=reference.DEADLINE_US)
    soak = got["columnar_soak"]
    assert soak["capacity_probe"] == cap and soak["rate_per_vs"] == rate
    assert soak["response_log_sha"] == res["response_log_sha"]
    assert soak["statuses"] == res["statuses"]
    res = run_columnar_soak(
        reference._store("batched", record=False),
        reference._scfg(store_inflight_cap=1, tenant_quota=64,
                        queue_cap=256),
        spec, rate_per_s=rate, n=300, seed=reference.SEED,
        deadline_us=reference.DEADLINE_US)
    dl = got["columnar_deadline_soak"]
    assert dl["response_log_sha"] == res["response_log_sha"]
    assert dl["statuses"] == res["statuses"] and dl["deadline"] > 0
    want = run_shm_soak(n_workers=2, ops_per_worker=512, batch=64,
                        nslots=4, seed=reference.SEED)
    shm = got["shm_soak"]
    assert shm["worker_log_sha"] == want["worker_log_sha"]
    assert shm["ipc"] == want["ipc"] and shm["verify"] == want["verify"]


def test_torch_serving_red_when_a_replay_differs(tmp_path, monkeypatch):
    from hermes_tpu_torch import serving

    real, calls = serving.run_open_loop, []

    def second_differs(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            res["response_log_sha"] = "0" * 64
        return res

    monkeypatch.setattr(serving, "run_open_loop", second_differs)
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "DIFFERENT response log" in rep["error"]
    assert "batched_replay_identical" not in rep


@pytest.mark.parametrize("cell,fault,message", [
    ("one_store", dict(ops_per_sec=None, error="answered 0/131072 ops"),
     "error-carrying"),
    ("one_store", dict(topology="private-store-per-worker"),
     "topology label"),
    ("loopback", dict(error="floor failed"), "loopback cell"),
])
def test_torch_serving_red_on_a_faulty_floor_cell(monkeypatch, cell, fault,
                                                   message):
    from hermes_tpu_torch.serving import bench, soak

    monkeypatch.setattr(gate, "ONE_STORE_FLOOR_X", 0.0)
    target, name = ((bench, "run_one_store_cell") if cell == "one_store"
                    else (soak, "measure_columnar_floor"))
    real = getattr(target, name)
    monkeypatch.setattr(target, name,
                        lambda *a, **kw: dict(real(*a, **kw), **fault))
    with pytest.raises(AssertionError, match=message):
        gate.check_shm({}, device="cpu")


def test_torch_serving_red_when_the_columnar_floor_cell_carries_error(
        monkeypatch):
    from hermes_tpu_torch.serving import soak

    monkeypatch.setattr(gate, "COLUMNAR_FLOOR_X", 0.0)
    real = soak.measure_columnar_floor
    monkeypatch.setattr(soak, "measure_columnar_floor", lambda *a, **kw: dict(
        real(*a, **kw), error="store died"))
    with pytest.raises(AssertionError, match="columnar floor cell"):
        gate.check_columnar({}, device="cpu")


def test_torch_serving_floor_probe_splits_the_floor_on_cpu(capsys):
    """``serving.floor_probe`` runs the gate's floor cell again: each run's
    rate, its store rounds, the host ms a round and the dispatch's share
    of them (no trace off the card)."""
    from hermes_tpu_torch.serving import floor_probe

    assert floor_probe.main(["--runs", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and len(out["runs"]) == 2
    assert "traced" not in out
    for run in out["runs"]:
        assert run["ops_per_sec"] > 0 and run["rounds"] > 0
        assert 0 < run["dispatch_s"] < run["call_s"]
    assert all(0 < x < 1 for x in out["dispatch_share"])
