"""The port's netchaos gate (hermes_tpu_torch/checks/netchaos.py) against
the JAX package's (scripts/check_netchaos.py).

The gate runs green on the CPU.  Each leg's report equals the reference
leg's at the same seed (the reference settled at depth 2): the wire
matrix's events, fault counts and membership over both inner transports,
the CRC red test, and the partition leg's ops, kinds, retries, stuck
ops, commits and membership on both fast engines.  The wire run's
executed log and fault log are the reference's byte for byte.  Red: a
corrupted frame applied with the CRC off, and a committed write the
history does not hold, turn the gate red."""

import pytest
import torch

from hermes_tpu_torch.checks import netchaos as gate
from torch_gatepair import (load_script, run_port_gate,
                            settled_reference)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return load_script("check_netchaos")


def test_torch_netchaos_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu" and rep["crc_red_test"]
    assert rep["wire_sim"]["faults"] == rep["wire_lockstep"]["faults"]


def test_torch_netchaos_legs_report_as_the_reference(reference,
                                                     settled_reference):
    want, got = {}, {}
    for name in ("check_wire_matrix", "check_crc_red",
                 "check_partition_fast"):
        getattr(reference, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert got == want
    assert got["partition_batched"]["retried"] > 0


def test_torch_netchaos_wire_logs_equal_the_reference(reference):
    _rt, ref_wire, ref_runner, _res = reference._run_wire("sim")
    _rt, wire, runner, res = gate._run_wire("sim", device="cpu")
    assert runner.log_json() == ref_runner.log_json()
    assert wire.fault_log_json() == ref_wire.fault_log_json()
    assert res["checked_ok"]


def test_torch_netchaos_red_on_a_corrupt_frame_applied(tmp_path,
                                                       monkeypatch):
    from hermes_tpu_torch.chaos import net

    init = net.FaultingTransport.__init__

    def crc_off(self, *args, **kwargs):
        kwargs["crc"] = False
        init(self, *args, **kwargs)

    monkeypatch.setattr(net.FaultingTransport, "__init__", crc_off)
    with pytest.raises(AssertionError, match="corrupt frames not all "
                       "dropped.*wire_corrupt_applied"):
        gate.check_wire_matrix({}, device="cpu")


def test_torch_netchaos_red_on_a_committed_write_lost(monkeypatch):
    """A put a client saw commit whose write the store never holds."""
    import dataclasses

    run = gate._run_partition

    def phantom(backend, device="cuda"):
        kvs, obs, runner, res, futs = run(backend, device)
        f = next(f for f in futs if f.result().kind == "put")
        f._result = dataclasses.replace(f.result(), uid=(10**6, 10**6))
        return kvs, obs, runner, res, futs

    monkeypatch.setattr(gate, "_run_partition", phantom)
    with pytest.raises(AssertionError, match="reported lost/aborted"):
        gate.check_partition_fast({}, device="cpu")
