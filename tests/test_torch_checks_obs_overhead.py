"""The port's obs-overhead gate (hermes_tpu_torch/checks/obs_overhead.py)
against the JAX package's (scripts/check_obs_overhead.py).

The gate runs green on the CPU at its own shape; the Meta columns of both
``phase_metrics`` variants equal the reference's leg for leg (base and
phase columns, the report's commit and INV counts), and the traced burst's
counters equal the reference's.  Timings are never compared.  Red: a
phase column leaking into a base column, and an uninstrumented round
writing a phase column, turn the gate red; so does a ``lock_*`` series
in the traced registry."""

import os

import numpy as np
import pytest
import torch

from hermes_tpu_torch.checks import obs_overhead as gate
from hermes_tpu_torch.core import faststep as fst
from torch_gatepair import run_port_gate, settled_reference  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    prior = os.environ.get("HERMES_LOCKLINT")
    from torch_gatepair import load_script

    mod = load_script("check_obs_overhead")
    if prior is None:
        os.environ.pop("HERMES_LOCKLINT", None)
    else:
        os.environ["HERMES_LOCKLINT"] = prior
    return mod


def test_torch_obs_overhead_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["gate"] == "obs-overhead" and rep["device"] == "cpu"
    assert rep["failures"] == [] and rep["max_overhead"] == 0.25
    assert len(rep["times_instrumented"]) == rep["reps"] == 9
    assert rep["traced"]["trace_sample"] == 64
    assert set(rep["launches"]) >= {"stats_block", "mega_route",
                                    "mega_apply", "mega_replay"}


@pytest.mark.parametrize("phase_metrics", [True, False])
def test_torch_obs_overhead_meta_equals_the_reference(reference,
                                                      phase_metrics):
    import jax

    want, _ = reference.build_runner(phase_metrics, 20, 2)
    got, _ = gate.build_runner(phase_metrics, 20, 2, device="cpu")
    want = jax.device_get(want)
    for col in gate.BASE_COLS + gate.PHASE_COLS:
        np.testing.assert_array_equal(getattr(got, col),
                                      np.asarray(getattr(want, col)),
                                      err_msg=col)
    assert gate.BASE_COLS == reference.BASE_COLS
    assert gate.PHASE_COLS == reference.PHASE_COLS
    if phase_metrics:
        assert int(got.n_inv.sum()) > 0
        assert gate.behaviour_failures(
            got, gate.build_runner(False, 20, 2, device="cpu")[0]) == []


def test_torch_obs_overhead_traced_counts_equal_the_reference(
        reference, settled_reference):
    # the reference's KVS settled each round: at depth 2 a host rewrite of
    # its staged stream can leak into a dispatched round (ROADMAP C3; a
    # loaded test run counted 144 reads and writes against the port's 96)
    for sample in (64, 0):
        _, ref_counts = reference.build_traced_runner(sample, 192)
        _, counts = gate.build_traced_runner(sample, 192, device="cpu")
        assert counts() == ref_counts()


def test_torch_obs_overhead_forces_locklint_off(monkeypatch):
    import importlib

    monkeypatch.setenv("HERMES_LOCKLINT", "1")
    importlib.reload(gate)
    assert os.environ["HERMES_LOCKLINT"] == "0"


def _leaky_scan(leak):
    """build_fast_scan whose chunk runs ``leak(cfg, meta)`` on the Meta."""
    real = fst.build_fast_scan

    def build(cfg, rounds):
        chunk = real(cfg, rounds)

        def run(fs, stream, ctl):
            fs = chunk(fs, stream, ctl)
            return fs._replace(meta=leak(cfg, fs.meta))

        return run

    return build


@pytest.mark.parametrize("leak,why", [
    (lambda cfg, m: m._replace(n_write=m.n_write + m.n_inv)
     if cfg.phase_metrics else m, "base column n_write diverged"),
    (lambda cfg, m: m if cfg.phase_metrics
     else m._replace(n_nack=m.n_nack + 1), "wrote phase column n_nack"),
])
def test_torch_obs_overhead_red_when_metrics_leak(tmp_path, monkeypatch,
                                                  leak, why):
    monkeypatch.setattr(fst, "build_fast_scan", _leaky_scan(leak))
    rc, rep = run_port_gate(gate, tmp_path, "--trace-sample", "0",
                            "--reps", "1")
    assert rc == 1 and not rep["ok"]
    assert any(why in f for f in rep["failures"]), rep["failures"]


def test_torch_obs_overhead_red_on_a_lock_series(monkeypatch):
    from hermes_tpu_torch.obs import metrics

    names = metrics.MetricsRegistry.names
    monkeypatch.setattr(metrics.MetricsRegistry, "names",
                        lambda self: names(self) + ["lock_hold_s"])
    with pytest.raises(AssertionError, match="lock sanitizer series"):
        gate.build_traced_runner(64, 8, device="cpu")


def test_torch_obs_overhead_bench_shape_is_bench_a():
    from hermes_tpu_torch.config import bench_cfg

    for on in (True, False):
        assert gate._cfg(on, "bench") == bench_cfg(
            "a", over=dict(phase_metrics=on))
