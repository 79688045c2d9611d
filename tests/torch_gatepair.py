"""Helpers of the gate tests (``tests/test_torch_checks_*.py``), not a
test module: the JAX package's gate scripts loaded from ``scripts/``, the
reference's FastRuntime settled at pipeline depth 2 (ROADMAP C), the
port's gate run through its ``main`` on the CPU, and the reference
artifacts no port gate may write."""

import hashlib
import importlib.util
import json
import pathlib
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the JAX package's gate artifacts at the root of the repo
ARTIFACTS = ("OBS_OVERHEAD.json", "CHAOS_SOAK.json", "ELASTIC_SOAK.json",
             "NETCHAOS_SOAK.json", "HEAP_SOAK.json", "DURABILITY_SOAK.json",
             "GATES_SUMMARY.json", "OP_BUDGET.json", "ANALYSIS_BASELINE.json",
             "FLEET_SOAK.json", "SERVING_SOAK.json", "BENCH_LATENCY.json")


def load_script(name: str):
    """``scripts/<name>.py`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_reference_under_test", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def artifacts() -> dict:
    """name -> sha256 of each reference artifact (None when absent)."""
    out = {}
    for name in ARTIFACTS:
        p = ROOT / name
        out[name] = (hashlib.sha256(p.read_bytes()).hexdigest()
                     if p.exists() else None)
    return out


def run_port_gate(mod, tmp_path, *extra) -> tuple:
    """``mod.main([*extra, "--device", "cpu", "--out", FILE])``: (exit
    code, the report), the reference artifacts held unchanged."""
    before = artifacts()
    out = tmp_path / f"{mod.__name__.rsplit('.', 1)[-1]}_report.json"
    rc = mod.main([*extra, "--device", "cpu", "--out", str(out)])
    assert artifacts() == before, "a port gate wrote a reference artifact"
    return rc, json.loads(out.read_text())


@pytest.fixture
def settled_reference(monkeypatch):
    """Every reference FastRuntime (the KVS's too) settled each round:
    each dispatched round completes before host code goes on (ROADMAP
    C); what it computes is unchanged."""
    from hermes_tpu import runtime as ref_runtime

    dispatch = ref_runtime.FastRuntime.dispatch_round

    def settled(self, *args, **kwargs):
        comp = dispatch(self, *args, **kwargs)
        jax.block_until_ready((comp, self.fs))
        return comp

    monkeypatch.setattr(ref_runtime.FastRuntime, "dispatch_round", settled)


@pytest.fixture
def temp_in_tmp_path(tmp_path, monkeypatch):
    """Temporary directories made in the test's ``tmp_path``: the
    reference's gate legs leave theirs behind (``tempfile.mkdtemp``)."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def assert_fast_state_equal(ref_rt, rt) -> None:
    """Every leaf of the reference FastRuntime's state equal to the
    port's (drop rows cut), part by part and field by field."""
    import numpy as np

    from hermes_tpu_torch import convert

    got = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
    want = jax.device_get(ref_rt.fs)
    for part in ("table", "sess", "replay", "meta"):
        a, b = getattr(want, part), getattr(got, part)
        for f in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{part}.{f}")


def drop(d: dict, *keys) -> dict:
    """``d`` without ``keys`` (wall-clock fields are never compared)."""
    return {k: v for k, v in d.items() if k not in keys}


sys.path.insert(0, str(ROOT))
