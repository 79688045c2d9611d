"""The port's observability (hermes_tpu_torch/obs) against the reference's
(hermes_tpu/obs): the same registry operations, series, histograms and
tracer events give equal snapshots, equal Prometheus text and a
byte-identical unstamped JSONL; the seeded trace sampler draws the same
ids; the report renders the same text as ``scripts/obs_report.py`` on
one run log; and an attached obs context (per-step spans, per-op
tracing) leaves the port's state and completions bit-identical to a run
without one."""

import dataclasses
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hermes_tpu import obs as R
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu_torch import convert
from hermes_tpu_torch import obs as P
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _feed(pkg, fp):
    """One seeded sequence of registry, series and exporter operations."""
    rng = np.random.default_rng(5)
    reg = pkg.MetricsRegistry()
    for i in range(40):
        reg.counter("ops", help="ops done").inc(int(rng.integers(1, 9)))
        reg.gauge("depth").set(int(rng.integers(0, 4)))
        reg.histogram("lat", bins=16, help="rounds").observe(
            int(rng.integers(0, 20)))
        reg.series("q", capacity=8).append(i, int(rng.integers(0, 100)))
    reg.counter("device_total").set_total(12345)
    reg.histogram("dev", bins=8).set_counts(rng.integers(0, 5, 8))
    ex = pkg.JsonlExporter(fp, stamp=False)
    ex.write({"b": 1, "a": [1, 2], "c": "x"})
    ex.write(reg.snapshot(), kind="registry")
    ex.write(reg.series_snapshot(), kind="series")
    s = reg.series("q")
    return reg, dict(window=s.window(3), rate=s.rate(), p=s.percentile(0.9),
                     last=s.last, n=len(s))


def test_torch_obs_registry_exports_equal_reference():
    fa, fb = io.StringIO(), io.StringIO()
    ra, sa = _feed(R, fa)
    rb, sb = _feed(P, fb)
    assert ra.snapshot() == rb.snapshot()
    assert ra.series_snapshot() == rb.series_snapshot()
    assert R.prometheus_text(ra) == P.prometheus_text(rb)
    assert fa.getvalue() == fb.getvalue()  # the unstamped JSONL, byte for byte
    assert sa == sb
    assert ra.names() == rb.names()


def test_torch_obs_registry_type_clash_raises():
    reg = P.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="Counter"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="capacity"):
        P.Series("s", capacity=1)
    s = P.Series("s")
    s.append(3, 1)
    with pytest.raises(ValueError, match="backwards"):
        s.append(2, 1)


@pytest.mark.parametrize("rate,seed", [(1, 0), (4, 7), (64, 3), (1000, 11)])
def test_torch_obs_sampler_equals_reference(rate, seed):
    seqs = np.arange(5000, dtype=np.uint64)
    a = R.TraceSampler(rate, seed=seed)
    b = P.TraceSampler(rate, seed=seed)
    np.testing.assert_array_equal(a.sample_array(seqs), b.sample_array(seqs))
    assert [a.sample(i) for i in range(300)] == [b.sample(i)
                                                  for i in range(300)]


def _run_log(path):
    """A run log of the port's CLI drive: intervals, freeze/thaw events,
    per-step spans, the summary with its histograms and the registry."""
    from hermes_tpu_torch import cli

    argv = ["--replicas", "3", "--keys", "256", "--sessions", "8",
            "--replay-slots", "4", "--ops-per-session", "16",
            "--steps", "24", "--report-every", "6", "--freeze", "1:6:12",
            "--metrics-out", str(path), "--trace-steps", "--device", "cpu"]
    assert cli.main(argv) == 0


def test_torch_obs_report_equals_reference_script(tmp_path):
    log = tmp_path / "run.jsonl"
    _run_log(log)
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["t"] for r in recs] == sorted(r["t"] for r in recs)
    names = {r.get("name") for r in recs if r["kind"] == "event"}
    assert {"freeze", "thaw", "ctl_upload"} <= names
    assert any(r["kind"] == "span_end" and r["name"] == "readback"
               for r in recs)
    ref = subprocess.run([sys.executable, "scripts/obs_report.py", str(log)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    port = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.obs.report",
                           str(log)], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert ref.returncode == 0 and port.returncode == 0, ref.stderr + port.stderr
    assert port.stdout == ref.stdout
    assert "-- membership / fault events (2) --" in port.stdout
    assert "commit latency" in port.stdout


def _cfgs(**over):
    kw = dict(n_replicas=3, n_keys=64, n_sessions=6, replay_slots=4,
              value_words=4, workload=RefWL(seed=7))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _drive(kvs, seed=3):
    rng = np.random.default_rng(seed)
    futs = []
    for i in range(48):
        r, s = int(rng.integers(3)), int(rng.integers(6))
        k = int(rng.integers(10))
        kind = rng.choice(["get", "put", "rmw"], p=[0.4, 0.4, 0.2])
        futs.append(kvs.get(r, s, k) if kind == "get" else
                    getattr(kvs, kind)(r, s, k, [i, -i]))
        if i % 5 == 4:
            kvs.step()
    assert kvs.run_until(futs, 400)
    for _ in range(4):
        kvs.step()
    kvs.rt.counters()
    return [dataclasses.astuple(f.result()) for f in futs]


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_obs_on_off_bit_identical(depth):
    """An attached obs context with per-step spans and per-op tracing
    changes nothing the round computes: the state tree and every
    completion equal an unobserved run's, and the traced port equals the
    traced reference's completions."""
    _, cfg_on = _cfgs(pipeline_depth=depth, trace_sample=2)
    _, cfg_off = _cfgs(pipeline_depth=depth)
    on = KVS(cfg_on, record=True, device="cpu")
    obs = on.rt.attach_obs(P.Observability(trace_steps=True))
    off = KVS(cfg_off, record=True, device="cpu")
    c_on, c_off = _drive(on), _drive(off)
    assert c_on == c_off
    a = convert.fast_state_to_numpy(on.rt.fs)
    b = convert.fast_state_to_numpy(off.rt.fs)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert on.rt.step_idx == off.rt.step_idx
    assert on.rt.check().ok and off.rt.check().ok
    kinds = {r["kind"] for r in obs.records}
    assert {"span_begin", "span_end", "event"} <= kinds
    assert P.canonical_span_bytes(obs.records)


def test_torch_obs_traced_completions_equal_reference():
    rc, cfg = _cfgs(trace_sample=2)
    ref = RefKVS(rc, record=True)
    ref.rt.attach_obs(R.Observability(trace_steps=True))
    port = KVS(cfg, record=True, device="cpu")
    port.rt.attach_obs(P.Observability(trace_steps=True))
    assert _drive(ref) == _drive(port)
