"""Per-op tracing, the runtime's obs feeds and the flight recorder of the
port against the reference: a traced KVS drive gives canonical span bytes
equal to the reference's (``trace_sample=0`` gives none); the runtime
feeds the same series; flight archives dumped by either package load in
the other's ``flightrec.load`` and tampering is refused; a wedged op
dumps its archive before ``StuckOpError`` raises; a red checker verdict
dumps one."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.obs import Observability as RefObs
from hermes_tpu.obs import canonical_span_bytes as ref_canon
from hermes_tpu.obs import flightrec as ref_flight
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS, StuckOpError
from hermes_tpu_torch.obs import (OP_SPANS, FlightRecorder, Observability,
                                  canonical_span_bytes)
from hermes_tpu_torch.obs import flightrec
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _cfgs(**over):
    kw = dict(n_replicas=3, n_keys=64, n_sessions=8, replay_slots=8,
              ops_per_session=4, value_words=4, trace_sample=4,
              workload=RefWL(seed=7))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _settle(ref):
    """Wait for each reference round before host code rewrites the
    staging arrays its stream may alias (see test_torch_kvs.py)."""
    dispatch = ref.rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, ref.rt.fs))
        return comp

    ref.rt.dispatch_round = settled


def _traced(kv, obs):
    kv.rt.attach_obs(obs)
    futs = [kv.put(i % 3, i % 8, i % 64, value=[i, i + 1])
            for i in range(32)]
    futs += [kv.get((i + 1) % 3, i % 8, i % 64) for i in range(16)]
    assert kv.run_until(futs)
    bf = kv.submit_batch(np.full(24, KVS.PUT, np.int32), np.arange(24),
                         np.ones((24, 2), np.int32))
    assert kv.run_batch(bf)
    return obs.records


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_tracing_spans_equal_reference(depth):
    rc, cfg = _cfgs(pipeline_depth=depth)
    ref = RefKVS(rc)
    if depth > 1:
        _settle(ref)
    want = ref_canon(_traced(ref, RefObs()))
    recs = _traced(KVS(cfg, device="cpu"), Observability())
    got = canonical_span_bytes(recs)
    assert got and got == want
    spans = [r for r in recs if r.get("kind") == "span_end"
             and r.get("name") in OP_SPANS]
    by_trace = {}
    for s in spans:
        assert 1 <= s["trace"] <= 0xFFFF and s["r1"] >= s["r0"] >= 0
        by_trace.setdefault((s["trace"], s["key"]), set()).add(s["name"])
    assert all(v == {"op_queue", "op_rounds"} for v in by_trace.values())
    # a second port run replays byte-identically
    assert canonical_span_bytes(
        _traced(KVS(cfg, device="cpu"), Observability())) == got


def test_torch_tracing_off_means_no_spans():
    _, cfg = _cfgs(trace_sample=0)
    kv = KVS(cfg, device="cpu")
    assert kv._sampler is None
    assert canonical_span_bytes(_traced(kv, Observability())) == b""


def test_torch_tracing_runtime_feeds_series_like_reference():
    rc, cfg = _cfgs(trace_sample=0, n_sessions=16, ops_per_session=32)
    out = []
    for rt, obs in ((RefRuntime(rc), RefObs()),
                    (FastRuntime(cfg, device="cpu"), Observability())):
        rt.attach_obs(obs)
        assert rt.drain(400)
        rt.counters()
        obs.series_snapshot()
        series = [r for r in obs.records if r["kind"] == "series"]
        assert len(series) == 1
        meta = obs.flight.metas[-1]
        out.append(({k: v for k, v in series[0].items() if k != "t"},
                    meta, [(r["kind"], r.get("name"), r.get("step"))
                           for r in obs.records if r["kind"] != "series"]))
    assert out[0] == out[1]
    assert out[1][0]["commits_series"]["v"][-1] > 0


def _archive(fr_cls, cfg, path):
    fr = fr_cls(capacity=4, meta_keep=2)
    for i in range(6):
        fr.record({"t": float(i), "kind": "metrics", "i": i})
    for i in range(3):
        fr.note_meta({"step": i})
    fr.set_config(cfg)
    fr.dump(str(path), "unit", extra=dict(k="v"))
    return fr


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torch_tracing_flight_archives_cross_load(tmp_path, writer):
    rc, cfg = _cfgs()
    path = tmp_path / "dump.json"
    if writer == "port":
        _archive(FlightRecorder, cfg, path)
        payload = ref_flight.load(str(path))
        assert payload == flightrec.load(str(path))
    else:
        _archive(ref_flight.FlightRecorder, rc, path)
        payload = flightrec.load(str(path))
        assert payload == ref_flight.load(str(path))
    assert payload["reason"] == "unit" and payload["extra"] == {"k": "v"}
    assert [e["i"] for e in payload["events"]] == [2, 3, 4, 5]
    assert [m["step"] for m in payload["meta_summaries"]] == [1, 2]
    # the config identity is the same fingerprint in both packages
    from hermes_tpu import snapshot as ref_snap
    assert payload["config_sha256"] == ref_snap.config_fingerprint(rc)
    archive = json.loads(path.read_text())
    archive["payload"]["events"][0]["i"] = 99
    path.write_text(json.dumps(archive))
    for load, err in ((flightrec.load, flightrec.FlightArchiveError),
                      (ref_flight.load, ref_flight.FlightArchiveError)):
        with pytest.raises(err, match="checksum"):
            load(str(path))
    path.write_text(json.dumps({"not": "an archive"}))
    with pytest.raises(flightrec.FlightArchiveError, match="not a flight"):
        flightrec.load(str(path))


def test_torch_tracing_flight_auto_dump_gated_on_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(flightrec.FLIGHT_DIR_ENV, raising=False)
    fr = FlightRecorder()
    fr.record({"t": 0.0, "kind": "event", "name": "x"})
    assert fr.auto_dump("nowhere") is None
    monkeypatch.setenv(flightrec.FLIGHT_DIR_ENV, str(tmp_path / "env"))
    p = fr.auto_dump("enved")
    assert p and flightrec.load(p)["reason"] == "enved"
    obs = Observability()
    obs.tracer.event("freeze", replica=2)
    obs.interval({"commits": 5})
    assert [e["kind"] for e in obs.flight.events] == ["event", "metrics"]


def test_torch_tracing_wedged_op_dumps_before_stuckop_raises(tmp_path):
    _, cfg = _cfgs(value_words=6, op_timeout_rounds=4, trace_sample=0)
    kv = KVS(cfg, strict_timeouts=True, device="cpu")
    obs = kv.rt.attach_obs(Observability(flight_dir=str(tmp_path)))
    kv.freeze(1)
    kv.freeze(2)  # no ack quorum: the put can never commit
    kv.put(0, 0, 3, [1])
    with pytest.raises(StuckOpError, match="stuck past op_timeout_rounds"):
        for _ in range(12):
            kv.step()
    assert obs.flight.dumps, "the watchdog must dump before raising"
    for load in (flightrec.load, ref_flight.load):
        payload = load(obs.flight.dumps[-1])
        assert payload["reason"] == "stuck_op"
        assert payload["extra"]["diags"][0]["key"] == 3
        assert payload["events"]


def test_torch_tracing_checker_red_dumps(tmp_path, monkeypatch):
    from hermes_tpu_torch import runtime as rt_mod

    _, cfg = _cfgs(trace_sample=0, n_sessions=16, ops_per_session=32)
    rt = FastRuntime(cfg, record=True, device="cpu")
    obs = rt.attach_obs(Observability(flight_dir=str(tmp_path)))
    assert rt.drain(400)
    assert rt.check().ok
    assert not obs.flight.dumps  # green never dumps

    class _Red:  # a stubbed red verdict: tests the trigger, not the checker
        ok = False
        keys_checked = 7

    monkeypatch.setattr(rt_mod.lin, "check_history", lambda *a, **k: _Red)
    assert not rt.check().ok
    payload = flightrec.load(obs.flight.dumps[-1])
    assert payload["reason"] == "checker_red"
    assert payload["extra"]["keys_checked"] == 7
    assert any(e.get("name") == "checker_verdict" for e in payload["events"])
