"""The port's KVS client (hermes_tpu_torch/kvs.py) against the reference
KVS (hermes_tpu/kvs.py): one seeded client drive of puts, gets and RMWs
across replicas — per-op futures and a submit_batch mix — must give the
same completion kinds, values, uids, steps and timestamps in both packages
(exact equality), and no committed write may be missing from the port's
recorded history (``committed_write_lost == []``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS

torch.set_num_threads(1)


def _drive(kvs, seed):
    """Seeded mix: per-op futures on every replica, then a batch."""
    rng = np.random.default_rng(seed)
    cfg = kvs.cfg
    futs = []
    for i in range(60):
        r = int(rng.integers(cfg.n_replicas))
        s = int(rng.integers(cfg.n_sessions))
        k = int(rng.integers(12))  # a few hot keys: real contention
        kind = rng.choice(["get", "put", "rmw"], p=[0.4, 0.4, 0.2])
        if kind == "get":
            futs.append(kvs.get(r, s, k))
        else:
            v = [int(x) for x in rng.integers(-1000, 1000, 2)]
            futs.append(getattr(kvs, kind)(r, s, k, v))
        if i % 7 == 6:
            kvs.step()
    assert kvs.run_until(futs, 500)
    n = 80
    kinds = rng.choice([KVS.GET, KVS.PUT, KVS.RMW], n, p=[0.5, 0.35, 0.15])
    keys = rng.integers(0, cfg.n_keys, n)
    vals = rng.integers(-(1 << 30), 1 << 30, (n, 2)).astype(np.int32)
    bf = kvs.submit_batch(kinds, keys, vals)
    assert kvs.run_batch(bf, 500)
    kvs.flush()
    return [f.result() for f in futs], bf


def _settle(ref):
    """Make each round the reference KVS dispatches complete before
    ``_step_pipelined`` goes back to host code.  On the CPU backend
    ``jnp.asarray`` does not copy an aligned numpy buffer, so the stream
    that ``_sync_stream`` uploads may alias the staging arrays
    (``_op``, ``_key``, ``_uval``), which the next injection rewrites in
    place while a round dispatched asynchronously may not have read them
    yet (ROADMAP C).  Waiting for the round removes that race; the drive
    and what it computes are unchanged."""
    dispatch = ref.rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, ref.rt.fs))
        return comp

    ref.rt.dispatch_round = settled


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_kvs_drive_identical_to_reference(depth):
    rc = RefConfig(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=4,
                   value_words=4, pipeline_depth=depth,
                   workload=RefWL(seed=24))
    cfg = HermesConfig(**dataclasses.asdict(rc))
    ref = RefKVS(rc, record=True)
    if depth > 1:
        _settle(ref)
    kvs = KVS(cfg, record=True, device="cpu")
    want, wbf = _drive(ref, seed=5)
    got, gbf = _drive(kvs, seed=5)
    for a, b in zip(want, got):
        assert (a.kind, a.key, a.value, a.uid, a.step, a.ts) == \
            (b.kind, b.key, b.value, b.uid, b.step, b.ts)
    for col in ("code", "value", "uid", "step", "tsv", "tsf"):
        np.testing.assert_array_equal(getattr(wbf, col), getattr(gbf, col),
                                      err_msg=col)
    kinds = {c.kind for c in got}
    assert {"get", "put", "rmw"} <= kinds
    committed = [c.uid for c in got if c.kind in ("put", "rmw")]
    committed += [tuple(u) for u, c in zip(gbf.uid.tolist(), gbf.code)
                  if c in (2, 3)]
    ops = kvs.rt.history_ops()
    assert lin.committed_write_lost(committed, ops,
                                    kvs.rt.recorder.aborted_uids) == []
    assert kvs.rt.check().ok


def _staged_stream_not_aliased(device):
    """After ``_sync_stream`` the runtime's stream is a copy: rewriting
    the staging arrays in place leaves it as it was uploaded."""
    cfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=2,
                       value_words=4, pipeline_depth=2)
    kvs = KVS(cfg, device=device)
    kvs.put(1, 2, 7, [11, 22])
    kvs.get(2, 3, 5)
    kvs._inject_ready()
    kvs._sync_stream()
    stream = kvs.rt.stream
    before = [x.cpu().clone() for x in stream]
    assert int(before[0][1, 2, 0]) != 0  # the put is staged
    for a in (kvs._op, kvs._key, kvs._uval):
        a[...] = 0x5A5A
    for x, y in zip(stream, before):
        assert torch.equal(x.cpu(), y)
    assert kvs.rt.stream is stream


def test_torch_kvs_staging_arrays_not_aliased_by_stream():
    _staged_stream_not_aliased("cpu")


@pytest.mark.gpu
def test_torch_kvs_staging_arrays_not_aliased_by_stream_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    _staged_stream_not_aliased("cuda")


def test_torch_kvs_put_get_every_replica():
    cfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=2, replay_slots=2,
                       value_words=4)
    kvs = KVS(cfg, device="cpu")
    p = kvs.put(0, 0, 7, [11, 22])
    assert kvs.run_until([p])
    gets = [kvs.get(r, 1, 7) for r in range(3)]
    assert kvs.run_until(gets)
    assert all(g.result().value == [11, 22] for g in gets)
    m = kvs.rmw(2, 0, 7, [5, 6])
    assert kvs.run_until([m])
    assert m.result().kind == "rmw" and m.result().value == [11, 22]


def test_torch_kvs_refuses_unported_knobs():
    """No client knob is refused any more: the last one, degraded mode
    (``min_healthy_for_writes``), builds a KVS that commits while enough
    replicas are healthy and sheds writes when they are not
    (``tests/test_torch_elastic.py`` holds it against the reference)."""
    cfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=2, replay_slots=2,
                       value_words=4, min_healthy_for_writes=2)
    kvs = KVS(cfg, device="cpu")
    p = kvs.put(0, 0, 7, [11, 22])
    assert kvs.run_until([p]) and p.result().kind == "put"
    kvs.freeze(1)
    kvs.freeze(2)
    assert kvs.put(0, 1, 7, [1, 2]).result().kind == "rejected"
    assert kvs.shed_writes == 1


@pytest.mark.parametrize("knob", ["wal_dir", "op_timeout_rounds",
                                  "trace_sample"])
def test_torch_kvs_ported_knob_builds_and_commits(knob, tmp_path):
    """The knobs the port refused until the durable, observed store
    landed now build a KVS that commits a put."""
    value = {"wal_dir": str(tmp_path / "wal"), "op_timeout_rounds": 4,
             "trace_sample": 2}[knob]
    cfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=2, replay_slots=2,
                       value_words=4, **{knob: value})
    kvs = KVS(cfg, device="cpu")
    p = kvs.put(0, 0, 7, [11, 22])
    assert kvs.run_until([p])
    assert p.result().kind == "put"
    assert (kvs.wal is not None) == (knob == "wal_dir")
    if kvs.wal is not None:
        assert p.result().durability == "commit"
        kvs.wal.close()
