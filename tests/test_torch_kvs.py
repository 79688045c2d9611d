"""The port's KVS client (hermes_tpu_torch/kvs.py) against the reference
KVS (hermes_tpu/kvs.py): one seeded client drive of puts, gets and RMWs
across replicas — per-op futures and a submit_batch mix — must give the
same completion kinds, values, uids, steps and timestamps in both packages
(exact equality), and no committed write may be missing from the port's
recorded history (``committed_write_lost == []``)."""

import dataclasses

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


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_kvs_drive_identical_to_reference(depth):
    rc = RefConfig(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=4,
                   value_words=4, pipeline_depth=depth,
                   workload=RefWL(seed=24))
    cfg = HermesConfig(**dataclasses.asdict(rc))
    ref = RefKVS(rc, record=True)
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


@pytest.mark.parametrize("knob", [dict(max_value_bytes=64),
                                  dict(wal_dir="w"),
                                  dict(op_timeout_rounds=4),
                                  dict(min_healthy_for_writes=2),
                                  dict(trace_sample=2),
                                  dict(sparse_keys=True)])
def test_torch_kvs_refuses_unported_knobs(knob):
    kw = dict(knob)
    sparse = kw.pop("sparse_keys", False)
    cfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=2, replay_slots=2,
                       value_words=4, **kw)
    with pytest.raises(NotImplementedError, match="A5"):
        KVS(cfg, sparse_keys=sparse, device="cpu")
