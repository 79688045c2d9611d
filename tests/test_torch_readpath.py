"""The port's local-read path (hermes_tpu_torch/core/readpath.py and
``KVS.multi_get`` / ``scan`` / ``pin_read_fence`` / ``read_stats``)
against the reference's (hermes_tpu/core/readpath.py, hermes_tpu/kvs.py).

Each drive runs seeded in both packages on the reference test's small
config (3 replicas, 256 keys, ``value_words=6``); every ``MultiGetResult``
column (``code``, ``value``, ``found``, ``local``, ``step``, the echoed
``key``) and ``read_stats()`` must be equal, bit for bit (tolerance 0).
The port's own history must pass the checker with ``stale_read == []``:
the locally served reads are recorded and checked, not assumed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.core import readpath as ref_rp
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import readpath as rp
from hermes_tpu_torch.kvs import KVS

torch.set_num_threads(1)

COLS = ("code", "value", "found", "local", "step", "key")


def _cfgs(**over):
    rc = RefConfig(**dict(dict(n_replicas=3, n_keys=256, value_words=6,
                               n_sessions=8, replay_slots=8,
                               ops_per_session=64,
                               workload=RefWL(read_frac=0.5, seed=3)),
                          **over))
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _settle(ref):
    """Complete every round the reference dispatches before host code
    runs again: on the CPU backend ``jnp.asarray`` may alias the staging
    arrays the next injection rewrites (ROADMAP C).  The drive and what
    it computes are unchanged."""
    dispatch = ref.rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, ref.rt.fs))
        return comp

    ref.rt.dispatch_round = settled


def _pair(record=True, sparse=False, **over):
    rc, cfg = _cfgs(**over)
    ref = RefKVS(rc, record=record, sparse_keys=sparse)
    if rc.pipeline_depth > 1:
        _settle(ref)
    return ref, KVS(cfg, record=record, sparse_keys=sparse, device="cpu")


def _cols(res):
    res._pull()
    return {c: np.asarray(getattr(res, c)).copy() for c in COLS}


def _same(want, got, tag=""):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        if isinstance(a, dict) and set(a) == set(COLS):
            for c in COLS:
                np.testing.assert_array_equal(b[c], a[c],
                                              err_msg=f"{tag} #{i} {c}")
                assert b[c].dtype == a[c].dtype, (tag, i, c)
        else:
            assert a == b, (tag, i, a, b)


def _put_all(kvs, pairs):
    futs = [kvs.put(i % kvs.cfg.n_replicas, i % kvs.cfg.n_sessions, k, v)
            for i, (k, v) in enumerate(pairs)]
    assert kvs.run_until(futs)
    return [(f.result().uid, f.result().ts) for f in futs]


def _clean(kvs):
    ops = kvs.rt.history_ops()
    assert lin.stale_read(ops) == []
    assert kvs.rt.check().ok


# -- the read programs -------------------------------------------------------


def test_torch_batch_bucket_equals_reference():
    for n in (0, 1, 255, 256, 257, 1000, 4096, 70000):
        assert rp.batch_bucket(n) == ref_rp.batch_bucket(n)
    assert rp.MIN_BATCH == ref_rp.MIN_BATCH


def test_torch_multi_get_and_scan_programs_equal_reference_on_hostile_slots():
    """The raw programs on one table state: hostile slots (negative, past
    K) clamp to [0, K) exactly as the reference's, and never reach the
    port's drop row K; scans equal the reference's windows."""
    ref, kvs = _pair(record=False)
    for k in (ref, kvs):
        _put_all(k, [(0, [1, 2]), (255, [3, 4]), (17, [-5, 6])])
    cfg = kvs.cfg
    slots = np.array([0, 255, 17, -1, -(1 << 30), 256, 1 << 30, 3], np.int32)
    want = ref_rp.build_multi_get(ref.cfg, "batched", rp.batch_bucket(8))(
        ref.rt.fs.table, np.pad(slots, (0, 248)), jax.numpy.int32(0))
    got = rp.build_multi_get(cfg)(kvs.rt.fs.table, slots)
    for f in ("valid", "val", "pts"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f))[:8], f)
    scan = rp.build_scan(cfg)
    for lo, hi in ((0, 256), (250, 256), (9, 13)):
        size = min(rp.batch_bucket(hi - lo), 256)
        start = min(lo, 256 - size)
        w = ref_rp.build_scan(ref.cfg, "batched", size)(
            ref.rt.fs.table, jax.numpy.int32(start), jax.numpy.int32(0))
        g = scan(kvs.rt.fs.table, lo, hi)
        for f in ("valid", "val", "pts"):
            np.testing.assert_array_equal(
                getattr(g, f),
                np.asarray(getattr(w, f))[lo - start:lo - start + hi - lo], f)
    with pytest.raises(ValueError):
        scan(kvs.rt.fs.table, 5, 257)


# -- KVS drives ----------------------------------------------------------------


def _dense_drive(kvs):
    out = [_put_all(kvs, [(7, [11, 22, 33]), (9, [44, 55, 66]),
                          (10, [5, 5]), (12, [6, 6])])]
    res = kvs.multi_get([7, 9, 3, 255, 7])
    assert res.all_done() and res.local.all()
    out.append(_cols(res))
    sc = kvs.scan(9, 13)
    assert sc.all_done()
    out.append(_cols(sc))
    out.append(_cols(kvs.scan(0, kvs.cfg.n_keys)))
    for lo, hi in ((5, 3), (0, kvs.cfg.n_keys + 1), (-1, 4), (4, 4)):
        with pytest.raises(ValueError):
            kvs.scan(lo, hi)
    with pytest.raises(ValueError):
        kvs.multi_get([1, kvs.cfg.n_keys])
    out.append(_cols(kvs.multi_get([])))
    out.append(kvs.read_stats())
    return out


def test_torch_dense_multi_get_and_scan_equal_reference():
    ref, kvs = _pair()
    want, got = _dense_drive(ref), _dense_drive(kvs)
    _same(want, got, "dense")
    assert got[-1]["local_reads"] == 5 + 4 + 256
    assert got[1]["value"][0].tolist()[:3] == [11, 22, 33]
    assert got[1]["found"][2]  # never written: the initial value
    _clean(kvs)


def _sparse_drive(kvs):
    big = 0xDEAD_BEEF_0000_0001
    keys = [1 << 40, 77, 1 << 50, big, 2**64 - 2]
    out = [_put_all(kvs, [(k, [i + 1]) for i, k in enumerate(keys)])]
    used = kvs.index.n_used
    res = kvs.multi_get([big, 0xFFFF_0000, 2**63 + 3, 77])
    assert res.all_done()
    out.append(_cols(res))
    out.append(kvs.index.n_used == used)  # absent probes claim no slot
    out.append(_cols(kvs.scan(0, kvs.cfg.n_keys)))  # write order
    out.append(_cols(kvs.scan(3, kvs.cfg.n_keys)))
    out.append(_cols(kvs.scan(100, 200)))  # past the frontier: empty
    out.append(kvs.read_stats())
    return out


def test_torch_sparse_multi_get_and_scan_equal_reference():
    ref, kvs = _pair(sparse=True)
    want, got = _sparse_drive(ref), _sparse_drive(kvs)
    _same(want, got, "sparse")
    assert got[1]["key"].dtype == np.uint64
    assert got[1]["found"].tolist() == [True, False, False, True]
    assert got[3]["key"].tolist() == [1 << 40, 77, 1 << 50,
                                      0xDEAD_BEEF_0000_0001, 2**64 - 2]
    assert [r[0] for r in got[3]["value"].tolist()] == [1, 2, 3, 4, 5]
    assert got[2] is True and len(got[5]["key"]) == 0
    _clean(kvs)


def _invalid_drive(kvs):
    """A key whose write is in flight is not Valid: the local path
    declines it and the round-path fallback resolves once it commits."""
    kvs.freeze(2)  # the quorum needs every live replica: the put stalls
    fw = kvs.put(0, 0, 5, [1, 2, 3])
    for _ in range(4):
        kvs.step()
    assert not fw.done()
    res = kvs.multi_get([5, 6, 5], wait=False)
    out = [_cols(res), res.fallbacks, res.all_done(), kvs.read_stats()]
    kvs.rt.thaw(2)
    assert kvs.run_until([fw])
    assert kvs.run_batch(res._fallback[0])
    out += [_cols(res), res.all_done(), kvs.read_stats(),
            (fw.result().uid, fw.result().ts)]
    return out


def test_torch_invalid_key_falls_back_to_round_path_as_reference():
    ref, kvs = _pair()
    want, got = _invalid_drive(ref), _invalid_drive(kvs)
    _same(want, got, "invalid")
    assert got[0]["local"].tolist() == [False, True, False]
    assert got[1] == 2 and got[-2]["fallback_reads"] == 2
    assert got[4]["value"][0].tolist()[:3] == [1, 2, 3]
    _clean(kvs)


def _unhealthy_drive(kvs):
    _put_all(kvs, [(1, [9, 9])])
    for r in range(3):
        kvs.freeze(r)
    res = kvs.multi_get([1, 2], wait=False)
    sc = kvs.scan(0, 4, wait=False)
    out = [_cols(res), res.fallbacks, _cols(sc), sc.fallbacks,
           kvs.read_stats()]
    for r in range(3):
        kvs.rt.thaw(r)
    assert kvs.run_batch(res._fallback[0]) and kvs.run_batch(sc._fallback[0])
    return out + [_cols(res), _cols(sc), kvs.read_stats()]


def test_torch_no_healthy_replica_serves_nothing_locally_as_reference():
    ref, kvs = _pair()
    want, got = _unhealthy_drive(ref), _unhealthy_drive(kvs)
    _same(want, got, "unhealthy")
    assert not got[0]["local"].any() and got[1] == 2 and got[3] == 4
    assert kvs.rt.healthy_replicas() == [0, 1, 2]
    assert got[-3]["value"][0].tolist()[:2] == [9, 9]
    _clean(kvs)


def _ryw_drive(kvs):
    f = kvs.put(0, 0, 42, [7, 8, 9])
    assert kvs.run_until([f])
    out = []
    res = kvs.multi_get([42], session=(0, 0))  # fence met: served, pruned
    out += [_cols(res), kvs.ryw_fallbacks, dict(kvs._ryw)]
    # poison: the lane saw a commit far in the version future
    kvs._ryw[(0, 0)] = {42: (1 << 40, 0)}
    res2 = kvs.multi_get([42], session=(0, 0))
    out += [_cols(res2), kvs.ryw_fallbacks]
    out.append(_cols(kvs.multi_get([42], session=(1, 0))))  # unfenced
    # a batch writer pins its own token
    bf = kvs.submit_batch(np.full(2, KVS.PUT, np.int32), [50, 51],
                          np.array([[1, 1], [2, 2]], np.int32))
    assert kvs.run_batch(bf)
    kvs.pin_read_fence("tenant", 50, (int(bf.tsv[0]), int(bf.tsf[0])))
    kvs.pin_read_fence("tenant", 51, (int(bf.tsv[1]) + 5, 0))  # ahead
    res3 = kvs.multi_get([50, 51, 52], session="tenant")
    out += [_cols(res3), dict(kvs._ryw["tenant"]), kvs.read_stats()]
    sc = kvs.scan(49, 53, session="tenant")  # the same fence on a scan
    out += [_cols(sc), kvs.read_stats()]
    return out


def test_torch_ryw_fence_and_pin_read_fence_equal_reference():
    ref, kvs = _pair()
    want, got = _ryw_drive(ref), _ryw_drive(kvs)
    _same(want, got, "ryw")
    assert got[0]["local"][0] and got[1] == 0 and got[2] == {(0, 0): {}}
    assert not got[3]["local"][0] and got[4] == 1
    assert got[3]["value"][0].tolist()[:3] == [7, 8, 9]
    assert got[5]["local"][0]
    assert got[6]["local"].tolist() == [True, False, True]
    assert got[7] == {51: (int(got[7][51][0]), 0)}
    _clean(kvs)


def _mixed_drive(kvs, seed):
    """Writes in flight beside reads: batches of puts stepped part way,
    then multi-gets (with and without a session) and scans that must
    decline the Invalid keys; per-op RMWs pin lanes."""
    rng = np.random.default_rng(seed)
    cfg = kvs.cfg
    out = []
    for it in range(6):
        n = 24
        keys = rng.integers(0, 32, n)
        vals = rng.integers(-(1 << 20), 1 << 20, (n, 3)).astype(np.int32)
        kinds = np.where(rng.random(n) < 0.8, KVS.PUT, KVS.RMW)
        stall = it % 2 == 0  # a frozen replica holds the writes in flight
        if stall:
            kvs.freeze(2)
        bf = kvs.submit_batch(kinds.astype(np.int32), keys, vals)
        for _ in range(int(rng.integers(1, 3))):
            kvs.step()
        lane = (int(rng.integers(cfg.n_replicas - 1)), 0)
        fut = kvs.put(*lane, int(keys[0]), [it, it, it])
        res = kvs.multi_get(rng.integers(0, 40, 16), session=lane,
                            wait=False)
        sc = kvs.scan(int(rng.integers(0, 16)), 40, session=lane,
                      wait=False)
        out += [_cols(res), _cols(sc)]
        if stall:
            kvs.rt.thaw(2)
        assert kvs.run_batch(bf) and kvs.run_until([fut])
        if sc._fallback is not None:
            assert kvs.run_batch(sc._fallback[0])
        out.append(_cols(sc))
        if res._fallback is not None:
            assert kvs.run_batch(res._fallback[0])
        c = fut.result()
        out += [_cols(res), (c.kind, c.uid, c.step, c.ts),
                _cols(kvs.multi_get([int(keys[0])], session=lane)),
                kvs.read_stats()]
    kvs.flush()
    out.append([tuple(x) for x in bf.uid.tolist()])
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("seed", [4, 11])
def test_torch_reads_beside_writes_equal_reference(depth, seed):
    ref, kvs = _pair(pipeline_depth=depth, n_keys=64)
    want, got = _mixed_drive(ref, seed), _mixed_drive(kvs, seed)
    _same(want, got, f"depth{depth}")
    st = got[-2]
    assert st["local_reads"] > 0 and st["fallback_reads"] > 0
    _clean(kvs)


def test_torch_record_local_reads_into_both_recorders():
    """The local reads land in the history of either recorder kind, as
    reads at the coming round's read point."""
    for record in (True, "array"):
        _, kvs = _pair(record=record)
        [(uid, _ts)] = _put_all(kvs, [(3, [1, 2])])
        step = kvs.rt.step_idx
        kvs.multi_get([3, 4])
        reads = [o for o in kvs.rt.history_ops()
                 if o.kind == "r" and o.inv == o.resp == 2.0 * step]
        assert sorted((o.key, o.ruid) for o in reads) == [(3, uid),
                                                          (4, (4, -1))]
        assert lin.stale_read(kvs.rt.history_ops()) == []
        assert kvs.rt.check().ok


def test_torch_read_path_entry_defaults_to_the_card():
    import inspect

    assert inspect.signature(KVS).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            KVS(_cfgs()[1])


# -- the sharded engine: one table copy a replica ------------------------------


def _sharded_pair():
    from jax.sharding import Mesh

    rc, cfg = _cfgs()
    mesh = Mesh(np.array(jax.devices()[:3]), ("replica",))
    ref = RefKVS(rc, backend="sharded", mesh=mesh, record=True)
    kvs = KVS(cfg, backend="sharded", record=True, device="cpu")
    return ref, kvs, mesh


def _part_copy_2(ref, kvs, mesh, key, row_words):
    """Make replica 2's copy of ``key`` differ from the others in both
    packages (a frozen replica still applies inbound INVs, so the
    engine's own stall model keeps the copies' values together)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.transport import codec

    K = kvs.cfg.n_keys
    row8 = codec.words_to_rows(np.asarray([row_words], np.int32))[0]
    bank = np.asarray(jax.device_get(ref.rt.fs.table.bank)).copy()
    bank[2 * K + key] = row8
    ref.rt.fs = ref.rt.fs._replace(table=ref.rt.fs.table._replace(
        bank=jax.device_put(jax.numpy.asarray(bank),
                            NamedSharding(mesh, P("replica")))))
    fst.copies(kvs.rt.fs.table.bank, K)[2, key] = torch.from_numpy(row8)


def test_torch_sharded_reads_serve_the_named_replicas_copy():
    """On the sharded engine a read is served from the serving replica's
    own copy (the row offset ``replica * (K+1)``): with replica 2's copy
    of key 17 made to differ, the raw programs read each replica's copy
    as the reference's do, the KVS serves from the first healthy replica
    (copy 0, then copy 2 once 0 and 1 are frozen), and a named replica
    reads its own."""
    ref, kvs, mesh = _sharded_pair()
    for k in (ref, kvs):
        _put_all(k, [(0, [1, 2]), (255, [3, 4]), (17, [-5, 6])])
    other = [123 << 10, (4 << 3) | 0, 17, -1, 9, 9, 9, 9]  # VALID, ts 123
    _part_copy_2(ref, kvs, mesh, 17, other)
    K = kvs.cfg.n_keys
    slots = np.array([0, 255, 17, -1, 256, 3], np.int32)
    mget = rp.build_multi_get(kvs.cfg)
    scan = rp.build_scan(kvs.cfg)
    answers = []
    for rep in range(3):
        want = ref_rp.build_multi_get(ref.cfg, "sharded",
                                      rp.batch_bucket(6))(
            ref.rt.fs.table, np.pad(slots, (0, 250)), jax.numpy.int32(rep))
        got = mget(kvs.rt.fs.table, slots, rep)
        for f in ("valid", "val", "pts"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f))[:6],
                                          f"replica {rep} {f}")
        w = ref_rp.build_scan(ref.cfg, "sharded", K)(
            ref.rt.fs.table, jax.numpy.int32(0), jax.numpy.int32(rep))
        g = scan(kvs.rt.fs.table, 0, K, rep)
        np.testing.assert_array_equal(g.val, np.asarray(w.val))
        answers.append(got.val[2].tolist())
    assert answers[0] == answers[1] != answers[2]
    assert answers[2][:2] == [17, -1]
    # the KVS and its reader: the first healthy replica's copy, or a named
    assert kvs.multi_get([17]).value[0].tolist() == answers[0][2:]
    reader = kvs._get_reader()
    assert reader.multi_get([17], replica=2).val[0].tolist() == answers[2]
    assert reader.scan(17, 18, replica=2).val[0].tolist() == answers[2]
    for k in (ref, kvs):
        k.freeze(0)
        k.freeze(1)
    want = _cols(ref.multi_get([17, 0]))
    got = _cols(kvs.multi_get([17, 0]))
    _same([want], [got], "served by replica 2")
    assert got["value"][0].tolist() == answers[2][2:]
    assert reader.multi_get([17], replica=0) is None  # frozen: no local read
