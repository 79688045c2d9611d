"""The port's live key-range migration (hermes_tpu_torch/elastic/migrate.py,
the fence mask and salvage of kvs.py, the range archives of snapshot.py,
keyindex.RangeRouter, record_migration of both recorders, the migration
drill and ``--drill migrate``) against the reference's
(hermes_tpu/elastic, hermes_tpu/kvs.py, hermes_tpu/snapshot.py).

Each drive of ``tests/test_elastic.py``'s migration section (dense and
sparse moves, mid-drain rejects, the forced salvage as ``maybe_w``, a
queued op behind a salvaged one, the refusals before the fence, the
abort path, the ``drill`` tag), the fenced reads of
``tests/test_readpath.py`` and the heap moves of ``tests/test_heap.py``
runs on both packages from the same config: completions, summaries,
``rejected_ops``, every leaf of both stores' final state (tables in the
reference's rows: vpts and bank bytes) and the recorded histories must
be equal, and every checker green.  Tolerance: exact (integer state).
The sharded cases run the reference on a CPU mesh and the port on a
``LocalGroup``, one a range that ends at slot K-1 (the port's per-copy
drop row must stay untouched).  The reference is settled at pipeline
depth 2 (ROADMAP C)."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hermes_tpu.kvs as ref_kvs_mod
from hermes_tpu import elastic as ref_elastic
from hermes_tpu import snapshot as ref_snapshot
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.keyindex import RangeRouter as RefRouter
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import convert, elastic, snapshot
from hermes_tpu_torch import kvs as kvs_mod
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.keyindex import RangeRouter
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)

REF = SimpleNamespace(elastic=ref_elastic, Router=RefRouter,
                      snapshot=ref_snapshot, kvs=ref_kvs_mod,
                      KVS=ref_kvs_mod.KVS)
PORT = SimpleNamespace(elastic=elastic, Router=RangeRouter,
                       snapshot=snapshot, kvs=kvs_mod, KVS=kvs_mod.KVS)


def _cfgs(**over):
    kw = dict(n_replicas=4, n_keys=64, n_sessions=4, value_words=6,
              replay_slots=8, workload=RefWL(seed=3))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _settle(rt):
    """Each dispatched reference round completes before host code goes
    on (ROADMAP C); what it computes is unchanged."""
    dispatch = rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, rt.fs))
        return comp

    rt.dispatch_round = settled


def _maker(pkg, cfg, backend="batched"):
    """A KVS factory of one package on ``cfg`` (the reference's sharded
    stores on a CPU mesh, the port's on the CPU)."""
    def make(c=None, **kw):
        c = c or cfg
        if pkg is REF:
            mesh = (Mesh(np.array(jax.devices()[:c.n_replicas]),
                         ("replica",)) if backend == "sharded" else None)
            k = REF.KVS(c, backend=backend, mesh=mesh, **kw)
            if c.pipeline_depth > 1:
                _settle(k.rt)
            return k
        return PORT.KVS(c, backend=backend, device="cpu", **kw)
    return make


def _state(kvs):
    """Every leaf of a store's state as numpy, tables in the reference's
    rows, plus its host control arrays."""
    rt = kvs.rt
    if isinstance(rt, FastRuntime):
        fs = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
    else:
        fs = jax.device_get(rt.fs)
    out = {}
    for part in ("table", "sess", "replay", "meta"):
        p = getattr(fs, part)
        for f in p._fields:
            out[f"{part}.{f}"] = np.asarray(getattr(p, f))
    out.update(live=np.asarray(rt.live), frozen=np.asarray(rt.frozen),
               fence=np.asarray(kvs._fence_mask))
    out["ver_base"] = (np.zeros(0) if rt._ver_base is None
                       else np.asarray(rt._ver_base))
    return out


def _ops(rt):
    return [(o.kind, o.key, o.inv, o.resp, o.wuid, o.ruid, o.ts)
            for o in rt.history_ops()]


def _assert_same_store(ref, port):
    a, b = _state(ref), _state(port)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.rejected_ops == ref.rejected_ops
    if port.rt.recorder is not None:
        assert _ops(port.rt) == _ops(ref.rt)
        assert port.rt.check().ok and ref.rt.check().ok


def _res(f):
    c = f.result()
    return (c.kind, c.key, c.value, c.uid, c.step, c.found)


def _summary(s):
    """A migration summary without the port's extra drain count, arrays
    as lists."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in s.items() if k != "drain_rounds"}


def _both(drive, rc, cfg, backend="batched"):
    """``drive(P, make)`` on the reference and the port; equal outputs;
    returns the port's."""
    want = drive(REF, _maker(REF, rc, backend))
    got = drive(PORT, _maker(PORT, cfg, backend))
    assert got[0] == want[0]
    for r, p in zip(want[1:], got[1:]):
        _assert_same_store(r, p)
    return got


# -- the router ----------------------------------------------------------------


def _router_drive(R):
    router = R(64, default_group=0)
    lo, hi = 16, 32
    router.begin_drain(lo, hi)
    out = [bool(router.draining(lo)), bool(router.draining(hi - 1)),
           bool(router.draining(lo - 1)), bool(router.draining(hi)),
           int(router.owner(lo))]
    router.flip(lo, hi, 7)
    out += [router.owner(np.arange(64)).tolist(),
            router.draining(np.arange(64)).tolist(),
            router.routable(np.array([lo - 1, lo, hi - 1, hi]), 7).tolist(),
            router.owned_ranges()]
    router.begin_drain(0, 8)
    router.release(0, 8)
    router.assign(40, 48, 3)
    out.append(router.owned_ranges())
    for bad in ((8, 4), (0, 65)):
        with pytest.raises(ValueError) as e:
            router.begin_drain(*bad)
        out.append(str(e.value))
    router.begin_drain(40, 44)
    with pytest.raises(RuntimeError) as e:
        router.assign(40, 48, 1)
    out.append(str(e.value))
    return out


def test_torch_range_router_equals_reference():
    got = _router_drive(RangeRouter)
    assert got == _router_drive(RefRouter)
    assert got[:5] == [True, True, False, False, 0]
    assert got[7] == [False, True, True, False]


# -- dense and sparse moves ------------------------------------------------------


def _dense_drive(P, make):
    src, dst = make(record=True), make(record=True)
    router = P.Router(src.cfg.n_keys)
    futs = [src.put(0, 0, k, [k, 100 + k]) for k in range(8, 16)]
    assert src.run_until(futs)
    res = P.elastic.migrate_range(src, dst, 8, 16, router=router,
                                  dst_group=1)
    f = src.get(0, 0, 9)
    g = dst.get(1, 0, 9)
    assert dst.run_until([g])
    w = dst.put(2, 1, 9, [77])
    assert dst.run_until([w])
    g2 = dst.get(0, 2, 9)
    assert dst.run_until([g2])
    out = [_summary(res), router.owner(np.arange(64)).tolist(),
           [_res(x) for x in futs + [f, g, w, g2]]]
    return out, src, dst


@pytest.mark.parametrize("backend,depth", [("batched", 1), ("batched", 2),
                                           ("sharded", 1)])
def test_torch_dense_migration_identical(backend, depth):
    rc, cfg = _cfgs(pipeline_depth=depth)
    (summary, owner, results), src, dst = _both(_dense_drive, rc, cfg,
                                                backend)
    assert summary["drained"] and summary["salvaged"] == 0
    assert owner[8:16] == [1] * 8 and owner[7] == 0 and owner[16] == 0
    assert results[8][0] == "rejected"
    assert results[9][2][:2] == [9, 109] and results[11][2][:1] == [77]
    # one synthetic committed write a migrated key, in the namespace
    mig = [o for o in _ops(dst.rt) if o[4] is not None and o[4][1] <= -2]
    assert sorted(o[1] for o in mig) == list(range(8, 16))


def test_torch_sharded_migration_ending_at_last_slot():
    """A range ending at slot K-1 on the sharded layout, replica 1 of the
    source frozen across the move (the donor is the lowest live, unfrozen
    copy): the state equals the reference's, every destination copy
    equals copy 0 over the range, and no copy's drop row changed."""
    rc, cfg = _cfgs(n_keys=48)
    K, lo = 48, 32

    def drop_rows(k):
        tbl = k.rt.fs.table
        return (tbl.vpts.view(-1, K + 1)[:, K].clone(),
                tbl.bank.view(-1, K + 1, tbl.bank.shape[1])[:, K].clone())

    drops = []

    def drive(P, make):
        src, dst = make(record=True), make(record=True)
        futs = [src.put(k % 4, k % 4, k, [k, 3 * k]) for k in range(24, K)]
        assert src.run_until(futs)
        src.freeze(1)
        if P is PORT:
            before = [drop_rows(src), drop_rows(dst)]
        res = P.elastic.migrate_range(src, dst, lo, K)
        if P is PORT:
            drops.extend(zip(before, [drop_rows(src), drop_rows(dst)]))
        src.rt.thaw(1)
        gets = [dst.get(r, 1, k) for r in range(4) for k in (lo, K - 1)]
        assert dst.run_until(gets)
        return [_summary(res), [_res(g) for g in gets]], src, dst

    got = _both(drive, rc, cfg, "sharded")
    assert got[0][0]["drained"] and len(drops) == 2
    for (v0, b0), (v1, b1) in drops:
        assert torch.equal(v1, v0) and torch.equal(b1, b0)
    dst = got[2]
    v = fst.copies(dst.rt.fs.table.vpts, K)[:, lo:K]
    b = fst.copies(dst.rt.fs.table.bank, K)[:, lo:K]
    assert all(torch.equal(v[j], v[0]) and torch.equal(b[j], b[0])
               for j in range(4))
    assert (v[0] != 0).all()
    assert [r[2][:2] for r in got[0][1]] == [[lo, 3 * lo],
                                            [K - 1, 3 * (K - 1)]] * 4


def test_torch_sparse_migration_identical():
    rc, cfg = _cfgs()
    keys = [(i + 1) * 10**12 for i in range(12)]

    def drive(P, make):
        src = make(record=True, sparse_keys=True)
        dst = make(record=True, sparse_keys=True)
        futs = [src.put(i % 4, i % 4, k, [i]) for i, k in enumerate(keys)]
        assert src.run_until(futs)
        res = P.elastic.migrate_range(src, dst, 4, 10)
        gets = [dst.get(0, 0, keys[i]) for i in range(4, 10)]
        assert dst.run_until(gets)
        stay = [src.get(0, 0, keys[i]) for i in (3, 10)]
        assert src.run_until(stay)
        r = src.get(0, 0, keys[4])
        return [_summary(res), [_res(x) for x in futs + gets + stay + [r]],
                dst.index._rev[:dst.index.n_used].tolist()], src, dst

    (summary, results, rev), _, _ = _both(drive, rc, cfg)
    assert summary["rows"] == 6
    assert [r[2][:1] for r in results[12:18]] == [[i] for i in range(4, 10)]
    assert results[-1][0] == "rejected"
    assert rev == keys[4:10]


# -- rejects, salvage, refusals ------------------------------------------------------


def test_torch_mid_drain_ops_and_fenced_reads_rejected():
    """Per-op, batch, multi_get and scan ops on a fenced range resolve
    rejected, counted and never stranded; releasing the fence serves the
    range again."""
    rc, cfg = _cfgs()

    def drive(P, make):
        src = make(record=True)
        futs = [src.put(0, 0, k, [k]) for k in range(8, 16)]
        assert src.run_until(futs)
        queued = [src.put(2, 3, 20, [1]), src.put(2, 3, 9, [2])]
        swept = src.fence_slots(8, 16)
        f = src.put(1, 1, 9, [5])
        bf = src.submit_batch(
            np.array([P.KVS.PUT, P.KVS.PUT], np.int32), np.array([9, 20]),
            np.array([[1], [2]], np.int32))
        code0 = int(bf.code[0])
        assert src.run_batch(bf) and src.run_until(queued)
        mg = src.multi_get([5, 15])
        sc = src.scan(6, 10)
        inflight = src.range_inflight(0, 64)
        src.release_slots(8, 16)
        f2 = src.put(1, 1, 9, [5])
        assert src.run_until([f2])
        return [swept, code0, [_res(x) for x in queued + [f, f2]],
                [bf.completion(i).kind for i in range(2)],
                mg.code.tolist(), sc.code.tolist(), sc.local.tolist(),
                inflight], src

    out, src = _both(drive, rc, cfg)
    swept, code0, results, bkinds, mg, sc, _local, inflight = out
    assert swept == 1 and code0 == kvs_mod.C_REJECTED
    assert [r[0] for r in results] == ["put", "rejected", "rejected", "put"]
    assert bkinds == ["rejected", "put"]
    assert mg == [t.C_READ, kvs_mod.C_REJECTED]
    assert sc == [t.C_READ] * 2 + [kvs_mod.C_REJECTED] * 2
    assert inflight == 0 and src.rejected_ops == 6


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_forced_salvage_as_maybe_w_identical(depth):
    """An op wedged by a frozen quorum member is salvaged: its future
    resolves 'lost', the history holds a maybe_w, an op queued behind it
    (outside the range) runs after the cutover, and a wedged batch op
    resolves C_LOST; both checkers green, the destination serves."""
    rc, cfg = _cfgs(pipeline_depth=depth)

    def drive(P, make):
        src, dst = make(record=True), make(record=True)
        ws = [src.put(0, 0, k, [k]) for k in range(8)]
        assert src.run_until(ws)
        src.freeze(2)
        wedge = src.put(1, 1, 10, [999])
        queued = src.put(1, 1, 50, [7])
        bf = src.submit_batch(np.array([P.KVS.PUT], np.int32),
                              np.array([11]), np.array([[5]], np.int32))
        for _ in range(4):
            src.step()
        res = P.elastic.migrate_range(src, dst, 8, 12, drain_steps=6,
                                      force=True)
        src.rt.thaw(2)
        assert src.run_until([queued], max_steps=200)
        g = dst.get(0, 0, 10)
        assert dst.run_until([g])
        maybe = [o for o in src.rt.history_ops() if o.kind == "maybe_w"]
        return [_summary(res), [_res(x) for x in (wedge, queued, g)],
                int(bf.code[0]), len(maybe)], src, dst

    (summary, results, bcode, n_maybe), _, _ = _both(drive, rc, cfg)
    assert summary["salvaged"] == 2 and not summary["drained"]
    assert [r[0] for r in results] == ["lost", "put", "get"]
    assert bcode == kvs_mod.C_LOST and n_maybe == 2


@pytest.mark.parametrize("case", [
    "not_fresh", "dense_n_keys", "sparse_capacity", "sparse_frontier",
    "dest_slots_count", "dest_slots_distinct", "dest_slots_space",
    "dest_slots_sparse", "heap_mode", "heap_cannot_hold", "abort_drain"])
def test_torch_migration_refusals_before_fence(case):
    """Every refusable migration is refused with the reference's message
    and no side effect on the source (no fence, no rejected op); a drain
    that fails after the fence takes the abort path (fence and router
    drain released, the source serves the range again)."""
    rc, cfg = _cfgs()
    small_kw = dict(n_replicas=4, n_keys=8, n_sessions=4, value_words=6,
                    replay_slots=8, workload=RefWL(seed=3))
    heap_kw = dict(n_replicas=3, n_keys=64, value_words=3, n_sessions=8,
                   replay_slots=8, max_value_bytes=256, heap_bytes=1 << 15)

    def drive(P, make):
        C = RefConfig if P is REF else HermesConfig
        src = make(record=True)
        router = P.Router(64)
        kw = {}
        if case == "not_fresh":
            dst = make(record=True)
            fs = [src.put(0, 0, 9, [1]), dst.put(0, 0, 9, [2])]
            assert src.run_until([fs[0]]) and dst.run_until([fs[1]])
            args = (8, 12)
        elif case == "dense_n_keys":
            dst = make(C(**small_kw))
            args = (8, 12)
        elif case in ("sparse_capacity", "sparse_frontier",
                      "dest_slots_sparse"):
            src = make(record=True, sparse_keys=True)
            dst = make(C(**dict(small_kw, n_keys=4)) if case ==
                       "sparse_capacity" else None, sparse_keys=True)
            futs = [src.put(0, 0, (i + 1) * 10**12, [i]) for i in range(8)]
            assert src.run_until(futs)
            args = (0, 12) if case == "sparse_frontier" else (0, 8)
            if case == "dest_slots_sparse":
                kw = dict(dest_slots=np.arange(8))
        elif case.startswith("dest_slots"):
            dst = make()
            args = (0, 4)
            kw = dict(dest_slots={"dest_slots_count": [1, 2],
                                  "dest_slots_distinct": [1, 1, 2, 3],
                                  "dest_slots_space": [1, 2, 3, 99]}[case])
        elif case.startswith("heap"):
            src = make(C(**heap_kw))
            dst = make(C(**dict(heap_kw, max_value_bytes=0))
                       if case == "heap_mode"
                       else C(**dict(heap_kw, max_value_bytes=128)))
            args = (0, 8)
        else:  # abort_drain
            dst = make(record=True)
            ws = [src.put(0, 0, k, [k]) for k in range(8)]
            assert src.run_until(ws)
            src.freeze(2)
            src.put(1, 1, 10, [5])
            for _ in range(3):
                src.step()
            args = (8, 12)
            kw = dict(router=router, drain_steps=5)
        with pytest.raises((ValueError, RuntimeError)) as e:
            P.elastic.migrate_range(src, dst, *args, **kw)
        out = [type(e.value).__name__, str(e.value),
               bool(src._fence_mask.any()), src.drill_phase,
               router.draining(np.arange(64)).tolist()]
        if case == "abort_drain":
            src.rt.thaw(2)
            f = src.put(1, 2, 10, [6])
            assert src.run_until([f])
            out.append(_res(f))
        else:
            out.append(src.rejected_ops)
        return [out]

    want = drive(REF, _maker(REF, rc))
    got = drive(PORT, _maker(PORT, cfg))
    assert got == want
    assert got[0][2:4] == [False, None] and not any(got[0][4])


def test_torch_migration_cleans_transfer_tempdir(tmp_path, monkeypatch):
    """The default (temporary) transfer archive is removed on success AND
    on a failure after the fence, whose abort releases the fence."""
    import tempfile as tempfile_mod

    monkeypatch.setattr(tempfile_mod, "tempdir", str(tmp_path))
    _, cfg = _cfgs()
    src, dst = (kvs_mod.KVS(cfg, record=True, device="cpu")
                for _ in range(2))
    assert src.run_until([src.put(0, 0, k, [k]) for k in range(8, 16)])
    elastic.migrate_range(src, dst, 8, 12)
    assert list(tmp_path.glob("hermes_migrate_*")) == []

    def boom(*a, **k):
        raise ValueError("boom")

    monkeypatch.setattr(snapshot, "read_range", boom)
    with pytest.raises(ValueError, match="boom"):
        elastic.migrate_range(src, dst, 12, 16)
    assert list(tmp_path.glob("hermes_migrate_*")) == []
    assert src._fence_mask[8:12].all() and not src._fence_mask[12:].any()
    assert src.drill_phase is None


def test_torch_stuck_op_diagnostics_carry_drill_phase():
    """A stuck op's diagnostic and the strict error's message carry the
    active migration stage and adversary window, as the reference's."""
    rc, cfg = _cfgs(op_timeout_rounds=3)

    def drive(P, make):
        kvs = make(strict_timeouts=True)
        kvs.freeze(2)
        kvs.put(0, 0, 5, [1])
        kvs.drill_phase = "drain"
        kvs.net_phase = {"partition": [[2, -1]]}
        with pytest.raises(P.kvs.StuckOpError, match="drill=drain") as e:
            for _ in range(8):
                kvs.step()
        quiet = make()
        quiet.freeze(2)
        quiet.put(0, 0, 5, [1])
        for _ in range(8):
            quiet.step()
        return [str(e.value), kvs.stuck_ops, quiet.stuck_ops]

    want = drive(REF, _maker(REF, rc))
    got = drive(PORT, _maker(PORT, cfg))
    assert got == want
    assert got[1][0]["drill"] == "drain" and "drill" not in got[2][0]
    assert "net={'partition': [[2, -1]]}" in got[0]


# -- the value heap ----------------------------------------------------------------


def _pay(i: int, n: int) -> bytes:
    return bytes(((i * 37 + j * 151 + 128) & 0xFF) for j in range(n))


def test_torch_heap_extents_move_byte_exact():
    rc, cfg = _cfgs(n_replicas=3, n_keys=128, value_words=3, n_sessions=8,
                    replay_slots=8, ops_per_session=64, max_value_bytes=256,
                    heap_bytes=1 << 15, workload=RefWL(read_frac=0.5, seed=3))
    n = 48
    pays = [_pay(i, (i * 13) % 180) for i in range(n)]

    def drive(P, make):
        src, dst = make(record=True), make(record=True)
        bf = src.submit_batch(np.full(n, P.KVS.PUT, np.int32),
                              np.arange(n, dtype=np.int64), pays)
        assert src.run_batch(bf)
        s = P.elastic.migrate_range(src, dst, 8, 40)
        res = dst.multi_get(np.arange(8, 40, dtype=np.int64))
        assert res.all_done()
        return [_summary(s), res.data, dst.heap.appends,
                bytes(dst.heap._mirror[:dst.heap.used_bytes()])], src, dst

    (summary, data, appends, log), _, _ = _both(drive, rc, cfg)
    assert summary["heap_extents"] == 32
    assert data == pays[8:40] and appends >= 32


# -- the drill ----------------------------------------------------------------------


def test_torch_migration_drill_identical(monkeypatch):
    """``migration_drill`` on both packages: the summary (but the port's
    extra counts), both stores' state and histories equal, both checkers
    green."""
    rc, cfg = _cfgs(n_keys=96, n_sessions=4, ops_per_session=1)
    made = []

    class Capture(REF.KVS):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ref_kvs_mod, "KVS", Capture)
    want = ref_elastic.migration_drill(rc, seed=4, load_ops=200)
    monkeypatch.undo()
    src, dst = (kvs_mod.KVS(cfg, record=True, device="cpu")
                for _ in range(2))
    got = elastic.migration_drill(cfg, seed=4, load_ops=200, src=src,
                                  dst=dst, device="cpu")
    extra = {"drain_rounds", "dst_read_values"}
    assert _summary({k: v for k, v in got.items() if k not in extra}) == \
        _summary(want)
    assert got["src_checked_ok"] and got["dst_checked_ok"]
    for r, p in zip(made, (src, dst)):
        _assert_same_store(r, p)
    # the destination reads the moved values: the source's last committed
    # rows (left behind, fenced) hold the same uid and payload
    lo, hi = 32, 64
    rows = fst._bank_to_i32(src.rt.copy_of(0)[1])
    for k, val in zip((lo, (lo + hi) // 2, hi - 1), got["dst_read_values"]):
        assert rows[k, fst.BANK_VAL + 2:].tolist() == val


# -- range archives -------------------------------------------------------------------


def _ref_runtime(rc, steps):
    rt = RefRuntime(rc)
    rt.run(steps)
    rt.drain(200)
    return rt


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_torch_range_archives_cross_load(tmp_path, direction):
    """A range archive written by either package loads in the other
    (``load_range``) and reads back the same rows and version deltas; a
    full ``load`` of it is refused on the manifest scope in both, and
    ``read_range`` of a full archive too."""
    rc, cfg = _cfgs(n_replicas=3, n_keys=128, n_sessions=8, replay_slots=4,
                    ops_per_session=16, workload=RefWL(seed=67))
    ref_src = _ref_runtime(rc, 6)
    port_src = FastRuntime(cfg, device="cpu")
    port_src.run(6)
    port_src.drain(200)
    np.testing.assert_array_equal(
        convert.fast_state_to_numpy(port_src.fs).table.bank,
        np.asarray(jax.device_get(ref_src.fs.table.bank)))
    p = str(tmp_path / "range.npz")
    full = str(tmp_path / "full.npz")
    if direction == "port_to_ref":
        m = snapshot.save_range(p, port_src, 32, 64)
        snapshot.save(full, port_src)
    else:
        m = ref_snapshot.save_range(p, ref_src, 32, 64)
        ref_snapshot.save(full, ref_src)
    assert m["scope"] == "range:[32,64)"
    want = ref_snapshot.read_range(p)
    got = snapshot.read_range(p)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    ref_tgt = RefRuntime(rc)
    port_tgt = FastRuntime(cfg, device="cpu")
    ref_snapshot.load_range(p, ref_tgt, dest_slots=np.arange(64, 96))
    snapshot.load_range(p, port_tgt, dest_slots=np.arange(64, 96))
    tbl = convert.fast_state_to_numpy(port_tgt.fs).table
    np.testing.assert_array_equal(
        tbl.vpts, np.asarray(jax.device_get(ref_tgt.fs.table.vpts)))
    np.testing.assert_array_equal(
        tbl.bank, np.asarray(jax.device_get(ref_tgt.fs.table.bank)))
    np.testing.assert_array_equal(tbl.vpts[64:96],
                                  np.asarray(jax.device_get(
                                      ref_src.fs.table.vpts))[32:64])
    # the drop row stays what a fresh table holds
    assert int(port_tgt.fs.table.vpts[128]) == 0
    for load, tgt in ((snapshot.load, FastRuntime(cfg, device="cpu")),
                      (ref_snapshot.load, RefRuntime(rc))):
        with pytest.raises(ValueError, match="scope="):
            load(p, tgt)
    for read in (snapshot.read_range, ref_snapshot.read_range):
        with pytest.raises(ValueError, match="not a range transfer"):
            read(full)


def test_torch_range_archive_ver_base_and_checksum(tmp_path):
    """The range's version-rebase deltas travel with it and re-anchor the
    destination; a bit-flipped member is refused on its checksum."""
    import zipfile

    _, cfg = _cfgs(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=4,
                   ops_per_session=16, value_words=6)
    kvs = kvs_mod.KVS(cfg, device="cpu")
    for r in range(2):
        assert kvs.run_until([kvs.put(0, 0, k, [k, r])
                              for k in range(8, 12)])
    assert kvs.rt.rebase_versions() > 0
    p = str(tmp_path / "r.npz")
    snapshot.save_range(p, kvs, 8, 12)
    tgt = FastRuntime(cfg, device="cpu")
    snapshot.load_range(p, tgt, dest_slots=[40, 41, 42, 43])
    np.testing.assert_array_equal(tgt._ver_base[40:44],
                                  kvs.rt._ver_base[8:12])
    bad = str(tmp_path / "bad.npz")
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(bad, "w") as zout:
        for item in zin.infolist():
            data = bytearray(zin.read(item.filename))
            if item.filename == "range.vpts.npy":
                data[-1] ^= 1
            zout.writestr(item, bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        snapshot.read_range(bad)


def test_torch_range_rows_byte_order():
    """The archive's row codec is the device's byte order
    (``fst._bank_to_i32``) and the reference's, both ways."""
    rng = np.random.default_rng(5)
    rows = rng.integers(-128, 128, size=(7, 24), dtype=np.int64).astype(
        np.int8)
    words = snapshot._rows_to_i32(rows)
    np.testing.assert_array_equal(words, ref_snapshot._rows_to_i32(rows))
    np.testing.assert_array_equal(snapshot._i32_to_rows(words), rows)
    np.testing.assert_array_equal(
        words, fst._bank_to_i32(torch.as_tensor(rows)).numpy())


# -- the CLI ----------------------------------------------------------------------------


def test_torch_cli_migrate_drill_matches_reference(capsys):
    """``--drill migrate --check``: the JSON line equals the reference
    CLI's on the same arguments (the port adds the drain's rounds and the
    probe reads)."""
    from hermes_tpu import cli as ref_cli
    from hermes_tpu_torch import cli

    argv = ["--replicas", "4", "--keys", "96", "--sessions", "4",
            "--value-words", "6", "--drill", "migrate", "--check"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    extra = {"drain_rounds", "dst_read_values"}
    assert {k: v for k, v in got.items() if k not in extra} == want
    assert got["ok"] and got["src_checked_ok"] and got["dst_checked_ok"]
    assert got["backend"] == "batched" and extra <= got.keys()
