"""The port's value heap (hermes_tpu_torch/heap) and the KVS's heap mode
against the reference's (hermes_tpu/heap, hermes_tpu/kvs.py), on the
reference test's config (128 keys, ``max_value_bytes=256``,
``heap_bytes=1<<15``): the ref packing, the allocator, ``compact`` and
``remap``, the device gather (hostile refs included, and the dirty-tail
sync after a first gather), and seeded KVS drives whose byte payloads,
completions and ``heap_stats()`` must be equal in both packages (bytes
and integers, tolerance 0)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import heap as RH
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu_torch import heap as H
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import layouts
from hermes_tpu_torch.kvs import KVS

torch.set_num_threads(1)

RAGGED = (0, 1, 3, 4, 5, 7, 8, 9, 63, 64, 65, 255, 256)


def _cfgs(**over):
    kw = dict(n_replicas=3, n_keys=128, value_words=3, n_sessions=8,
              replay_slots=8, ops_per_session=64,
              max_value_bytes=256, heap_bytes=1 << 15,
              workload=RefWL(read_frac=0.5, seed=3))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _pay(i: int, n: int) -> bytes:
    """Deterministic high-bit-heavy payload of length n."""
    return bytes(((i * 37 + j * 151 + 128) & 0xFF) for j in range(n))


def _settle(ref):
    """Complete each round the reference dispatches before host code runs
    again (the CPU backend's aliasing of staging arrays, ROADMAP C)."""
    dispatch = ref.rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, ref.rt.fs))
        return comp

    ref.rt.dispatch_round = settled


def _pair(record=True, **over):
    rc, cfg = _cfgs(**over)
    ref = RefKVS(rc, record=record)
    if rc.pipeline_depth > 1:
        _settle(ref)
    return ref, KVS(cfg, record=record, device="cpu")


def _heaps(**over):
    rc, cfg = _cfgs(**over)
    return RH.ValueHeap(rc), H.ValueHeap(cfg, device="cpu")


# -- the ref word --------------------------------------------------------------


def test_torch_heap_ref_packing_equals_reference():
    f_gran = layouts.HEAP_REF.field("gran")
    assert H.GRANULE == RH.GRANULE == 16
    cases = [(1, 0), (1, 1), (5, 255), (f_gran.cap - 1,
                                        layouts.MAX_VALUE_BYTES)]
    rng = np.random.default_rng(3)
    cases += [(int(g), int(n)) for g, n in zip(
        rng.integers(1, f_gran.cap, 200), rng.integers(0, 4096, 200))]
    for gran, ln in cases:
        ref = H.pack_ref(gran, ln)
        assert ref == RH.pack_ref(gran, ln)
        assert H.ref_gran(ref) == RH.ref_gran(ref) == gran
        assert H.ref_len(ref) == RH.ref_len(ref) == ln
        assert 0 < ref <= 0x7FFFFFFF  # rides int32 columns, sign clear
    words = rng.integers(-(1 << 31), 1 << 31, 500, dtype=np.int64)
    np.testing.assert_array_equal(H.ref_gran(words), RH.ref_gran(words))
    np.testing.assert_array_equal(H.ref_len(words), RH.ref_len(words))
    for mvb in (1, 4, 5, 255, 256, 4095):
        rc, cfg = _cfgs(max_value_bytes=mvb)
        assert H.cap_bytes(cfg) == RH.cap_bytes(rc)
    assert cfg.heap_granules == rc.heap_granules


# -- ValueHeap ---------------------------------------------------------------


def test_torch_heap_append_read_and_full_equal_reference():
    r, p = _heaps(heap_bytes=1 << 10, max_value_bytes=64)
    for i, n in enumerate((0, 1, 15, 16, 17, 64)):
        ref = p.append(_pay(i, n))
        assert ref == r.append(_pay(i, n))
        assert p.read(ref) == r.read(ref) == _pay(i, n)
    for h in (r, p):
        with pytest.raises(ValueError, match="max_value_bytes"):
            h.append(b"x" * 65)
    k = 0
    while True:  # HeapFull at the same append in both
        try:
            a = p.append(b"y" * (k % 64))
        except H.HeapFull:
            with pytest.raises(RH.HeapFull):
                r.append(b"y" * (k % 64))
            break
        assert a == r.append(b"y" * (k % 64))
        k += 1
    assert k > 0 and p.stats() == r.stats()
    for bad in (H.pack_ref(p._cursor + 1, 4), H.pack_ref(0, 4),
                H.pack_ref(p._cursor - 1, 40)):
        for h in (r, p):
            with pytest.raises(ValueError, match="dangling"):
                h.read(bad)
    assert p.read_many([0, H.pack_ref(1, 0)]) == [None, b""]
    np.testing.assert_array_equal(p._mirror, r._mirror)


def test_torch_heap_compact_and_remap_equal_reference():
    r, p = _heaps(heap_bytes=1 << 12, max_value_bytes=64)
    live, dead = [], []
    for i in range(12):
        for h in (r, p):
            d, lv = h.append(_pay(i, 40)), h.append(_pay(100 + i, 33 + i))
        dead.append(d)
        live.append(lv)
    roots = np.asarray(live + [0, live[3]], np.int64)  # null and repeats
    (wo, wn), (go, gn) = r.compact(roots), p.compact(roots)
    np.testing.assert_array_equal(go, wo)
    np.testing.assert_array_equal(gn, wn)
    assert p.stats() == r.stats()
    np.testing.assert_array_equal(p._mirror, r._mirror)
    moved = H.ValueHeap.remap(np.asarray(live, np.int32), go, gn)
    np.testing.assert_array_equal(
        moved, RH.ValueHeap.remap(np.asarray(live, np.int32), wo, wn))
    assert moved.dtype == np.int32
    for i, ref in enumerate(moved):
        assert p.read(int(ref)) == _pay(100 + i, 33 + i)
    assert H.ValueHeap.remap(np.zeros(3, np.int64), go, gn).sum() == 0
    with pytest.raises(ValueError, match="root"):
        H.ValueHeap.remap(np.asarray([dead[0]], np.int64), go, gn)
    with pytest.raises(ValueError, match="dangling"):
        p.compact(np.asarray([H.pack_ref(p._cursor + 3, 4)], np.int64))


def test_torch_heap_device_gather_equals_reference_and_clamps():
    r, p = _heaps()
    refs = [p.append(_pay(i, n)) for i, n in enumerate(RAGGED)]
    assert refs == [r.append(_pay(i, n)) for i, n in enumerate(RAGGED)]
    f_gran = layouts.HEAP_REF.field("gran")
    hostile = refs + [
        H.pack_ref(p.granules - 1, 256), H.pack_ref(f_gran.cap - 1, 4095),
        -1, -(1 << 31), (1 << 31) - 1, H.pack_ref(5, 4000), 0,
        H.pack_ref(p._cursor + 9, 100)]
    rows, lens = p.device_gather(np.asarray(hostile, np.int32))
    wrows, wlens = r.device_gather(np.asarray(hostile, np.int32))
    assert rows.dtype == wrows.dtype == np.uint8
    assert rows.shape == wrows.shape == (len(hostile), p.cap)
    np.testing.assert_array_equal(rows, wrows)
    np.testing.assert_array_equal(lens, wlens)
    for i, n in enumerate(RAGGED):
        assert int(lens[i]) == n and rows[i, :n].tobytes() == _pay(i, n)
        assert not rows[i, n:].any()
    # appends after a first gather reach the device log only through the
    # dirty-tail sync: a port that forgot the tail answers zeros here
    more = [p.append(_pay(50 + i, 90 + i)) for i in range(5)]
    assert more == [r.append(_pay(50 + i, 90 + i)) for i in range(5)]
    rows, lens = p.device_gather(np.asarray(more + refs[:3], np.int32))
    wrows, wlens = r.device_gather(np.asarray(more + refs[:3], np.int32))
    np.testing.assert_array_equal(rows, wrows)
    np.testing.assert_array_equal(lens, wlens)
    for i in range(5):
        assert rows[i, :90 + i].tobytes() == _pay(50 + i, 90 + i)
    assert p.gather_dispatches == 2
    empty_rows, empty_lens = p.device_gather(np.zeros(0, np.int32))
    assert empty_rows.shape == (0, p.cap) and empty_lens.shape == (0,)


def test_torch_heap_device_log_is_a_copy_of_the_mirror():
    _, p = _heaps()
    p.append(b"abc")
    log = p.device_log()
    p._mirror[16:19] = 0  # the mirror changes; the device log must not
    assert bytes(log[16:19].tolist()) == b"abc"
    fn = H.build_append(p.capacity, 4)
    with pytest.raises(ValueError):
        fn(log, torch.zeros(4, dtype=torch.uint8), p.capacity - 3)


# -- KVS heap mode -----------------------------------------------------------


def _roundtrip_drive(kvs):
    n = 48
    keys = np.arange(n, dtype=np.int64)
    pays = [_pay(i, (i * 7) % 200) for i in range(n)]
    bf = kvs.submit_batch(np.full(n, KVS.PUT, np.int32), keys, pays)
    assert kvs.run_batch(bf)
    res = kvs.multi_get(np.append(keys, [100, 101]))
    assert res.all_done()
    assert all(res.data[i] == pays[i] for i in range(n))
    assert res.data[n:] == [None, None]  # never written: the null ref
    sc = kvs.scan(0, 60)
    assert all(sc.data[i] == pays[i] for i in range(n))
    out = [res.data, res.value.tolist(), sc.data, sc.local.tolist(),
           bf.uid.tolist(), bf.step.tolist()]
    c = bf.future(3).result()
    out.append((c.kind, c.uid, c.data))
    f = kvs.put(0, 0, 7, b"\x00\x80\xff new")
    assert kvs.run_until([f])
    g = kvs.get(1, 0, 7)
    assert kvs.run_until([g])
    r = kvs.rmw(0, 1, 7, b"after-rmw")
    assert kvs.run_until([r])
    g2 = kvs.get(2, 0, 7)
    assert kvs.run_until([g2])
    gb = kvs.submit_batch(np.full(3, KVS.GET, np.int32),
                          np.asarray([7, 8, 120]))
    assert kvs.run_batch(gb)
    for fut in (f, g, r, g2):
        c = fut.result()
        out.append((c.kind, c.key, c.value, c.data, c.uid, c.step, c.ts))
    out += [gb.data, [gb.completion(i).data for i in range(3)],
            kvs.heap_stats(), kvs.read_stats()]
    return out


def test_torch_kvs_heap_put_get_scan_byte_exact_as_reference():
    ref, kvs = _pair()
    want, got = _roundtrip_drive(ref), _roundtrip_drive(kvs)
    assert got == want
    assert got[9][3] == b"\x00\x80\xff new"  # the get after the put
    if got[10][0] == "rmw":  # read part: the displaced bytes
        assert got[10][3] == b"\x00\x80\xff new"
        assert got[11][3] == b"after-rmw"
    assert kvs.rt.check().ok
    assert lin.stale_read(kvs.rt.history_ops()) == []


def test_torch_kvs_heap_refuses_word_payloads_as_reference():
    ref, kvs = _pair(record=False)
    for k in (ref, kvs):
        with pytest.raises(TypeError, match="byte payloads"):
            k.put(0, 0, 1, [1, 2])
        with pytest.raises(TypeError, match="byte payloads"):
            k.submit_batch(np.full(2, KVS.PUT, np.int32),
                           np.asarray([1, 2], np.int64), [b"ok", [3]])
        with pytest.raises(ValueError, match="max_value_bytes"):
            k.put(0, 0, 1, b"z" * 257)
        with pytest.raises(TypeError, match="values=None"):
            k.submit_batch(np.full(2, KVS.PUT, np.int32),
                           np.asarray([1, 2], np.int64))
        with pytest.raises(ValueError, match="2 byte payloads"):
            k.submit_batch(np.full(2, KVS.PUT, np.int32),
                           np.asarray([1, 2], np.int64), [b"x"])
        bf = k.submit_batch(np.full(2, KVS.GET, np.int32),
                            np.asarray([1, 2], np.int64))
        assert k.run_batch(bf) and bf.data == [None, None]
    # the refused batch's first extent stays appended, as in the reference
    assert kvs.heap_stats() == ref.heap_stats()
    with pytest.raises(RuntimeError, match="max_value_bytes"):
        KVS(_cfgs(max_value_bytes=0, value_words=4)[1],
            device="cpu").heap_gc()
    assert KVS(_cfgs(max_value_bytes=0, value_words=4)[1],
               device="cpu").heap_stats() is None


def _pressure_drive(kvs, seed):
    """Overwrite churn on a heap sized to need collection mid-load, then
    an explicit GC: every surviving value byte-exact."""
    rng = np.random.default_rng(seed)
    latest, out = {}, []
    for rnd in range(12):
        keys = rng.permutation(32)[:16].astype(np.int64)
        pays = [_pay(rnd * 64 + int(k), int(rng.integers(1, 128)))
                for k in keys]
        bf = kvs.submit_batch(np.full(16, KVS.PUT, np.int32), keys, pays)
        if rnd % 3 == 1:  # per-op traffic queued beside the batch
            futs = [kvs.put(1, s, int(keys[s]), _pay(999 + rnd, 40 + s))
                    for s in range(3)]
            assert kvs.run_until(futs)
            for s in range(3):
                latest[int(keys[s])] = None  # the batch and the put race
        assert kvs.run_batch(bf)
        kvs.flush()
        for k, p in zip(keys, pays):
            if latest.get(int(k), 0) is not None:
                latest[int(k)] = p
        out.append((kvs.heap_stats(), bf.uid.tolist()))
    out.append(kvs.heap_gc(reason="test"))
    res = kvs.multi_get(np.asarray(sorted(latest), np.int64))
    assert res.all_done()
    for j, k in enumerate(sorted(latest)):
        if latest[k] is not None:
            assert res.data[j] == latest[k], k
    out += [res.data, kvs.heap_stats()]
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_heap_gc_on_pressure_and_on_demand_equal_reference(depth):
    ref, kvs = _pair(n_keys=32, heap_bytes=1 << 12, max_value_bytes=128,
                     pipeline_depth=depth)
    want, got = _pressure_drive(ref, 5), _pressure_drive(kvs, 5)
    assert got == want
    assert kvs.heap.gc_runs >= 2, "churn never triggered a pressure GC"
    st = got[-3]
    assert st and st["live_bytes"] <= st["used_bytes"]
    assert kvs.rt.check().ok
    assert lin.stale_read(kvs.rt.history_ops()) == []


def _rebase_drive(kvs):
    bf = kvs.submit_batch(np.full(8, KVS.PUT, np.int32),
                          np.arange(8, dtype=np.int64),
                          [_pay(i, 20) for i in range(8)])
    assert kvs.run_batch(bf)
    bf = kvs.submit_batch(np.full(8, KVS.PUT, np.int32),
                          np.arange(8, dtype=np.int64),
                          [_pay(100 + i, 24) for i in range(8)])
    assert kvs.run_batch(bf)
    runs0 = kvs.heap.gc_runs
    n = kvs.rt.rebase_versions()
    assert kvs.heap.gc_runs == runs0 + 1, "rebase did not drive the GC"
    res = kvs.multi_get(np.arange(8, dtype=np.int64))
    assert res.all_done()
    assert all(res.data[i] == _pay(100 + i, 24) for i in range(8))
    f = kvs.put(0, 0, 3, b"post-rebase")
    assert kvs.run_until([f])
    return [n, kvs.heap_stats(), res.data, f.result().ts,
            kvs.multi_get([3]).data]


def test_torch_heap_gc_rides_version_rebase_as_reference():
    ref, kvs = _pair()
    assert kvs.rt.rebase_hook == kvs._heap_rebase_hook
    want, got = _rebase_drive(ref), _rebase_drive(kvs)
    assert got == want
    assert got[-1] == [b"post-rebase"]
    assert kvs.rt.check().ok


def _ref_column(bank):
    col = 4 * (fst.BANK_VAL + 2)
    return fst._bank_to_i32(bank[:, col:col + 4])[:, 0]


def _contended_drive(kvs):
    """Many sessions write the same few keys each round: the losing
    writes' rows go to the port's drop row K.  Returns the ref words key
    0 held, each overwritten later (dead extents)."""
    held = []
    for rnd in range(6):
        n = 48
        keys = np.arange(n, dtype=np.int64) % 3  # 16 writers a key
        pays = [_pay(rnd * 100 + i, 10 + i) for i in range(n)]
        bf = kvs.submit_batch(np.full(n, KVS.PUT, np.int32), keys, pays)
        assert kvs.run_batch(bf)
        if isinstance(kvs, KVS):
            held.append(int(_ref_column(kvs.rt.fs.table.bank)[0]))
    return held


def test_torch_heap_gc_ignores_the_drop_row_as_reference():
    """Row K absorbs every masked row of the round's winner-row scatter,
    losing writes with their heap refs among them.  On the CPU the last
    masked row of a round is an empty lane, so row K ends at zero; on the
    card duplicates land in any order (ROADMAP C) and a losing write's
    ref can stay there.  The test puts one there, a dead extent's ref, as
    the card may: rooting row K would keep those bytes alive and leave
    ``heap_stats()`` off the reference's, and the GC's ref-column rewrite
    must leave row K byte for byte as it was."""
    ref, kvs = _pair(n_sessions=16, heap_bytes=1 << 14)
    _contended_drive(ref)
    held = _contended_drive(kvs)
    bank = kvs.rt.fs.table.bank
    live = set(_ref_column(bank)[:-1].tolist())
    dead = held[0]
    assert dead != 0 and dead not in live and held[-1] in live
    col = 4 * (fst.BANK_VAL + 2)
    bank[-1, col:col + 4] = fst._i32_to_bank(
        torch.tensor([dead], dtype=torch.int32))
    row_k = bank[-1].clone()
    got, want = kvs.heap_gc(reason="t"), ref.heap_gc(reason="t")
    assert got == want and got["live_bytes"] <= got["used_bytes"]
    assert kvs.heap_stats() == ref.heap_stats()
    assert torch.equal(kvs.rt.fs.table.bank[-1], row_k)  # untouched
    res, wres = kvs.multi_get(np.arange(3)), ref.multi_get(np.arange(3))
    assert res.data == wres.data and all(d is not None for d in res.data)
    assert kvs.rt.check().ok
