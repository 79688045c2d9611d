"""The port's write-ahead log (hermes_tpu_torch/wal) against the
reference's (hermes_tpu/wal): segments written by either package decode
to equal records in the other; the torn tail, a flipped interior byte, a
torn non-last segment, a header mismatch and an unknown record kind each
give the reference's outcome; the vectorised replay gives the reference's
applied/skipped counts, table bytes and heap bytes; the KVS surface
(durability labels, backpressure, rotation, truncation, replay across a
snapshot boundary) behaves as the reference's; and ``recover_store`` on
both packages, from one log, gives equal tables with no committed write
lost, with value words and with the value heap."""

import dataclasses
import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.wal import GroupCommitWal as RefWal
from hermes_tpu.wal import replay as ref_replay
from hermes_tpu_torch import convert
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS
from hermes_tpu_torch.transport import codec
from hermes_tpu_torch.wal import GroupCommitWal, WalCorrupt, WalError, replay
from hermes_tpu_torch.wal import crashdrive

torch.set_num_threads(1)


def _kw(wal_dir, **over):
    kw = dict(n_replicas=3, n_keys=256, n_sessions=8, replay_slots=4,
              value_words=6, replay_age=4, replay_scan_every=4,
              wal_dir=str(wal_dir) if wal_dir is not None else None,
              wal_sync="commit", workload=RefWL(seed=5))
    kw.update(over)
    return kw


def _cfg(wal_dir, **over):
    return HermesConfig(**dataclasses.asdict(RefConfig(**_kw(wal_dir, **over))))


def _write_log(wal_cls, cfg, batches=3, per=4):
    """A sealed synthetic log: ``batches`` K_ROUND records of ``per``
    writes each."""
    wal = wal_cls(cfg)
    for b in range(batches):
        keys = np.arange(per, dtype=np.int32) + b * per
        wv = np.zeros((per, 6), np.int32)
        wv[:, 0] = 1000 + b
        wv[:, 1] = np.arange(per)
        wv[:, 3] = 7 * b + np.arange(per)
        wal.append_round(b, np.full(per, b, np.int64), keys,
                         np.ones(per, np.int64), np.zeros(per, np.int32),
                         wv, np.zeros(per, np.int32), b"")
    wal.note_remap(np.array([5, 6], np.int32), np.array([1, 2], np.int32))
    wal.sync()
    wal.close()
    return wal.segments()


def _same_scan(a, b):
    assert a["torn_tail"] == b["torn_tail"]
    assert a["headers"] == b["headers"]
    assert len(a["records"]) == len(b["records"])
    for x, y in zip(a["records"] + a["remaps"], b["records"] + b["remaps"]):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torch_wal_segments_cross_decode(tmp_path, writer):
    if writer == "port":
        segs = _write_log(GroupCommitWal, _cfg(tmp_path))
    else:
        segs = _write_log(RefWal, RefConfig(**_kw(tmp_path)))
    assert len(segs) == 1
    a = replay.read_records(str(tmp_path))
    _same_scan(a, ref_replay.read_records(str(tmp_path)))
    assert len(a["records"]) == 3 and len(a["remaps"]) == 1


def test_torch_wal_port_bytes_equal_reference(tmp_path):
    """The same appends give byte-identical segment files."""
    sa = _write_log(GroupCommitWal, _cfg(tmp_path / "a"))
    sb = _write_log(RefWal, RefConfig(**_kw(tmp_path / "b")))
    assert open(sa[0], "rb").read() == open(sb[0], "rb").read()


def _frame_offsets(path):
    data = open(path, "rb").read()
    offs, off = [], 0
    while off < len(data):
        _m, _a, _p, length, _c = codec.FRAME_HEADER.unpack(
            data[off:off + codec.FRAME_OVERHEAD])
        offs.append(off)
        off += codec.FRAME_OVERHEAD + length
    return offs, len(data)


def _both(wal_dir):
    """Each package's read of ``wal_dir``: the scan, or the refusal."""
    out = []
    for fn in (replay.read_records, ref_replay.read_records):
        try:
            out.append(("ok", fn(str(wal_dir))))
        except (WalCorrupt, ref_replay.WalCorrupt) as e:
            out.append(("refused", str(e)))
    return out


@pytest.mark.parametrize("crash_point", ["mid_record", "mid_frame_header",
                                         "mid_fsync_window"])
def test_torch_wal_torn_tail_like_reference(tmp_path, crash_point):
    seg = _write_log(GroupCommitWal, _cfg(tmp_path), batches=3)[0]
    offs, size = _frame_offsets(seg)
    cut = {"mid_record": size - 5, "mid_frame_header": offs[-1] + 3,
           "mid_fsync_window": offs[2] + codec.FRAME_OVERHEAD + 2}[crash_point]
    with open(seg, "r+b") as f:
        f.truncate(cut)
    (ka, a), (kb, b) = _both(tmp_path)
    assert ka == kb == "ok"
    _same_scan(a, b)
    assert a["torn_tail"] is True
    assert len(a["records"]) == (1 if crash_point == "mid_fsync_window"
                                 else 3)


def test_torch_wal_flipped_interior_byte_refused_like_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HERMES_FLIGHT_DIR", str(tmp_path / "flight"))
    seg = _write_log(GroupCommitWal, _cfg(tmp_path / "wal"))[0]
    offs, _ = _frame_offsets(seg)
    with open(seg, "r+b") as f:
        f.seek(offs[1] + codec.FRAME_OVERHEAD + 4)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    (ka, a), (kb, b) = _both(tmp_path / "wal")
    assert ka == kb == "refused" and a == b and "checksum" in a
    dumps = glob.glob(str(tmp_path / "flight" / "flight_*.json"))
    assert len(dumps) == 2  # one per package
    blob = json.dumps([json.load(open(d)) for d in dumps])
    assert "wal_checksum_mismatch" in blob and "header_hex" in blob


def test_torch_wal_torn_nonlast_segment_refused_like_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HERMES_FLIGHT_DIR", str(tmp_path / "flight"))
    cfg = _cfg(tmp_path)
    for b in range(2):  # two store generations: two segments
        wal = GroupCommitWal(cfg)
        wal.append_round(b, np.full(2, b, np.int64),
                         np.arange(2, dtype=np.int32),
                         np.full(2, b + 1, np.int64), np.zeros(2, np.int32),
                         np.zeros((2, 6), np.int32), np.zeros(2, np.int32),
                         b"")
        wal.sync()
        wal.close()
    seg0, _seg1 = wal.segments()
    with open(seg0, "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.truncate(f.tell() - 3)
    (ka, a), (kb, b) = _both(tmp_path)
    assert ka == kb == "refused" and a == b and "NON-last" in a


def test_torch_wal_header_mismatch_and_unknown_kind(tmp_path, monkeypatch):
    monkeypatch.setenv("HERMES_FLIGHT_DIR", str(tmp_path / "flight"))
    seg = _write_log(GroupCommitWal, _cfg(tmp_path / "wal"), batches=1)[0]
    scan = replay.read_records(str(tmp_path / "wal"))
    msgs = []
    for check, cfg in ((replay.check_headers, _cfg(None, n_keys=512)),
                       (ref_replay.check_headers,
                        RefConfig(**_kw(None, n_keys=512)))):
        with pytest.raises((WalCorrupt, ref_replay.WalCorrupt),
                           match="different config") as ei:
            check(scan["headers"], cfg)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with open(seg, "ab") as f:  # a CRC-valid frame around garbage
        f.write(codec.frame_pack(
            np.frombuffer(bytes([99]) * 40, np.uint8)).tobytes())
    (ka, a), (kb, b) = _both(tmp_path / "wal")
    assert ka == kb == "refused" and a == b and "unknown" in a


# -- the vectorised replay against the reference's record loop --------------


def _random_records(rng, n_rec, per, K, V, heap):
    recs = []
    for j in range(n_rec):
        key = rng.integers(0, K, per).astype(np.int32)
        ver = rng.integers(1, 6, per).astype(np.int64)
        fc = rng.integers(0, 8, per).astype(np.int32)
        wv = rng.integers(-99, 99, (per, V)).astype(np.int32)
        lens = (rng.integers(0, 40, per) if heap
                else np.zeros(per, np.int64)).astype(np.int32)
        blob = rng.integers(0, 256, int(lens.sum())).astype(np.uint8).tobytes()
        recs.append(dict(kind=1, lsn=j + 1, round_idx=j,
                         step=np.full(per, 10 + j, np.int64), key=key,
                         ver=ver, fc=fc, wv=wv, lens=lens, blob=blob))
    return recs


@pytest.mark.parametrize("heap", [False, True], ids=["words", "heap"])
def test_torch_wal_apply_records_equals_reference(heap):
    """Many records per key, out of timestamp order, over a table that
    already holds some of them: same counts, same table, same heap."""
    rng = np.random.default_rng(11)
    over = dict(max_value_bytes=64, heap_bytes=1 << 14, value_words=4) \
        if heap else {}
    rc = RefConfig(**_kw(None, n_keys=32, **over))
    cfg = HermesConfig(**dataclasses.asdict(rc))
    ref, port = RefKVS(rc), KVS(cfg, device="cpu")
    seed = _random_records(rng, 2, 8, 32, cfg.value_words, heap)
    recs = _random_records(rng, 6, 16, 32, cfg.value_words, heap)
    for kv in (ref, port):  # an older table state: the seed records
        rh = kv.heap
        assert (ref_replay if kv is ref else replay).apply_records(
            kv.rt, seed, heap=rh)[0] > 0
    got = replay.apply_records(port.rt, recs, heap=port.heap)
    want = ref_replay.apply_records(ref.rt, recs, heap=ref.heap)
    assert got == want and 0 < got[0] < 96 and got[1] > 0
    a = convert.fast_state_to_numpy(port.rt.fs).table
    b = jax.device_get(ref.rt.fs.table)
    np.testing.assert_array_equal(a.vpts, np.asarray(b.vpts))
    np.testing.assert_array_equal(a.bank, np.asarray(b.bank))
    assert int(port.rt.fs.table.vpts[-1]) == 0  # the drop row untouched
    if heap:
        assert port.heap._cursor == ref.heap._cursor
        np.testing.assert_array_equal(port.heap._mirror, ref.heap._mirror)
    # idempotent: a second replay applies nothing
    assert replay.apply_records(port.rt, recs, heap=port.heap) == (0, 96)


@pytest.mark.parametrize("heap", [False, True], ids=["words", "heap"])
def test_torch_wal_apply_records_sharded_replicas_equals_reference(heap):
    """``apply_records(replicas=)`` on the sharded engine: the seed
    records land in copy 1 only, so the copies differ; the replay into
    copies 0 and 1 applies a record when it beats the row of either and
    writes each copy's own winners.  Same counts, same copies, same heap
    as the reference's record loop; the copy not named is untouched."""
    from jax.sharding import Mesh

    from hermes_tpu_torch.core import faststep as fst

    rng = np.random.default_rng(12)
    over = dict(max_value_bytes=64, heap_bytes=1 << 14, value_words=4) \
        if heap else {}
    rc = RefConfig(**_kw(None, n_keys=32, **over))
    cfg = HermesConfig(**dataclasses.asdict(rc))
    mesh = Mesh(np.array(jax.devices()[:3]), ("replica",))
    ref = RefKVS(rc, backend="sharded", mesh=mesh)
    port = KVS(cfg, backend="sharded", device="cpu")
    seed = _random_records(rng, 2, 8, 32, cfg.value_words, heap)
    recs = _random_records(rng, 6, 16, 32, cfg.value_words, heap)
    for kv, mod in ((ref, ref_replay), (port, replay)):
        assert mod.apply_records(kv.rt, seed, heap=kv.heap,
                                 replicas=[1])[0] > 0
    K = cfg.n_keys
    v = fst.copies(port.rt.fs.table.vpts, K)
    assert not torch.equal(v[0], v[1]) and torch.equal(v[0], v[2])
    before2 = fst.copies(port.rt.fs.table.bank, K)[2].clone()
    got = replay.apply_records(port.rt, recs, heap=port.heap,
                               replicas=[0, 1])
    want = ref_replay.apply_records(ref.rt, recs, heap=ref.heap,
                                    replicas=[0, 1])
    assert got == want and got[0] > 0 and got[1] > 0
    a = convert.fast_state_to_numpy(port.rt.fs, n_copies=3).table
    b = jax.device_get(ref.rt.fs.table)
    np.testing.assert_array_equal(a.vpts, np.asarray(b.vpts))
    np.testing.assert_array_equal(a.bank, np.asarray(b.bank))
    assert torch.equal(fst.copies(port.rt.fs.table.bank, K)[2], before2)
    if heap:
        assert port.heap._cursor == ref.heap._cursor
        np.testing.assert_array_equal(port.heap._mirror, ref.heap._mirror)
    assert replay.apply_records(port.rt, recs, heap=port.heap,
                                replicas=[0, 1]) == (0, 96)


# -- the KVS surface -----------------------------------------------------------


@pytest.mark.parametrize("mode,label", [
    ("commit", "commit"),
    ("round", "round:not-fsynced-at-resolve"),
    ("off", "off:not-fsynced-at-resolve"),
    (None, None),
])
def test_torch_wal_durability_labels(tmp_path, mode, label):
    cfg = (_cfg(tmp_path / mode, wal_sync=mode) if mode else _cfg(None))
    kvs = KVS(cfg, device="cpu")
    fut = kvs.put(0, 0, key=1, value=[1, 2, 3, 4])
    assert kvs.run_until([fut])
    assert fut.result().kind == "put" and fut.result().durability == label
    bf = kvs.submit_batch(np.array([KVS.PUT], np.int32), np.array([2]),
                          np.array([[9, 9, 9, 9]], np.int32))
    assert kvs.run_batch(bf)
    assert bf.completion(0).durability == label
    if kvs.wal is not None:
        kvs.wal.close()


def test_torch_wal_backpressure_sheds_retry_after(tmp_path):
    kvs = KVS(_cfg(tmp_path, wal_sync="round", wal_dirty_window=4),
              device="cpu")
    wal = kvs.wal
    wal._stop.set()
    wal.kick()
    wal._flusher_t.join(timeout=10)
    assert not wal._flusher_t.is_alive()
    futs = [kvs.put(0, s, key=s, value=[s, 0, 0, 0]) for s in range(8)]
    assert kvs.run_until(futs)
    assert wal.dirty_records() > 4 and wal.backpressured()
    shed = kvs.put(0, 0, key=99, value=[9, 9, 9, 9])
    assert shed.result().kind == "retry_after"
    bf = kvs.submit_batch(np.array([KVS.PUT] * 3, np.int32), np.arange(3),
                          np.zeros((3, 4), np.int32))
    kvs.step()
    assert all(bf.completion(i).kind == "retry_after" for i in range(3))
    assert kvs.wal_shed >= 4
    g = kvs.get(1, 1, 0)  # reads still flow
    assert kvs.run_until([g]) and g.result().kind == "get"
    with pytest.raises(WalError, match="dead|failed"):
        wal.sync(timeout=1.0)


def test_torch_wal_segment_rotation_and_truncate(tmp_path):
    wal = GroupCommitWal(_cfg(tmp_path, wal_segment_bytes=4096))
    per = 16
    for b in range(40):
        wv = np.zeros((per, 6), np.int32)
        wv[:, 3] = b
        wal.append_round(b, np.full(per, b, np.int64),
                         np.arange(per, dtype=np.int32),
                         np.full(per, 1 + b, np.int64),
                         np.zeros(per, np.int32), wv,
                         np.zeros(per, np.int32), b"")
    wal.sync()
    n_before = len(wal.segments())
    assert n_before > 1, "rotation never fired"
    _same_scan(replay.read_records(str(tmp_path)),
               ref_replay.read_records(str(tmp_path)))
    wal.truncate_to(39)
    assert 1 <= len(wal.segments()) < n_before
    assert wal.stats()["retired_segments"] == n_before - len(wal.segments())
    assert replay.read_records(str(tmp_path))["records"]
    wal.close()


@pytest.mark.parametrize("record", [True, "array"])
def test_torch_wal_replay_idempotent_across_snapshot(tmp_path, record):
    from hermes_tpu_torch import snapshot
    from hermes_tpu_torch.chaos import recover_store

    wal_dir = tmp_path / "wal"
    kvs = KVS(_cfg(wal_dir), record=record, device="cpu")
    f1 = [kvs.put(0, s, key=10 + s, value=[100 + s, 0, 0, s])
          for s in range(4)]
    assert kvs.run_until(f1)
    snap = str(tmp_path / "snap.npz")
    snapshot.save(snap, kvs)
    f2 = [kvs.put(1, s, key=20 + s, value=[200 + s, 0, 0, s])
          for s in range(4)]
    assert kvs.run_until(f2)
    kvs.wal.sync()
    kvs.wal.close()
    kvs2, summary = recover_store(_cfg(wal_dir), snapshot_path=snap,
                                  record=record, device="cpu")
    assert summary["applied"] + summary["skipped"] == summary["records"]
    assert summary["applied"] >= 4
    for s in range(4):
        g1, g2 = kvs2.get(2, 0, 10 + s), kvs2.get(2, 1, 20 + s)
        assert kvs2.run_until([g1, g2])
        assert g1.result().value == [100 + s, 0, 0, s]
        assert g2.result().value == [200 + s, 0, 0, s]
    before = kvs2.rt.fs.table.vpts.clone()
    kvs2.flush()
    kvs2.wal.sync()
    scan = replay.read_records(str(wal_dir))
    n = sum(r["key"].shape[0] for r in scan["records"])
    assert replay.apply_records(kvs2.rt, scan["records"]) == (0, n)
    assert torch.equal(before, kvs2.rt.fs.table.vpts)
    kvs2.wal.close()


# -- recover_store, port against reference, from one log -------------------


def _history_drive(kvs, heap):
    """Puts over a few hot keys, per-op; returns (future, payload)."""
    rng = np.random.default_rng(9)
    out = []
    for i in range(60):
        r, s, k = (int(rng.integers(3)), int(rng.integers(8)),
                   int(rng.integers(24)))
        v = (rng.integers(0, 256, int(rng.integers(1, 40)))
             .astype(np.uint8).tobytes() if heap else [i, -i, 1, 2])
        out.append((kvs.put(r, s, k, v), v))
        if i % 6 == 5:
            kvs.step()
    assert kvs.run_until([f for f, _ in out], 600)
    kvs.flush()
    return out


@pytest.mark.parametrize("heap", [False, True], ids=["words", "heap"])
def test_torch_wal_recover_store_equals_reference(tmp_path, heap):
    from hermes_tpu.chaos.recovery import recover_store as ref_recover
    from hermes_tpu_torch.chaos import recover_store

    over = dict(max_value_bytes=64, heap_bytes=1 << 14, value_words=4) \
        if heap else {}
    kvs = KVS(_cfg(tmp_path / "wal", **over), record=True, device="cpu")
    drive = _history_drive(kvs, heap)
    kvs.wal.sync()
    kvs.wal.close()  # the segments stay, as after a kill -9
    committed = [f.result().uid for f, _ in drive]
    assert all(f.result().kind == "put" for f, _ in drive)
    scan = replay.read_records(str(tmp_path / "wal"))
    shutil.copytree(tmp_path / "wal", tmp_path / "wal_ref")
    port, ps = recover_store(_cfg(tmp_path / "wal", **over), record=True,
                             device="cpu")
    ref, rs = ref_recover(RefConfig(**_kw(tmp_path / "wal_ref", **over)),
                          record=True)
    for k in ("records", "applied", "skipped", "torn_tail", "old_segments",
              "resume_step"):
        assert ps[k] == rs[k], k
    a = convert.fast_state_to_numpy(port.rt.fs).table
    b = jax.device_get(ref.rt.fs.table)
    np.testing.assert_array_equal(a.vpts, np.asarray(b.vpts))
    np.testing.assert_array_equal(a.bank, np.asarray(b.bank))
    if heap:
        np.testing.assert_array_equal(port.heap._mirror, ref.heap._mirror)
    # every committed write is in the log, and every key serves its
    # newest committed value (the newest protocol timestamp)
    assert lin.committed_write_lost(committed,
                                    crashdrive.log_ops(scan["records"])) == []
    latest = {}
    for f, v in drive:
        c = f.result()
        if c.key not in latest or c.ts > latest[c.key][0]:
            latest[c.key] = (c.ts, v)
    keys = sorted(latest)
    res = port.multi_get(np.asarray(keys))
    for j, k in enumerate(keys):
        if heap:
            assert res.data[j] == latest[k][1]
        else:
            assert res.value[j].tolist() == latest[k][1]
    nf = port.put(0, 0, 1, b"new" if heap else [7, 7, 7, 7])
    assert port.run_until([nf]) and nf.result().kind == "put"
    port.wal.close()
    ref.wal.close()


def test_torch_wal_commit_gate_with_more_ops_than_slots(tmp_path):
    """Under wal_sync='commit' at pipeline depth 1 a harvested round
    parks until its log batch is durable.  A batch larger than the slot
    count must not re-inject a parked slot before its resolution lands
    (the reference's ``_inject_batches`` only guards that at depth >= 2
    and raises KeyError in the deferred resolve): every op resolves, each
    with its own key's value."""
    kvs = KVS(_cfg(tmp_path, n_sessions=4), device="cpu")
    n = 100  # 3 replicas x 4 sessions = 12 slots
    keys = np.random.default_rng(2).choice(256, n, replace=False)
    vals = np.zeros((n, 4), np.int32)
    vals[:, 0] = keys
    vals[:, 1] = np.arange(n)
    bf = kvs.submit_batch(np.full(n, KVS.PUT, np.int32), keys, vals)
    assert kvs.run_batch(bf)
    assert (bf.code == 2).all()  # types.C_WRITE
    res = kvs.multi_get(keys)
    np.testing.assert_array_equal(res.value, vals)
    assert all(bf.completion(i).durability == "commit" for i in range(n))
    kvs.wal.close()
