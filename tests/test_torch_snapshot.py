"""The port's snapshots (hermes_tpu_torch/snapshot.py) against the
reference's (hermes_tpu/snapshot.py): an archive written by either
package loads in the other, for a FastRuntime and for a KVS with sparse
keys and the value heap, and the state it restores is the saved one in
the reference's shapes (the port's drop row cut on the way out, re-added
on the way in); a resume is deterministic; a config mismatch, a
truncated archive and a torn manifest are refused before any mutation;
the rebase bookkeeping and the never-rebased sentinel are kept; the
quiescence trap gives the reference's counts."""

import dataclasses
import zipfile

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import snapshot as ref_snap
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import convert, snapshot
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _cfgs(**over):
    kw = dict(n_replicas=3, n_keys=128, n_sessions=8, replay_slots=4,
              ops_per_session=16, workload=RefWL(seed=61))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _ref_tree(rt):
    return jax.device_get(rt.fs)


def _assert_state_equal(port_fs, ref_fs):
    a = convert.fast_state_to_numpy(port_fs)
    for part_a, part_b in zip(a, ref_fs):
        for f, x, y in zip(part_a._fields, part_a, part_b):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torch_snapshot_runtime_cross_load(tmp_path, writer):
    rc, cfg = _cfgs()
    ref, port = RefRuntime(rc), FastRuntime(cfg, device="cpu")
    ref.run(7)
    port.run(7)
    _assert_state_equal(port.fs, _ref_tree(ref))
    p = str(tmp_path / "snap.npz")
    if writer == "port":
        snapshot.save(p, port)
        dst_ref, dst_port = RefRuntime(rc), FastRuntime(cfg, device="cpu")
    else:
        ref_snap.save(p, ref)
        dst_ref, dst_port = RefRuntime(rc), FastRuntime(cfg, device="cpu")
    assert snapshot.read_manifest(p) == ref_snap.read_manifest(p)
    snapshot.load(p, dst_port)
    ref_snap.load(p, dst_ref)
    assert dst_port.step_idx == dst_ref.step_idx == 7
    _assert_state_equal(dst_port.fs, _ref_tree(dst_ref))
    assert int(dst_port.fs.table.vpts[-1]) == 0  # the drop row re-added
    dst_port.run(10)
    dst_ref.run(10)
    _assert_state_equal(dst_port.fs, _ref_tree(dst_ref))


def _assert_sharded_equal(port_fs, ref_fs, n):
    a = convert.fast_state_to_numpy(port_fs, n_copies=n)
    for part_a, part_b in zip(a, jax.device_get(ref_fs)):
        for f, x, y in zip(part_a._fields, part_a, part_b):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torch_snapshot_sharded_cross_load(tmp_path, writer):
    """The sharded engine's full archive: every replica's copy in the
    reference's (R*K,) rows, each copy's own drop row cut and re-added;
    written by either package it loads in the other (copies that differ
    included: replica 2 was frozen through the replay scan), the restored
    runs go on equal, and the archive is refused by a batched runtime."""
    from jax.sharding import Mesh

    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core.group import LocalGroup

    rc, cfg = _cfgs(replay_age=1, replay_scan_every=2)
    mesh = Mesh(np.array(jax.devices()[:3]), ("replica",))
    mk_ref = lambda: RefRuntime(rc, backend="sharded", mesh=mesh)
    mk_port = lambda: FastRuntime(cfg, backend="sharded",
                                  group=LocalGroup("cpu"))
    ref, port = mk_ref(), mk_port()
    for rt in (ref, port):
        rt.run(2)
        jax.block_until_ready(ref.fs)
        rt.freeze(2)
        rt.run(5)
    _assert_sharded_equal(port.fs, ref.fs, 3)
    bank = fst.copies(port.fs.table.bank, cfg.n_keys)
    assert not torch.equal(bank[2], bank[0]), "the copies never parted"
    p = str(tmp_path / "snap.npz")
    (snapshot if writer == "port" else ref_snap).save(p, port if writer
                                                      == "port" else ref)
    with np.load(p) as z:
        assert z["state.table.vpts"].shape == (3 * cfg.n_keys,)
    dst_ref, dst_port = mk_ref(), mk_port()
    snapshot.load(p, dst_port)
    ref_snap.load(p, dst_ref)
    _assert_sharded_equal(dst_port.fs, dst_ref.fs, 3)
    for r in range(3):  # every drop row re-added zeroed
        assert int(dst_port.fs.table.vpts[r * (cfg.n_keys + 1)
                                          + cfg.n_keys]) == 0
    for rt in (dst_ref, dst_port):
        jax.block_until_ready(dst_ref.fs)
        rt.thaw(2)
        rt.run(10)
    _assert_sharded_equal(dst_port.fs, dst_ref.fs, 3)
    batched = FastRuntime(cfg, device="cpu")
    with pytest.raises(ValueError, match="1 table copy"):
        snapshot.load(p, batched)


def test_torch_snapshot_port_archive_equals_reference_members(tmp_path):
    """Every member the port writes has the reference's checksum."""
    rc, cfg = _cfgs()
    ref, port = RefRuntime(rc), FastRuntime(cfg, device="cpu")
    ref.run(5)
    port.run(5)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    snapshot.save(pa, port)
    ref_snap.save(pb, ref)
    ma, mb = snapshot.read_manifest(pa), ref_snap.read_manifest(pb)
    assert ma == mb


def _kvs_drive(kvs, heap, sparse):
    rng = np.random.default_rng(4)
    keys = (rng.integers(0, 1 << 62, 24).astype(np.uint64) if sparse
            else rng.choice(64, 24, replace=False))
    futs = []
    for i, k in enumerate(keys):
        v = (bytes([i]) * (i + 1) if heap else [i, -i])
        futs.append(kvs.put(i % 3, i % 4, int(k), v))
    assert kvs.run_until(futs)
    kvs.flush()
    return keys


@pytest.mark.parametrize("mode", ["dense", "sparse", "heap"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_torch_snapshot_kvs_cross_load(tmp_path, writer, mode):
    heap, sparse = mode == "heap", mode == "sparse"
    over = dict(n_keys=64, n_sessions=4, value_words=6 if not heap else 3,
                replay_slots=8)
    if heap:
        over.update(max_value_bytes=64, heap_bytes=1 << 12)
    rc, cfg = _cfgs(**over)
    src = (KVS(cfg, sparse_keys=sparse, device="cpu") if writer == "port"
           else RefKVS(rc, sparse_keys=sparse))
    keys = _kvs_drive(src, heap, sparse)
    p = str(tmp_path / "kvs.npz")
    (snapshot if writer == "port" else ref_snap).save(p, src)
    port = KVS(cfg, sparse_keys=sparse, device="cpu")
    ref = RefKVS(rc, sparse_keys=sparse)
    snapshot.load(p, port)
    ref_snap.load(p, ref)
    _assert_state_equal(port.rt.fs, _ref_tree(ref.rt))
    np.testing.assert_array_equal(port._uval, ref._uval)
    if sparse:
        np.testing.assert_array_equal(port.index._rev, ref.index._rev)
        assert port.index.n_used == ref.index.n_used
    if heap:
        np.testing.assert_array_equal(port.heap._mirror, ref.heap._mirror)
        assert port.heap._cursor == ref.heap._cursor
    a, b = port.multi_get(keys), ref.multi_get(keys)
    np.testing.assert_array_equal(a.value, b.value)
    assert a.data == b.data
    # both keep serving, the same way
    fa, fb = port.put(0, 0, int(keys[0]), b"z" if heap else [5]), \
        ref.put(0, 0, int(keys[0]), b"z" if heap else [5])
    assert port.run_until([fa]) and ref.run_until([fb])
    assert dataclasses.astuple(fa.result())[:8] == \
        dataclasses.astuple(fb.result())[:8]


def test_torch_snapshot_resume_deterministic(tmp_path):
    _, cfg = _cfgs()
    a = FastRuntime(cfg, device="cpu")
    a.run(7)
    p = str(tmp_path / "snap.npz")
    snapshot.save(p, a)
    b = FastRuntime(cfg, device="cpu")
    snapshot.load(p, b)
    assert b.step_idx == 7
    a.run(10)
    b.run(10)
    for x, y in zip(convert.fast_state_to_numpy(a.fs),
                    convert.fast_state_to_numpy(b.fs)):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def _refusals(tmp_path, pkg, kvs_cls, cfg, mk):
    """Config mismatch, truncated archive and torn manifest: the messages
    of one package."""
    src = mk(kvs_cls, cfg)
    assert src.run_until([src.put(0, 0, 3, [7])])
    p = str(tmp_path / f"{pkg.__name__}.npz")
    pkg.save(p, src)
    msgs = []
    other = mk(kvs_cls, dataclasses.replace(cfg, n_keys=128))
    with pytest.raises(ValueError) as ei:
        pkg.load(p, other)
    msgs.append(str(ei.value))
    trunc = p + ".trunc.npz"
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(trunc, "w") as zout:
        victim = [n for n in zin.namelist() if n.startswith("state.")][0]
        for name in zin.namelist():
            if name != victim:
                zout.writestr(name, zin.read(name))
    torn = p + ".torn.npz"
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(torn, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name.startswith("meta.manifest"):
                data = data[:-7]  # the manifest's JSON bytes, cut short
            zout.writestr(name, data)
    for bad in (trunc, torn):
        target = mk(kvs_cls, cfg)
        before = (target._op.copy(), target._key.copy(), target.rt.step_idx)
        with pytest.raises(ValueError) as ei:
            pkg.load(bad, target)
        msgs.append(str(ei.value).split(":")[0])
        np.testing.assert_array_equal(target._op, before[0])
        np.testing.assert_array_equal(target._key, before[1])
        assert target.rt.step_idx == before[2]
    return msgs


def test_torch_snapshot_refusals_like_reference(tmp_path):
    rc, cfg = _cfgs(n_keys=64, value_words=4, ops_per_session=16)
    got = _refusals(tmp_path, snapshot, KVS, cfg,
                    lambda k, c: k(c, device="cpu"))
    want = _refusals(tmp_path, ref_snap, RefKVS, rc, lambda k, c: k(c))
    assert got[1:] == want[1:]
    assert "fingerprint mismatch" in got[0] and "fingerprint mismatch" in \
        want[0]
    assert "incomplete" in got[1]


def test_torch_snapshot_rebase_bookkeeping_and_sentinel(tmp_path):
    rc, cfg = _cfgs(n_keys=32, wrap_stream=True,
                    workload=RefWL(seed=66, read_frac=0.0))
    a = FastRuntime(cfg, device="cpu")
    a.run(5)
    p = str(tmp_path / "never.npz")
    snapshot.save(p, a)
    with np.load(p) as z:
        assert "ctl.ver_base" in z and z["ctl.ver_base"].size == 0
    b = FastRuntime(cfg, device="cpu")
    snapshot.load(p, b)
    assert b._ver_base is None and b.step_idx == 5
    a.run(25)
    assert a.rebase_versions() > 0 and a._ver_base is not None
    snapshot.save(p, a)
    with np.load(p) as z:
        assert z["ctl.ver_base"].size == cfg.n_keys
    ref = RefRuntime(rc)
    ref_snap.load(p, ref)  # the reference takes the port's bookkeeping
    b = FastRuntime(cfg, device="cpu")
    snapshot.load(p, b)
    for rt in (ref, b):
        assert rt.rebases == a.rebases
        assert rt._next_rebase_at == a._next_rebase_at
        np.testing.assert_array_equal(rt._ver_base, a._ver_base)
    old = str(tmp_path / "old.npz")
    drop = ("ctl.ver_base", "ctl.rebases", "ctl.next_rebase_at",
            "ctl.quiesce")
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(old, "w") as zout:
        for name in zin.namelist():
            if not name.startswith(drop):
                zout.writestr(name, zin.read(name))
    with pytest.raises(ValueError, match="rebase"):
        snapshot.load(old, b)


def test_torch_snapshot_quiescence_trap_like_reference(tmp_path):
    rc, cfg = _cfgs(n_keys=64, n_sessions=4, value_words=6, replay_slots=8)
    msgs = []
    for pkg, kv in ((snapshot, KVS(cfg, sparse_keys=True, device="cpu")),
                    (ref_snap, RefKVS(rc, sparse_keys=True))):
        kv.put(0, 0, 42, [1])
        kv.put(0, 0, 43, [1])
        kv.submit_batch(np.full(3, KVS.PUT, np.int32), np.arange(3),
                        np.ones((3, 1), np.int32))
        with pytest.raises(ValueError, match="quiescent") as ei:
            pkg.save(str(tmp_path / "no.npz"), kv)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "0 op(s) in flight, 2 queued, 3 unresolved" in msgs[0]
