"""Crash recovery, the stuck-op watchdog and the bounded retry of the
port against the reference: ``restart_replica`` with a donor, from a
snapshot, with a torn snapshot falling back to peer transfer and with a
WAL tail gives the reference's state and summary and a green checker;
the watchdog reports the reference's ``stuck_ops`` once per op; a retry
drive that freezes a coordinator, lets its ops wedge and removes it
gives the reference's completions, ``retried_ops`` and verdict; and the
kill -9 drive of ``wal/crashdrive.py`` — a real SIGKILL of a child
process — recovers with no committed write lost."""

import dataclasses
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import snapshot as ref_snap
from hermes_tpu.chaos.recovery import restart_replica as ref_restart
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.obs import Observability as RefObs
from hermes_tpu_torch import convert, snapshot
from hermes_tpu_torch.chaos import recover_store, restart_replica
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS
from hermes_tpu_torch.obs import Observability
from hermes_tpu_torch.wal import crashdrive, replay

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(**over):
    kw = dict(n_replicas=5, n_keys=96, n_sessions=6, replay_slots=6,
              value_words=6, replay_age=6, replay_scan_every=4,
              rebroadcast_every=2, workload=RefWL(seed=23))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _state_equal(port, ref, n_copies=1):
    a = convert.fast_state_to_numpy(port.rt.fs, n_copies=n_copies)
    b = jax.device_get(ref.rt.fs)
    for pa, pb in zip(a, b):
        for f, x, y in zip(pa._fields, pa, pb):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)


def _load(kvs, seed, n=40, step_every=4):
    """Per-op puts and gets over hot keys, stepped now and then; leaves
    ops in flight."""
    rng = np.random.default_rng(seed)
    futs = []
    for i in range(n):
        r, s, k = (int(rng.integers(5)), int(rng.integers(6)),
                   int(rng.integers(16)))
        futs.append(kvs.get(r, s, k) if i % 3 == 2
                    else kvs.put(r, s, k, [i, -i, 3]))
        if i % step_every == step_every - 1:
            kvs.step()
    return futs


def _results(futs):
    return [dataclasses.astuple(f.result()) if f.done() else None
            for f in futs]


@pytest.mark.parametrize("source", ["donor", "snapshot", "torn", "wal"])
def test_torch_recovery_restart_replica_equals_reference(tmp_path, source):
    wal = source == "wal"
    rc, cfg = _cfgs(wal_dir=str(tmp_path / "wal") if wal else None,
                    wal_sync="round")
    if wal:
        rc = dataclasses.replace(rc, wal_dir=str(tmp_path / "rwal"))
    ref = RefKVS(rc, record=True)
    port = KVS(cfg, record=True, device="cpu")
    robs = ref.rt.attach_obs(RefObs())
    pobs = port.rt.attach_obs(Observability())
    snap = None
    if source in ("snapshot", "torn", "wal"):
        for kv, pkg, name in ((ref, ref_snap, "r.npz"),
                              (port, snapshot, "p.npz")):
            f = _load(kv, 1, n=12)
            assert kv.run_until(f)
            pkg.save(str(tmp_path / name), kv)
        snap = (str(tmp_path / "r.npz"), str(tmp_path / "p.npz"))
        if source == "torn":
            for p in snap:
                with open(p, "r+b") as f:
                    f.truncate(os.path.getsize(p) // 2)
    fr, fp = _load(ref, 2), _load(port, 2)
    for kv, fl in ((ref, fr), (port, fp)):
        # replica 4 frozen: replica 3's puts wedge in flight, and the
        # crash loses them
        kv.freeze(4)
        fl += [kv.put(3, s, 40 + s, [s, s, s]) for s in range(3)]
        kv.step()
        kv.step()
    kw_r = dict(snapshot_path=snap[0] if snap else None,
                wal_dir=rc.wal_dir if wal else None)
    kw_p = dict(snapshot_path=snap[1] if snap else None,
                wal_dir=cfg.wal_dir if wal else None)
    if wal:
        ref.wal.sync()
        port.wal.sync()
    sr = ref_restart(ref, 3, **kw_r)
    sp = restart_replica(port, 3, **kw_p)
    assert sp == sr
    assert sp["source"] == ("transfer" if source in ("donor", "torn")
                            else "snapshot")
    if source == "wal":
        assert sp["wal_applied"] == 0 and sp["wal_skipped"] > 0
    assert sp["lost_client_futures"] > 0
    _state_equal(port, ref)
    assert _results(fp) == _results(fr)
    assert [f.result().kind for f in fp if f.done()].count("lost") == \
        sp["lost_client_futures"]
    for kv in (ref, port):
        kv.rt.thaw(4)
        f = kv.put(3, 0, 5, [1, 2, 3])  # the restarted replica coordinates
        assert kv.run_until([f], 200)
        for _ in range(8):  # let in-flight replays settle
            kv.step()
    _state_equal(port, ref)
    assert port.rt.check().ok and ref.rt.check().ok
    ev = lambda recs: [(r["name"], r.get("replica"))
                       for r in recs if r["kind"] == "event"]
    assert ev(pobs.records) == ev(robs.records)
    if wal:
        port.wal.close()
        ref.wal.close()


@pytest.mark.parametrize("source", ["snapshot", "wal"])
def test_torch_recovery_sharded_restart_replica_equals_reference(tmp_path,
                                                                 source):
    """``restart_replica`` of one copy on the sharded engine: the donor's
    copy is transferred into replica 3's (its in-flight states folded to
    INVALID), the snapshot's rows current against the donor are counted,
    and the WAL tail is replayed into replica 3's copy only.  Same state,
    summary and completions as the reference's sharded KVS."""
    from jax.sharding import Mesh

    from hermes_tpu_torch.core import faststep as fst

    wal = source == "wal"
    rc, cfg = _cfgs(wal_dir=str(tmp_path / "wal") if wal else None,
                    wal_sync="round")
    if wal:
        rc = dataclasses.replace(rc, wal_dir=str(tmp_path / "rwal"))
    mesh = Mesh(np.array(jax.devices()[:5]), ("replica",))
    ref = RefKVS(rc, backend="sharded", mesh=mesh, record=True)
    port = KVS(cfg, backend="sharded", record=True, device="cpu")
    for kv, pkg, name in ((ref, ref_snap, "r.npz"),
                          (port, snapshot, "p.npz")):
        f = _load(kv, 1, n=12)
        assert kv.run_until(f)
        pkg.save(str(tmp_path / name), kv)
    fr, fp = _load(ref, 2), _load(port, 2)
    for kv, fl in ((ref, fr), (port, fp)):
        kv.freeze(4)
        fl += [kv.put(3, s, 40 + s, [s, s, s]) for s in range(3)]
        kv.step()
        kv.step()
    if wal:
        ref.wal.sync()
        port.wal.sync()
    sr = ref_restart(ref, 3, snapshot_path=str(tmp_path / "r.npz"),
                     wal_dir=rc.wal_dir if wal else None)
    sp = restart_replica(port, 3, snapshot_path=str(tmp_path / "p.npz"),
                         wal_dir=cfg.wal_dir if wal else None)
    assert sp == sr and sp["source"] == "snapshot"
    assert 0 < sp["rows_current"] <= cfg.n_keys
    _state_equal(port, ref, n_copies=5)
    assert _results(fp) == _results(fr)
    K = cfg.n_keys
    bank = fst.copies(port.rt.fs.table.bank, K)
    sst = fst._bank_to_i32(bank[..., 4:8])[..., 0]
    assert not torch.equal(sst[3], sst[0])  # the join re-stamped copy 3
    for kv in (ref, port):
        kv.rt.thaw(4)
        f = kv.put(3, 0, 5, [1, 2, 3])
        assert kv.run_until([f], 200)
        for _ in range(8):
            kv.step()
    _state_equal(port, ref, n_copies=5)
    assert port.rt.check().ok and ref.rt.check().ok
    if wal:
        port.wal.close()
        ref.wal.close()


def _watchdog(kv):
    obs = kv.rt.attach_obs((RefObs if isinstance(kv, RefKVS)
                            else Observability)())
    kv.freeze(1)
    kv.freeze(2)
    fut = kv.put(0, 0, 9, [42])
    fut2 = kv.put(0, 1, 10, [43])
    for _ in range(10):
        kv.step()
    stuck = [r for r in obs.records if r.get("name") == "stuck_op"]
    kv.rt.thaw(1)
    kv.rt.thaw(2)
    assert kv.run_until([fut, fut2], 200)
    return kv.stuck_ops, len(stuck), fut.result().kind


def test_torch_recovery_watchdog_equals_reference():
    rc, cfg = _cfgs(n_replicas=3, n_keys=64, n_sessions=4,
                    op_timeout_rounds=5)
    got = _watchdog(KVS(cfg, device="cpu"))
    want = _watchdog(RefKVS(rc))
    assert got == want
    diags, n_events, kind = got
    assert n_events == len(diags) == 2  # once per op
    assert diags[0]["phase"] == "ack-wait" and diags[0]["age_rounds"] > 5
    assert kind == "put"


def _retry_drive(kv):
    """Freeze coordinator 2, let its ops wedge past the timeout, remove
    it: the wedged per-op futures are salvaged onto healthy replicas."""
    futs = [kv.put(0, s, 20 + s, [s, 2]) for s in range(4)]
    kv.step()
    kv.freeze(2)
    futs += [kv.put(2, s, 10 + s, [s, 1]) for s in range(4)]
    futs += [kv.get(2, s, 20 + s) for s in range(2)]
    for _ in range(8):
        kv.step()
    kv.remove(2)
    assert kv.run_until(futs, 400)
    for _ in range(8):
        kv.step()
    v = kv.rt.check()
    return _results(futs), kv.retried_ops, len(kv.stuck_ops), v.ok


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_recovery_retry_drive_equals_reference(depth):
    rc, cfg = _cfgs(n_replicas=5, n_keys=64, n_sessions=4, value_words=4,
                    op_timeout_rounds=4, op_retry_limit=2,
                    pipeline_depth=depth, workload=RefWL(seed=9))
    ref = RefKVS(rc, record=True)
    if depth > 1:
        dispatch = ref.rt.dispatch_round

        def settled(*a, **k):
            comp = dispatch(*a, **k)
            jax.block_until_ready((comp, ref.rt.fs))
            return comp

        ref.rt.dispatch_round = settled
    want = _retry_drive(ref)
    got = _retry_drive(KVS(cfg, record=True, device="cpu"))
    assert got == want
    results, retried, n_stuck, ok = got
    assert retried > 0 and n_stuck > 0 and ok
    assert all(r is not None for r in results)


def test_torch_recovery_kill9_child_loses_no_committed_write(tmp_path):
    """The recipe ``chip_smoke.py``'s durable phase runs at the bench
    shape, here at a small one on the CPU: the child SIGKILLs itself in
    the middle of its last wave; recovery serves every committed write."""
    wal, wit = str(tmp_path / "wal"), str(tmp_path / "wit")
    p = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch.wal.crashdrive", wal, wit,
         "--shape", "small", "--wave-puts", "200", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    scan = replay.read_records(wal)
    kvs, summary = recover_store(crashdrive.crash_cfg("small", wal),
                                 device="cpu")
    assert summary["applied"] + summary["skipped"] == summary["records"]
    got = crashdrive.check_recovery(kvs, scan["records"], wit)
    assert got["witnessed"] == 800 and got["log_records"] >= 800
    f = kvs.put(0, 0, 1, [1, 2, 3, 4])
    assert kvs.run_until([f]) and f.result().durability == "commit"
    kvs.wal.close()
