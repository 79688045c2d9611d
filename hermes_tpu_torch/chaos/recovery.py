"""Crash-restart recovery: the port of ``hermes_tpu/chaos/recovery.py``.

``restart_replica`` models a full host-crash of one replica end to end:

  1. **Crash.** The replica's volatile state dies: every in-flight client
     op is lost.  In-flight UPDATES were already broadcast, so the
     cluster may still finish them via replay though no client hears
     back: they are folded into the recorded history as ``maybe_w``
     BEFORE the session rows are wiped, and wiped sessions step past the
     lost op so a restarted slot never re-mints its write uid.  On a KVS
     the dead replica's futures resolve as ``kind='lost'``.
  2. **Fence + remove.** A crashed replica must not serve reads.
  3. **Restore.** With ``snapshot_path`` the archive is verified first (a
     torn or foreign snapshot is refused on the timeline and recovery
     falls back to peer transfer).  The batched table is shared and
     survives the crash, so every row of a verified snapshot counts as
     current; on the sharded engine the rows of the replica's archived
     copy whose packed ts equals the donor's count.
  4. **Rejoin.** ``join(replica, donor)`` (sharded: the donor's copy is
     transferred into the rejoined one); with ``wal_dir`` the log's tail
     is replayed idempotently after it, into the rejoined copy only on
     the sharded engine.

``recover_store`` brings a whole killed store back from its WAL (and
optionally a snapshot) with zero committed writes lost.  ``wipe_volatile``
is the crash primitive the KVS's bounded retry also uses on single slots.
"""

from __future__ import annotations

import dataclasses
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from hermes_tpu_torch import snapshot as snapshot_lib
from hermes_tpu_torch.core import types as t


def wipe_volatile(rt, sess_mask, replay_mask=None) -> int:
    """Lose the volatile per-session (and optionally replay) state of the
    masked slots: ``sess_mask`` is ``(R, S)`` bool, ``replay_mask`` ``(R,
    replay_slots)`` bool.  Loaded ops (READ/ISSUE/INFL) on masked slots
    vanish and their sessions step past them.  Callers own the history
    fold (``recorder.fold_pending``), which must come BEFORE this wipe.
    Returns the number of client ops lost."""
    cfg = rt.cfg
    fs = rt.fs
    sess, replay = fs.sess, fs.replay
    dev = sess.status.device
    m = torch.as_tensor(np.asarray(sess_mask, bool)).to(dev)
    loaded = m & ((sess.status == t.S_READ) | (sess.status == t.S_ISSUE)
                  | (sess.status == t.S_INFL))
    op_idx = sess.op_idx + loaded.to(torch.int32)
    if cfg.wrap_stream:
        wiped_status = torch.full_like(sess.status, t.S_IDLE)
    else:
        wiped_status = torch.where(op_idx >= cfg.ops_per_session,
                                   t.S_DONE, t.S_IDLE).to(torch.int32)
    z = lambda a: torch.where(m, torch.zeros_like(a), a)
    new_sess = sess._replace(
        status=torch.where(m, wiped_status, sess.status),
        op_idx=op_idx,
        pts=z(sess.pts),
        acks=z(sess.acks),
        retries=z(sess.retries),
        issue_step=z(sess.issue_step),
    )
    new_replay = replay
    if replay_mask is not None:
        rm = torch.as_tensor(np.asarray(replay_mask, bool)).to(dev)
        new_replay = replay._replace(
            active=torch.where(rm, False, replay.active))
    rt.fs = fs._replace(sess=new_sess, replay=new_replay)
    return int(loaded.sum())


def _wipe_replica_volatile(rt, replica: int) -> int:
    """Full host-crash of one replica: every session and replay slot of
    ``replica`` loses its volatile state.  Returns the client ops lost."""
    cfg = rt.cfg
    sess_mask = np.zeros((cfg.n_replicas, cfg.n_sessions), bool)
    sess_mask[replica] = True
    replay_mask = np.zeros((cfg.n_replicas, cfg.replay_slots), bool)
    replay_mask[replica] = True
    return wipe_volatile(rt, sess_mask, replay_mask)


def _snapshot_rows_current(rt, replica: int, donor: int,
                           snapshot_path: str) -> Optional[int]:
    """FULLY verify the snapshot (manifest, every array checksum, config
    fingerprint) and count its rows still current for ``replica``.  The
    batched table is shared by every replica and survives the crash, so
    every row of a verified snapshot is current; on the sharded engine a
    row of the replica's archived copy is current when its packed ts
    equals the donor's (same ts, byte-identical row).  Returns None —
    with a ``snapshot_rejected`` timeline event — when the snapshot
    cannot be trusted."""
    try:
        snapshot_lib.verify_archive(snapshot_path, rt.cfg)
        K = rt.cfg.n_keys
        if rt.backend == "batched":
            return K
        with np.load(snapshot_path) as z:
            snap = np.asarray(
                z["state.table.vpts"])[replica * K:(replica + 1) * K]
        donor_rows = rt.copy_of(donor)[0].cpu().numpy()
        return int((snap == donor_rows).sum())
    except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:
        rt._trace("snapshot_rejected", replica=replica,
                  path=str(snapshot_path), reason=str(e)[:160])
        return None


def restart_replica(target, replica: int, donor: Optional[int] = None,
                    snapshot_path: Optional[str] = None,
                    wal_dir: Optional[str] = None) -> dict:
    """Full host-crash + recovery of ``replica`` on a FastRuntime or a KVS
    (see the module docstring).  ``donor`` defaults to the lowest live,
    unfrozen peer; ``snapshot_path`` opts into snapshot-seeded restore
    (peer transfer when the snapshot is invalid); ``wal_dir`` replays the
    durability log's tail after the join, idempotently.  Returns a summary
    dict (also the ``crash_restart`` obs event)."""
    kvs = None
    if hasattr(target, "rt") and hasattr(target, "index"):  # the KVS facade
        kvs, rt = target, target.rt
    else:
        rt = target
    cfg = rt.cfg
    if not (0 <= replica < cfg.n_replicas):
        raise ValueError(f"replica {replica} out of range")

    # completions the device already produced are pre-crash facts
    rt.flush_pipeline()

    # 1. crash: fold the history first, then lose the volatile state
    if rt.recorder is not None:
        rt.recorder.fold_pending(rt._sess_view(), replica)
    lost_client = kvs._on_replica_crash(replica) if kvs is not None else 0
    lost_ops = _wipe_replica_volatile(rt, replica)

    # 2. fence + remove (unless already ejected)
    if (int(rt.live[0]) >> replica) & 1:
        rt.remove(replica)
    else:
        rt.frozen[replica] = True
        rt._ctl_dirty = True

    if donor is None:
        live = int(rt.live[0])
        cands = [d for d in range(cfg.n_replicas)
                 if d != replica and (live >> d) & 1 and not rt.frozen[d]]
        if not cands:
            raise RuntimeError(
                "restart_replica needs a live unfrozen donor; none left")
        donor = cands[0]

    # 3. restore source: a verified snapshot, else peer transfer
    rows_current = None
    if snapshot_path is not None:
        rows_current = _snapshot_rows_current(rt, replica, donor,
                                              snapshot_path)
    source = "snapshot" if rows_current is not None else "transfer"

    # 4. rejoin; the live coordinator / replay scan re-validates
    rt.join(replica, donor)

    # 5. WAL tail catch-up, idempotent by packed ts
    wal_applied = wal_skipped = None
    if wal_dir is not None:
        from hermes_tpu_torch.wal import replay as wal_replay

        scan = wal_replay.read_records(wal_dir, obs=rt.obs)
        wal_replay.check_headers(scan["headers"], cfg, obs=rt.obs)
        wal_applied, wal_skipped = wal_replay.apply_records(
            rt, scan["records"], heap=getattr(kvs, "heap", None),
            replicas=[replica])

    summary = dict(replica=replica, donor=donor, source=source,
                   lost_ops=lost_ops, lost_client_futures=lost_client,
                   rows_current=rows_current)
    if wal_dir is not None:
        summary.update(wal_applied=wal_applied, wal_skipped=wal_skipped)
    rt._trace("crash_restart", **summary)
    return summary


def recover_store(cfg, wal_dir: Optional[str] = None,
                  backend: str = "batched",
                  snapshot_path: Optional[str] = None, record=False,
                  sparse_keys: bool = False, device="cuda"):
    """Whole-store recovery with zero committed writes lost:

      1. parse and triage the WAL segments FIRST (a torn tail truncates
         cleanly, a torn interior refuses loudly with a flight dump);
      2. build a fresh KVS on ``device`` with the same config and
         ``wal_dir`` (its log continues the segment numbering);
      3. restore the snapshot if given (verified, all-or-nothing);
      4. replay the log into the table, idempotent by packed ts, minting
         fresh heap refs from the logged extent bytes;
      5. resume ``step_idx`` past every replayed commit step;
      6. re-append the surviving records into the FRESH log and retire
         the old segments, so the new log alone covers the state.

    Returns ``(kvs, summary)``."""
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.wal import replay as wal_replay

    t0 = time.perf_counter()
    wal_dir = wal_dir if wal_dir is not None else cfg.wal_dir
    if wal_dir is None:
        raise ValueError("recover_store needs a wal_dir (argument or "
                         "cfg.wal_dir)")
    cfg = dataclasses.replace(cfg, wal_dir=wal_dir)
    scan = wal_replay.read_records(wal_dir)
    wal_replay.check_headers(scan["headers"], cfg)
    kvs = KVS(cfg, backend=backend, record=record, sparse_keys=sparse_keys,
              device=device)
    if snapshot_path is not None:
        snapshot_lib.load(snapshot_path, kvs)
    applied, skipped = wal_replay.apply_records(
        kvs.rt, scan["records"], heap=kvs.heap)
    max_step = max((int(r["step"].max()) for r in scan["records"]
                    if r["step"].size), default=-1)
    kvs.rt.step_idx = max(kvs.rt.step_idx, max_step + 1)
    kvs.rt._ctl_dirty = True
    for rec in scan["records"]:
        kvs.wal.append_round(rec["round_idx"], rec["step"], rec["key"],
                             rec["ver"], rec["fc"], rec["wv"],
                             rec["lens"], rec["blob"])
    kvs.wal.sync()
    kvs.wal.retire_segments(scan["segments"])
    summary = dict(records=sum(int(r["key"].shape[0])
                               for r in scan["records"]),
                   applied=applied, skipped=skipped,
                   torn_tail=bool(scan["torn_tail"]),
                   old_segments=len(scan["segments"]),
                   resume_step=int(kvs.rt.step_idx),
                   seconds=round(time.perf_counter() - t0, 3))
    kvs.rt._trace("wal_recover", **summary)
    return kvs, summary
