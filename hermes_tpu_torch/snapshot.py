"""State snapshot / restore: the full-archive part of
``hermes_tpu/snapshot.py``, byte-compatible with it.

A snapshot is a plain ``.npz`` of the fast engine's state plus the
host-side control state (step index, epoch, live mask, frozen flags, the
rebase bookkeeping) and, for a ``kvs.KVS``, its staged stream arrays,
the ``KeyIndex`` and the value heap's log.  Archives are written in the
reference's shapes: the port's table drop row (``core/faststep.py``) is
cut off on the way out and re-added on the way in
(``convert.fast_state_to_numpy`` / ``fast_state_from_numpy``), so an
archive written by either package loads in the other.

Crash consistency: ``save`` writes the archive to a temp file, fsyncs it
and ``os.replace``s it into place (a crash mid-save leaves the previous
snapshot intact), and embeds a checksummed MANIFEST (format version,
scope, config fingerprint, step, flushed ring depth, per-array sha256).
``load`` verifies the manifest and every member it will read before any
mutation: a bit-rotted, truncated or foreign archive is refused and the
target is left as it was.

The sharded engine's archive holds every replica's table copy in the
reference's ``(R*K,)`` rows, each copy's own drop row cut and re-added;
it loads only into a sharded runtime (and a batched archive only into a
batched one), of one process.

Scope: every manifest declares what the archive HOLDS — ``scope:
"full"`` (the whole state, a crash-recovery archive) or ``scope:
"range:[lo,hi)"`` (just the table rows of a dense key-slot range, the
transfer archive of a live key-range migration, written by
``save_range``).  ``load`` refuses a range archive outright and
``load_range`` / ``read_range`` refuse a full one.  A range archive holds
the rows as the reference writes them (one copy's rows, no drop row), so
it too loads in either package.  The table's layout is the runtime's
(``rt.backend``, ``fst.copies``), never inferred from the shapes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from hermes_tpu_torch import convert
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st
# the bank rows of a range archive travel as int32 words in the byte order
# fst._bank_to_i32 defines on the device (transport/codec.py)
from hermes_tpu_torch.transport.codec import rows_to_words as _rows_to_i32
from hermes_tpu_torch.transport.codec import words_to_rows as _i32_to_rows

MANIFEST_KEY = "meta.manifest"
MANIFEST_VERSION = 1


def config_fingerprint(cfg) -> str:
    """Stable sha256 of the run config (the manifest's identity check)."""
    return hashlib.sha256(
        json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    ).hexdigest()


def _array_sha256(a) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def read_manifest(path: str) -> dict:
    """The snapshot's manifest dict; raises ValueError on archives
    without one."""
    with np.load(path) as z:
        if MANIFEST_KEY not in z:
            raise ValueError(
                "snapshot has no manifest (truncated archive?); refusing "
                "to trust unverifiable state")
        return json.loads(bytes(z[MANIFEST_KEY]).decode())


def _verify_npz(z) -> dict:
    """Manifest + per-array checksum verification over an OPEN npz: a
    bit-rotted, hand-edited or undeclared member is refused; a MISSING
    member is left to the caller's targeted checks.  Returns the
    manifest."""
    if MANIFEST_KEY not in z:
        raise ValueError(
            "snapshot has no manifest (truncated archive?); refusing to "
            "restore unverifiable state")
    manifest = json.loads(bytes(z[MANIFEST_KEY]).decode())
    if manifest.get("version") != MANIFEST_VERSION:
        raise ValueError(
            f"snapshot manifest version {manifest.get('version')} != "
            f"{MANIFEST_VERSION}; archive written by an incompatible build")
    declared = manifest.get("arrays", {})
    for k in z.files:
        if k == MANIFEST_KEY:
            continue
        if k not in declared:
            raise ValueError(
                f"snapshot archive carries undeclared array {k!r} "
                "(corrupt or hand-edited?)")
        if _array_sha256(z[k]) != declared[k]:
            raise ValueError(
                f"snapshot checksum mismatch on {k!r} (torn or corrupt "
                "archive); refusing to restore")
    return manifest


def verify_archive(path: str, cfg=None) -> dict:
    """Full verification WITHOUT mutation: manifest + every array
    checksum (+ config fingerprint when ``cfg`` is given).  Returns the
    manifest."""
    with np.load(path) as z:
        manifest = _verify_npz(z)
    if cfg is not None and manifest.get("config_sha256") != config_fingerprint(cfg):
        raise ValueError(
            "snapshot config fingerprint mismatch (manifest "
            f"{manifest.get('config_sha256', '?')[:12]}.. vs config "
            f"{config_fingerprint(cfg)[:12]}..)")
    return manifest


def _flatten(tree, prefix=""):
    out = {}
    if hasattr(tree, "_asdict"):
        for f, v in tree._asdict().items():
            out.update(_flatten(v, f"{prefix}{f}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _leaf_keys(prefix="state."):
    """Archive key names of the state tree, in the reference's order."""
    out = []
    for sub, cls in (("table", fst.FastTable), ("sess", fst.FastSess),
                     ("replay", fst.FastReplay), ("meta", st.Meta)):
        out += [f"{prefix}{sub}.{f}" for f in cls._fields]
    return out


def _split(target):
    """(kvs or None, runtime) of a KVS facade or a FastRuntime."""
    kvs, rt = ((target, target.rt)
               if hasattr(target, "rt") and hasattr(target, "index")
               else (None, target))
    if rt.group is not None and rt.group.world > 1:
        raise ValueError("a snapshot holds every replica's state: one "
                         "process only (a DistGroup rank holds some)")
    return kvs, rt


def save(path: str, rt) -> None:
    """Snapshot a FastRuntime, or a client ``KVS`` — which additionally
    captures the staged stream arrays, the KeyIndex in sparse-key mode
    and the heap log in heap mode.  A KVS must be QUIESCENT (no queued or
    in-flight client op): futures are host objects and cannot be
    serialized."""
    kvs, rt = _split(rt)
    if kvs is not None:
        kvs.flush()  # pipelined mode: land the deferred round's futures
        if kvs._inflight or kvs._queued_slots or kvs._bat:
            n_inflight = len(kvs._inflight)
            n_queued = sum(len(kvs._queues[k]) for k in kvs._queued_slots)
            n_batch = sum(len(b["bf"]) - b["bf"].done_count()
                          for b in kvs._bat.values())
            raise ValueError(
                f"snapshot requires a quiescent KVS: {n_inflight} op(s) in "
                f"flight, {n_queued} queued, {n_batch} unresolved batch "
                f"op(s) across {len(kvs._bat)} active batch(es); resolve "
                "them (run step()/run_until/run_batch) before saving"
            )
    # harvest in-flight ring rounds: the recorder must not miss
    # completions the restored run would re-record
    ring_flushed = rt.flush_pipeline()
    arrays = _flatten(convert.fast_state_to_numpy(
        rt.fs, n_copies=rt.n_copies), "state.")
    arrays["ctl.step_idx"] = np.int64(rt.step_idx)
    arrays["ctl.epoch"] = np.asarray(rt.epoch)
    arrays["ctl.live"] = np.asarray(rt.live)
    arrays["ctl.frozen"] = np.asarray(rt.frozen)
    # rebase bookkeeping: a never-rebased runtime writes a zero-length
    # ver_base sentinel (load keys on the shape)
    arrays["ctl.ver_base"] = (np.zeros(0, np.int64) if rt._ver_base is None
                              else np.asarray(rt._ver_base))
    arrays["ctl.rebases"] = np.int64(rt.rebases)
    arrays["ctl.next_rebase_at"] = np.int64(rt._next_rebase_at)
    arrays["ctl.quiesce"] = np.bool_(rt.quiesce)
    arrays["meta.cfg"] = np.frombuffer(
        json.dumps(dataclasses.asdict(rt.cfg)).encode(), dtype=np.uint8)
    if kvs is not None:
        arrays["kvs.op"] = kvs._op
        arrays["kvs.key"] = kvs._key
        arrays["kvs.uval"] = kvs._uval
        if kvs.index is not None:
            idx = kvs.index
            arrays["kvs.index.bucket_key"] = idx._bucket_key
            arrays["kvs.index.bucket_slot"] = idx._bucket_slot
            arrays["kvs.index.rev"] = idx._rev
            arrays["kvs.index.n_used"] = np.int64(idx.n_used)
        if kvs.heap is not None:
            h = kvs.heap
            arrays["kvs.heap.log"] = h._mirror[: h.used_bytes()].copy()
            arrays["kvs.heap.cursor"] = np.int64(h._cursor)
    manifest = dict(
        version=MANIFEST_VERSION,
        scope="full",
        config_sha256=config_fingerprint(rt.cfg),
        step=int(rt.step_idx),
        pipeline_depth=int(rt.cfg.pipeline_depth),
        ring_flushed=int(ring_flushed),
        arrays={k: _array_sha256(v) for k, v in arrays.items()},
    )
    _atomic_savez(path, arrays, manifest)
    if rt.wal is not None:
        # the snapshot now covers everything committed at or before
        # step_idx: sealed WAL segments wholly behind it are dropped
        rt.wal.truncate_to(int(rt.step_idx))


def _atomic_savez(path: str, arrays: dict, manifest: dict) -> None:
    """Embed the manifest and write tmp + fsync + rename."""
    arrays = dict(arrays)
    arrays[MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez's suffix rule, applied before the rename
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _state_tree(z):
    """The archive's state as a FastState of numpy arrays (reference
    shapes)."""
    def part(sub, cls):
        return cls(**{f: np.asarray(z[f"state.{sub}.{f}"])
                      for f in cls._fields})

    return fst.FastState(table=part("table", fst.FastTable),
                         sess=part("sess", fst.FastSess),
                         replay=part("replay", fst.FastReplay),
                         meta=part("meta", st.Meta))


def load(path: str, rt) -> None:
    """Restore a snapshot into a runtime (or KVS) built with the SAME
    config.  ALL validation (manifest, config, KVS-mode match both ways,
    target quiescence, every member present) happens before any
    mutation: a refused load leaves the target as it was, except that
    the target's own in-flight pipeline is drained first (its
    completions belong to the OLD run's version era)."""
    kvs, rt = _split(rt)
    if kvs is not None:
        kvs.flush()
    rt.flush_pipeline()
    with np.load(path) as z:
        _load(z, rt, kvs)


def _load(z, rt, kvs) -> None:
    manifest = _verify_npz(z)
    scope = manifest.get("scope", "full")
    if scope != "full":
        raise ValueError(
            f"snapshot is scope={scope!r} — a key-range migration transfer "
            "archive (snapshot.save_range), not full crash-recovery state; "
            "restoring it as a full snapshot would resurrect a runtime "
            "from a sliver of one table.  Range archives restore through "
            "snapshot.load_range / hermes_tpu_torch.elastic.migrate_range")
    if manifest.get("config_sha256") != config_fingerprint(rt.cfg):
        raise ValueError(
            "snapshot config fingerprint mismatch (manifest "
            f"{manifest.get('config_sha256', '?')[:12]}.. vs runtime "
            f"{config_fingerprint(rt.cfg)[:12]}..); rebuild the runtime "
            "with the saved config")
    saved_cfg = json.loads(bytes(z["meta.cfg"]).decode())
    cur_cfg = dataclasses.asdict(rt.cfg)
    if saved_cfg != cur_cfg:
        raise ValueError(
            "snapshot config mismatch; rebuild the runtime with the saved "
            f"config (saved={saved_cfg}, current={cur_cfg})")
    if kvs is not None:
        if "kvs.op" not in z:
            raise ValueError("snapshot was not taken from a KVS")
        if kvs._inflight or kvs._queued_slots or kvs._bat:
            raise ValueError(
                "load requires a quiescent KVS target: restoring over "
                "queued/in-flight client ops or active batches would "
                "strand their futures")
        sparse_snap = "kvs.index.bucket_key" in z
        if kvs.index is not None and not sparse_snap:
            raise ValueError("snapshot has no KeyIndex (dense-key run); "
                             "build the KVS with sparse_keys=False")
        if kvs.index is None and sparse_snap:
            raise ValueError(
                "snapshot carries a KeyIndex (sparse-key run); build the "
                "KVS with sparse_keys=True or the client-key mapping is "
                "lost")
    needed = _leaf_keys()
    needed += ["ctl.step_idx", "ctl.epoch", "ctl.live", "ctl.frozen"]
    if "ctl.ver_base" not in z:
        if any(k in z for k in ("ctl.rebases", "ctl.next_rebase_at",
                                "ctl.quiesce")):
            raise ValueError(
                "snapshot archive is incomplete (truncated/corrupt?): "
                "rebase bookkeeping present but ctl.ver_base missing")
        if rt._ver_base is not None:
            raise ValueError(
                "snapshot has no rebase bookkeeping (ctl.ver_base) but the "
                "target runtime has already rebased; restoring would "
                "re-anchor recorded versions from the wrong era — use a "
                "fresh runtime")
    else:
        needed += ["ctl.rebases", "ctl.next_rebase_at", "ctl.quiesce"]
    if kvs is not None:
        needed += ["kvs.op", "kvs.key", "kvs.uval"]
        if kvs.index is not None:
            needed += ["kvs.index.bucket_key", "kvs.index.bucket_slot",
                       "kvs.index.rev", "kvs.index.n_used"]
        if kvs.heap is not None:
            needed += ["kvs.heap.log", "kvs.heap.cursor"]
    missing = [k for k in needed if k not in z]
    if missing:
        raise ValueError(
            f"snapshot archive is incomplete (truncated/corrupt?): missing "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    # the state is built (and its shapes checked) before anything mutates
    restored = convert.fast_state_from_numpy(rt.cfg, _state_tree(z),
                                             rt.device, rt.n_copies)
    # -- mutate --------------------------------------------------------------
    if kvs is not None:
        kvs._op[:] = z["kvs.op"]
        kvs._key[:] = z["kvs.key"]
        kvs._uval[:] = z["kvs.uval"]
        kvs._dirty = True
        if kvs.index is not None:
            idx = kvs.index
            idx._bucket_key[:] = z["kvs.index.bucket_key"]
            idx._bucket_slot[:] = z["kvs.index.bucket_slot"]
            idx._rev[:] = z["kvs.index.rev"]
            idx.n_used = int(z["kvs.index.n_used"])
        if kvs.heap is not None:
            h = kvs.heap
            log = np.asarray(z["kvs.heap.log"], np.uint8)
            h._mirror[:] = 0
            h._mirror[: log.shape[0]] = log
            h._cursor = int(z["kvs.heap.cursor"])
            h._dev = None  # the device log re-syncs lazily from the mirror
            h._synced = 1
            h.appends = h.append_bytes = 0
            h.gc_runs = h.gc_reclaimed_bytes = 0
            h.live_bytes = 0
    rt.fs = restored
    rt.step_idx = int(z["ctl.step_idx"])  # also re-seeds the device counter
    rt.epoch[:] = z["ctl.epoch"]
    rt.live[:] = z["ctl.live"]
    rt.frozen[:] = z["ctl.frozen"]
    rt._ctl_dirty = True
    # suspect-age copies of the old run's rounds must not reach the
    # detector of the restored one
    rt._age_ring.clear()
    rt.harvested_ages = None
    if "ctl.ver_base" in z:
        vb = np.asarray(z["ctl.ver_base"]).astype(np.int64)
        rt._ver_base = vb.copy() if vb.size and vb.any() else None
        rt.rebases = int(z["ctl.rebases"])
        rt._next_rebase_at = int(z["ctl.next_rebase_at"])
        rt.quiesce = bool(z["ctl.quiesce"])


# -- range archives (the live key-range migration's transfer) -------------


def _range_rows(rt, lo: int, hi: int):
    """(vpts (n,) int32, bank (n, 4*(2+V)) int8) of slots [lo, hi), taken
    from the lowest live unfrozen replica's table copy (the shared table
    on the batched backend), one slice of the copies and one copy to the
    host.  On the sharded engine every OTHER live unfrozen copy must be
    byte-identical over the range — the drained-range precondition,
    verified loudly rather than trusted (a range with in-flight
    coordination is not transferable)."""
    K = rt.cfg.n_keys
    vk = fst.copies(rt.fs.table.vpts, K)
    bk = fst.copies(rt.fs.table.bank, K)
    if rt.backend == "batched":
        return vk[0, lo:hi].cpu().numpy(), bk[0, lo:hi].cpu().numpy()
    cands = rt.healthy_replicas()
    if not cands:
        raise RuntimeError("save_range needs at least one live unfrozen "
                           "replica to donate the range rows")
    idx = torch.as_tensor([rt.copy_index(r) for r in cands],
                          device=vk.device)
    vpts = vk[idx, lo:hi].cpu().numpy()
    bank = bk[idx, lo:hi].cpu().numpy()
    for j, r in enumerate(cands[1:], 1):
        if not (np.array_equal(vpts[j], vpts[0])
                and np.array_equal(bank[j], bank[0])):
            raise RuntimeError(
                f"range [{lo}, {hi}) is not quiesced: replicas {cands[0]} "
                f"and {r} disagree on its rows — drain the range (reject-new"
                " + flush in-flight) before snapshotting it")
    return vpts[0], bank[0]


def save_range(path: str, rt, lo: int, hi: int) -> dict:
    """Snapshot ONLY the table rows of dense slots ``[lo, hi)`` of a
    FastRuntime (or the runtime under a KVS facade) into a range-scoped
    archive — the transfer artifact of a live key-range migration
    (``elastic.migrate_range``).  The range must be DRAINED: in-flight
    pipeline rounds are flushed here, and on the sharded engine the live
    replicas' copies of the range are verified byte-identical.  Carries
    the range's cumulative version-rebase deltas (``ver_base``) so the
    destination can re-anchor recorded versions into the source's global
    version space.  Returns the manifest.

    Value heap: when the facade is a heap-mode KVS, the range's live
    extents travel WITH the rows — per-row byte lengths (-1 = no extent)
    plus one concatenated blob, under the same checksummed manifest, so a
    migration moves the bytes the ref words name and the destination
    re-appends them into ITS log."""
    kvs, rt = _split(rt)
    if kvs is not None:
        kvs.flush()
    if not (0 <= lo < hi <= rt.cfg.n_keys):
        raise ValueError(f"range [{lo}, {hi}) outside [0, {rt.cfg.n_keys})")
    rt.flush_pipeline()
    vpts, bank = _range_rows(rt, lo, hi)
    vb = (rt._ver_base[lo:hi].copy() if rt._ver_base is not None
          else np.zeros(hi - lo, np.int64))
    arrays = {
        "range.vpts": vpts,
        "range.bank": bank,
        "range.ver_base": vb,
        "meta.cfg": np.frombuffer(
            json.dumps(dataclasses.asdict(rt.cfg)).encode(), dtype=np.uint8),
    }
    heap = kvs.heap if kvs is not None else None
    if heap is not None:
        refs = _rows_to_i32(bank)[:, fst.BANK_VAL + 2]
        lens = np.full(hi - lo, -1, np.int64)
        parts = []
        for i, ref in enumerate(refs):
            if int(ref):
                ext = heap.read(int(ref))
                lens[i] = len(ext)
                parts.append(np.frombuffer(ext, np.uint8))
        arrays["range.heap_lens"] = lens
        arrays["range.heap_blob"] = (
            np.concatenate(parts) if parts else np.zeros(0, np.uint8))
    manifest = dict(
        version=MANIFEST_VERSION,
        scope=f"range:[{lo},{hi})",
        lo=int(lo),
        hi=int(hi),
        value_words=int(rt.cfg.value_words),
        config_sha256=config_fingerprint(rt.cfg),
        step=int(rt.step_idx),
        arrays={k: _array_sha256(v) for k, v in arrays.items()},
    )
    _atomic_savez(path, arrays, manifest)
    return manifest


def read_range(path: str):
    """Verify and read a range-scoped archive WITHOUT touching any runtime:
    returns ``(manifest, slots, vpts, rows32, ver_base)`` where ``slots``
    is the archived ``[lo, hi)`` as an index array and ``rows32`` the bank
    rows as int32 words ``[pts | sst | val...]`` — the form
    ``migrate_range`` patches (uid re-mint) before restoring.  Refuses
    full-scoped archives (the inverse of ``load``'s scope gate)."""
    with np.load(path) as z:
        manifest = _verify_npz(z)
        scope = manifest.get("scope", "full")
        if not scope.startswith("range:"):
            raise ValueError(
                f"archive is scope={scope!r}, not a range transfer; full "
                "snapshots restore through snapshot.load")
        missing = [k for k in ("range.vpts", "range.bank", "range.ver_base")
                   if k not in z]
        if missing:
            raise ValueError(
                f"range archive is incomplete (truncated/corrupt?): "
                f"missing {missing}")
        vpts = np.asarray(z["range.vpts"])
        rows32 = _rows_to_i32(np.asarray(z["range.bank"]))
        ver_base = np.asarray(z["range.ver_base"]).astype(np.int64)
    lo, hi = int(manifest["lo"]), int(manifest["hi"])
    if vpts.shape[0] != hi - lo or rows32.shape[0] != hi - lo:
        raise ValueError(
            f"range archive row count {vpts.shape[0]} != declared "
            f"[{lo}, {hi})")
    return manifest, np.arange(lo, hi, dtype=np.int64), vpts, rows32, ver_base


def read_range_heap(path: str):
    """The value-heap extents of a range archive: ``(lens, extents)`` —
    per-row byte lengths (-1 = the row has no extent) and the per-row
    byte payloads (None where absent) — or None when the archive carries
    no heap section (a fixed-word source).  Re-verifies the checksums
    itself, so it cannot get out of step with ``read_range``."""
    with np.load(path) as z:
        manifest = _verify_npz(z)
        if not manifest.get("scope", "full").startswith("range:"):
            raise ValueError("not a range archive")
        if "range.heap_lens" not in z:
            return None
        lens = np.asarray(z["range.heap_lens"], np.int64)
        blob = np.asarray(z["range.heap_blob"], np.uint8)
    have = lens[lens >= 0].sum()
    if have != blob.shape[0]:
        raise ValueError(
            f"range heap blob is {blob.shape[0]} bytes but the lengths "
            f"declare {int(have)} (truncated/corrupt archive)")
    out, off = [], 0
    for ln in lens:
        if ln < 0:
            out.append(None)
        else:
            out.append(blob[off:off + int(ln)].tobytes())
            off += int(ln)
    return lens, out


def write_rows(rt, dest_slots, vpts, rows32) -> None:
    """Write table rows into a FastRuntime at ``dest_slots``, in every
    table copy (migrated rows arrive converged, exactly as a committed
    VAL would leave them), in place after the pipeline is flushed (no
    dispatched round still reads them).  Mechanical: scope checks, uid
    re-minting and version re-anchoring are the caller's job
    (``elastic.migrate_range`` / ``load_range``)."""
    cfg = rt.cfg
    K = cfg.n_keys
    dest = np.asarray(dest_slots, np.int64)
    if dest.size == 0:
        return
    if dest.min() < 0 or dest.max() >= K or np.unique(dest).size != dest.size:
        raise ValueError("dest_slots must be distinct slots in [0, n_keys)")
    if rows32.shape != (dest.size, 2 + cfg.value_words):
        raise ValueError(
            f"rows32 shape {rows32.shape} != ({dest.size}, "
            f"{2 + cfg.value_words}) — value_words mismatch between the "
            "archive and the destination config")
    rt.flush_pipeline()
    dev = rt.device
    idx = torch.as_tensor(dest, device=dev)
    # distinct slots: the put over every copy has no duplicate target
    fst.copies(rt.fs.table.vpts, K)[:, idx] = torch.as_tensor(
        np.asarray(vpts, np.int32), device=dev)
    fst.copies(rt.fs.table.bank, K)[:, idx] = torch.as_tensor(
        _i32_to_rows(rows32), device=dev)


def anchor_ver_base(rt, dest_slots, ver_base) -> None:
    """Adopt a migrated range's cumulative version-rebase deltas into the
    destination runtime's re-anchoring table (``load_range`` and
    ``elastic.migrate_range``): completions recorded for the restored
    slots must re-anchor into the SOURCE's global version space or the
    checker's witness order would restart mid-history.  Fresh
    destination slots (the migration precondition) carry no deltas of
    their own, so assignment — not addition — is the fold."""
    ver_base = np.asarray(ver_base, np.int64)
    if not ver_base.any():
        return
    if rt._ver_base is None:
        rt._ver_base = np.zeros(rt.cfg.n_keys, np.int64)
    rt._ver_base[np.asarray(dest_slots, np.int64)] = ver_base


def load_range(path: str, rt, dest_slots=None) -> dict:
    """Restore a range-scoped archive into a FastRuntime (or KVS facade)
    at ``dest_slots`` (default: the archived slots — identity placement).
    The destination slots must be FRESH (no prior committed writes in the
    destination's history): migration owns that precondition through
    routing — a key lives in exactly one group.  Verifies scope and
    checksums first and re-anchors the destination's ``_ver_base`` over
    the restored slots with the source's deltas.  Returns the manifest.
    This mechanical restore keeps the rows' original write uids;
    recorded destinations migrate through ``elastic.migrate_range``,
    which re-mints uids and seeds the destination history."""
    kvs, rt = _split(rt)
    if kvs is not None:
        kvs.flush()
    manifest, slots, vpts, rows32, ver_base = read_range(path)
    if int(manifest["value_words"]) != rt.cfg.value_words:
        raise ValueError(
            f"range archive value_words={manifest['value_words']} != "
            f"destination {rt.cfg.value_words}; rows are not portable "
            "across value widths")
    dest = slots if dest_slots is None else np.asarray(dest_slots, np.int64)
    if dest.shape != slots.shape:
        raise ValueError(
            f"dest_slots count {dest.size} != archived rows {slots.size}")
    write_rows(rt, dest, vpts, rows32)
    anchor_ver_base(rt, dest, ver_base)
    return manifest
