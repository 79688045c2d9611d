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
batched one), of one process.  The range archives of the elastic
migration (``save_range`` / ``load_range``) are ROADMAP A11b.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from hermes_tpu_torch import convert
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st

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
            "archive, not full crash-recovery state; range archives "
            "restore through the elastic migration (ROADMAP A11b)")
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
