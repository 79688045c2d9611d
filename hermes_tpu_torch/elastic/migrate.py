"""Live key-range migration: move a dense key-slot range between two
stores under traffic, with the checker green throughout.  The port of
``hermes_tpu/elastic/migrate.py``.

Hermes coordinates per key, so a key range can change owner without
stopping the world.  ``migrate_range`` goes through these stages:

  fence    — the router marks the range draining and the source KVS
             rejects new ops on it loudly (kind='rejected'; they never
             entered the store, so the history is untouched);
  drain    — the source steps until no client op on the range is in
             flight.  Ops that cannot drain are SALVAGED, never dropped:
             the recorder folds them as ``maybe_w``, their futures
             resolve 'lost', their session and replay slots are wiped
             (``KVS.salvage_slots``);
  snapshot — just the range's table rows, normalized to canonical
             committed form, into a scope-tagged checksummed archive
             (``snapshot.save_range``; ``snapshot.load`` refuses it);
  transfer — rows are re-minted with migration write uids
             (lo=dest_slot, hi=-(2+dst_step)), so the destination's
             checker sees the migration as ONE synthetic committed write
             a key (``recorder.record_migration``), linearized strictly
             before any post-flip op;
  restore  — rows land in every table copy of the destination, whose
             version re-anchoring (``_ver_base``) adopts the source's
             cumulative deltas, so recorded versions stay monotone
             across the move;
  flip     — the router moves ownership and clears the drain in ONE host
             update; the source's fence stays for good;
  release  — the destination serves the range (it was never fenced
             there).

Sparse-key mode re-maps through the key indexes: each migrated slot's
client key allocates a fresh dense slot in the destination's KeyIndex.

Everything refusable is refused BEFORE the fence (destination capacity
and freshness, mode mismatch), so a refused migration has no side
effects; an error after the fence but before the flip takes the ABORT
path (fence and router drain released, the source keeps the range).

Device reads: a copy's rows come to the host as one slice of the copies
and one copy, between rounds, after the drain; never on the dispatch
path.  The table's layout is the runtime's (``rt.backend``,
``fst.copies``): a sharded table holds one copy a replica, each with its
own drop row, and the donor is the lowest live, unfrozen replica's copy.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import numpy as np

from hermes_tpu_torch import snapshot as snapshot_lib
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import types as t


def _kvs_of(target):
    if hasattr(target, "rt") and hasattr(target, "index"):
        return target, target.rt
    raise TypeError(
        "migrate_range drives the client layer (kvs.KVS): fencing and "
        "salvage are client-visible contracts, not runtime internals")


def _donor_copy(rt) -> int:
    """Index in the runtime's table of the donor copy: 0 for the batched
    table every replica shares, else the lowest live, unfrozen replica's
    copy."""
    if rt.backend == "batched":
        return 0
    cands = rt.healthy_replicas()
    if not cands:
        raise RuntimeError("migration needs a live unfrozen source replica")
    return rt.copy_index(cands[0])


def _copy_rows(rt, copy: int, slots):
    """(vpts, bank) of one copy's rows at ``slots`` (a slice or an index
    array), one copy to the host each."""
    K = rt.cfg.n_keys
    vk = fst.copies(rt.fs.table.vpts, K)[copy]
    bk = fst.copies(rt.fs.table.bank, K)[copy]
    if not isinstance(slots, slice):
        import torch

        slots = torch.as_tensor(np.asarray(slots, np.int64),
                                device=vk.device)
    return vk[slots].cpu().numpy(), bk[slots].cpu().numpy()


def _normalize_range(rt, lo: int, hi: int) -> None:
    """Rewrite the range's rows to canonical committed form in every
    table copy: state VALID, row pts mirroring vpts, one uniform sst
    step.  After a clean drain this changes nothing the protocol reads
    (the rows are converged VALID); after a forced salvage it DECIDES the
    salvaged ``maybe_w`` ops as applied at the cutover — an outcome the
    checker allows them — and re-converges copies whose sst bytes differ
    (coordinator WRITE against peer INVALID)."""
    vpts, bank = _copy_rows(rt, _donor_copy(rt), slice(lo, hi))
    rows32 = snapshot_lib._rows_to_i32(bank)
    rows32[:, fst.BANK_PTS] = vpts
    rows32[:, fst.BANK_SST] = (rt.step_idx << fst.SST_STEP_SHIFT) | t.VALID
    snapshot_lib.write_rows(rt, np.arange(lo, hi), vpts, rows32)


def migrate_range(src, dst, lo: int, hi: int, router=None,
                  dst_group: int = 1, path: Optional[str] = None,
                  drain_steps: int = 2000, force: bool = False,
                  dest_slots=None) -> dict:
    """Move dense slots ``[lo, hi)`` from the ``src`` KVS to ``dst``
    (module docstring: fence, drain, snapshot, transfer, flip, release).
    ``router`` (keyindex.RangeRouter, optional) carries the routing flip;
    ``path`` keeps the transfer archive (default: a temporary file,
    removed after the restore).  ``force`` salvages ops that fail to
    drain within ``drain_steps`` instead of raising.  ``dest_slots``
    (dense mode only) places the migrated rows on chosen destination
    slots instead of the source slot ids — a fleet's groups both have
    their own keys, so the fleet allocates the destination's spare slots
    and passes them here (sparse mode allocates through the destination
    KeyIndex instead and refuses the argument).  Returns a summary dict
    (also traced as ``migrate_out``/``migrate_in`` on the two
    runtimes), with ``drain_rounds``: the source rounds the drain ran."""
    src_kvs, src_rt = _kvs_of(src)
    dst_kvs, dst_rt = _kvs_of(dst)
    if src_rt.cfg.value_words != dst_rt.cfg.value_words:
        raise ValueError("source and destination value_words differ; rows "
                         "are not portable across value widths")
    if (src_kvs.heap is None) != (dst_kvs.heap is None):
        raise ValueError(
            "source and destination must agree on value-heap mode "
            "(cfg.max_value_bytes): a packed heap ref is meaningless in a "
            "fixed-word store and vice versa")
    if src_kvs.heap is not None and (
            src_rt.cfg.max_value_bytes > dst_rt.cfg.max_value_bytes):
        raise ValueError(
            f"destination max_value_bytes={dst_rt.cfg.max_value_bytes} "
            f"cannot hold the source's {src_rt.cfg.max_value_bytes}-byte "
            "extents")
    if (src_kvs.index is None) != (dst_kvs.index is None):
        raise ValueError("source and destination must agree on sparse-key "
                         "mode (the client-key remap needs both indexes)")
    if not (0 <= lo < hi <= src_rt.cfg.n_keys):
        raise ValueError(f"range [{lo}, {hi}) outside "
                         f"[0, {src_rt.cfg.n_keys})")
    if dest_slots is not None:
        if src_kvs.index is not None:
            raise ValueError(
                "dest_slots is a dense-mode placement; sparse mode "
                "allocates destination slots through the KeyIndex")
        dest_slots = np.asarray(dest_slots, np.int64)
        if dest_slots.shape != (hi - lo,):
            raise ValueError(
                f"dest_slots must place every slot of [{lo}, {hi}) "
                f"(want shape ({hi - lo},), got {dest_slots.shape})")
        if np.unique(dest_slots).size != dest_slots.size:
            raise ValueError("dest_slots must be distinct")
        if dest_slots.size and not (
                (dest_slots >= 0) & (dest_slots < dst_rt.cfg.n_keys)).all():
            raise ValueError(
                f"dest_slots outside the destination's slot space "
                f"[0, {dst_rt.cfg.n_keys})")

    # -- validate the DESTINATION before any destructive step: a slot with
    # committed writes already has history the preload would contradict
    # (a key lives in exactly one group); nothing steps either group
    # between here and the restore, so the check cannot go stale
    dcopy = _donor_copy(dst_rt)
    fresh_err = ("destination slots are not fresh (committed writes "
                 "present); a key must live in exactly one group")
    if src_kvs.index is None:
        if dest_slots is None and hi > dst_rt.cfg.n_keys:
            raise ValueError(
                f"dense migration needs destination n_keys >= {hi} "
                "(or caller-chosen dest_slots)")
        dst_vpts, _ = _copy_rows(
            dst_rt, dcopy,
            slice(lo, hi) if dest_slots is None else dest_slots)
        if (dst_vpts != 0).any():
            raise ValueError(fresh_err)
    else:
        if hi > src_kvs.index.n_used:
            raise ValueError(
                f"range [{lo}, {hi}) reaches past the source's allocated "
                f"slot frontier ({src_kvs.index.n_used}); migrate "
                "allocated ranges only")
        # client keys already present in the destination index must sit
        # on never-written slots (keys allocated at transfer are fresh)
        pre_keys = np.array(
            [src_kvs.index.key_of(s) for s in range(lo, hi)], np.uint64)
        got = dst_kvs.index.get_slots(pre_keys, insert=False)
        n_new = int((got < 0).sum())
        if dst_kvs.index.n_used + n_new > dst_rt.cfg.n_keys:
            raise ValueError(
                f"sparse migration needs {n_new} fresh destination slot(s) "
                f"but the destination index holds {dst_kvs.index.n_used} of "
                f"n_keys={dst_rt.cfg.n_keys}; size the destination to the "
                "combined working set")
        present = got[got >= 0].astype(np.int64)
        if present.size:
            dst_vpts, _ = _copy_rows(dst_rt, dcopy, present)
            if (dst_vpts != 0).any():
                raise ValueError(fresh_err)

    summary: dict = dict(lo=lo, hi=hi, rows=hi - lo)
    flipped = False
    tmp_dir = None
    try:
        # -- fence: reject-new on the range ---------------------------------
        src_kvs.drill_phase = "fence"
        if router is not None:
            router.begin_drain(lo, hi)
        summary["rejected_at_fence"] = src_kvs.fence_slots(lo, hi)
        src_rt._trace("migrate_fence", lo=lo, hi=hi)

        # -- drain: flush in-flight range ops to normal completion ----------
        src_kvs.drill_phase = "drain"
        drained = False
        rounds = 0
        for _ in range(drain_steps):
            if src_kvs.range_inflight(lo, hi) == 0:
                drained = True
                break
            src_kvs.step()
            rounds += 1
        src_kvs.flush()
        src_rt.flush_pipeline()
        summary["drain_rounds"] = rounds
        if not drained and src_kvs.range_inflight(lo, hi) and not force:
            raise RuntimeError(
                f"range [{lo}, {hi}) did not drain in {drain_steps} rounds "
                f"({src_kvs.range_inflight(lo, hi)} op(s) still in flight); "
                "pass force=True to salvage them as maybe_w/lost")
        # forced cutover: whatever still holds the range is salvaged; in
        # the clean path this also clears orphaned replay slots on the
        # range (a post-flip replay commit would change copied rows)
        summary["salvaged"] = src_kvs.salvage_slots(lo, hi)
        summary["drained"] = drained

        # -- snapshot: canonical rows, scope-tagged archive -----------------
        _normalize_range(src_rt, lo, hi)
        if path is None:
            tmp_dir = tempfile.mkdtemp(prefix="hermes_migrate_")
            path = os.path.join(tmp_dir, f"range_{lo}_{hi}.npz")
        # the facade, so heap-mode extents ride the archive
        manifest = snapshot_lib.save_range(path, src_kvs, lo, hi)
        summary["archive_step"] = manifest["step"]

        # -- transfer: verify + read back + re-map + re-mint uids -----------
        _m, slots, vpts, rows32, ver_base = snapshot_lib.read_range(path)
        if src_kvs.index is not None:
            # sparse: each migrated client key allocates a fresh dense
            # slot in the destination's index (pre_keys: the validation
            # pass's keys of these slots; nothing stepped since)
            dest_slots = dst_kvs.index.get_slots(pre_keys).astype(np.int64)
        elif dest_slots is None:
            dest_slots = slots
        rows32 = rows32.copy()
        mig_hi = -(2 + dst_rt.step_idx)  # migration uid namespace: hi <= -2
        rows32[:, fst.BANK_VAL] = dest_slots.astype(np.int32)
        rows32[:, fst.BANK_VAL + 1] = np.int32(mig_hi)
        uids = np.stack([dest_slots.astype(np.int32),
                         np.full(dest_slots.size, mig_hi, np.int32)], axis=1)
        if dst_kvs.heap is not None:
            # re-append the archived extents into the DESTINATION's log
            # and re-point the rows' ref words (source refs name source
            # granules).  Appends before the flip are safe on the abort
            # path: unreachable rows leave dead extents the next
            # destination GC reclaims
            heap_ext = snapshot_lib.read_range_heap(path)
            if heap_ext is None:
                raise RuntimeError(
                    "heap-mode migration needs a heap section in the "
                    "range archive (source saved without its facade?)")
            from hermes_tpu_torch.heap import HeapFull

            _lens, extents = heap_ext
            newrefs = np.zeros(dest_slots.size, np.int32)
            # newrefs is a GC root while the transfer stages: a HeapFull
            # mid-loop compacts the destination and remaps them
            with dst_kvs._heap_staging(newrefs):
                for i, ext in enumerate(extents):
                    if ext is not None:
                        try:
                            newrefs[i] = dst_kvs.heap.append(ext)
                        except HeapFull:
                            dst_kvs.heap_gc(reason="migrate")
                            newrefs[i] = dst_kvs.heap.append(ext)
            rows32[:, fst.BANK_VAL + 2] = newrefs
            summary["heap_extents"] = int(sum(
                1 for e in extents if e is not None))

        # -- restore: rows + version re-anchoring + history preload ---------
        snapshot_lib.write_rows(dst_rt, dest_slots, vpts, rows32)
        snapshot_lib.anchor_ver_base(dst_rt, dest_slots, ver_base)
        if dst_rt.recorder is not None:
            vers = (vpts.astype(np.int64) >> fst.PTS_FC_BITS) + ver_base
            fcs = vpts.astype(np.int64) & fst.FC_MASK
            dst_rt.recorder.record_migration(
                dest_slots, uids, vers, fcs, dst_rt.step_idx)

        # -- flip: atomic routing cutover -----------------------------------
        src_kvs.drill_phase = "flip"
        if router is not None:
            router.flip(lo, hi, dst_group)
        flipped = True
        src_rt._trace("migrate_out", lo=lo, hi=hi, rows=hi - lo,
                      salvaged=summary["salvaged"])
        dst_rt._trace("migrate_in", lo=lo, hi=hi, rows=hi - lo,
                      step=dst_rt.step_idx)
    except BaseException:
        # abort: the keys STAY with the source — un-fence the range and
        # clear the router drain.  Ops already salvaged stay lost (their
        # maybe_w rows stand); rows already restored into the destination
        # are unreachable (routing never flipped): a retry must target a
        # fresh destination
        if not flipped:
            src_kvs.release_slots(lo, hi)
            if router is not None:
                router.release(lo, hi)
        raise
    finally:
        src_kvs.drill_phase = None
        if tmp_dir is not None:
            # the transfer archive is a byproduct: removed on every exit
            # path (a caller-supplied path is kept)
            shutil.rmtree(tmp_dir, ignore_errors=True)
    summary["dest_lo"] = int(dest_slots.min())
    summary["dest_hi"] = int(dest_slots.max()) + 1
    summary["dest_slots"] = dest_slots
    return summary
