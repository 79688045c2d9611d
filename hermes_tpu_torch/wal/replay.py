"""WAL recovery half: segment reading with torn-frame triage, and the
idempotent apply path.  Port of ``hermes_tpu/wal/replay.py``.

Triage contract:

  * **torn tail** — the failure is explainable as ONE interrupted append
    reaching end-of-file in the LAST segment: fewer bytes than a frame
    header remain, or a valid header's declared payload runs past EOF.
    That is the kill -9 shape; reading truncates cleanly at the last
    whole record and recovery proceeds with everything before it.
  * **torn interior / checksum mismatch** — anything else: bad magic with
    a full header present, a CRC mismatch over a fully-present payload,
    any failure in a non-last segment, or a record that decodes
    inconsistently inside a CRC-valid frame.  The flight recorder dumps
    (with the offending frame header bytes in the payload) and
    ``WalCorrupt`` raises.

Apply contract: a record applies to a table row iff its packed timestamp
``pack_pts(ver - ver_base[key], fc)`` is NEWER than the row's current
``vpts`` (and than every earlier record of the key in the log), so
replaying a record the snapshot already covers is a no-op and replaying
the whole log twice is identical to once.  The reference applies record
by record in Python; ``apply_records`` here decides every record at once
with a segmented running maximum of the packed timestamp per key, and
writes each key's newest applying record to the table in one scatter.
The counts, the table bytes and, in heap mode, the heap bytes and refs
are the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.obs.flightrec import FlightRecorder
from hermes_tpu_torch.transport import codec
from hermes_tpu_torch.wal import log as wlog


class WalCorrupt(RuntimeError):
    """A WAL segment failed integrity checks in a way a crash cannot
    explain: recovery refuses loudly instead of guessing."""


def _refuse(reason: str, obs, path: str, seq: int, offset: int,
            header: bytes, detail: str) -> None:
    """Arm the flight recorder, then raise WalCorrupt."""
    flight = obs.flight if obs is not None else FlightRecorder()
    flight.auto_dump(reason, extra=dict(
        segment=os.path.basename(path), seq=seq, offset=offset,
        header_hex=header.hex(), detail=detail))
    raise WalCorrupt(
        f"{reason}: segment {os.path.basename(path)} (seq {seq}) at "
        f"offset {offset}: {detail} — refusing to replay past it "
        f"(header bytes {header.hex() or '<eof>'})")


def read_records(wal_dir: str, obs=None) -> dict:
    """Parse every segment in ``wal_dir`` in sequence order.

    Returns ``dict(records, remaps, headers, segments, torn_tail)``:
    ``records`` are decoded K_ROUND dicts in append order, ``remaps`` the
    K_REMAP dicts, ``headers`` the per-segment K_SEGHDR dicts,
    ``segments`` the paths read (recovery retires exactly these after
    re-appending), ``torn_tail`` whether the last segment ended in a
    cleanly truncated partial append."""
    paths = sorted(
        (os.path.join(wal_dir, n) for n in os.listdir(wal_dir)
         if n.startswith("wal-") and n.endswith(".seg")),
        key=wlog.GroupCommitWal._seq_of) if os.path.isdir(wal_dir) else []
    records, remaps, headers = [], [], []
    torn_tail = False
    for pi, path in enumerate(paths):
        seq = wlog.GroupCommitWal._seq_of(path)
        last_seg = pi == len(paths) - 1
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            remaining = len(data) - off
            header = data[off:off + codec.FRAME_OVERHEAD]
            if remaining < codec.FRAME_OVERHEAD:
                if last_seg:
                    torn_tail = True  # interrupted append at EOF
                    break
                _refuse("wal_torn_interior", obs, path, seq, off, header,
                        f"{remaining} trailing bytes (< {codec.FRAME_OVERHEAD}"
                        "-byte frame header) in a NON-last segment")
            magic, algo, _pad, length, crc = codec.FRAME_HEADER.unpack(header)
            if magic != codec.FRAME_MAGIC:
                _refuse("wal_torn_interior", obs, path, seq, off, header,
                        f"bad frame magic 0x{magic:04x} with a full header "
                        "present (appends are sequential, so this is not a "
                        "torn tail)")
            end = off + codec.FRAME_OVERHEAD + length
            if end > len(data):
                if last_seg:
                    torn_tail = True  # header landed, payload did not
                    break
                _refuse("wal_torn_interior", obs, path, seq, off, header,
                        f"frame payload ({length} bytes) runs past EOF in a "
                        "NON-last segment")
            payload = data[off + codec.FRAME_OVERHEAD:end]
            got = codec.wire_crc(payload, algo)
            if got != crc:
                _refuse("wal_checksum_mismatch", obs, path, seq, off, header,
                        f"frame checksum mismatch over a fully-present "
                        f"payload (header 0x{crc:08x} != 0x{got:08x})")
            try:
                rec = wlog.decode_record(payload)
            except wlog.WalError as e:
                _refuse("wal_record_inconsistent", obs, path, seq, off,
                        header, str(e))
            rec["segment"] = path
            if rec["kind"] == wlog.K_SEGHDR:
                headers.append(rec["header"])
            elif rec["kind"] == wlog.K_REMAP:
                remaps.append(rec)
            else:
                records.append(rec)
            off = end
    return dict(records=records, remaps=remaps, headers=headers,
                segments=paths, torn_tail=torn_tail)


def check_headers(headers, cfg, obs=None) -> None:
    """Refuse a log written under a different table shape: replaying it
    would scatter rows into the wrong slots silently."""
    for h in headers:
        bad = [k for k in ("n_keys", "value_words", "n_replicas",
                           "max_value_bytes")
               if h.get(k) != getattr(cfg, k)]
        if bad:
            flight = obs.flight if obs is not None else FlightRecorder()
            flight.auto_dump("wal_recovery_refused", extra=dict(
                header=h, mismatched=bad, expected={
                    k: getattr(cfg, k) for k in bad}))
            raise WalCorrupt(
                f"wal segment seq {h.get('seq')} was written under a "
                f"different config ({', '.join(bad)} mismatch: segment "
                f"{ {k: h.get(k) for k in bad} } vs runtime "
                f"{ {k: getattr(cfg, k) for k in bad} }) — refusing to "
                "replay it into this table")


def _concat(records, field, dtype):
    parts = [np.asarray(r[field], dtype) for r in records]
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def apply_records(rt, records, heap=None, replicas=None):
    """Replay decoded K_ROUND records into ``rt``'s table, idempotently
    by packed timestamp.  Returns ``(applied, skipped)`` record counts.
    The batched table is one copy shared by every replica; on the sharded
    engine ``replicas`` picks the copies written (restart_replica's
    catch-up of the rejoined copy), None every copy.  Only the key rows
    ``[0, K)`` of a copy are written, never its drop row.  A record
    applies when it beats the row of at least one selected copy.  In heap
    mode each applying record's extent bytes are re-appended into
    ``heap``, in log order, and the row's ref word re-minted (the logged
    ref is from the dead store's heap)."""
    cfg = rt.cfg
    K = cfg.n_keys
    key = _concat(records, "key", np.int64)
    n = key.shape[0]
    if n == 0:
        return 0, 0
    bad = np.nonzero((key < 0) | (key >= K))[0]
    if bad.size:
        raise WalCorrupt(
            f"wal record key {int(key[bad[0]])} outside the table "
            f"[0, {K}) — log/config mismatch")
    gver = _concat(records, "ver", np.int64)
    ver_base = getattr(rt, "_ver_base", None)
    dver = gver - (ver_base[key] if ver_base is not None else 0)
    bad = np.nonzero((dver <= 0) | (dver >= cfg.max_key_versions))[0]
    if bad.size:
        i = int(bad[0])
        raise WalCorrupt(
            f"wal record for key {int(key[i])} re-anchors to device "
            f"version {int(dver[i])} (global {int(gver[i])}) outside "
            f"(0, {cfg.max_key_versions}) — version-era mismatch "
            "between the log and this runtime's rebase state")
    fc = _concat(records, "fc", np.int64)
    pts = fst.pack_pts(dver, fc).astype(np.int32)
    tbl = rt.fs.table
    vk = fst.copies(tbl.vpts, K)  # (n_copies, K) views
    bk = fst.copies(tbl.bank, K)
    if rt.backend == "sharded":
        sel = list(range(rt.n_copies)) if replicas is None else [
            r - rt._first for r in replicas]
    else:
        sel = [0]
    vpts0 = vk[sel].cpu().numpy()  # (c, K)
    # log order within each key: a record applies to a copy iff its pts
    # beats the copy's row and every earlier record's of the key (a
    # segmented running max)
    order = np.lexsort((np.arange(n), key))
    ks, ps = key[order], pts[order].astype(np.int64)
    first = np.ones(n, bool)
    first[1:] = ks[1:] != ks[:-1]
    group = np.cumsum(first) - 1
    # offset each key group above the last so one running max is
    # segmented (pts + 2^31 fits in 33 bits)
    lifted = (group << 33) + (ps + (1 << 31))
    run = np.maximum.accumulate(lifted)
    prev = np.empty(n, np.int64)
    prev[0] = -1
    prev[1:] = run[:-1]
    prev_max = np.where(first, np.int64(-(1 << 40)),
                        (prev - (group << 33)) - (1 << 31))
    thr = np.maximum(prev_max[None], vpts0[:, ks].astype(np.int64))
    hit_copy = ps[None] > thr  # (c, n), sorted order
    hit_sorted = hit_copy.any(axis=0)
    applied = int(hit_sorted.sum())
    skipped = n - applied
    if applied == 0:
        return 0, skipped
    hit = np.zeros(n, bool)
    hit[order] = hit_sorted
    step = _concat(records, "step", np.int64)
    wv = np.concatenate([np.asarray(r["wv"], np.int32) for r in records])
    if heap is not None:
        # mint a FRESH ref for the logged extent bytes of every applying
        # record, in log order (the reference's appends, superseded
        # records included); never for a skipped one, so a replayed-twice
        # log cannot leak heap space
        lens = _concat(records, "lens", np.int64)
        blobs = [r["blob"] for r in records]
        rec_of = np.concatenate([np.full(r["key"].shape[0], j, np.int64)
                                 for j, r in enumerate(records)])
        offs = np.zeros(n + 1, np.int64)
        for j, r in enumerate(records):
            m = rec_of == j
            offs[1:][m] = np.cumsum(lens[m])
        wv = wv.copy()
        for i in np.nonzero(hit & (lens > 0))[0]:
            j = int(rec_of[i])
            ext = blobs[j][int(offs[i + 1] - lens[i]):int(offs[i + 1])]
            wv[i, 2] = np.int32(heap.append(ext))
    dev = tbl.vpts.device
    for c, hit_c in zip(sel, hit_copy):
        # each key's newest record applying to this copy stays: the last
        # hit of its group in log order
        hs = np.nonzero(hit_c)[0]
        if hs.size == 0:
            continue
        last = np.ones(hs.size, bool)
        last[:-1] = ks[hs[1:]] != ks[hs[:-1]]
        win = order[hs[last]]
        rows32 = np.empty((win.size, 2 + cfg.value_words), np.int32)
        rows32[:, fst.BANK_PTS] = pts[win]
        rows32[:, fst.BANK_SST] = fst.pack_sst(step[win],
                                               t.VALID).astype(np.int32)
        rows32[:, fst.BANK_VAL:] = wv[win]
        idx = torch.from_numpy(key[win]).to(dev)
        vk[c][idx] = torch.from_numpy(pts[win]).to(dev)
        bk[c][idx] = torch.from_numpy(codec.words_to_rows(rows32)).to(dev)
    return applied, skipped
