"""The value heap: port of ``hermes_tpu/heap/core.py``.  MICA-style
variable-length values behind one packed ref word per key.

* ``ValueHeap``: a per-store append log.  Extents of up to
  ``cfg.max_value_bytes`` bytes land at a granule-aligned bump cursor;
  each extent is named by ONE packed int32 ref word ``(granule << 12) |
  byte_length`` (``layouts.HEAP_REF``; ref 0 is the null sentinel,
  granule 0 is reserved).  The host mirror is authoritative for writes
  (the client layer appends BEFORE the INV issues); the device log holds
  the same bytes, its dirty tail synced with one copy, and serves the
  batched device gather.
* ``build_extent_gather``: ONE gather answers a batch of refs from the
  device log.  Refs are untrusted: the fields unpack by an arithmetic
  shift and a mask on int32, every byte index is clamped into the log,
  and bytes past each extent's length are masked to zero.
* ``compact``: GC.  The live extents (every ref reachable from table
  rows, staged streams and queued client ops) are copied to the front of
  a fresh log and the ref words are remapped (``kvs.KVS.heap_gc``).

An extent never changes once appended (a new value is a new extent and a
new ref through the normal round), so the ref word inherits the row's
linearizability; compaction runs only with the store quiesced and every
completion resolved.

Where the port differs: the device log is a ``uint8`` tensor, built with
a COPY of the mirror (``torch.tensor``), so appends reach it only through
the dirty-tail sync; and there are no batch buckets to pad to.  The op
census (``gather_census``, ``append_census``) waits for ROADMAP A14 and
``analyze_gather`` for A16.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from hermes_tpu_torch import device as device_lib
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import layouts

GRANULE = layouts.HEAP_GRANULE
_LEN = layouts.HEAP_REF.field("len")
_GRAN = layouts.HEAP_REF.field("gran")


class HeapFull(RuntimeError):
    """The append log is out of granules even after compaction: the LIVE
    value bytes exceed ``config.heap_bytes``.  A full store refuses
    writes; it never drops payload bytes."""


def pack_ref(gran: int, length: int) -> int:
    """Pack an extent ref word from the declared fields."""
    return (int(gran) << _GRAN.shift) | int(length)


def ref_len(ref) -> int:
    """Extent byte length of a packed ref (field ``len``)."""
    return ref & _LEN.mask


def ref_gran(ref) -> int:
    """Granule index of a packed ref (field ``gran``)."""
    return (ref >> _GRAN.shift) & (_GRAN.cap - 1)


def cap_bytes(cfg: HermesConfig) -> int:
    """Word-aligned per-extent gather width."""
    return 4 * ((cfg.max_value_bytes + 3) // 4)


def build_extent_gather(heap_bytes: int, cap: int):
    """The batched extent gather: ``fn(log, refs) -> (rows, lens)``, one
    gather of ``cap`` bytes a ref from the ``(heap_bytes,)`` uint8 log.
    ``rows`` is (n, cap) uint8, zero past each extent's length; ``lens``
    (n,) int32."""

    def gather(log: torch.Tensor, refs: torch.Tensor):
        refs = refs.to(torch.int32)
        lens = (refs & _LEN.mask).clamp(0, cap)
        gran = (refs >> _GRAN.shift) & (_GRAN.cap - 1)
        off = torch.arange(cap, dtype=torch.int32, device=log.device)
        idx = (gran[:, None] * GRANULE + off[None, :]).clamp(
            max=heap_bytes - 1)
        rows = log[idx.long()]  # the one gather
        rows = torch.where(off[None, :] < lens[:, None], rows,
                           torch.zeros_like(rows))
        return rows, lens

    return gather


def build_append(heap_bytes: int, chunk: int):
    """The log append: ``fn(log, data, start) -> log``, one copy of a
    ``chunk``-byte tail into the device log in place (appends bump a
    cursor; they never copy the heap)."""

    def append(log: torch.Tensor, data: torch.Tensor, start: int):
        if not (0 <= start and start + chunk <= heap_bytes
                and data.shape == (chunk,)):
            raise ValueError(f"append of {tuple(data.shape)} bytes at "
                             f"{start} outside the {heap_bytes}-byte log")
        log[start:start + chunk].copy_(data)
        return log

    return append


class ValueHeap:
    """One store's value log: the host mirror (authoritative, in append
    order) and a lazily synced log on ``device`` (default the card).  Not
    thread-safe: it lives under the KVS's single-threaded step loop."""

    def __init__(self, cfg: HermesConfig, device="cuda"):
        if not cfg.use_heap:
            raise ValueError("ValueHeap needs cfg.max_value_bytes > 0")
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.capacity = cfg.heap_bytes
        self.granules = cfg.heap_granules
        self.cap = cap_bytes(cfg)
        self._gather = build_extent_gather(self.capacity, self.cap)
        self._mirror = np.zeros(cfg.heap_bytes, np.uint8)
        self._cursor = 1       # granules; granule 0 = the null-ref sentinel
        self._synced = 1       # granules already copied to the device log
        self._dev = None       # lazy device-resident log
        self.appends = 0
        self.append_bytes = 0
        self.gc_runs = 0
        self.gc_reclaimed_bytes = 0
        self.live_bytes = 0    # as of the last compaction
        self.gather_dispatches = 0

    # -- allocation ----------------------------------------------------------

    def used_bytes(self) -> int:
        return self._cursor * GRANULE

    def free_bytes(self) -> int:
        return (self.granules - self._cursor) * GRANULE

    def _granules_for(self, nbytes: int) -> int:
        return max(1, (nbytes + GRANULE - 1) // GRANULE)

    def append(self, data) -> int:
        """Land one extent at the bump cursor; returns its packed ref
        word.  Raises ``HeapFull`` when the log is out of granules (the
        caller compacts and retries: kvs.KVS does) and ``ValueError`` on
        an over-long payload."""
        raw = bytes(data)
        if len(raw) > self.cfg.max_value_bytes:
            raise ValueError(
                f"value is {len(raw)} bytes > max_value_bytes="
                f"{self.cfg.max_value_bytes}")
        need = self._granules_for(len(raw))
        if self._cursor + need > self.granules:
            raise HeapFull(
                f"value heap out of space: {len(raw)}-byte extent needs "
                f"{need} granule(s), {self.granules - self._cursor} free "
                f"of {self.granules} (heap_bytes={self.capacity})")
        ref = pack_ref(self._cursor, len(raw))
        start = self._cursor * GRANULE
        self._mirror[start:start + len(raw)] = np.frombuffer(raw, np.uint8)
        self._cursor += need
        self.appends += 1
        self.append_bytes += len(raw)
        return ref

    # -- reads ---------------------------------------------------------------

    def _check_ref(self, ref: int) -> Tuple[int, int]:
        gran, ln = ref_gran(ref), ref_len(ref)
        if not (1 <= gran < self._cursor) or gran * GRANULE + ln > \
                self._cursor * GRANULE:
            raise ValueError(
                f"dangling heap ref 0x{ref:08x} (gran={gran}, len={ln}, "
                f"cursor={self._cursor}): the extent is not inside the "
                "allocated log — row corruption or a missed GC remap")
        return gran, ln

    def read(self, ref: int) -> bytes:
        """The extent bytes behind one packed ref (host mirror)."""
        gran, ln = self._check_ref(int(ref))
        start = gran * GRANULE
        return self._mirror[start:start + ln].tobytes()

    def read_many(self, refs) -> List[Optional[bytes]]:
        """Mirror reads for a ref vector; ``None`` for null refs (the
        never-written row)."""
        return [None if int(r) == 0 else self.read(int(r)) for r in refs]

    # -- the device log ------------------------------------------------------

    def device_log(self) -> torch.Tensor:
        """The device-resident log: a copy of the mirror at first use,
        then the dirty tail (appends since the last sync are contiguous)
        copied in with one ``build_append`` call."""
        if self._dev is None:
            self._dev = torch.tensor(self._mirror, device=self.device)
            self._synced = self._cursor
            return self._dev
        if self._synced < self._cursor:
            lo, hi = self._synced * GRANULE, self._cursor * GRANULE
            fn = build_append(self.capacity, hi - lo)
            self._dev = fn(self._dev,
                           torch.tensor(self._mirror[lo:hi],
                                        device=self.device), lo)
            self._synced = self._cursor
        return self._dev

    def device_gather(self, refs) -> Tuple[np.ndarray, np.ndarray]:
        """Batched extent fetch through the DEVICE log: ``(rows (n, cap)
        uint8 zero past each length, lens (n,) int32)``, on the host."""
        refs = torch.as_tensor(np.asarray(refs, np.int32))
        rows, lens = self._gather(self.device_log(), refs.to(self.device))
        self.gather_dispatches += 1
        return rows.cpu().numpy(), lens.cpu().numpy()

    # -- compaction (GC) -----------------------------------------------------

    def compact(self, roots) -> Tuple[np.ndarray, np.ndarray]:
        """Copy the live extents (the unique non-null refs of ``roots``)
        to the front of a fresh log in allocation order and reset the
        bump cursor behind them.  Returns ``(old_refs, new_refs)`` sorted
        by ``old_refs``; feed any ref array through ``remap`` to follow
        the move.  The device log is dropped (re-copied at next use).
        The caller owns quiescence: every live ref must be IN ``roots``
        (kvs.KVS.heap_gc collects them under the rebase quiesce)."""
        roots = np.asarray(roots, np.int64).ravel()
        old = np.unique(roots[roots != 0]).astype(np.int64)
        grans = (old >> _GRAN.shift) & (_GRAN.cap - 1)
        lens = old & _LEN.mask
        order = np.argsort(grans, kind="stable")
        new_mirror = np.zeros(self.capacity, np.uint8)
        new_refs = np.zeros(old.shape[0], np.int64)
        cursor = 1
        for j in order:
            g, ln = int(grans[j]), int(lens[j])
            if not (1 <= g < self._cursor):
                raise ValueError(
                    f"GC root 0x{int(old[j]):08x} is dangling (gran={g}, "
                    f"cursor={self._cursor})")
            need = self._granules_for(ln)
            src = g * GRANULE
            dst = cursor * GRANULE
            new_mirror[dst:dst + ln] = self._mirror[src:src + ln]
            new_refs[j] = pack_ref(cursor, ln)
            cursor += need
        reclaimed = (self._cursor - cursor) * GRANULE
        self._mirror = new_mirror
        self._cursor = cursor
        self._dev = None
        self._synced = 1
        self.gc_runs += 1
        self.gc_reclaimed_bytes += max(0, reclaimed)
        self.live_bytes = int(lens.sum())
        return old, new_refs

    @staticmethod
    def remap(refs, old: np.ndarray, new: np.ndarray) -> np.ndarray:
        """Apply a compaction's (old, new) ref mapping to an int array;
        null refs stay null, unknown refs raise (they were not rooted: a
        GC soundness fault, never silently preserved)."""
        refs = np.asarray(refs)
        out = refs.astype(np.int64).copy()
        nz = out != 0
        if nz.any():
            idx = np.searchsorted(old, out[nz])
            bad = (idx >= old.shape[0])
            safe = np.where(bad, 0, idx)
            bad |= old[safe] != out[nz]
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} ref(s) missing from the GC root set "
                    "(first: 0x%08x)" % int(out[nz][bad][0]))
            out[nz] = new[idx]
        return out.astype(refs.dtype, copy=False)

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        used = self.used_bytes()
        return dict(
            capacity_bytes=self.capacity,
            used_bytes=used,
            free_bytes=self.free_bytes(),
            appends=self.appends,
            append_bytes=self.append_bytes,
            gc_runs=self.gc_runs,
            gc_reclaimed_bytes=self.gc_reclaimed_bytes,
            live_bytes=self.live_bytes,
            # post-GC utilization: live bytes over the allocated prefix
            util=(self.live_bytes / used) if self.live_bytes else None,
        )
