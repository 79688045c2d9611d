"""Zero-copy SPSC columnar rings over POSIX shared memory.

The serving data plane's process boundary: N front-end worker processes
feed ONE device-owning store process (serving/ipc.py), and every byte
crosses that boundary through these rings — preallocated columnar slots
(numpy views over one ``multiprocessing.shared_memory`` block), a
seq-counter handshake per slot batch, and LOUD backpressure on a full
ring.  Nothing is pickled, nothing is copied through a pipe: the
producer writes request columns straight into mapped memory and the
consumer reads the same cache lines.

Ring layout (one shared block; every array 64-byte aligned)::

    begin[nslots]  u64   producer: stamped BEFORE the slot fill
    end[nslots]    u64   producer: stamped AFTER count + columns
    count[nslots]  i64   rows valid in the slot this generation
    ack[nslots]    u64   consumer: stamped after the slot is drained
    <field 0>[nslots, slot_rows(, width)]   caller-declared columns
    <field 1> ...

Seq-counter protocol — slot ``i`` at monotone position ``pos`` carries
generation ``g = pos // nslots + 1`` (generations start at 1 so the
all-zero fresh mapping reads as "generation 0 fully consumed"):

  * producer claim: legal iff ``ack[i] == g - 1`` (the consumer has
    drained the previous lap).  Claiming stamps ``begin[i] = g``.
  * producer commit: fill columns, write ``count[i]``, THEN stamp
    ``end[i] = g`` — the publish.  A reader that sees ``end[i] == g``
    is guaranteed a fully-written slot.
  * consumer poll: ready iff ``end[i] == g``.  Polling advances the
    read cursor but defers the ack, so a consumer may gather views of
    several ready slots (one merged ``np.concatenate`` out of shm)
    before releasing any of them.
  * consumer ack: ``ack[i] = g`` — the slot is reusable.
  * torn slot: ``begin[i] == g`` but ``end[i] != g``.  Mid-write for a
    live producer; a dead producer's tombstone (the crash-semantics
    signal serving/ipc.py's owner consumes).

Memory-model note: correctness of the handshake rides CPython + the
platform's store ordering.  Each counter is ONE aligned 8-byte numpy
store (a single mov), CPython executes the fill and the ``end`` stamp
as distinct bytecodes, and x86-TSO keeps stores in program order, so a
consumer that observes ``end[i] == g`` observes the slot's columns and
count.  On weakly-ordered ISAs the guarantee degrades gracefully: a
stale read can only mis-report "not ready yet" (a retry), never surface
a half-written slot as ready, because nothing is ever read without the
``end`` generation matching first and a spuriously EARLY ``end`` would
require the store to be reordered before its own claim — which the
per-slot ``ack`` gate makes harmless (the producer never reclaims an
unacked slot).

Backpressure contract (the house rule: never drop, never silently
block past a deadline): ``try_claim`` is non-blocking; ``claim_wait``
spins with a micro-sleep and raises ``ShmBackpressure`` LOUDLY when the
deadline passes — the caller turns that into a wire-visible refusal
(S_RETRY_AFTER / R_QUEUE_FULL) or a teardown, never a silent stall.

Python 3.10 quirk: attaching ``SharedMemory`` by name registers the
segment with this process's ``resource_tracker``, which would unlink a
still-live segment (and warn) when the ATTACHING process exits first.
Only the creator owns the segment's lifetime here, so attachers
unregister themselves (the ``track=False`` of 3.13+, done by hand).
"""

from __future__ import annotations

import dataclasses
import secrets
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np

_ALIGN = 64  # cache-line align every array: no false sharing between
#              control words and columns

#: (name, numpy dtype string, width) — width 0 declares a 1-D
#: ``(slot_rows,)`` column, width w > 0 a 2-D ``(slot_rows, w)`` matrix.
FieldSpec = Tuple[str, str, int]


class ShmBackpressure(RuntimeError):
    """A ring stayed full past the caller's deadline.  Loud by design:
    the producer must surface this as a wire refusal or a teardown —
    never swallow it (the never-drop / never-silently-block rule)."""


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """The picklable identity of a ring: everything a child process
    needs to ``SpscColumnRing.attach`` the same mapping by name."""

    name: str                        # SharedMemory segment name
    nslots: int
    slot_rows: int
    fields: Tuple[FieldSpec, ...]


def _aligned(off: int) -> int:
    return (off + _ALIGN - 1) & ~(_ALIGN - 1)


def _layout(spec: RingSpec):
    """Byte offsets of every array in the block: (total_size,
    {ctrl_name: off}, {field_name: (off, shape, dtype)})."""
    off = 0
    ctrl: Dict[str, int] = {}
    for cname in ("begin", "end", "count", "ack"):
        off = _aligned(off)
        ctrl[cname] = off
        off += 8 * spec.nslots
    cols: Dict[str, Tuple[int, tuple, np.dtype]] = {}
    for fname, dts, width in spec.fields:
        dt = np.dtype(dts)
        shape = ((spec.nslots, spec.slot_rows) if width == 0
                 else (spec.nslots, spec.slot_rows, width))
        nbytes = dt.itemsize * int(np.prod(shape[1:])) * spec.nslots
        off = _aligned(off)
        cols[fname] = (off, shape, dt)
        off += nbytes
    return _aligned(off), ctrl, cols


class SlotView:
    """A claimed/ready slot: ``cols[name]`` are LIVE numpy views into
    shared memory for slot ``idx`` (valid until the producer's commit
    or the consumer's ack of this slot), ``count`` the valid row count
    (consumer side; the producer declares it at commit)."""

    __slots__ = ("idx", "gen", "count", "cols")

    def __init__(self, idx: int, gen: int, count: int,
                 cols: Dict[str, np.ndarray]):
        self.idx = idx
        self.gen = gen
        self.count = count
        self.cols = cols


class SpscColumnRing:
    """One single-producer / single-consumer columnar ring (the module
    docstring's protocol).  Exactly one process may produce and exactly
    one may consume; within a process, callers serialize their own
    access (serving/ipc.py's worker holds its ``_ring_lock`` across the
    claim/fill/commit of the request ring — the reader threads are
    collectively ONE producer)."""

    def __init__(self, spec: RingSpec, shm: shared_memory.SharedMemory,
                 is_creator: bool):
        self.spec = spec
        self._shm = shm
        self._is_creator = is_creator
        self._closed = False
        total, ctrl, cols = _layout(spec)
        buf = shm.buf
        self._begin = np.frombuffer(buf, np.uint64, spec.nslots,
                                    ctrl["begin"])
        self._end = np.frombuffer(buf, np.uint64, spec.nslots,
                                  ctrl["end"])
        self._count = np.frombuffer(buf, np.int64, spec.nslots,
                                    ctrl["count"])
        self._ack = np.frombuffer(buf, np.uint64, spec.nslots,
                                  ctrl["ack"])
        self._cols: Dict[str, np.ndarray] = {}
        for fname, (off, shape, dt) in cols.items():
            n = int(np.prod(shape))
            self._cols[fname] = np.frombuffer(
                buf, dt, n, off).reshape(shape)
        # local (per-process) cursors: monotone positions, never shared
        self.produced = 0          # committed slots
        self.consumed = 0          # acked slots
        self._write_pos = 0        # next slot to claim
        self._read_pos = 0         # next slot to poll
        self._claimed = False      # claim outstanding (producer side)
        self._pending_ack: List[Tuple[int, int]] = []  # (idx, gen) FIFO

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, nslots: int, slot_rows: int,
               fields: Tuple[FieldSpec, ...],
               name_hint: str = "hermes") -> "SpscColumnRing":
        if nslots < 2 or slot_rows < 1:
            raise ValueError("ring needs nslots >= 2 and slot_rows >= 1")
        spec = RingSpec(name="", nslots=int(nslots),
                        slot_rows=int(slot_rows),
                        fields=tuple((str(n), str(d), int(w))
                                     for n, d, w in fields))
        total, _, _ = _layout(spec)
        shm = shared_memory.SharedMemory(
            create=True, size=total,
            name=f"{name_hint}_{secrets.token_hex(6)}")
        spec = dataclasses.replace(spec, name=shm.name)
        shm.buf[:total] = b"\x00" * total  # generation 0 = fully consumed
        return cls(spec, shm, is_creator=True)

    @classmethod
    def attach(cls, spec: RingSpec) -> "SpscColumnRing":
        # Python 3.10 has no ``track=False``: plain attach would register
        # the segment with resource_tracker a second time, and since
        # spawn children SHARE the parent's tracker process, a later
        # unregister-on-close from either side corrupts the other's
        # bookkeeping (KeyError noise, or worse: the tracker unlinking a
        # live segment).  Only the creator owns lifetime here, so the
        # attach suppresses registration outright.  Attach is only
        # called from single-threaded startup paths (child boot, test
        # setup), so the brief monkeypatch cannot race another register.
        orig = resource_tracker.register
        try:
            resource_tracker.register = lambda *a, **k: None
            shm = shared_memory.SharedMemory(name=spec.name)
        finally:
            resource_tracker.register = orig
        return cls(spec, shm, is_creator=False)

    def close(self) -> None:
        """Unmap; the creator also unlinks the segment."""
        if self._closed:
            return
        self._closed = True
        # drop every view BEFORE closing the mapping (exported pointers
        # keep the mmap alive and SharedMemory.close raises); callers
        # may still hold SlotViews, so tolerate a pinned mapping — the
        # OS reclaims it at process exit and the unlink below still
        # removes the name
        self._begin = self._end = self._count = self._ack = None
        self._cols = {}
        try:
            self._shm.close()
        except BufferError:
            # a live SlotView pins the mmap; disarm SharedMemory.__del__
            # so interpreter exit doesn't re-raise the same error as
            # "Exception ignored" noise — the OS unmaps at process exit
            self._shm._mmap = None  # noqa: SLF001
        if self._is_creator:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    # -- producer side -------------------------------------------------------

    def _pos(self, pos: int) -> Tuple[int, int]:
        return pos % self.spec.nslots, pos // self.spec.nslots + 1

    def try_claim(self) -> Optional[SlotView]:
        """Claim the next slot (stamps ``begin``), or None while the
        consumer still owns it (ring full)."""
        if self._claimed:
            raise RuntimeError("claim already outstanding: commit first")
        i, g = self._pos(self._write_pos)
        if int(self._ack[i]) != g - 1:
            return None
        self._begin[i] = g
        self._claimed = True
        return SlotView(i, g, 0,
                        {n: a[i] for n, a in self._cols.items()})

    def claim_wait(self, timeout_s: float,
                   poll_s: float = 50e-6) -> SlotView:
        """``try_claim`` with a spin-wait bound: raises
        ``ShmBackpressure`` loudly once ``timeout_s`` passes."""
        deadline = time.monotonic() + timeout_s
        while True:
            slot = self.try_claim()
            if slot is not None:
                return slot
            if time.monotonic() >= deadline:
                raise ShmBackpressure(
                    f"ring {self.spec.name} full for {timeout_s:.3f}s "
                    f"({self.spec.nslots} slots x {self.spec.slot_rows} "
                    "rows): consumer stalled or dead — refusing loudly "
                    "instead of blocking past the deadline")
            time.sleep(poll_s)

    def commit(self, count: int) -> None:
        """Publish the claimed slot: ``count`` valid rows, then the
        ``end`` stamp (the ordering the protocol rides)."""
        if not self._claimed:
            raise RuntimeError("commit without a claim")
        if not (0 <= count <= self.spec.slot_rows):
            raise ValueError(f"count {count} outside [0, "
                             f"{self.spec.slot_rows}]")
        i, g = self._pos(self._write_pos)
        self._count[i] = count
        self._end[i] = g      # publish AFTER count + columns
        self._claimed = False
        self._write_pos += 1
        self.produced += 1

    def free_slots(self) -> int:
        """Producer-side occupancy gauge: claimable slots right now."""
        free = 0
        for d in range(self.spec.nslots):
            i, g = self._pos(self._write_pos + d)
            if int(self._ack[i]) != g - 1:
                break
            free += 1
        return free

    # -- consumer side -------------------------------------------------------

    def poll(self) -> Optional[SlotView]:
        """Next ready slot (advances the read cursor, defers the ack),
        or None when the cursor slot is unpublished.  Views stay valid
        until this slot's ``ack``."""
        i, g = self._pos(self._read_pos)
        if int(self._end[i]) != g:
            return None
        self._read_pos += 1
        self._pending_ack.append((i, g))
        return SlotView(i, g, int(self._count[i]),
                        {n: a[i] for n, a in self._cols.items()})

    def ack(self, n: Optional[int] = None) -> int:
        """Release the oldest ``n`` polled slots back to the producer
        (default: all).  Returns the number released."""
        k = len(self._pending_ack) if n is None \
            else min(n, len(self._pending_ack))
        for _ in range(k):
            i, g = self._pending_ack.pop(0)
            self._ack[i] = g
            self.consumed += 1
        return k

    def ready(self) -> int:
        """Consumer-side depth gauge: published slots beyond the read
        cursor (not counting polled-but-unacked ones)."""
        depth = 0
        for d in range(self.spec.nslots):
            i, g = self._pos(self._read_pos + d)
            if int(self._end[i]) != g:
                break
            depth += 1
        return depth

    def torn(self) -> bool:
        """True when the cursor slot was claimed but never published —
        mid-write for a live producer, a tombstone for a dead one (the
        caller brings the liveness verdict)."""
        i, g = self._pos(self._read_pos)
        return int(self._begin[i]) == g and int(self._end[i]) != g

    def pending_ack(self) -> int:
        return len(self._pending_ack)
