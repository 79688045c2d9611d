"""The write-ahead extent+commit log: the port's copy of
``hermes_tpu/wal/log.py``, byte-compatible with it.

One ``GroupCommitWal`` owns one segment directory.  Appenders (the
runtime's harvest path) never touch a file: ``append_comp`` /
``append_round`` copy the committed-write columns out of a harvested
``Completions`` (numpy arrays already copied off the card), assign a
monotone LSN under one small lock, and enqueue; a dedicated flusher
thread does ALL file work — frame encoding, segment rotation, directory
fsync on a new segment, and ONE ``os.fsync`` per drained batch (the
group commit).  The flusher does host I/O only: it never sees a tensor.
``sync(lsn)`` blocks until the batch holding ``lsn`` is durable, which
is how ``wal_sync='commit'`` gates client completions without putting
an fsync on the per-round path.

Segment format: ``wal-%08d.seg`` = a run of ``transport/codec`` frames.
The first frame of every segment is a ``K_SEGHDR`` JSON header (seq +
the config shape words replay validates against); every later frame is
a ``K_ROUND`` record batch (one harvested round's committed writes:
commit step, key, re-anchored version, fc, the full value words, and —
in heap mode — the extent BYTES behind each heap ref, so replay never
needs the old heap) or a ``K_REMAP`` bookkeeping record (a heap GC moved
extents).

Loudness: the flusher publishes its first exception to ``_error`` and
every later ``sync``/``append`` raises it.  Backpressure is the
caller's job via ``backpressured()`` (the KVS sheds with
``retry_after``); the log never blocks appends.
"""

from __future__ import annotations

import collections
import json
import os
import struct
import threading
import time

import numpy as np

from hermes_tpu_torch.concurrency import make_lock
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.transport import codec

# record kinds (first payload byte)
K_SEGHDR = 0  # JSON segment header (seq + config shape words)
K_ROUND = 1  # one harvested round's committed writes (columnar)
K_REMAP = 2  # heap-GC ref rewrite bookkeeping (old[c] -> new[c])

#: K_ROUND / K_REMAP head: kind u8, pad x3, lsn i64, round_idx i64,
#: count u32, value_words u32 — then the columns (see _encode_round).
_HEAD = struct.Struct("<BxxxqqII")

SEG_FMT = "wal-%08d.seg"


class WalError(RuntimeError):
    """A durability promise cannot be kept (dead flusher, sync timeout,
    malformed record): raised loudly, never degraded to a warning."""


def _encode_round(lsn, round_idx, step, key, ver, fc, wv, lens, blob):
    c = int(np.asarray(key).shape[0])
    v = int(np.asarray(wv).shape[1]) if c else 0
    return b"".join((
        _HEAD.pack(K_ROUND, int(lsn), int(round_idx), c, v),
        np.ascontiguousarray(step, np.int64).tobytes(),
        np.ascontiguousarray(key, np.int32).tobytes(),
        np.ascontiguousarray(ver, np.int64).tobytes(),
        np.ascontiguousarray(fc, np.int32).tobytes(),
        np.ascontiguousarray(wv, np.int32).tobytes(),
        np.ascontiguousarray(lens, np.int32).tobytes(),
        bytes(blob),
    ))


def _encode_remap(lsn, old, new):
    c = int(np.asarray(old).shape[0])
    return b"".join((
        _HEAD.pack(K_REMAP, int(lsn), -1, c, 0),
        np.ascontiguousarray(old, np.int32).tobytes(),
        np.ascontiguousarray(new, np.int32).tobytes(),
    ))


def decode_record(payload: bytes) -> dict:
    """Decode one frame payload back into its record dict.  Raises
    ``WalError`` on an internally-inconsistent record (the frame CRC
    passed, so this is a writer bug or a deliberate edit — refuse)."""
    if len(payload) < 1:
        raise WalError("empty wal record payload")
    kind = payload[0]
    if kind == K_SEGHDR:
        try:
            return dict(kind=K_SEGHDR, header=json.loads(payload[1:].decode()))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WalError(f"malformed segment header record: {e}") from e
    if len(payload) < _HEAD.size:
        raise WalError(
            f"wal record head truncated inside a CRC-valid frame "
            f"({len(payload)} < {_HEAD.size} bytes)")
    kind, lsn, round_idx, c, v = _HEAD.unpack_from(payload, 0)
    off = _HEAD.size

    def take(dtype, n):
        nonlocal off
        a = np.frombuffer(payload, dtype, count=n, offset=off)
        off += a.nbytes
        return a

    try:
        if kind == K_REMAP:
            return dict(kind=K_REMAP, lsn=lsn,
                        old=take(np.int32, c), new=take(np.int32, c))
        if kind != K_ROUND:
            raise WalError(f"unknown wal record kind {kind}")
        step = take(np.int64, c)
        key = take(np.int32, c)
        ver = take(np.int64, c)
        fc = take(np.int32, c)
        wv = take(np.int32, c * v).reshape(c, v)
        lens = take(np.int32, c)
    except ValueError as e:  # np.frombuffer ran off the payload
        raise WalError(f"wal record columns truncated inside a CRC-valid "
                       f"frame: {e}") from e
    blob = payload[off:]
    if len(blob) != int(lens.sum()):
        raise WalError(
            f"wal record extent blob is {len(blob)} bytes but the length "
            f"column sums to {int(lens.sum())}")
    return dict(kind=K_ROUND, lsn=lsn, round_idx=round_idx, step=step,
                key=key, ver=ver, fc=fc, wv=wv, lens=lens, blob=blob)


class GroupCommitWal:
    """Group-commit write-ahead log: lock-light appends, one flusher
    thread owning every file handle, one fsync per drained batch."""

    #: flusher batching window — how long the flusher dozes between batch
    #: drains when nobody kicks it (a kick drains immediately)
    GROUP_WINDOW_S = 0.002

    def __init__(self, cfg, wal_dir: str | None = None, obs=None):
        self.cfg = cfg
        self.dir = wal_dir if wal_dir is not None else cfg.wal_dir
        if self.dir is None:
            raise WalError(
                "GroupCommitWal needs a segment directory (cfg.wal_dir or "
                "an explicit wal_dir)")
        os.makedirs(self.dir, exist_ok=True)
        self.sync_mode = cfg.wal_sync
        self.obs = obs
        # -- appender<->flusher handoff (guarded by _lock) ---------------
        self._lock = make_lock("GroupCommitWal._lock")
        self._buf = collections.deque()  # (op, lsn, arg) tuples
        self._next_lsn = 1  # lsn 0 = "nothing appended yet"
        self._durable_lsn = 0
        self._dirty = 0  # appended-but-not-durable write records
        self._flush_evt = threading.Event()  # swapped per flush generation
        # -- internally-synchronized signals -----------------------------
        self._wake = threading.Event()
        self._stop = threading.Event()
        # -- single-writer publish: flusher writes once, everyone reads --
        self._error = None
        # -- flusher-thread-private file state ---------------------------
        self._f = None
        self._seg_path = None
        self._seg_bytes = 0
        self._seg_max_step = -1
        self._sealed_steps = {}  # sealed path -> max commit step inside
        existing = self.segments()
        self._seg_seq = (self._seq_of(existing[-1]) + 1) if existing else 0
        # -- gil-atomic monotone telemetry counters ----------------------
        self.records = 0
        self.rounds = 0
        self.remaps = 0
        self.fsyncs = 0
        self.wal_bytes = 0
        self.retired_segments = 0
        self._flusher_t = threading.Thread(
            target=self._flusher, name="wal-flusher", daemon=True)
        self._flusher_t.start()

    # ------------------------------------------------------------------
    # appender side (KVS harvest path / recovery re-append)
    # ------------------------------------------------------------------

    @staticmethod
    def _seq_of(path: str) -> int:
        return int(os.path.basename(path)[4:-4])

    def segments(self) -> list:
        """Segment paths on disk, in sequence order."""
        out = [os.path.join(self.dir, n) for n in os.listdir(self.dir)
               if n.startswith("wal-") and n.endswith(".seg")]
        return sorted(out, key=self._seq_of)

    def append_comp(self, comp, heap=None, round_idx=None):
        """Tap a harvested ``Completions``: append its committed writes
        (C_WRITE/C_RMW cells) as one K_ROUND record batch.  Returns the
        batch LSN, or None when the round committed nothing.  In heap
        mode the extent bytes behind each value's heap ref ride in the
        record, so replay is self-contained."""
        self._check_error()
        code = np.asarray(comp.code).ravel()
        m = (code == t.C_WRITE) | (code == t.C_RMW)
        if not bool(m.any()):
            return None
        key = np.asarray(comp.key).ravel()[m].astype(np.int32)
        ver = np.asarray(comp.ver).ravel()[m].astype(np.int64)
        fc = np.asarray(comp.fc).ravel()[m].astype(np.int32)
        step = np.asarray(comp.commit_step).ravel()[m].astype(np.int64)
        wval = np.asarray(comp.wval)
        wv = wval.reshape(-1, wval.shape[-1])[m].astype(np.int32)
        lens = np.zeros(key.shape[0], np.int32)
        blob = b""
        if heap is not None:
            chunks = [heap.read(int(r)) if int(r) else b""
                      for r in wv[:, 2]]
            lens = np.array([len(c) for c in chunks], np.int32)
            blob = b"".join(chunks)
        if round_idx is None:
            round_idx = int(step.max())
        return self.append_round(round_idx, step, key, ver, fc, wv,
                                 lens, blob)

    def append_round(self, round_idx, step, key, ver, fc, wv, lens,
                     blob) -> int:
        """Append one pre-extracted record batch; returns its LSN."""
        self._check_error()
        arg = dict(round_idx=int(round_idx),
                   step=np.ascontiguousarray(step, np.int64),
                   key=np.ascontiguousarray(key, np.int32),
                   ver=np.ascontiguousarray(ver, np.int64),
                   fc=np.ascontiguousarray(fc, np.int32),
                   wv=np.ascontiguousarray(wv, np.int32),
                   lens=np.ascontiguousarray(lens, np.int32),
                   blob=bytes(blob))
        n = int(arg["key"].shape[0])
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            self._dirty += n
            self._buf.append(("round", lsn, arg))
        return lsn

    def note_remap(self, old, new) -> int:
        """Heap GC moved extents: log the ref rewrite (bookkeeping — the
        extent BYTES in earlier records stay authoritative)."""
        self._check_error()
        arg = (np.ascontiguousarray(old, np.int32).copy(),
               np.ascontiguousarray(new, np.int32).copy())
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            self._buf.append(("remap", lsn, arg))
        self.kick()
        return lsn

    def truncate_to(self, step: int, wait: bool = True) -> int:
        """Drop sealed segments whose every record committed at or before
        ``step`` (snapshot-save calls this: the snapshot now covers
        them).  The open segment is never dropped."""
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            self._buf.append(("truncate", lsn, int(step)))
        self.kick()
        if wait:
            self.sync(lsn)
        return lsn

    def retire_segments(self, paths, wait: bool = True) -> int:
        """Delete exactly ``paths`` (recovery calls this after it has
        re-appended their surviving records into this log).  The open
        segment is refused, never deleted."""
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            self._buf.append(("retire", lsn, tuple(paths)))
        self.kick()
        if wait:
            self.sync(lsn)
        return lsn

    def kick(self) -> None:
        """Wake the flusher now instead of at the group window."""
        self._wake.set()

    def last_lsn(self) -> int:
        with self._lock:
            return self._next_lsn - 1

    def durable_lsn(self) -> int:
        with self._lock:
            return self._durable_lsn

    def dirty_records(self) -> int:
        with self._lock:
            return self._dirty

    def backpressured(self) -> bool:
        """True when the appended-but-not-durable window exceeds the
        configured bound — the caller must shed loudly (RETRY_AFTER),
        never queue into a log that cannot drain."""
        with self._lock:
            return self._dirty > self.cfg.wal_dirty_window

    def sync(self, lsn: int | None = None, timeout: float = 60.0) -> None:
        """Block until ``lsn`` (default: everything appended so far) is
        durable under the configured sync mode.  Raises WalError on a
        dead/failed flusher or timeout — never returns un-durable."""
        with self._lock:
            target = (self._next_lsn - 1) if lsn is None else int(lsn)
        deadline = time.monotonic() + timeout
        while True:
            self._check_error()
            with self._lock:
                if self._durable_lsn >= target:
                    return
                evt = self._flush_evt
            if not self._flusher_t.is_alive():
                self._check_error()
                raise WalError(
                    "wal flusher thread is dead (no published error): "
                    f"cannot make lsn {target} durable")
            self.kick()
            evt.wait(0.05)
            if time.monotonic() > deadline:
                raise WalError(
                    f"wal sync timed out after {timeout}s waiting for lsn "
                    f"{target} (durable {self.durable_lsn()}, "
                    f"dirty {self.dirty_records()} records)")

    def close(self) -> None:
        """Drain, seal the open segment, and stop the flusher."""
        self._stop.set()
        self._wake.set()
        self._flusher_t.join(timeout=60.0)
        if self._flusher_t.is_alive():
            raise WalError("wal flusher did not stop within 60s")
        # the thread is dead: sealing from here cannot race it
        self._seal_current()

    def stats(self) -> dict:
        return dict(records=self.records, rounds=self.rounds,
                    remaps=self.remaps, fsyncs=self.fsyncs,
                    bytes=self.wal_bytes, dirty=self.dirty_records(),
                    durable_lsn=self.durable_lsn(),
                    last_lsn=self.last_lsn(),
                    retired_segments=self.retired_segments,
                    segments=len(self.segments()), sync=self.sync_mode)

    def _check_error(self) -> None:
        err = self._error
        if err is not None:
            raise WalError(f"wal flusher failed: {err!r}") from err

    # ------------------------------------------------------------------
    # flusher thread (sole owner of every file handle below here)
    # ------------------------------------------------------------------

    def _flusher(self) -> None:
        try:
            while True:
                self._wake.wait(self.GROUP_WINDOW_S)
                self._wake.clear()
                with self._lock:
                    batch = list(self._buf)
                    self._buf.clear()
                if not batch:
                    if self._stop.is_set():
                        return
                    continue
                max_lsn, n_recs = self._write_batch(batch)
                t0 = time.perf_counter()
                if self._f is not None:
                    self._f.flush()
                    if self.sync_mode != "off":
                        os.fsync(self._f.fileno())
                        self.fsyncs += 1
                dt = time.perf_counter() - t0
                with self._lock:
                    self._durable_lsn = max(self._durable_lsn, max_lsn)
                    self._dirty -= n_recs
                    dirty = self._dirty
                    evt, self._flush_evt = self._flush_evt, threading.Event()
                evt.set()
                self._feed_obs(dt, dirty, n_recs)
        except BaseException as e:  # noqa: BLE001 — published, re-raised at callers
            self._error = e
            with self._lock:
                evt = self._flush_evt
            evt.set()

    def _write_batch(self, batch):
        max_lsn, n = 0, 0
        for op, lsn, arg in batch:
            if op == "round":
                payload = _encode_round(lsn, **arg)
                self._append_frame(
                    payload,
                    int(arg["step"].max()) if arg["step"].size else -1)
                self.rounds += 1
                self.records += int(arg["key"].shape[0])
                n += int(arg["key"].shape[0])
            elif op == "remap":
                old, new = arg
                self._append_frame(_encode_remap(lsn, old, new), -1)
                self.remaps += 1
            elif op == "truncate":
                self._truncate(arg)
            elif op == "retire":
                self._retire(arg)
            max_lsn = max(max_lsn, lsn)
        return max_lsn, n

    def _append_frame(self, payload: bytes, max_step: int) -> None:
        if self._f is None or self._seg_bytes >= self.cfg.wal_segment_bytes:
            self._roll_segment()
        fb = codec.frame_pack(np.frombuffer(payload, np.uint8)).tobytes()
        self._f.write(fb)
        self._seg_bytes += len(fb)
        self.wal_bytes += len(fb)
        self._seg_max_step = max(self._seg_max_step, max_step)

    def _roll_segment(self) -> None:
        self._seal_current()
        path = os.path.join(self.dir, SEG_FMT % self._seg_seq)
        self._seg_seq += 1
        self._f = open(path, "ab")
        self._seg_path = path
        self._seg_bytes = 0
        self._seg_max_step = -1
        hdr = json.dumps(dict(
            seq=self._seq_of(path), n_keys=self.cfg.n_keys,
            value_words=self.cfg.value_words,
            n_replicas=self.cfg.n_replicas,
            max_value_bytes=self.cfg.max_value_bytes,
            sync=self.sync_mode)).encode()
        fb = codec.frame_pack(
            np.frombuffer(bytes([K_SEGHDR]) + hdr, np.uint8)).tobytes()
        self._f.write(fb)
        self._seg_bytes += len(fb)
        self.wal_bytes += len(fb)
        # fsync the directory so the new NAME survives a powercut (the
        # file's own fsync does not cover its directory entry)
        if self.sync_mode != "off":
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _seal_current(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        if self.sync_mode != "off":
            os.fsync(self._f.fileno())
        self._f.close()
        self._sealed_steps[self._seg_path] = self._seg_max_step
        self._f = None
        self._seg_path = None

    def _truncate(self, step: int) -> None:
        drop = [p for p, ms in self._sealed_steps.items() if ms <= step]
        for p in drop:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
            del self._sealed_steps[p]
            self.retired_segments += 1

    def _retire(self, paths) -> None:
        for p in paths:
            if p == self._seg_path:
                continue  # never delete the open segment
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
            self._sealed_steps.pop(p, None)
            self.retired_segments += 1

    def _feed_obs(self, fsync_s: float, dirty: int, n_recs: int) -> None:
        obs = self.obs
        if obs is None:
            return
        reg = obs.registry
        reg.series("wal_fsync_s").append(self.fsyncs, fsync_s)
        reg.series("wal_dirty_records").append(self.fsyncs, dirty)
        reg.counter("wal_records").inc(n_recs)
        reg.gauge("wal_dirty").set(dirty)
