"""Shared-memory columnar IPC plane: N front-end worker
PROCESSES feeding ONE card-owning store process.

Accept sharding (``launch.start_serve_workers``) scales the socket path
by giving every worker its own store — N private KVS instances, N CUDA
contexts on the card.  This plane keeps the worker processes (own GIL, own accept queue, own
socket syscalls) but funnels every request into a SINGLE
``ColumnarFrontend`` owned by one process, over the
``transport.shm.SpscColumnRing`` pairs — so the device round stays ONE
program at full lane occupancy while the Python-side socket work scales
out across processes.

Topology (``OneStoreServer``)::

    client --tcp--> ShmWorker 0 --req ring 0--\
    client --tcp--> ShmWorker 1 --req ring 1---> StoreOwner -> ONE
        ...                                       ColumnarFrontend
    client <--tcp-- ShmWorker w <--rsp ring w--/  (merge + pump +
                                                   scatter per round)

Zero-copy discipline: a worker's reader thread validates an inbound
frame with ``wire.check_request_matrix`` and copies the raw record
matrix STRAIGHT into request-ring slot columns (one vectorized
assignment — the frame bytes are never re-encoded, re-framed, or
pickled).  The owner concatenates the ready slot views (the one
mandatory copy out of shared memory), decodes the merged matrix ONCE
with ``wire.decode_request_matrix``, and runs ONE ``submit_batch`` +
``pump`` for the whole fleet per round.  Resolutions scatter back as
decoded response columns; the worker encodes one wire batch per
connection per slot.

Connection identity across the boundary: worker-local connection ids
pack into the frontend's int32 ``conn`` column as
``(worker_id << CONN_BITS) | local_cid`` — the owner's pump emissions
arrive already grouped per packed id, and ``conn_worker``/``conn_local``
split them back.

Backpressure (the never-drop / never-silently-block rule):

  * request ring full past the worker's deadline -> the worker refuses
    the overflow rows ON THE WIRE (S_RETRY_AFTER / R_QUEUE_FULL, retry
    hint attached) — loud, bounded, no drops;
  * response ring full past the owner's deadline -> ``ShmBackpressure``
    propagates out of the owner pump (a live worker that stopped
    draining is a deployment fault, not a steady state);
  * dead worker (crashed process) -> the owner stops consuming its
    request ring (a torn slot is its tombstone), keeps pumping the
    store (admission conservation holds — every admitted op still
    resolves), and counts the undeliverable response rows LOUDLY
    (``ipc_dead_drop_rows``); its clients see EOF from the broken
    socket, and MAYBE-committed writes surface through the store's
    normal S_LOST/S_DEADLINE contract.

``run_shm_soak`` is the deterministic witness: real rings, simulated
workers, a VirtualClock, worker-id-order merge — same seed + config =>
byte-identical per-worker response logs, held against the reference's
by ``tests/test_torch_shm_ipc.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from hermes_tpu_torch.concurrency import make_lock
from hermes_tpu_torch.serving import wire
from hermes_tpu_torch.transport.shm import (RingSpec, ShmBackpressure,
                                            SpscColumnRing)

#: Worker-local connection ids occupy the low CONN_BITS of the packed
#: int32 ``conn`` column; the worker id rides above them.  22 bits of
#: local ids x up to 512 workers fits int32 with the sign bit clear.
CONN_BITS = 22
CONN_MASK = (1 << CONN_BITS) - 1
MAX_WORKERS = 1 << (31 - CONN_BITS)


def pack_conn(worker_id: int, local_cid: int) -> int:
    return (worker_id << CONN_BITS) | local_cid


def conn_worker(conn: int) -> int:
    return conn >> CONN_BITS


def conn_local(conn: int) -> int:
    return conn & CONN_MASK


def req_ring_fields(u: int) -> Tuple:
    """Request-ring slot columns: the RAW wire record matrix (rows ARE
    the columnar request records — decode happens once, owner-side)
    plus the worker-local connection id per row."""
    return (("conn", "<i4", 0), ("raw", "u1", wire.req_nbytes(u)))


def rsp_ring_fields(u: int) -> Tuple:
    """Response-ring slot columns: DECODED response columns (the owner
    already has them as arrays off the completion ring; the worker
    encodes wire bytes per connection at the socket edge)."""
    return (("conn", "<i4", 0), ("req_id", "<u4", 0),
            ("status", "u1", 0), ("reason", "u1", 0),
            ("found", "u1", 0), ("has_uid", "u1", 0),
            ("step", "<i4", 0), ("retry_after_us", "<u4", 0),
            ("uid", "<i4", 2), ("value", "<i4", u))


def create_ring_pair(u: int, nslots: int, slot_rows: int,
                     worker_id: int) -> Tuple[SpscColumnRing,
                                              SpscColumnRing]:
    """One worker's (request, response) ring pair, creator side."""
    req = SpscColumnRing.create(nslots, slot_rows, req_ring_fields(u),
                                name_hint=f"hermes_req{worker_id}")
    rsp = SpscColumnRing.create(nslots, slot_rows, rsp_ring_fields(u),
                                name_hint=f"hermes_rsp{worker_id}")
    return req, rsp


# -- the worker process edge --------------------------------------------------


class ShmWorker:
    """One front-end worker: TCP accept + frame decode on its own GIL,
    requests forwarded through its request ring, responses drained from
    its response ring.  Thread shape mirrors ``ColumnarTcpServer`` (one
    accept thread, one reader per connection, one response-drain thread
    in place of the pump); the reader threads serialize on
    ``_ring_lock`` so the request ring sees ONE producer."""

    def __init__(self, worker_id: int, req_ring: SpscColumnRing,
                 rsp_ring: SpscColumnRing, u: int,
                 host: str = "127.0.0.1", port: int = 0,
                 reuseport: bool = False,
                 push_timeout_s: float = 2.0,
                 retry_after_us: int = 2000):
        from hermes_tpu_torch.transport.tcp import (FramedSocket,
                                                    serving_listener)

        self.worker_id = worker_id
        self.req_ring = req_ring
        self.rsp_ring = rsp_ring
        self.u = u
        self.stride = wire.req_nbytes(u)
        self.push_timeout_s = push_timeout_s
        self.retry_after_us = retry_after_us
        self._FramedSocket = FramedSocket
        # minted via make_lock: ObsLocks under HERMES_LOCKLINT=1.
        # _ring_lock serializes the reader threads on the request ring
        # (collectively one producer); _map_lock guards conn bookkeeping.
        self._ring_lock = make_lock("ShmWorker._ring_lock")
        self._map_lock = make_lock("ShmWorker._map_lock")
        self._next_cid = 1
        self._sock_of: Dict[int, object] = {}
        self.undecodable = 0     # CRC-valid frames that fail record triage
        self.backpressured = 0   # rows refused S_RETRY_AFTER on a full ring
        self.rows_in = 0         # rows committed into the request ring
        self.rows_out = 0        # rows drained from the response ring
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: List = []
        self._listener = serving_listener(host, port, reuseport=reuseport)
        self.addr = self._listener.getsockname()
        accept_t = threading.Thread(target=self._accept_loop, daemon=True)
        self._rsp_t = threading.Thread(target=self._rsp_loop, daemon=True)
        # registered before starting either (see ColumnarTcpServer)
        self._threads.extend((accept_t, self._rsp_t))
        accept_t.start()
        self._rsp_t.start()

    # -- accept / read -------------------------------------------------------

    def _accept_loop(self) -> None:
        import socket as _socket
        import struct as _struct

        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                sock, _peer = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return
            # bound sends only — a non-reading client must stall only
            # its own stream (the ColumnarTcpServer rationale)
            sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDTIMEO,
                            _struct.pack("ll", 1, 0))
            fsock = self._FramedSocket(sock)
            with self._map_lock:
                cid, self._next_cid = self._next_cid, self._next_cid + 1
                if cid > CONN_MASK:
                    fsock.close()
                    raise RuntimeError(
                        f"worker {self.worker_id} exhausted its "
                        f"{CONN_MASK} connection ids")
                self._sock_of[cid] = fsock
                self._conns.append(fsock)
            t = threading.Thread(target=self._reader_loop,
                                 args=(fsock, cid), daemon=True)
            with self._map_lock:
                self._threads = [th for th in self._threads
                                 if th.is_alive()]
                self._threads.append(t)
            t.start()

    def _reader_loop(self, fsock, cid: int) -> None:
        try:
            self._reader_body(fsock, cid)
        finally:
            fsock.close()
            with self._map_lock:
                self._sock_of.pop(cid, None)
                try:
                    self._conns.remove(fsock)
                except ValueError:
                    pass

    def _reader_body(self, fsock, cid: int) -> None:
        import select

        while not self._stop.is_set():
            try:
                raw = fsock.recv()
            except Exception:
                return
            if raw is None:
                return
            raws = [raw]
            while select.select([fsock.sock], [], [], 0)[0]:
                try:
                    more = fsock.recv()
                except Exception:
                    more = None
                if more is None:
                    break
                raws.append(more)
            for raw in raws:
                if len(raw) == 0 or len(raw) % self.stride:
                    # torn record stream: no per-row identity to refuse
                    # on — tear the stream down LOUDLY (client sees EOF
                    # now, not a timeout later)
                    with self._map_lock:
                        self.undecodable += 1
                    return
                M = np.frombuffer(raw, np.uint8).reshape(-1, self.stride)
                try:
                    wire.check_request_matrix(M)
                except ValueError:
                    with self._map_lock:
                        self.undecodable += 1
                    return
                if not self._push(M, cid, fsock):
                    return

    def _push(self, M: np.ndarray, cid: int, fsock) -> bool:
        """Forward validated raw records into the request ring: claim a
        slot under ``_ring_lock``, ONE vectorized copy of up to
        slot_rows records, commit.  A ring full past the deadline
        refuses the REMAINING rows on the wire (never drops, never
        blocks unbounded).  Returns False only if the worker stopped."""
        rows = self.req_ring.spec.slot_rows
        k = M.shape[0]
        done = 0
        deadline = time.monotonic() + self.push_timeout_s
        while done < k:
            if self._stop.is_set():
                return False
            claimed = 0
            with self._ring_lock:
                slot = self.req_ring.try_claim()
                if slot is not None:
                    n = min(k - done, rows)
                    slot.cols["raw"][:n] = M[done: done + n]
                    slot.cols["conn"][:n] = cid
                    self.req_ring.commit(n)
                    self.rows_in += n
                    claimed = n
            if claimed:
                done += claimed
                deadline = time.monotonic() + self.push_timeout_s
                continue
            if time.monotonic() >= deadline:
                # loud backpressure: the owner stalled — surface
                # S_RETRY_AFTER / R_QUEUE_FULL for the overflow rows
                with self._map_lock:
                    self.backpressured += k - done
                self._refuse(M[done:], fsock)
                return True
            time.sleep(50e-6)
        return True

    def _refuse(self, M: np.ndarray, fsock) -> None:
        k = M.shape[0]
        rb = wire.RspBatch(
            status=np.full(k, wire.S_RETRY_AFTER, np.uint8),
            reason=np.full(k, wire.R_QUEUE_FULL, np.uint8),
            req_id=wire._get_col(M, 4, "<u4"),
            found=np.ones(k, bool), has_uid=np.zeros(k, bool),
            step=np.full(k, -1, np.int32),
            retry_after_us=np.full(k, self.retry_after_us, np.uint32),
            uid=np.zeros((k, 2), np.int32),
            value=np.zeros((k, self.u), np.int32))
        self._send_out(fsock, rb)

    # -- response drain ------------------------------------------------------

    def _rsp_loop(self) -> None:
        while True:
            slot = self.rsp_ring.poll()
            if slot is None:
                if self._stop.is_set() and self.rsp_ring.ready() == 0:
                    return
                time.sleep(0.0002)
                continue
            n = slot.count
            if n:
                self._deliver(slot)
                self.rows_out += n
            self.rsp_ring.ack()

    def _deliver(self, slot) -> None:
        """One ready response slot -> one encoded wire batch per
        connection (fancy-indexed column copies leave shared memory
        BEFORE the ack releases the slot)."""
        n = slot.count
        c = slot.cols
        conns = np.asarray(c["conn"][:n])
        for cid in np.unique(conns).tolist():
            idx = np.nonzero(conns == cid)[0]
            rb = wire.RspBatch(
                status=c["status"][:n][idx],
                reason=c["reason"][:n][idx],
                req_id=c["req_id"][:n][idx],
                found=c["found"][:n][idx] != 0,
                has_uid=c["has_uid"][:n][idx] != 0,
                step=c["step"][:n][idx],
                retry_after_us=c["retry_after_us"][:n][idx],
                uid=c["uid"][:n][idx],
                value=c["value"][:n][idx])
            with self._map_lock:
                fsock = self._sock_of.get(int(cid))
            if fsock is not None:
                self._send_out(fsock, rb)

    def _send_out(self, fsock, rb: wire.RspBatch) -> None:
        try:
            fsock.send(wire.encode_response_batch(rb, self.u))
        except OSError:
            fsock.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # the rsp drain thread flushes remaining ready slots before
        # exiting — join it FIRST, while client sockets are still open,
        # so in-flight resolutions reach their clients
        self._rsp_t.join(timeout=5.0)
        # now cut the streams (reader threads block in recv until their
        # socket closes), then join everything
        with self._map_lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for fsock in conns:
            fsock.close()
        for t in threads:
            t.join(timeout=2.0)


def shm_worker_main(worker_id: int, req_spec: RingSpec,
                    rsp_spec: RingSpec, u: int, host: str, port: int,
                    ready_q, push_timeout_s: float = 2.0) -> None:
    """One shm front-end worker process (module-level so ``spawn`` can
    import it): attaches the ring pair by name, binds SO_REUSEPORT on
    the shared port, reports ``(worker_id, port)`` once accepting, and
    serves until the parent's SIGTERM.  Deliberately torch-free: the
    import chain (wire/tcp/shm/concurrency) never loads ``torch`` or
    CUDA, so worker boot is milliseconds and only the store process
    holds a context on the card.

    Shutdown rides SIGTERM + a process-local Event, NOT a shared
    ``multiprocessing.Event``: mp's Event is a condition variable whose
    ``set()`` blocks until every sleeper CONFIRMS wake-up — a worker
    killed with SIGKILL while waiting on it would deadlock the parent's
    ``set()`` forever (the crashed sleeper can never confirm).  Signals
    have no such handshake, so the crash path the kill soak gates stays
    deadlock-free."""
    import signal

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    req_ring = SpscColumnRing.attach(req_spec)
    rsp_ring = SpscColumnRing.attach(rsp_spec)
    srv = ShmWorker(worker_id, req_ring, rsp_ring, u, host=host,
                    port=port, reuseport=True,
                    push_timeout_s=push_timeout_s)
    ready_q.put((worker_id, srv.addr[1]))
    done.wait()
    srv.close()
    req_ring.close()
    rsp_ring.close()


# -- the store-owner side -----------------------------------------------------


class StoreOwner:
    """The single device-owning merge/pump/scatter engine: polls every
    live worker's request ring in worker-id order, decodes the merged
    record matrix ONCE, runs ONE ``submit_batch`` + ``pump`` against
    the shared ``ColumnarFrontend`` per round, and scatters refusals
    and resolutions back to the owning worker's response ring.

    Single-threaded by contract (the caller — ``OneStoreServer``'s pump
    thread or the soak driver — is the only entrant), so the frontend
    needs no lock here."""

    def __init__(self, fe, rings: List[Tuple[SpscColumnRing,
                                             SpscColumnRing]],
                 alive: Optional[Callable[[int], bool]] = None,
                 push_timeout_s: float = 5.0):
        if fe.vbytes:
            raise ValueError(
                "the shm IPC plane is fixed-value mode only (the ring "
                "slot layout preallocates (rows, u) int32 value "
                "columns; heap stores stay on the socket planes)")
        if len(rings) > MAX_WORKERS:
            raise ValueError(f"at most {MAX_WORKERS} workers fit the "
                             f"packed conn id ({CONN_BITS} local bits)")
        self.fe = fe
        self.rings = rings
        self.alive = alive if alive is not None else (lambda w: True)
        self.push_timeout_s = push_timeout_s
        self.u = fe.u
        self.stride = wire.req_nbytes(fe.u)
        self.dead = [False] * len(rings)
        self.rows_in = 0          # rows merged out of request rings
        self.rows_by_worker = [0] * len(rings)  # the same, by worker
        self.rows_out = 0         # rows scattered into response rings
        self.dead_drop_rows = 0   # response rows for a dead worker
        self.torn_slots = 0       # dead producers' tombstone slots
        self.rsp_stalls = 0       # response-ring claim waits

    # -- liveness ------------------------------------------------------------

    def _mark_dead(self, w: int) -> None:
        if self.dead[w]:
            return
        self.dead[w] = True
        req_ring, _ = self.rings[w]
        if req_ring.torn():
            # the crashed producer's half-written slot: count the
            # tombstone, never read past it
            self.torn_slots += 1
        self.fe._count("ipc_worker_dead")

    def live_workers(self) -> List[int]:
        return [w for w in range(len(self.rings)) if not self.dead[w]]

    # -- merge (request rings -> ONE submit_batch) ---------------------------

    def intake(self) -> Dict[int, wire.RspBatch]:
        """Drain every live request ring (worker-id order — the
        deterministic merge), decode the concatenated record matrix
        once, submit as ONE batch with per-row packed conn tags.
        Returns the immediate refusals, grouped {packed_conn:
        RspBatch} like ``pump``'s emissions."""
        mats: List[np.ndarray] = []
        conns: List[np.ndarray] = []
        polled: List[SpscColumnRing] = []
        for w, (req_ring, _) in enumerate(self.rings):
            if self.dead[w]:
                continue
            if not self.alive(w):
                self._mark_dead(w)
                continue
            while True:
                slot = req_ring.poll()
                if slot is None:
                    break
                polled.append(req_ring)
                n = slot.count
                if n:
                    self.rows_by_worker[w] += n
                    mats.append(slot.cols["raw"][:n])
                    conns.append(slot.cols["conn"][:n].astype(np.int32)
                                 + np.int32(w << CONN_BITS))
        if not mats:
            for req_ring in polled:
                req_ring.ack()
            return {}
        # the one mandatory copy out of shared memory: concatenate the
        # slot views into the round's merged matrix, then release slots
        M = np.concatenate(mats) if len(mats) > 1 else mats[0].copy()
        conn = (np.concatenate(conns) if len(conns) > 1
                else conns[0])  # astype above already copied
        for req_ring in polled:
            req_ring.ack()
        self.rows_in += M.shape[0]
        batch = wire.decode_request_matrix(M, self.u)
        return self.fe.submit_batch(batch, conn=conn)

    # -- scatter (resolutions -> response rings) -----------------------------

    def scatter(self, rsps: Dict[int, wire.RspBatch]) -> None:
        """Route {packed_conn: RspBatch} back to the owning workers'
        response rings: one concatenated column set per worker per
        call, chunked to slot_rows.  Dead workers' rows are dropped
        LOUDLY (counted); a live worker that stops draining raises
        ``ShmBackpressure`` out of the pump."""
        by_w: Dict[int, List[int]] = {}
        for cid in sorted(rsps):
            by_w.setdefault(conn_worker(cid), []).append(cid)
        for w, cids in sorted(by_w.items()):
            n_rows = sum(len(rsps[c]) for c in cids)
            if self.dead[w] or not self.alive(w):
                self._mark_dead(w)
                self.dead_drop_rows += n_rows
                self.fe._count("ipc_dead_drop_rows", n_rows)
                continue
            parts = [rsps[c] for c in cids]
            cols = dict(
                conn=np.concatenate([np.full(len(rsps[c]),
                                             conn_local(c), np.int32)
                                     for c in cids]),
                req_id=np.concatenate([np.asarray(p.req_id, np.uint32)
                                       for p in parts]),
                status=np.concatenate([np.asarray(p.status, np.uint8)
                                       for p in parts]),
                reason=np.concatenate([np.asarray(p.reason, np.uint8)
                                       for p in parts]),
                found=np.concatenate([np.asarray(p.found, np.uint8)
                                      for p in parts]),
                has_uid=np.concatenate([np.asarray(p.has_uid, np.uint8)
                                        for p in parts]),
                step=np.concatenate([np.asarray(p.step, np.int32)
                                     for p in parts]),
                retry_after_us=np.concatenate(
                    [np.asarray(p.retry_after_us, np.uint32)
                     for p in parts]),
                uid=np.concatenate([np.asarray(p.uid, np.int32)
                                    .reshape(-1, 2) for p in parts]),
                value=np.concatenate(
                    [np.asarray(p.value, np.int32).reshape(-1, self.u)
                     for p in parts]))
            self._push_rows(w, n_rows, cols)

    def _push_rows(self, w: int, total: int,
                   cols: Dict[str, np.ndarray]) -> None:
        _, rsp_ring = self.rings[w]
        rows = rsp_ring.spec.slot_rows
        done = 0
        deadline = time.monotonic() + self.push_timeout_s
        while done < total:
            slot = rsp_ring.try_claim()
            if slot is None:
                if not self.alive(w):
                    self._mark_dead(w)
                    dropped = total - done
                    self.dead_drop_rows += dropped
                    self.fe._count("ipc_dead_drop_rows", dropped)
                    return
                if time.monotonic() >= deadline:
                    raise ShmBackpressure(
                        f"worker {w} response ring full for "
                        f"{self.push_timeout_s:.3f}s with the worker "
                        "alive: its drain thread is wedged — failing "
                        "the pump loudly instead of blocking")
                self.rsp_stalls += 1
                time.sleep(50e-6)
                continue
            n = min(total - done, rows)
            sl = slice(done, done + n)
            for name, arr in cols.items():
                slot.cols[name][:n] = arr[sl]
            rsp_ring.commit(n)
            self.rows_out += n
            done += n
            deadline = time.monotonic() + self.push_timeout_s

    # -- one owner round -----------------------------------------------------

    def step(self) -> int:
        """One merge + pump + scatter round.  Returns the number of
        rows moved (0 = nothing to do; the caller may sleep)."""
        before = self.rows_in + self.rows_out
        refusals = self.intake()
        if refusals:
            self.scatter(refusals)
        if not self.fe.idle():
            out = self.fe.pump()
            if out:
                self.scatter(out)
            self._series()
        return self.rows_in + self.rows_out - before

    def _series(self) -> None:
        rt = self.fe._rt()
        if rt.obs is None:
            return
        reg = rt.obs.registry
        live = self.live_workers()
        depth = sum(self.rings[w][0].ready() for w in live)
        free = min((self.rings[w][1].free_slots() for w in live),
                   default=0)
        reg.series("ipc_req_depth_series").append(rt.step_idx, depth)
        reg.series("ipc_rsp_free_series").append(rt.step_idx, free)
        reg.series("ipc_rsp_stall_series").append(rt.step_idx,
                                                  self.rsp_stalls)

    def counters(self) -> dict:
        return dict(rows_in=self.rows_in, rows_out=self.rows_out,
                    dead_drop_rows=self.dead_drop_rows,
                    torn_slots=self.torn_slots,
                    rsp_stalls=self.rsp_stalls,
                    dead_workers=[w for w, d in enumerate(self.dead)
                                  if d])


# -- the one-store topology ---------------------------------------------------


def claim_port(host: str) -> int:
    """A free port on ``host``, claimed up front: every worker must bind
    the SAME number for SO_REUSEPORT accept sharding."""
    import socket as _socket

    probe = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    probe.bind((host, 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def spawn_workers(target, args_of: Callable, n_workers: int,
                  ready_timeout_s: float, what: str,
                  boot_failed: Callable) -> list:
    """Start ``n_workers`` spawned daemon processes ``target(*args_of(w,
    ready_q))`` and block until each has put ``(w, port)`` on ``ready_q``.
    If one is not ready within ``ready_timeout_s`` or dies during boot,
    ``boot_failed(procs)`` stops them and this raises.  ``spawn``: a
    forked child of a process with a CUDA context cannot use CUDA."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("spawn")
    ready_q = ctx.Queue()
    procs = []
    for w in range(n_workers):
        p = ctx.Process(target=target, args=args_of(w, ready_q),
                        daemon=True)
        p.start()
        procs.append(p)
    ready = set()
    while len(ready) < n_workers:
        try:
            wid, _port = ready_q.get(timeout=ready_timeout_s)
        except _queue.Empty:
            boot_failed(procs)
            raise RuntimeError(
                f"{what}s failed to come up: {sorted(ready)} of "
                f"{n_workers} ready within {ready_timeout_s}s")
        ready.add(wid)
        if sum(p.is_alive() for p in procs) < n_workers:
            boot_failed(procs)
            raise RuntimeError(
                f"a {what} died during boot — check its stderr")
    return procs


class OneStoreServer:
    """The one-store topology: ``n_workers`` shm front-end PROCESSES sharding
    TCP accepts on one SO_REUSEPORT port, all feeding THIS process's
    single store through the ring pairs; one owner pump thread runs the
    merge/pump/scatter rounds.  Counterpart of
    ``launch.start_serve_workers`` (which gives every worker a PRIVATE
    store) — here the device program stays one store at full lane
    occupancy and only the socket work scales out."""

    def __init__(self, store, scfg=None, host: str = "127.0.0.1",
                 port: int = 0, n_workers: int = 2, nslots: int = 8,
                 slot_rows: int = 512, pump_sleep_s: float = 0.0002,
                 push_timeout_s: float = 5.0,
                 worker_push_timeout_s: float = 2.0,
                 ready_timeout_s: float = 120.0):
        from hermes_tpu_torch.serving.server import ColumnarFrontend

        if n_workers < 1:
            raise ValueError("need at least one shm worker")
        self.fe = ColumnarFrontend(store, scfg)
        u = self.fe.u
        self.rings = [create_ring_pair(u, nslots, slot_rows, w)
                      for w in range(n_workers)]
        port = port or claim_port(host)
        self.addr = (host, port)

        def boot_failed(procs):
            self.procs = procs
            self._teardown_procs()
            self._close_rings()

        self.procs = spawn_workers(
            shm_worker_main,
            lambda w, ready_q: (w, self.rings[w][0].spec,
                                self.rings[w][1].spec, u, host, port,
                                ready_q, worker_push_timeout_s),
            n_workers, ready_timeout_s, "shm worker", boot_failed)
        self.owner = StoreOwner(
            self.fe, self.rings,
            alive=lambda w: self.procs[w].is_alive(),
            push_timeout_s=push_timeout_s)
        self._pump_sleep = pump_sleep_s
        self._stop = threading.Event()
        self._closed = False
        self.pump_error: Optional[BaseException] = None
        self._pump_t = threading.Thread(target=self._pump_loop,
                                        daemon=True)
        self._pump_t.start()

    def alive(self) -> int:
        return sum(p.is_alive() for p in self.procs)

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                moved = self.owner.step()
            except BaseException as e:  # noqa: BLE001 — store died or a
                # live worker wedged its ring: fail LOUDLY, stop the
                # workers so every client sees EOF now
                self.pump_error = e
                self._stop.set()
                rt = self.fe._rt()
                if rt.obs is not None:
                    rt.obs.flight_dump("ipc_pump_error",
                                       dict(err=repr(e)))
                self._teardown_procs(timeout_s=5.0)
                raise
            if moved == 0 and self.fe.idle():
                time.sleep(0.001)
            else:
                time.sleep(self._pump_sleep)

    def _teardown_procs(self, timeout_s: float = 10.0) -> None:
        # SIGTERM -> the worker's clean close path (see shm_worker_main
        # on why this is a signal, not a shared Event); SIGKILL for
        # stragglers.  Both are no-ops on already-dead processes.
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=timeout_s)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)

    def _close_rings(self) -> None:
        for req_ring, rsp_ring in self.rings:
            req_ring.close()
            rsp_ring.close()

    def close(self, drain_timeout_s: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._pump_t.join(timeout=5.0)
        # inline drain: resolve and scatter everything still in flight
        # before stopping the workers, so connected clients get their
        # answers instead of an EOF race
        if self.pump_error is None:
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                try:
                    moved = self.owner.step()
                except ShmBackpressure:
                    break
                if moved == 0 and self.fe.idle():
                    break
        self._teardown_procs()
        self._close_rings()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the deterministic witness ------------------------------------------------


def run_shm_soak(cfg=None, scfg=None, n_workers: int = 2,
                 ops_per_worker: int = 512, batch: int = 64,
                 read_frac: float = 0.65, seed: int = 14,
                 nslots: int = 4, slot_rows: Optional[int] = None,
                 max_rounds: int = 50_000, device="cuda") -> dict:
    """Deterministic one-store soak: REAL shm rings, SIMULATED workers
    (in-process, single thread), a VirtualClock, and the owner's
    worker-id-order merge — the replay witness for the IPC plane.
    Every worker's outbound bytes are logged in drain order; same seed
    + config => byte-identical logs and identical counters, which is
    the determinism leg the serving tests hold.

    Workers submit their streams batch-by-batch, skipping a round when
    their request ring is full (deterministic backpressure — nothing is
    dropped, the rows just wait), and drain their response rings after
    every owner round.  Runs until every submitted row has exactly one
    response row and the frontend envelope is empty."""
    import hashlib

    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving.server import (ColumnarFrontend,
                                                 ServingConfig, VirtualClock,
                                                 verify_columnar)

    cfg = cfg or HermesConfig(n_replicas=4, n_keys=1 << 10,
                              n_sessions=64, value_words=6)
    scfg = scfg or ServingConfig(queue_cap=4096,
                                 tenant_rate_per_s=1e9,
                                 tenant_burst=1e9, tenant_quota=1 << 20)
    store = KVS(cfg, record="array", device=device)  # the checker's witness
    clock = VirtualClock()
    fe = ColumnarFrontend(store, scfg, clock=clock)
    u = fe.u
    rows = slot_rows or batch
    rings = [create_ring_pair(u, nslots, rows, w)
             for w in range(n_workers)]
    owner = StoreOwner(fe, rings)
    stride = wire.req_nbytes(u)
    try:
        # deterministic per-worker streams (encoded once, pushed in
        # ring-paced chunks)
        streams: List[np.ndarray] = []
        for w in range(n_workers):
            rng = np.random.default_rng(seed * 7919 + 31 * w + 1)
            k = ops_per_worker
            kind = np.where(
                rng.random(k) < read_frac, wire.K_GET,
                np.where(rng.random(k) < 0.5, wire.K_PUT, wire.K_RMW)
            ).astype(np.uint8)
            b = wire.ReqBatch(
                kind=kind,
                req_id=np.arange(1, k + 1, dtype=np.uint32),
                tenant=np.full(k, w, np.uint16),
                trace=np.zeros(k, np.uint16),
                deadline_us=np.zeros(k, np.uint32),
                key=rng.integers(0, cfg.n_keys, k).astype(np.int64),
                value=rng.integers(0, 1 << 20,
                                   (k, u)).astype(np.int32))
            raw = wire.encode_request_batch(b, u)
            streams.append(np.frombuffer(raw, np.uint8)
                           .reshape(k, stride))
        sent = [0] * n_workers
        recv = [0] * n_workers
        logs: List[List[bytes]] = [[] for _ in range(n_workers)]
        client_uids: List[Tuple[int, int]] = []
        for _ in range(max_rounds):
            # 1. workers submit (skip when the ring is full — the
            # deterministic backpressure shape)
            for w in range(n_workers):
                req_ring, _ = rings[w]
                while sent[w] < ops_per_worker:
                    slot = req_ring.try_claim()
                    if slot is None:
                        break
                    n = min(batch, ops_per_worker - sent[w], rows)
                    slot.cols["raw"][:n] = \
                        streams[w][sent[w]: sent[w] + n]
                    slot.cols["conn"][:n] = 1
                    req_ring.commit(n)
                    sent[w] += n
            # 2. one owner round
            owner.step()
            clock.advance(scfg.round_us * 1e-6)
            # 3. workers drain + log (the byte witness)
            for w in range(n_workers):
                _, rsp_ring = rings[w]
                while True:
                    slot = rsp_ring.poll()
                    if slot is None:
                        break
                    n = slot.count
                    c = slot.cols
                    # write uids the CLIENT saw commit, in drain order —
                    # the committed_write_lost witness set the serving
                    # gate cross-checks against the store history
                    minted = (np.asarray(c["status"][:n]) == wire.S_OK) \
                        & (np.asarray(c["has_uid"][:n]) != 0)
                    for i in np.nonzero(minted)[0].tolist():
                        client_uids.append((int(c["uid"][i, 0]),
                                            int(c["uid"][i, 1])))
                    conns = np.asarray(c["conn"][:n])
                    for cid in np.unique(conns).tolist():
                        idx = np.nonzero(conns == cid)[0]
                        rb = wire.RspBatch(
                            status=c["status"][:n][idx],
                            reason=c["reason"][:n][idx],
                            req_id=c["req_id"][:n][idx],
                            found=c["found"][:n][idx] != 0,
                            has_uid=c["has_uid"][:n][idx] != 0,
                            step=c["step"][:n][idx],
                            retry_after_us=c["retry_after_us"][:n][idx],
                            uid=c["uid"][:n][idx],
                            value=c["value"][:n][idx])
                        logs[w].append(
                            wire.encode_response_batch(rb, u))
                    recv[w] += int(n)
                    rsp_ring.ack()
            if (all(s == ops_per_worker for s in sent)
                    and all(r == ops_per_worker for r in recv)
                    and fe.idle()):
                break
        else:
            raise RuntimeError(
                f"shm soak failed to drain in {max_rounds} rounds: "
                f"sent={sent} recv={recv} idle={fe.idle()}")
        v = store.rt.check()
        assert v.ok, ("shm soak checker FAIL: "
                      f"{[f.reason[:160] for f in v.failures[:2]]}")
        ver = verify_columnar(fe)
        return dict(
            ok=True, checker_ok=bool(v.ok),
            worker_log_sha=[hashlib.sha256(b"".join(lg)).hexdigest()
                            for lg in logs],
            response_rows=list(recv),
            ipc=owner.counters(), verify=ver,
            counters=fe.counters(),
            _store=store, _client_uids=client_uids)
    finally:
        for req_ring, rsp_ring in rings:
            req_ring.close()
            rsp_ring.close()
