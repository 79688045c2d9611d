"""The networked RPC path of the serving front-end.

Two servers share one ``Frontend``:

  * ``LoopbackServer`` — in-process, byte-honest: every request and
    response round-trips through the full wire codec (encode -> CRC
    frame -> unframe -> decode), but no socket or thread exists, so
    soaks are single-threaded and byte-identically replayable on a
    ``VirtualClock`` (the CI gate / test path).
  * ``TcpRpcServer`` — real localhost sockets: one accept thread, one
    reader thread per connection feeding a locked intake, and one pump
    thread driving ``Frontend.pump`` — the honest end-to-end path
    ``bench.py --serve`` measures client-socket p50/p99 on.  Frames ride
    ``transport.tcp.FramedSocket`` (the CRC frame layer over a
    stream socket).

``RpcClient`` is the matching blocking client: ``call`` for one op,
``send``/``recv_next`` for open-loop pacing (requests in flight while
more are sent — the Poisson load shape needs a non-lockstep client).
"""

from __future__ import annotations

import select
import socket
import threading
from typing import Dict, List, Optional

import numpy as np

from hermes_tpu_torch.concurrency import make_lock
from hermes_tpu_torch.serving import wire
from hermes_tpu_torch.serving.server import Frontend


class LoopbackServer:
    """Byte-honest in-process server: the deterministic soak path."""

    def __init__(self, frontend: Frontend):
        self.fe = frontend
        self.u = frontend.u
        self.vbytes = frontend.vbytes
        self.wire_rx = 0
        self.wire_tx = 0
        self._out: List[bytes] = []

    def _roundtrip_req(self, req):
        from hermes_tpu_torch.transport import codec

        raw = codec.frame_unpack(codec.frame_pack(np.frombuffer(
            wire.encode_any_request(req, self.u, self.vbytes),
            np.uint8))).tobytes()
        self.wire_rx += len(raw) + codec.FRAME_OVERHEAD
        return wire.decode_any_request(raw, self.u, self.vbytes)

    def submit(self, req) -> Optional[object]:
        """One client request (single-op Request or batched
        ReadRequest) through the wire codec + admission.  Immediate
        refusals come back decoded; admitted ops resolve via ``pump``."""
        rsp = self.fe.submit(self._roundtrip_req(req))
        if rsp is None:
            return None
        return self._encode_out([rsp])[0]

    def pump(self) -> List[wire.Response]:
        return self._encode_out(self.fe.pump())

    def drain(self, max_rounds: int = 10_000) -> bool:
        """Pump until the frontend envelope is empty, keeping every
        response in the byte log (``Frontend.drain`` queues them for
        ``pop_responses``; this encodes them in emission order)."""
        ok = self.fe.drain(max_rounds)
        self._encode_out(self.fe.pop_responses())
        return ok

    def _encode_out(self, rsps) -> List[object]:
        out = []
        for rsp in rsps:
            raw = wire.encode_any_response(rsp, self.u, self.vbytes)
            self.wire_tx += len(raw)
            self._out.append(raw)
            out.append(wire.decode_any_response(raw, self.u,
                                                 self.vbytes))
        return out

    def response_log(self) -> bytes:
        """Concatenated response bytes in emission order — the
        determinism witness (same seed + config => byte-identical)."""
        return b"".join(self._out)


class TcpRpcServer:
    """Threaded localhost RPC server over CRC-framed sockets."""

    def __init__(self, frontend: Frontend, host: str = "127.0.0.1",
                 port: int = 0, pump_sleep_s: float = 0.0002):
        from hermes_tpu_torch.transport.tcp import FramedSocket

        self.fe = frontend
        self.u = frontend.u
        self.vbytes = frontend.vbytes
        self._FramedSocket = FramedSocket
        # minted via make_lock: ObsLocks under HERMES_LOCKLINT=1
        self._lock = make_lock("TcpRpcServer._lock")
        # lock-fairness split: ``_lock`` guards the Frontend
        # itself (submit/pump — held for a full store round at a time);
        # ``_map_lock`` guards only the iid<->connection bookkeeping, so
        # the pump's per-response map pops and the readers' iid minting
        # never extend the frontend critical section
        self._map_lock = make_lock("TcpRpcServer._map_lock")
        # client req_ids are only unique PER CONNECTION (wire.py): the
        # server re-mints each into a globally unique internal id before
        # submit, and maps it back on send — two connections using the
        # same req_id can never collide in the frontend's pending map or
        # steal each other's responses
        self._next_iid = 1
        self._conn_of: Dict[int, tuple] = {}  # iid -> (FramedSocket, rid)
        self.undecodable = 0  # frame-valid requests refused undecoded
        self._stop = threading.Event()
        self.pump_error: Optional[BaseException] = None
        self._pump_sleep = pump_sleep_s
        self._threads: List[threading.Thread] = []
        self._conns: List = []
        self._listener = socket.create_server((host, port))
        self.addr = self._listener.getsockname()
        # register BOTH threads before starting either: the accept loop
        # prunes/extends _threads (under _map_lock), so a start-then-
        # append would race the pump thread's registration away
        accept_t = threading.Thread(target=self._accept_loop, daemon=True)
        pump_t = threading.Thread(target=self._pump_loop, daemon=True)
        self._threads.extend((accept_t, pump_t))
        accept_t.start()
        pump_t.start()

    # -- server side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                sock, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # bound SENDS only (SO_SNDTIMEO, not settimeout — the reader
            # thread must keep blocking on recv indefinitely): a client
            # that stops reading fills its kernel buffer, and an
            # unbounded sendall would wedge the pump thread's send pass.
            # Sends happen OUTSIDE the frontend lock, so a stalled send
            # never blocks intake or other connections' submits; it can
            # still delay the pump's send pass by up to this bound once,
            # after which the send raises and the slow client's stream
            # dies — server-wide service survives one non-reading client.
            import struct as _struct
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            _struct.pack("ll", 1, 0))
            # CRC failures on implausible frame lengths tear the stream
            # down instead of desyncing it; plausible = the fixed
            # single-op size OR a variable read-request size
            # (a corrupted-but-plausible frame is skipped + counted)
            fsock = self._FramedSocket(
                sock, expect_lens=wire.plausible_request_len(self.u,
                                                         self.vbytes))
            t = threading.Thread(target=self._reader_loop, args=(fsock,),
                                 daemon=True)
            # register conn + thread (and prune finished readers so a
            # long-lived server's list doesn't grow with every
            # connection ever made) BEFORE start, under _map_lock:
            # close() snapshots both lists under the same lock
            with self._map_lock:
                self._conns.append(fsock)
                self._threads = [th for th in self._threads
                                 if th.is_alive()]
                self._threads.append(t)
            t.start()

    def _reader_loop(self, fsock) -> None:
        try:
            self._reader_body(fsock)
        finally:
            fsock.close()
            with self._map_lock:
                try:
                    self._conns.remove(fsock)
                except ValueError:
                    pass

    def _reader_body(self, fsock) -> None:
        while not self._stop.is_set():
            # batch intake: one blocking recv, then drain everything the
            # socket already buffered, and submit the whole batch under
            # ONE lock acquisition — the pump thread holds the lock for a
            # full store round at a time, so per-message locking would
            # throttle intake to ~1 request per round
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
            reqs = []
            for raw in raws:
                try:
                    reqs.append(wire.decode_any_request(raw, self.u,
                                                        self.vbytes))
                except ValueError:
                    # frame-valid but undecodable (payload-width/magic
                    # mismatch): refuse LOUDLY when the header still
                    # yields a req_id — never leave the client to time
                    # out on silence.  No lock needed: FramedSocket.send
                    # serializes itself, so the pump thread's concurrent
                    # sends on this socket can't splice frames.
                    rid = wire.peek_req_id(raw)
                    with self._map_lock:
                        self.undecodable += 1
                    if rid is not None:
                        try:
                            fsock.send(wire.encode_response(
                                wire.Response(
                                    status=wire.S_REJECTED, req_id=rid,
                                    found=False), self.u, self.vbytes))
                        except OSError:
                            fsock.close()
                            return
            # mint iids + record the return map OUTSIDE the frontend
            # lock (the map has its own lock): the frontend critical
            # section is exactly the submit calls, nothing else
            with self._map_lock:
                for req in reqs:
                    iid, self._next_iid = self._next_iid, self._next_iid + 1
                    self._conn_of[iid] = (fsock, req.req_id)
                    req.req_id = iid
            refusals = []
            with self._lock:
                for req in reqs:
                    rsp = self.fe.submit(req)
                    if rsp is not None:  # immediate refusal
                        refusals.append(rsp)
            outs = [out for out in map(self._resolve, refusals) if out]
            # send OUTSIDE the lock: a non-reading client stalls only
            # its own reader thread here, never the frontend
            for conn, rsp in outs:
                self._send_out(conn, rsp)

    def _resolve(self, rsp: wire.Response):
        """Swap the internal id back for the client's req_id; returns
        ``(fsock, rsp)`` ready to send, or None for an unknown (already
        torn down) connection.  Takes ``_map_lock`` itself — callers
        must NOT hold the frontend lock (that coupling was the
        fairness bug: per-response dict work inside the pump's critical
        section)."""
        with self._map_lock:
            ent = self._conn_of.pop(rsp.req_id, None)
        if ent is None:
            return None
        fsock, client_rid = ent
        rsp.req_id = client_rid
        return fsock, rsp

    def _send_out(self, fsock, rsp) -> None:
        try:
            fsock.send(wire.encode_any_response(rsp, self.u, self.vbytes))
        except OSError:
            # send timed out or failed mid-frame: the stream boundary is
            # gone, so the connection is unusable — tear it down
            fsock.close()

    def _pump_loop(self) -> None:
        import time as _time

        fe = self.fe
        while not self._stop.is_set():
            with self._lock:
                busy = bool(fe._intake or fe._pending or fe._abandoned)
            if not busy:
                _time.sleep(0.001)  # idle: don't spin the store
                continue
            try:
                with self._lock:
                    rsps = fe.pump()
                # publish completions OUTSIDE the frontend lock (the
                # fairness fix): the map swap is _map_lock-only,
                # so readers can submit while this pass runs
                outs = [out for out in map(self._resolve, rsps) if out]
            except Exception as e:  # noqa: BLE001 — store died (e.g.
                # StuckOpError): a silently dead pump thread would leave
                # every connected client hanging on its socket timeout.
                # Fail LOUDLY instead: record, stop, and close every
                # stream so clients see EOF now.
                self.pump_error = e
                self._stop.set()
                with self._map_lock:
                    conns = list(self._conns)
                for fsock in conns:
                    fsock.close()
                raise
            # sends OUTSIDE the lock: a stalled client blocks this send
            # pass (bounded by SO_SNDTIMEO) but never the reader
            # threads' intake path
            for fsock, rsp in outs:
                self._send_out(fsock, rsp)
            # ALWAYS yield between pumps: Python locks are unfair, and a
            # tight re-acquire starves the reader threads' submit path —
            # requests would sit unsubmitted for whole pump generations
            _time.sleep(self._pump_sleep)

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # snapshot under _map_lock, close/join OUTSIDE it: joining a
        # reader while holding the lock its exit path needs would
        # deadlock close() against the threads it is waiting out
        with self._map_lock:
            conns = list(self._conns)
            threads = list(self._threads)
        # close every accepted connection: reader threads blocked in
        # fsock.recv() only exit when their socket dies
        for fsock in conns:
            fsock.close()
        for t in threads:
            t.join(timeout=2.0)


# -- the columnar RPC path ---------------------------------------------------


class ColumnarLoopback:
    """Byte-honest in-process COLUMNAR server: every request batch and
    response batch round-trips the full columnar wire codec (encode ->
    CRC frame -> unframe -> decode) with no socket or thread, so
    columnar soaks replay byte-identically on a ``VirtualClock`` — the
    columnar twin of ``LoopbackServer`` and the serving gate's floor
    path.  The response byte log is record-for-record walkable by
    ``wire.response_extent`` (the columnar stream is byte-identical to
    the per-struct one), so ``soak.committed_uids`` works unchanged."""

    def __init__(self, frontend):
        self.fe = frontend
        self.u = frontend.u
        self.vbytes = frontend.vbytes
        self.wire_rx = 0
        self.wire_tx = 0
        self._out: List[bytes] = []

    def submit_batch(self, batch: wire.ReqBatch,
                     conn: int = 0) -> wire.RspBatch:
        """One client batch through the wire + admission; returns the
        decoded immediate-refusal batch (possibly empty)."""
        from hermes_tpu_torch.transport import codec

        raw = wire.encode_request_batch(batch, self.u, self.vbytes)
        raw = codec.frame_unpack(codec.frame_pack(
            np.frombuffer(raw, np.uint8))).tobytes()
        self.wire_rx += len(raw) + codec.FRAME_OVERHEAD
        b = wire.decode_request_batch(raw, self.u, self.vbytes)
        return self._encode_out(self.fe.submit_batch(b, conn=conn))

    def pump(self) -> Dict[int, wire.RspBatch]:
        return {cid: self._encode_out(rb)
                for cid, rb in self.fe.pump().items()}

    def drain(self, max_rounds: int = 10_000) -> bool:
        """Pump until the envelope drains, keeping every response batch
        in the byte log in emission order."""
        drained, emitted = self.fe.drain(max_rounds)
        for d in emitted:
            for cid in sorted(d):
                self._encode_out(d[cid])
        return drained

    def _encode_out(self, rb: wire.RspBatch) -> wire.RspBatch:
        if len(rb) == 0:
            return rb
        raw = wire.encode_response_batch(rb, self.u, self.vbytes)
        self.wire_tx += len(raw)
        self._out.append(raw)
        return wire.decode_response_batch(raw, self.u, self.vbytes)

    def response_log(self) -> bytes:
        """Concatenated response bytes in emission order — the
        determinism witness (same seed + config => byte-identical)."""
        return b"".join(self._out)


class ColumnarTcpServer:
    """Threaded localhost COLUMNAR RPC server: every inbound frame
    carries a whole request batch, and the pump sends ONE framed
    response batch per connection per round (the one-encode-per-
    connection-per-pump drain the ring plane was built for).

    ``reuseport=True`` binds the listener with SO_REUSEPORT so N worker
    PROCESSES shard accepts on one port (``launch.start_serve_workers``):
    the kernel load-balances new connections across workers, and each
    worker owns its own store, frontend, and GIL — the GIL stops being
    the admission ladder."""

    def __init__(self, frontend, host: str = "127.0.0.1", port: int = 0,
                 pump_sleep_s: float = 0.0002, reuseport: bool = False):
        from hermes_tpu_torch.transport.tcp import (FramedSocket,
                                                    serving_listener)

        self.fe = frontend
        self.u = frontend.u
        self.vbytes = frontend.vbytes
        self._FramedSocket = FramedSocket
        # minted via make_lock: ObsLocks under HERMES_LOCKLINT=1
        self._lock = make_lock("ColumnarTcpServer._lock")
        self._map_lock = make_lock("ColumnarTcpServer._map_lock")
        self._next_cid = 1
        self._sock_of: Dict[int, object] = {}
        self.undecodable = 0
        self._stop = threading.Event()
        self.pump_error: Optional[BaseException] = None
        self._pump_sleep = pump_sleep_s
        self._threads: List[threading.Thread] = []
        self._conns: List = []
        self._listener = serving_listener(host, port, reuseport=reuseport)
        self.addr = self._listener.getsockname()
        # register both threads before starting either (see TcpRpcServer)
        accept_t = threading.Thread(target=self._accept_loop, daemon=True)
        pump_t = threading.Thread(target=self._pump_loop, daemon=True)
        self._threads.extend((accept_t, pump_t))
        accept_t.start()
        pump_t.start()

    def _accept_loop(self) -> None:
        import struct as _struct

        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                sock, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # bound sends only — same rationale as TcpRpcServer: a
            # non-reading client must stall only its own stream
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            _struct.pack("ll", 1, 0))
            # columnar frames are variable-length (k * record strides),
            # so no plausible-length set: a CRC failure skips the frame
            fsock = self._FramedSocket(sock)
            with self._map_lock:
                cid, self._next_cid = self._next_cid, self._next_cid + 1
                self._sock_of[cid] = fsock
                self._conns.append(fsock)
            t = threading.Thread(target=self._reader_loop,
                                 args=(fsock, cid), daemon=True)
            # registered before start (see TcpRpcServer._accept_loop)
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
        while not self._stop.is_set():
            # batch intake, batch-of-batches drain: one blocking recv,
            # then everything the socket already buffered, submitted
            # under ONE frontend lock acquisition
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
            batches = []
            for raw in raws:
                try:
                    batches.append(wire.decode_request_batch(
                        raw, self.u, self.vbytes))
                except ValueError:
                    # a CRC-valid frame that doesn't parse as a batch
                    # (torn record stream, width mismatch) means the
                    # sender's batch framing itself is broken — there is
                    # no per-row identity to refuse on, so tear the
                    # stream down LOUDLY (client sees EOF now, not a
                    # timeout later)
                    with self._map_lock:
                        self.undecodable += 1
                    return
            refusals = []
            with self._lock:
                for b in batches:
                    rb = self.fe.submit_batch(b, conn=cid)
                    if len(rb):
                        refusals.append(rb)
            for rb in refusals:  # send outside the lock
                self._send_out(fsock, rb)

    def _send_out(self, fsock, rb: wire.RspBatch) -> None:
        try:
            fsock.send(wire.encode_response_batch(rb, self.u,
                                                  self.vbytes))
        except OSError:
            fsock.close()

    def _pump_loop(self) -> None:
        import time as _time

        fe = self.fe
        while not self._stop.is_set():
            with self._lock:
                busy = not fe.idle()
            if not busy:
                _time.sleep(0.001)
                continue
            try:
                with self._lock:
                    rsps = fe.pump()
            except Exception as e:  # noqa: BLE001 — store died: fail
                # loudly, close every stream so clients see EOF now
                self.pump_error = e
                self._stop.set()
                with self._map_lock:
                    conns = list(self._conns)
                for fsock in conns:
                    fsock.close()
                raise
            # publish OUTSIDE the frontend lock: one encode + one send
            # per connection per round
            for cid in sorted(rsps):
                with self._map_lock:
                    fsock = self._sock_of.get(cid)
                if fsock is not None:
                    self._send_out(fsock, rsps[cid])
            _time.sleep(self._pump_sleep)

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # snapshot under _map_lock, close/join outside it (see
        # TcpRpcServer.close)
        with self._map_lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for fsock in conns:
            fsock.close()
        for t in threads:
            t.join(timeout=2.0)


class ColumnarClient:
    """Blocking columnar client: one framed request BATCH per send;
    a batch's rows may resolve across several server pump rounds, so
    ``call_batch`` collects response batches until every req_id has
    answered."""

    def __init__(self, addr, u: int, vbytes: int = 0,
                 timeout_s: float = 30.0):
        from hermes_tpu_torch.transport.tcp import FramedSocket

        sock = socket.create_connection(addr, timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.fsock = FramedSocket(sock)
        self.u = u
        self.vbytes = vbytes
        self._next_id = 1

    def next_ids(self, k: int) -> np.ndarray:
        ids = np.arange(self._next_id, self._next_id + k, dtype=np.uint32)
        self._next_id += k
        return ids

    def send_batch(self, batch: wire.ReqBatch) -> None:
        self.fsock.send(wire.encode_request_batch(batch, self.u,
                                                  self.vbytes))

    def recv_batch(self) -> Optional[wire.RspBatch]:
        raw = self.fsock.recv()
        if raw is None:
            return None
        return wire.decode_response_batch(raw, self.u, self.vbytes)

    def call_batch(self, batch: wire.ReqBatch) -> Dict[int, wire.Response]:
        """Send one batch and block until every row has a response;
        returns {req_id: Response}."""
        want = set(int(r) for r in batch.req_id.tolist())
        self.send_batch(batch)
        out: Dict[int, wire.Response] = {}
        while want:
            rb = self.recv_batch()
            if rb is None:
                raise ConnectionError("server closed mid-batch")
            for r in rb.to_responses():
                out[r.req_id] = r
                want.discard(r.req_id)
        return out

    def close(self) -> None:
        self.fsock.close()


def serve_worker_main(worker_id: int, host: str, port: int, cfg, scfg,
                      ready_q, stop_ev, device="cuda") -> None:
    """One accept-sharding worker process (module-level so the
    ``spawn`` start method can import it): own KVS, own
    ColumnarFrontend, own ColumnarTcpServer bound SO_REUSEPORT on the
    shared port.  Reports ``(worker_id, port)`` on ``ready_q`` once
    accepting, then serves until ``stop_ev`` fires.  On the card each
    worker holds its own CUDA context (a ``spawn``ed process: a forked
    child of a process with a context cannot use CUDA)."""
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving.server import ColumnarFrontend

    store = KVS(cfg, device=device)
    fe = ColumnarFrontend(store, scfg)
    srv = ColumnarTcpServer(fe, host=host, port=port, reuseport=True)
    ready_q.put((worker_id, srv.addr[1]))
    stop_ev.wait()
    srv.close()


class RpcClient:
    """Blocking client over one CRC-framed socket."""

    def __init__(self, addr, u: int, timeout_s: float = 30.0,
                 vbytes: int = 0):
        from hermes_tpu_torch.transport.tcp import FramedSocket

        sock = socket.create_connection(addr, timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.fsock = FramedSocket(
            sock, expect_lens=wire.plausible_response_len(u, vbytes))
        self.u = u
        self.vbytes = vbytes
        self._next_id = 1

    def next_id(self) -> int:
        rid, self._next_id = self._next_id, self._next_id + 1
        return rid

    def send(self, req) -> None:
        self.fsock.send(wire.encode_any_request(req, self.u, self.vbytes))

    def recv_next(self) -> Optional[object]:
        raw = self.fsock.recv()
        if raw is None:
            return None
        return wire.decode_any_response(raw, self.u, self.vbytes)

    def call(self, kind: str, key: int, value=None, tenant: int = 0,
             deadline_us: int = 0, data=None) -> wire.Response:
        req = wire.Request(kind=kind, req_id=self.next_id(), tenant=tenant,
                           key=key, deadline_us=deadline_us, value=value,
                           data=data)
        self.send(req)
        rsp = self.recv_next()
        if rsp is None:
            raise ConnectionError("server closed mid-call")
        return rsp

    def call_mget(self, keys, tenant: int = 0,
                  deadline_us: int = 0) -> wire.ReadResponse:
        """One batched K_MGET round trip."""
        req = wire.ReadRequest(kind="mget", req_id=self.next_id(),
                               tenant=tenant, keys=list(keys),
                               deadline_us=deadline_us)
        self.send(req)
        rsp = self.recv_next()
        if rsp is None:
            raise ConnectionError("server closed mid-call")
        return rsp

    def call_scan(self, lo: int, hi: int, tenant: int = 0,
                  deadline_us: int = 0) -> wire.ReadResponse:
        """One K_SCAN round trip over keys [lo, hi)."""
        req = wire.ReadRequest(kind="scan", req_id=self.next_id(),
                               tenant=tenant, lo=lo, hi=hi,
                               deadline_us=deadline_us)
        self.send(req)
        rsp = self.recv_next()
        if rsp is None:
            raise ConnectionError("server closed mid-call")
        return rsp

    def close(self) -> None:
        self.fsock.close()
