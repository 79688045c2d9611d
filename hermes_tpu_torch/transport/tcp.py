"""TCP transport: the port of ``hermes_tpu/transport/tcp.py``.

A ctypes binding of the C++ full-mesh exchanger
(``native/tcp_transport.cpp``, built with ``g++ -pthread`` into
``_build/`` at first use by ``build.load_cxx``).  One process = one
replica; ``TcpMesh.exchange`` moves one fixed-size block a peer a call
with per-edge FIFO and reliability (TCP): the lockstep schedule of the
sim transport over real sockets.  ``TcpHostTransport`` adapts it to the
``HostTransport`` interface for ``distributed.py``, every block in a
checksummed frame.  ``FramedSocket`` and ``serving_listener`` are the
serving tier's stream helpers.

Each rank listens at ``base_port + rank``; a failed build or link, a
mesh that cannot form, or a peer that dies mid-run raises.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from hermes_tpu_torch import build
from hermes_tpu_torch.concurrency import make_lock

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "tcp_transport.cpp"


def _load():
    """The mesh library, built from the checkout's source if needed."""
    return build.load_cxx(_SRC, build.THREAD_FLAGS)


def serving_listener(host: str, port: int, reuseport: bool = False,
                     backlog: int = 128):
    """Bound+listening TCP socket for the serving RPC servers.
    ``reuseport=True`` sets SO_REUSEPORT before bind so N
    worker processes can shard accepts on ONE port — the kernel
    load-balances incoming connections across the listeners.  Raises
    loudly where the platform has no SO_REUSEPORT rather than silently
    falling back to a single-listener bind (the second worker would
    EADDRINUSE anyway, later and more confusingly)."""
    import socket as _socket

    sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    try:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        if reuseport:
            if not hasattr(_socket, "SO_REUSEPORT"):
                raise RuntimeError(
                    "accept sharding needs SO_REUSEPORT, which this "
                    "platform's socket module does not expose")
            sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(backlog)
    except BaseException:
        sock.close()
        raise
    return sock


class FramedSocket:
    """Checksummed-frame message boundary over one stream socket
    (the serving RPC path).  Every message crosses as a
    CRC frame (``codec.frame_pack``): the fixed header carries
    the payload length (the stream framing) AND the checksum (end-to-end
    integrity) — a corrupt frame raises ``codec.FrameCorrupt`` at the
    receiver, which must treat it as dropped, never decode it.

    Blocking, one-message-at-a-time; the serving server gives each
    connection its own reader thread.  ``send`` is
    internally serialized, so two threads sharing one FramedSocket can
    never splice frames mid-stream.

    ``expect_lens`` (optional: a set of plausible payload lengths, OR a
    predicate ``len -> bool`` for variable-size protocols like the
    multi-get and scan frames) is consulted ONLY when a frame fails
    its CRC: a failing frame whose length field is not a plausible
    message size most likely had the LENGTH itself corrupted — skipping
    it would silently misalign the stream cursor — so the stream tears
    down loudly instead.  Frames with a valid CRC pass through at any
    length (the server must still see wrong-width-but-intact requests
    to refuse them decodably)."""

    def __init__(self, sock, expect_lens=None):
        from hermes_tpu_torch.transport import codec

        self._codec = codec
        self.sock = sock
        self.corrupt_dropped = 0
        if expect_lens is None or callable(expect_lens):
            self._plausible = expect_lens
        else:
            lens = frozenset(expect_lens)
            self._plausible = lens.__contains__
        # make_lock: instrumented under HERMES_LOCKLINT=1 (sanitizer
        # soaks), plain threading.Lock otherwise
        self._send_lock = make_lock("FramedSocket._send_lock")

    def send(self, payload: bytes) -> None:
        frame = self._codec.frame_pack(np.frombuffer(
            bytes(payload), np.uint8))
        # sendall UNDER the lock is deliberate (a BlockingAudit in
        # concurrency.REGISTRY): the lock exists precisely to keep
        # whole frames atomic on the stream, and SO_SNDTIMEO bounds
        # the stall a non-reading peer can impose
        with self._send_lock:
            self.sock.sendall(frame.tobytes())

    def _read_exact(self, n: int):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None  # peer closed
            buf += chunk
        return bytes(buf)

    def recv(self):
        """One framed payload as bytes, None on orderly EOF.  A frame
        that fails its CRC is counted and skipped (the serving analogue
        of TcpHostTransport's corrupt -> zero-block downgrade); a
        header too mangled to carry a believable length — or, with
        ``expect_lens``, a CRC failure on an implausible length —
        tears the stream down (raises), since the message boundary
        itself is suspect."""
        codec = self._codec
        while True:
            hdr = self._read_exact(codec.FRAME_OVERHEAD)
            if hdr is None:
                return None
            magic, _algo, _pad, length, _crc = codec.FRAME_HEADER.unpack(hdr)
            if magic != codec.FRAME_MAGIC or length > (1 << 26):
                raise codec.FrameCorrupt(
                    f"unrecoverable stream framing (magic 0x{magic:04x}, "
                    f"len {length}): message boundary lost")
            body = self._read_exact(length)
            if body is None:
                return None
            try:
                payload = codec.frame_unpack(np.frombuffer(
                    hdr + body, np.uint8))
            except codec.FrameCorrupt:
                if (self._plausible is not None
                        and not self._plausible(length)):
                    # the CRC failed AND the length field names no
                    # plausible message: the corruption likely hit the
                    # length itself, so the bytes just consumed straddle
                    # a real frame boundary — "skip and continue" would
                    # silently desynchronize the stream
                    raise codec.FrameCorrupt(
                        f"CRC failure on implausible frame length "
                        f"{length}: length field suspect, stream "
                        f"alignment lost") from None
                self.corrupt_dropped += 1
                continue
            return payload.tobytes()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class TcpMesh:
    """Full-mesh, step-synchronous block exchange between replica processes.

    ``registry`` (optional ``obs.MetricsRegistry``) counts
    exchanges and wire bytes per rank — the distributed driver's transport
    feed into the obs metrics snapshot."""

    def __init__(self, my_rank: int, n_ranks: int, hosts: str | None = None,
                 base_port: int = 29500, registry=None):
        self.registry = registry
        lib = _load()
        lib.ht_create.restype = ctypes.c_void_p
        lib.ht_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.ht_exchange.restype = ctypes.c_int
        lib.ht_exchange.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ht_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self.my_rank = my_rank
        self.n_ranks = n_ranks
        hosts = hosts or ",".join(["127.0.0.1"] * n_ranks)
        self._h = lib.ht_create(my_rank, n_ranks, hosts.encode(), base_port)
        if not self._h:
            raise RuntimeError(
                f"tcp mesh setup failed (rank {my_rank}/{n_ranks}, base_port {base_port})"
            )

    def exchange(self, out_slices: np.ndarray) -> np.ndarray:
        """out_slices: (R, B) uint8, slice r to rank r.  Returns (R, B) with
        slice r received from rank r (self slice copied through)."""
        out = np.ascontiguousarray(out_slices, dtype=np.uint8)
        if out.ndim != 2 or out.shape[0] != self.n_ranks:
            raise ValueError(f"want ({self.n_ranks}, B) uint8 slices, got "
                             f"{out.shape}")
        inb = np.empty_like(out)
        rc = self._lib.ht_exchange(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(out.shape[1]),
            inb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise RuntimeError("tcp exchange failed (peer closed?)")
        if self.registry is not None:
            self.registry.counter("net_tcp_exchanges").inc()
            # every exchange moves one block per non-self peer, both ways
            self.registry.counter("net_tcp_bytes_sent").inc(
                int(out.shape[1]) * (self.n_ranks - 1))
            self.registry.counter("net_tcp_bytes_recv").inc(
                int(out.shape[1]) * (self.n_ranks - 1))
        return inb

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ht_destroy(self._h)
            self._h = None

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


class TcpHostTransport:
    """``transport.base.HostTransport`` over the C++ TcpMesh, one process =
    one replica (the socket path as a transport the chaos interposer can
    wrap).

    Single-rank layout: outbound blocks are THIS rank's (no leading R_src
    axis); inbound blocks carry a leading ``(R_src, ...)`` axis with the
    destination implicit (``local_rank`` mode of
    chaos.net.FaultingTransport).

    Outbound blocks may be tensors (on the card: one ``.cpu()`` of each
    field) or numpy; inbound blocks are numpy.

    Every block crosses the wire as a checksummed FRAME
    (codec.frame_pack): TCP already guarantees link integrity, but the
    frame CRC is END-TO-END — a corrupted or mis-framed payload (buggy
    peer, adversarial interposer, torn buffer) is detected on receipt and
    downgraded to a DROP (zero block, counted in ``corrupt_dropped``)
    instead of a scrambled key/ts/value entering the protocol, which
    tolerates drops by design (re-INV, ack accumulation, replay scan)."""

    def __init__(self, cfg, my_rank: int, n_ranks: int,
                 hosts: str | None = None, base_port: int = 29500,
                 registry=None, mesh=None):
        from hermes_tpu_torch.core import state as st
        from hermes_tpu_torch.transport import codec

        self._codec = codec
        self.cfg = cfg
        self.my_rank = my_rank
        self.n_ranks = n_ranks
        # ``mesh``: injectable exchanger (tests stub the socket layer to
        # exercise the frame path without a live peer set)
        self.mesh = mesh if mesh is not None else TcpMesh(
            my_rank, n_ranks, hosts=hosts, base_port=base_port,
            registry=registry)
        self._inv_t = _numpy(st.empty_invs(cfg))
        self._ack_row_t = _numpy(st.empty_acks(cfg))
        self._val_t = _numpy(st.empty_vals(cfg))
        self.corrupt_dropped = 0

    def _exchange_framed(self, template, rows):
        """Frame per-peer payload rows, move them through the mesh, verify
        + unpack each inbound frame (corrupt -> zero block + counter)."""
        codec = self._codec
        framed = np.stack([codec.frame_pack(r) for r in rows])
        inb = self.mesh.exchange(framed)
        blocks = []
        for r in range(self.n_ranks):
            try:
                payload = codec.frame_unpack(inb[r])
                blocks.append(codec.unpack(template, payload))
            except codec.FrameCorrupt:
                self.corrupt_dropped += 1
                if self.mesh.registry is not None:
                    self.mesh.registry.counter("net_tcp_corrupt_dropped").inc()
                blocks.append(type(template)(
                    *[np.zeros_like(np.asarray(f)) for f in template]))
        return codec.stack(blocks)

    def _bcast(self, template, block):
        """INV/VAL: the same serialized block goes to every peer (one copy
        of each field to the host if it lies on the card)."""
        payload = self._codec.pack(_numpy(block))
        return self._exchange_framed(
            template, [payload] * self.n_ranks)

    def exchange_inv(self, out_inv, step: int):
        return self._bcast(self._inv_t, out_inv)

    def exchange_val(self, out_val, step: int):
        return self._bcast(self._val_t, out_val)

    def exchange_ack(self, out_ack, step: int):
        """ACK: row p of my (R, L) block routes to rank p."""
        blk = _numpy(out_ack)
        rows = [self._codec.pack(type(blk)(*(x[p] for x in blk)))
                for p in range(self.n_ranks)]
        return self._exchange_framed(self._ack_row_t, rows)

    def pending(self) -> int:
        return 0  # TCP delivers within the exchange: nothing in flight after

    def close(self) -> None:
        self.mesh.close()


def _numpy(block):
    """A block's fields as numpy arrays (tensors copied to the host)."""
    return type(block)(*(x.cpu().numpy() if hasattr(x, "cpu")
                         else np.asarray(x) for x in block))
