"""RPC wire format of the serving front-end.

One client op = one fixed-size REQUEST message; one resolution = one
fixed-size RESPONSE.  Both are little-endian structs followed by the
config's fixed value-payload width (``value_words - 2`` int32 words —
the same "both ends derive the layout from the same config" discipline
as the replica wire codec, transport/codec.py), so a message's byte
length is known from the config alone.  Every message that crosses a
real socket rides a checksummed CRC frame (``codec.frame_pack`` /
``frame_unpack`` — the frame layer): corruption is detected on
receipt and the frame is dropped, never decoded into a scrambled
key/deadline/tenant.

Deadlines are RELATIVE microseconds in the request (0 = none); the
server stamps the absolute expiry on intake against ITS clock, so a
client never needs clock sync to bound its wait.  The response echoes
``req_id`` (client-chosen, unique per connection) and carries either the
op result or a loud refusal:

  * ``S_RETRY_AFTER`` — admission control / backpressure / load shed;
    ``retry_after_us`` is the server's earliest-retry hint and ``reason``
    says which rung refused (queue_full / quota / rate / shed_write /
    shed_read) — queue-full is an explicit signal, NEVER silent
    buffering;
  * ``S_DEADLINE`` — the op's deadline expired (at intake or at
    completion).  For updates this is a MAYBE: the broadcast may still
    commit (exactly the crash-'lost' semantics, kvs.C_LOST);
  * ``S_REJECTED`` — definitively did not happen (elastic fence /
    degraded-mode shed inside the store);
  * ``S_LOST`` — the serving replica died holding the op (maybe).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

# -- op kinds (wire) ---------------------------------------------------------
K_GET, K_PUT, K_RMW = 1, 2, 3
# batched read verbs: K_MGET carries a count-prefixed key
# vector, K_SCAN a [lo, hi) fleet/dense key range — both answered by the
# store's device-resident local-read fast path (kvs.KVS.multi_get /
# Fleet.multi_get), falling back to the round path per Invalid key
K_MGET, K_SCAN = 4, 5
_KIND_NAMES = {K_GET: "get", K_PUT: "put", K_RMW: "rmw"}
_KIND_CODES = {v: k for k, v in _KIND_NAMES.items()}
_READ_KIND_NAMES = {K_MGET: "mget", K_SCAN: "scan"}
_READ_KIND_CODES = {v: k for k, v in _READ_KIND_NAMES.items()}

# -- response statuses -------------------------------------------------------
S_OK = 0           # op completed (kind's normal completion)
S_RMW_ABORT = 1    # rmw lost its race (reference abort semantics)
S_REJECTED = 2     # definitively did NOT happen (fence / degraded shed)
S_RETRY_AFTER = 3  # refused at the front door; retry_after_us hints when
S_DEADLINE = 4     # deadline expired (updates: MAYBE committed)
S_LOST = 5         # replica crash holding the op (MAYBE committed)
STATUS_NAMES = {S_OK: "ok", S_RMW_ABORT: "rmw_abort", S_REJECTED: "rejected",
                S_RETRY_AFTER: "retry_after", S_DEADLINE: "deadline",
                S_LOST: "lost"}

# -- retry_after reasons (which admission rung refused) ----------------------
R_NONE = 0
R_QUEUE_FULL = 1   # bounded intake queue at capacity
R_QUOTA = 2        # tenant's in-flight session quota exhausted
R_RATE = 3         # tenant's token bucket empty
R_SHED_WRITE = 4   # overload ladder rung 1: new writes shed
R_SHED_READ = 5    # overload ladder rung 2: non-hot-key reads shed
REASON_NAMES = {R_NONE: "", R_QUEUE_FULL: "queue_full", R_QUOTA: "quota",
                R_RATE: "rate", R_SHED_WRITE: "shed_write",
                R_SHED_READ: "shed_read"}

REQ_MAGIC = 0x5251   # 'QR'
RSP_MAGIC = 0x5253   # 'SR'
# magic u16 | kind u8 | pad u8 | req_id u32 | tenant u16 | trace u16 |
# deadline_us u32 | key i64
# (trace was pad until : nonzero = the op is sampled for per-op
# tracing, obs/tracing.py — same size, 0-compatible with old frames)
_REQ = struct.Struct("<HBBIHHIq")
# magic u16 | status u8 | reason u8 | req_id u32 | found u8 | has_uid u8 |
# pad u16 | step i32 | retry_after_us u32 | uid_hi i32 | uid_lo i32
# (has_uid is explicit: uid (0, 0) is a REAL write id — replica 0,
# session 0, op 0 — and must not read back as "absent")
_RSP = struct.Struct("<HBBIBBHiIii")


def req_nbytes(u: int) -> int:
    """Wire size of one (unframed) fixed-word request at payload width
    ``u`` (heap-mode messages are variable — see the vbytes tail)."""
    return _REQ.size + 4 * u


def rsp_nbytes(u: int) -> int:
    return _RSP.size + 4 * u


# -- value-heap payload tail ----------------------------------------
#
# With ``vbytes = cfg.max_value_bytes > 0`` (both ends derive it from the
# shared config, like ``u``), every K_PUT/K_RMW request and K_GET/K_RMW
# response swaps its fixed word payload for a LENGTH-PREFIXED byte tail:
# ``dlen u32 | dlen bytes`` — dlen = _DLEN_NONE marks "no payload" (a get
# request, a put response, the never-written key), distinct from a real
# zero-length value.  K_MGET/K_SCAN responses keep fixed-stride rows
# (numpy-packable) of ``found|local|code|pad | dlen u32 | vcap(vbytes)
# padded bytes``.  The CRC frame already bounds and checksums the whole
# message, so the prefix only has to carve the tail.

_DLEN_NONE = 0xFFFFFFFF


def _vcap(vbytes: int) -> int:
    """Fixed per-row byte capacity of a heap-mode read-response row
    (word-aligned so the row stride stays 4-byte aligned)."""
    return 4 * ((vbytes + 3) // 4)


def _pack_tail(data, vbytes: int) -> bytes:
    if data is None:
        return struct.pack("<I", _DLEN_NONE)
    raw = bytes(data)
    if len(raw) > vbytes:
        raise ValueError(f"payload is {len(raw)} bytes > max_value_bytes="
                         f"{vbytes}")
    return struct.pack("<I", len(raw)) + raw


def _unpack_tail(buf: bytes, off: int, vbytes: int):
    """(data, next_offset) of a length-prefixed tail at ``off``."""
    if off + 4 > len(buf):
        raise ValueError("payload tail truncated (no length prefix)")
    (dlen,) = struct.unpack_from("<I", buf, off)
    if dlen == _DLEN_NONE:
        return None, off + 4
    if dlen > vbytes or off + 4 + dlen > len(buf):
        raise ValueError(f"payload tail declares {dlen} bytes "
                         f"(max {vbytes}, have {len(buf) - off - 4})")
    return buf[off + 4: off + 4 + dlen], off + 4 + dlen


@dataclasses.dataclass
class Request:
    kind: str                 # 'get' | 'put' | 'rmw'
    req_id: int
    tenant: int
    key: int
    deadline_us: int = 0      # RELATIVE to server intake; 0 = none
    value: Optional[List[int]] = None  # payload words (updates)
    data: Optional[bytes] = None       # heap mode: variable byte payload
    # trace id (obs/tracing.py): nonzero u16 = this op is
    # sampled for per-op tracing; rides the formerly-pad u16 of the fixed
    # header, so the wire size is unchanged and 0 (the old pad value)
    # means "not sampled" — old peers interoperate bit-for-bit
    trace: int = 0


@dataclasses.dataclass
class Response:
    status: int
    req_id: int
    reason: int = R_NONE
    found: bool = True
    step: int = -1
    retry_after_us: int = 0
    uid: Optional[tuple] = None
    value: Optional[List[int]] = None
    data: Optional[bytes] = None       # heap mode: variable byte payload

    @property
    def status_name(self) -> str:
        return STATUS_NAMES[self.status]

    @property
    def reason_name(self) -> str:
        return REASON_NAMES[self.reason]


def encode_request(req: Request, u: int, vbytes: int = 0) -> bytes:
    if req.kind not in _KIND_CODES:
        raise ValueError(f"unknown op kind {req.kind!r}")
    if not (0 <= req.deadline_us < 1 << 32):
        raise ValueError("deadline_us must fit u32 (relative microseconds)")
    if not (0 <= req.trace <= 0xFFFF):
        raise ValueError("trace id must fit u16 (0 = not sampled)")
    head = _REQ.pack(REQ_MAGIC, _KIND_CODES[req.kind], 0, req.req_id,
                     req.tenant, req.trace, req.deadline_us, req.key)
    if vbytes:
        # heap mode: the length-prefixed byte tail replaces the fixed
        # word payload (an update's bytes; None for gets)
        return head + _pack_tail(
            req.data if req.kind != "get" else None, vbytes)
    pay = np.zeros(u, np.int32)
    if req.value is not None:
        v = np.asarray(list(req.value), np.int32)
        if v.ndim != 1 or v.shape[0] > u:
            raise ValueError(f"value must be <= {u} int32 words")
        pay[: v.shape[0]] = v
    return head + pay.tobytes()


def peek_req_id(buf: bytes) -> Optional[int]:
    """Best-effort req_id from a request whose BODY is undecodable (wrong
    payload width): the fixed header may still be intact, letting the
    server refuse the request loudly instead of leaving the client to
    time out.  None when even the header is unusable."""
    buf = bytes(buf)
    if len(buf) < _RREQ.size:
        return None
    magic, _k, _p, req_id = struct.unpack_from("<HBBI", buf, 0)
    # both request layouts put req_id at the same offset behind their magic
    return req_id if magic in (REQ_MAGIC, RREQ_MAGIC) else None


def decode_request(buf: bytes, u: int, vbytes: int = 0) -> Request:
    buf = bytes(buf)
    if len(buf) < _REQ.size:
        raise ValueError(f"request size {len(buf)} too short "
                         f"(header is {_REQ.size} bytes)")
    if not vbytes and len(buf) != req_nbytes(u):
        raise ValueError(f"request size {len(buf)} != {req_nbytes(u)} "
                         f"(payload width {u})")
    magic, kind, _p, req_id, tenant, trace, dl, key = _REQ.unpack(
        buf[: _REQ.size])
    if magic != REQ_MAGIC:
        raise ValueError(f"bad request magic 0x{magic:04x}")
    if kind not in _KIND_NAMES:
        raise ValueError(f"unknown wire op kind {kind}")
    if vbytes:
        data, end = _unpack_tail(buf, _REQ.size, vbytes)
        if end != len(buf):
            raise ValueError(f"request size {len(buf)} != {end} "
                             "(trailing bytes after the payload tail)")
        return Request(kind=_KIND_NAMES[kind], req_id=req_id, tenant=tenant,
                       key=key, deadline_us=dl, trace=trace,
                       data=data if _KIND_NAMES[kind] != "get" else None)
    value = np.frombuffer(buf[_REQ.size:], np.int32).tolist()
    return Request(kind=_KIND_NAMES[kind], req_id=req_id, tenant=tenant,
                   key=key, deadline_us=dl, trace=trace,
                   value=value if _KIND_NAMES[kind] != "get" else None)


def encode_response(rsp: Response, u: int, vbytes: int = 0) -> bytes:
    hi, lo = rsp.uid if rsp.uid is not None else (0, 0)
    head = _RSP.pack(RSP_MAGIC, rsp.status, rsp.reason, rsp.req_id,
                     1 if rsp.found else 0,
                     1 if rsp.uid is not None else 0, 0, rsp.step,
                     rsp.retry_after_us, hi, lo)
    if vbytes:
        return head + _pack_tail(
            rsp.data if rsp.status == S_OK else None, vbytes)
    pay = np.zeros(u, np.int32)
    if rsp.value is not None:
        v = np.asarray(list(rsp.value), np.int32)
        pay[: v.shape[0]] = v
    return head + pay.tobytes()


def decode_response(buf: bytes, u: int, vbytes: int = 0) -> Response:
    buf = bytes(buf)
    if len(buf) < _RSP.size:
        raise ValueError(f"response size {len(buf)} too short "
                         f"(header is {_RSP.size} bytes)")
    if not vbytes and len(buf) != rsp_nbytes(u):
        raise ValueError(f"response size {len(buf)} != {rsp_nbytes(u)}")
    (magic, status, reason, req_id, found, has_uid, _p2, step, retry,
     hi, lo) = _RSP.unpack(buf[: _RSP.size])
    if magic != RSP_MAGIC:
        raise ValueError(f"bad response magic 0x{magic:04x}")
    if vbytes:
        data, end = _unpack_tail(buf, _RSP.size, vbytes)
        if end != len(buf):
            raise ValueError(f"response size {len(buf)} != {end} "
                             "(trailing bytes after the payload tail)")
        return Response(status=status, reason=reason, req_id=req_id,
                        found=bool(found), step=step, retry_after_us=retry,
                        uid=(hi, lo) if has_uid else None,
                        data=data if status == S_OK else None)
    value = np.frombuffer(buf[_RSP.size:], np.int32).tolist()
    return Response(status=status, reason=reason, req_id=req_id,
                    found=bool(found), step=step, retry_after_us=retry,
                    uid=(hi, lo) if has_uid else None,
                    value=value if status == S_OK else None)


# -- batched-read structs (K_MGET / K_SCAN) -------------------------
#
# Variable-size messages: the CRC frame already carries the byte length
# (stream boundary), so a count prefix inside the struct is enough for
# both ends to agree on the vector extent — the payload rows keep the
# config-width discipline (u int32 words each, derived from the shared
# config like every other message).  Distinct magics keep the decoders
# honest: a read response can never be mis-decoded as a single-op one.

RREQ_MAGIC = 0x5255   # 'UR' — batched-read request
RRSP_MAGIC = 0x5254   # 'TR' — batched-read response
MGET_MAX_KEYS = 65_535  # count rides a u16

# magic u16 | kind u8 | pad u8 | req_id u32 | tenant u16 | count u16 |
# deadline_us u32   ...then count*i64 keys (mget) or lo i64, hi i64 (scan)
_RREQ = struct.Struct("<HBBIHHI")
# magic u16 | status u8 | reason u8 | req_id u32 | count u16 | pad u16 |
# step i32 | retry_after_us u32   ...then count rows of
# [found u8 | local u8 | code u8 | pad u8 | u*i32 payload]
_RRSP = struct.Struct("<HBBIHHiI")

# per-key row status codes in a read response
RK_OK = 0        # served (found flag says whether the key ever existed)
RK_REJECTED = 2  # draining/fenced range: definitively not served here


@dataclasses.dataclass
class ReadRequest:
    """One batched read RPC: ``mget`` over an explicit key vector or
    ``scan`` over the key range [lo, hi).  One admission unit — the
    ladder treats it as a read (rung 2 sheds it unless EVERY key is in
    the hot set; a range never is)."""

    kind: str                 # 'mget' | 'scan'
    req_id: int
    tenant: int
    keys: Optional[List[int]] = None  # mget
    lo: int = 0                       # scan
    hi: int = 0
    deadline_us: int = 0

    @property
    def count(self) -> int:
        return len(self.keys) if self.kind == "mget" else self.hi - self.lo


@dataclasses.dataclass
class ReadResponse:
    """Answer to one ReadRequest: per-key rows in request key order.
    Refusals (S_RETRY_AFTER / S_DEADLINE / S_REJECTED) carry count 0."""

    status: int
    req_id: int
    reason: int = R_NONE
    step: int = -1
    retry_after_us: int = 0
    found: Optional[List[bool]] = None
    local: Optional[List[bool]] = None   # served by the fast path
    codes: Optional[List[int]] = None    # RK_* per key
    values: Optional[List[List[int]]] = None
    # heap mode: per-key byte payloads (None = never written / not served)
    data: Optional[List[Optional[bytes]]] = None

    @property
    def status_name(self) -> str:
        return STATUS_NAMES[self.status]

    @property
    def reason_name(self) -> str:
        return REASON_NAMES[self.reason]


def rreq_nbytes(kind: str, count: int) -> int:
    return _RREQ.size + (8 * count if kind == "mget" else 16)


def rrsp_nbytes(u: int, count: int, vbytes: int = 0) -> int:
    """Read-response size: fixed-stride rows — word payloads at width
    ``u``, or (heap mode) a u32 length + vcap padded bytes per row."""
    if vbytes:
        return _RRSP.size + count * (8 + _vcap(vbytes))
    return _RRSP.size + count * (4 + 4 * u)


def encode_read_request(req: ReadRequest) -> bytes:
    if req.kind not in _READ_KIND_CODES:
        raise ValueError(f"unknown read kind {req.kind!r}")
    if not (0 <= req.deadline_us < 1 << 32):
        raise ValueError("deadline_us must fit u32 (relative microseconds)")
    if req.kind == "mget":
        keys = list(req.keys or ())
        if not (1 <= len(keys) <= MGET_MAX_KEYS):
            raise ValueError(
                f"mget wants 1..{MGET_MAX_KEYS} keys, got {len(keys)}")
        body = np.asarray(keys, np.int64).tobytes()
        count = len(keys)
    else:
        body = np.asarray([req.lo, req.hi], np.int64).tobytes()
        count = 0  # the range rides the body; count is mget-only
    return _RREQ.pack(RREQ_MAGIC, _READ_KIND_CODES[req.kind], 0, req.req_id,
                      req.tenant, count, req.deadline_us) + body


def decode_read_request(buf: bytes) -> ReadRequest:
    buf = bytes(buf)
    if len(buf) < _RREQ.size:
        raise ValueError(f"read request too short ({len(buf)} bytes)")
    magic, kind, _p, req_id, tenant, count, dl = _RREQ.unpack(
        buf[: _RREQ.size])
    if magic != RREQ_MAGIC:
        raise ValueError(f"bad read-request magic 0x{magic:04x}")
    if kind not in _READ_KIND_NAMES:
        raise ValueError(f"unknown wire read kind {kind}")
    name = _READ_KIND_NAMES[kind]
    if len(buf) != rreq_nbytes(name, count):
        raise ValueError(
            f"read request size {len(buf)} != {rreq_nbytes(name, count)}")
    body = np.frombuffer(buf[_RREQ.size:], np.int64)
    if name == "mget":
        return ReadRequest(kind="mget", req_id=req_id, tenant=tenant,
                           keys=body.tolist(), deadline_us=dl)
    return ReadRequest(kind="scan", req_id=req_id, tenant=tenant,
                       lo=int(body[0]), hi=int(body[1]), deadline_us=dl)


def encode_read_response(rsp: ReadResponse, u: int, vbytes: int = 0) -> bytes:
    n = len(rsp.found or ())
    head = _RRSP.pack(RRSP_MAGIC, rsp.status, rsp.reason, rsp.req_id, n, 0,
                      rsp.step, rsp.retry_after_us)
    if n == 0:
        return head
    if vbytes:
        cap = _vcap(vbytes)
        rows = np.zeros((n, 8 + cap), np.uint8)
        rows[:, 0] = np.asarray(rsp.found, np.uint8)
        rows[:, 1] = np.asarray(rsp.local or [0] * n, np.uint8)
        rows[:, 2] = np.asarray(rsp.codes or [RK_OK] * n, np.uint8)
        dlen = np.full(n, _DLEN_NONE, np.uint32)
        data = rsp.data or [None] * n
        for i, d in enumerate(data):
            if d is not None:
                raw = bytes(d)
                if len(raw) > vbytes:
                    raise ValueError(f"row {i} payload is {len(raw)} bytes "
                                     f"> max_value_bytes={vbytes}")
                dlen[i] = len(raw)
                rows[i, 8: 8 + len(raw)] = np.frombuffer(raw, np.uint8)
        rows[:, 4:8] = dlen.view(np.uint8).reshape(n, 4)
        return head + rows.tobytes()
    rows = np.zeros((n, 4 + 4 * u), np.uint8)
    rows[:, 0] = np.asarray(rsp.found, np.uint8)
    rows[:, 1] = np.asarray(rsp.local or [0] * n, np.uint8)
    rows[:, 2] = np.asarray(rsp.codes or [RK_OK] * n, np.uint8)
    vals = np.zeros((n, u), np.int32)
    if rsp.values is not None:
        vals[:] = np.asarray(rsp.values, np.int32)
    rows[:, 4:] = vals.view(np.uint8).reshape(n, 4 * u)
    return head + rows.tobytes()


def decode_read_response(buf: bytes, u: int, vbytes: int = 0) -> ReadResponse:
    buf = bytes(buf)
    if len(buf) < _RRSP.size:
        raise ValueError(f"read response too short ({len(buf)} bytes)")
    magic, status, reason, req_id, n, _p, step, retry = _RRSP.unpack(
        buf[: _RRSP.size])
    if magic != RRSP_MAGIC:
        raise ValueError(f"bad read-response magic 0x{magic:04x}")
    if len(buf) != rrsp_nbytes(u, n, vbytes):
        raise ValueError(
            f"read response size {len(buf)} != {rrsp_nbytes(u, n, vbytes)}")
    out = ReadResponse(status=status, reason=reason, req_id=req_id,
                       step=step, retry_after_us=retry)
    if n and vbytes:
        cap = _vcap(vbytes)
        rows = np.frombuffer(buf[_RRSP.size:], np.uint8).reshape(n, 8 + cap)
        out.found = (rows[:, 0] != 0).tolist()
        out.local = (rows[:, 1] != 0).tolist()
        out.codes = rows[:, 2].astype(int).tolist()
        dlen = np.ascontiguousarray(rows[:, 4:8]).view(np.uint32).ravel()
        out.data = []
        for i in range(n):
            if dlen[i] == _DLEN_NONE:
                out.data.append(None)
            elif dlen[i] > vbytes:
                raise ValueError(f"row {i} declares {int(dlen[i])} bytes > "
                                 f"max_value_bytes={vbytes}")
            else:
                out.data.append(rows[i, 8: 8 + int(dlen[i])].tobytes())
    elif n:
        rows = np.frombuffer(buf[_RRSP.size:], np.uint8).reshape(n, 4 + 4 * u)
        out.found = (rows[:, 0] != 0).tolist()
        out.local = (rows[:, 1] != 0).tolist()
        out.codes = rows[:, 2].astype(int).tolist()
        out.values = np.ascontiguousarray(
            rows[:, 4:]).view(np.int32).reshape(n, u).tolist()
    return out


def plausible_request_len(u: int, vbytes: int = 0):
    """Predicate over frame payload lengths a server may legitimately
    receive (FramedSocket's corruption-triage hook): the fixed single-op
    request size (heap mode: header + length prefix + up to vbytes), or
    a read-request size — header + count*i64 keys (mget) / + 2*i64
    (scan).  Only consulted when a frame FAILS its CRC, to decide
    skip-vs-teardown."""
    fixed = req_nbytes(u)

    def ok(length: int) -> bool:
        if vbytes:
            if _REQ.size + 4 <= length <= _REQ.size + 4 + vbytes:
                return True
        elif length == fixed:
            return True
        body = length - _RREQ.size
        return (body >= 8 and body % 8 == 0
                and body <= 8 * MGET_MAX_KEYS)

    return ok


def plausible_response_len(u: int, vbytes: int = 0):
    """Predicate over frame payload lengths a client may legitimately
    receive: the fixed single-op response size (heap mode: a bounded
    variable tail), or a read-response size (header + fixed-stride
    rows)."""
    fixed = rsp_nbytes(u)
    row = (8 + _vcap(vbytes)) if vbytes else (4 + 4 * u)

    def ok(length: int) -> bool:
        if vbytes:
            if _RSP.size + 4 <= length <= _RSP.size + 4 + vbytes:
                return True
        elif length == fixed:
            return True
        if length == _RRSP.size:
            return True
        body = length - _RRSP.size
        return body > 0 and body % row == 0 and body // row <= MGET_MAX_KEYS

    return ok


def response_extent(raw: bytes, off: int, u: int, vbytes: int = 0) -> int:
    """Byte length of the response record at ``off`` in a response log
    (either layout, either payload mode) — the walker primitive
    ``serving.soak.committed_uids`` steps with."""
    (magic,) = struct.unpack_from("<H", raw, off)
    if magic == RRSP_MAGIC:
        (count,) = struct.unpack_from("<H", raw, off + 8)
        return rrsp_nbytes(u, count, vbytes)
    if vbytes:
        (dlen,) = struct.unpack_from("<I", raw, off + _RSP.size)
        return _RSP.size + 4 + (0 if dlen == _DLEN_NONE else dlen)
    return rsp_nbytes(u)


# -- columnar batch codec -------------------------------------------
#
# The serving data plane processes requests the way the round does: as
# COLUMNS, not structs.  A drained socket buffer is k back-to-back
# single-op records (REQ_MAGIC delimits; a classic one-op frame is a
# 1-row batch) and decodes in one numpy pass into per-field arrays; a
# pump's resolutions encode back into one record stream per connection.
# The per-struct encode/decode above stay as the compat/fuzz ORACLE: for
# any batch,
#
#     encode_request_batch(b)  == b"".join(encode_request(r) for r in b)
#     encode_response_batch(b) == b"".join(encode_response(r) for r in b)
#
# byte-for-byte (both payload modes), and decode is the exact inverse —
# so the response-log walkers (response_extent / committed_uids) and old
# one-op peers read columnar streams unchanged.  The struct codec's
# asymmetries are mirrored exactly: heap-mode request encode drops data
# on gets, heap-mode response encode drops data on non-OK statuses, and
# fixed-mode encode writes the value column verbatim regardless of
# kind/status (decode nulls it back, same as the struct path).

from hermes_tpu_torch.transport import codec as _codec

_REQ_KINDS = (K_GET, K_PUT, K_RMW)


def _put_col(M: np.ndarray, off: int, arr, dt: str) -> None:
    """Write a scalar column into byte-matrix ``M`` at byte ``off`` (one
    contiguous-view reinterpret, the rows_to_words discipline)."""
    k = M.shape[0]
    col = np.ascontiguousarray(np.asarray(arr).astype(dt, copy=False))
    w = col.dtype.itemsize
    M[:, off: off + w] = col.view(np.uint8).reshape(k, w)


def _get_col(M: np.ndarray, off: int, dt: str) -> np.ndarray:
    """Read a scalar column out of byte-matrix ``M`` at byte ``off``."""
    k = M.shape[0]
    w = np.dtype(dt).itemsize
    return np.ascontiguousarray(M[:, off: off + w]).view(dt).reshape(k)


@dataclasses.dataclass
class ReqBatch:
    """Columnar view of k single-op requests (one column per wire field;
    heap mode swaps the fixed ``value`` matrix for a ``vlen``/``voff``
    pair addressing one shared payload ``blob``, -1 = no tail)."""

    kind: np.ndarray          # (k,) uint8 — K_GET / K_PUT / K_RMW
    req_id: np.ndarray        # (k,) uint32
    tenant: np.ndarray        # (k,) uint16
    trace: np.ndarray         # (k,) uint16 — 0 = not sampled
    deadline_us: np.ndarray   # (k,) uint32 — relative; 0 = none
    key: np.ndarray           # (k,) int64
    value: Optional[np.ndarray] = None  # fixed mode: (k, u) int32
    vlen: Optional[np.ndarray] = None   # heap mode: (k,) int64; -1 = none
    voff: Optional[np.ndarray] = None   # heap mode: (k,) offsets into blob
    blob: bytes = b""                   # heap mode: shared payload pool

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    def row_data(self, i: int) -> Optional[bytes]:
        """Heap payload bytes of row ``i`` (None when absent)."""
        if self.vlen is None or self.vlen[i] < 0:
            return None
        o = int(self.voff[i]) if self.voff is not None else 0
        return self.blob[o: o + int(self.vlen[i])]

    def select(self, idx) -> "ReqBatch":
        """Row-gather a sub-batch (shares the heap blob)."""
        idx = np.asarray(idx)
        return ReqBatch(
            kind=self.kind[idx], req_id=self.req_id[idx],
            tenant=self.tenant[idx], trace=self.trace[idx],
            deadline_us=self.deadline_us[idx], key=self.key[idx],
            value=None if self.value is None else self.value[idx],
            vlen=None if self.vlen is None else self.vlen[idx],
            voff=None if self.voff is None else self.voff[idx],
            blob=self.blob)

    def to_requests(self) -> List[Request]:
        """Struct rows (the oracle direction) — mirrors decode_request's
        nulling rules (gets carry no value/data)."""
        out = []
        for i in range(len(self)):
            kname = _KIND_NAMES[int(self.kind[i])]
            value = data = None
            if kname != "get":
                if self.value is not None:
                    value = self.value[i].tolist()
                data = self.row_data(i)
            out.append(Request(
                kind=kname, req_id=int(self.req_id[i]),
                tenant=int(self.tenant[i]), key=int(self.key[i]),
                deadline_us=int(self.deadline_us[i]),
                trace=int(self.trace[i]), value=value, data=data))
        return out

    @staticmethod
    def from_requests(reqs: List[Request], u: int,
                      vbytes: int = 0) -> "ReqBatch":
        """Columnarize struct rows — mirrors encode_request's payload
        rules (fixed mode writes value verbatim even for gets; heap mode
        drops data on gets)."""
        k = len(reqs)
        b = ReqBatch(
            kind=np.array([_KIND_CODES[r.kind] for r in reqs], np.uint8),
            req_id=np.array([r.req_id for r in reqs], np.uint32),
            tenant=np.array([r.tenant for r in reqs], np.uint16),
            trace=np.array([r.trace for r in reqs], np.uint16),
            deadline_us=np.array([r.deadline_us for r in reqs], np.uint32),
            key=np.array([r.key for r in reqs], np.int64))
        if vbytes:
            vlen = np.full(k, -1, np.int64)
            voff = np.zeros(k, np.int64)
            parts = []
            off = 0
            for i, r in enumerate(reqs):
                if r.data is not None and r.kind != "get":
                    raw = bytes(r.data)
                    vlen[i] = len(raw)
                    voff[i] = off
                    parts.append(raw)
                    off += len(raw)
            b.vlen, b.voff, b.blob = vlen, voff, b"".join(parts)
        else:
            val = np.zeros((k, u), np.int32)
            for i, r in enumerate(reqs):
                if r.value is not None:
                    v = np.asarray(list(r.value), np.int32)
                    if v.ndim != 1 or v.shape[0] > u:
                        raise ValueError(f"value must be <= {u} int32 words")
                    val[i, : v.shape[0]] = v
            b.value = val
        return b


def _req_heads(b: ReqBatch, width: int) -> np.ndarray:
    k = len(b)
    kind = np.asarray(b.kind, np.uint8)
    if k and not np.isin(kind, _REQ_KINDS).all():
        bad = int(kind[~np.isin(kind, _REQ_KINDS)][0])
        raise ValueError(f"unknown wire op kind {bad} in batch")
    M = np.zeros((k, width), np.uint8)
    _put_col(M, 0, np.full(k, REQ_MAGIC), "<u2")
    M[:, 2] = kind
    _put_col(M, 4, b.req_id, "<u4")
    _put_col(M, 8, b.tenant, "<u2")
    _put_col(M, 10, b.trace, "<u2")
    _put_col(M, 12, b.deadline_us, "<u4")
    _put_col(M, 16, b.key, "<i8")
    return M


def encode_request_batch(b: ReqBatch, u: int, vbytes: int = 0) -> bytes:
    """k requests -> one record stream, byte-identical to concatenating
    ``encode_request`` over the rows (one numpy pass, no per-row Python
    beyond the heap-mode blob gather)."""
    k = len(b)
    if vbytes:
        vlen = (np.asarray(b.vlen, np.int64) if b.vlen is not None
                else np.full(k, -1, np.int64))
        # the struct codec's rule: gets never carry a payload tail
        vlen = np.where(np.asarray(b.kind, np.uint8) == K_GET, -1, vlen)
        if k and int(vlen.max(initial=-1)) > vbytes:
            raise ValueError(f"payload is {int(vlen.max())} bytes > "
                             f"max_value_bytes={vbytes}")
        plen = np.maximum(vlen, 0)
        recs = _REQ.size + 4 + plen
        offs = np.concatenate(([0], np.cumsum(recs)[:-1])) if k \
            else np.zeros(0, np.int64)
        out = np.zeros(int(recs.sum()), np.uint8)
        H = _req_heads(b, _REQ.size + 4)
        _put_col(H, _REQ.size,
                 np.where(vlen < 0, _DLEN_NONE, vlen).astype(np.uint32),
                 "<u4")
        _codec.scatter_records(out, offs, H)
        voff = (np.asarray(b.voff, np.int64) if b.voff is not None
                else np.zeros(k, np.int64))
        blob8 = np.frombuffer(b.blob, np.uint8)
        src = _codec.ragged_gather(blob8, voff, plen)
        _codec.ragged_scatter(out, offs + _REQ.size + 4, plen, src)
        return out.tobytes()
    M = _req_heads(b, req_nbytes(u))
    val = b.value if b.value is not None else np.zeros((k, u), np.int32)
    val = np.asarray(val, np.int32)
    if val.shape != (k, u):
        raise ValueError(f"value matrix shape {val.shape} != ({k}, {u})")
    if u:
        M[:, _REQ.size:] = np.ascontiguousarray(val).view(
            np.uint8).reshape(k, 4 * u)
    return M.tobytes()


def decode_request_batch(buf: bytes, u: int, vbytes: int = 0) -> ReqBatch:
    """One drained buffer of k back-to-back request records -> columns
    (the inverse of ``encode_request_batch``; raises ValueError on torn
    trailing bytes, bad magic, or an unknown kind — same triage rules as
    the struct decoder, applied batch-wide)."""
    buf = bytes(buf)
    if vbytes:
        offs, dls = [], []
        off, hsz = 0, _REQ.size
        while off < len(buf):
            if off + hsz + 4 > len(buf):
                raise ValueError(
                    f"torn batch: truncated request header at byte {off} "
                    f"({len(buf) - off} trailing bytes)")
            (dlen,) = struct.unpack_from("<I", buf, off + hsz)
            if dlen == _DLEN_NONE:
                dls.append(-1)
                end = off + hsz + 4
            else:
                if dlen > vbytes:
                    raise ValueError(f"payload tail declares {dlen} bytes "
                                     f"(max {vbytes})")
                if off + hsz + 4 + dlen > len(buf):
                    raise ValueError(
                        f"torn batch: payload tail at byte {off} wants "
                        f"{dlen} bytes, have {len(buf) - off - hsz - 4}")
                dls.append(dlen)
                end = off + hsz + 4 + dlen
            offs.append(off)
            off = end
        k = len(offs)
        offs_a = np.asarray(offs, np.int64)
        M = _codec.gather_records(np.frombuffer(buf, np.uint8), offs_a,
                                  hsz + 4)
        vlen = np.asarray(dls, np.int64)
        voff = offs_a + hsz + 4
        b = _decode_req_heads(M)
        b.vlen, b.voff, b.blob = vlen, voff, buf
        return b
    stride = req_nbytes(u)
    if len(buf) % stride:
        raise ValueError(
            f"torn batch: {len(buf)} bytes is not a whole number of "
            f"{stride}-byte requests ({len(buf) % stride} trailing bytes)")
    k = len(buf) // stride
    M = np.frombuffer(buf, np.uint8).reshape(k, stride)
    b = _decode_req_heads(M)
    b.value = np.ascontiguousarray(M[:, _REQ.size:]).view(
        np.int32).reshape(k, u)
    return b


def check_request_matrix(M: np.ndarray) -> None:
    """Batch-wide magic + kind triage of a (k, >=_REQ.size) request
    record matrix, WITHOUT building columns — the shm IPC worker's
    cheap validation pass before raw records land in ring slots
    (serving/ipc.py): a front-end process can refuse a garbage stream
    loudly while leaving the column decode to the store owner.  Raises
    ValueError with the struct decoder's triage wording."""
    k = M.shape[0]
    magic = _get_col(M, 0, "<u2")
    if k and (magic != REQ_MAGIC).any():
        i = int(np.nonzero(magic != REQ_MAGIC)[0][0])
        raise ValueError(f"bad request magic 0x{int(magic[i]):04x} "
                         f"at row {i}")
    kind = M[:, 2]
    if k and not np.isin(kind, _REQ_KINDS).all():
        bad = int(kind[~np.isin(kind, _REQ_KINDS)][0])
        raise ValueError(f"unknown wire op kind {bad}")


def decode_request_matrix(M: np.ndarray, u: int) -> ReqBatch:
    """Fixed-mode column decode of a (k, req_nbytes(u)) record matrix
    that ALREADY lives in memory as rows — the zero-copy shm path: ring
    slots hold raw record matrices, the store owner decodes the merged
    matrix once, no intermediate ``bytes`` round-trip
    (``decode_request_batch`` is this plus the byte-stream framing)."""
    if M.shape[1] != req_nbytes(u):
        raise ValueError(f"record matrix is {M.shape[1]} bytes/row, "
                         f"want {req_nbytes(u)} for u={u}")
    b = _decode_req_heads(M)
    b.value = np.ascontiguousarray(M[:, _REQ.size:]).view(
        np.int32).reshape(M.shape[0], u)
    return b


def _decode_req_heads(M: np.ndarray) -> ReqBatch:
    check_request_matrix(M)
    return ReqBatch(
        kind=M[:, 2].copy(), req_id=_get_col(M, 4, "<u4"),
        tenant=_get_col(M, 8, "<u2"), trace=_get_col(M, 10, "<u2"),
        deadline_us=_get_col(M, 12, "<u4"), key=_get_col(M, 16, "<i8"))


@dataclasses.dataclass
class RspBatch:
    """Columnar view of k single-op responses (same contract as
    ``ReqBatch``: byte-identical record stream, shared heap blob)."""

    status: np.ndarray          # (k,) uint8 — S_*
    reason: np.ndarray          # (k,) uint8 — R_*
    req_id: np.ndarray          # (k,) uint32
    found: np.ndarray           # (k,) bool
    has_uid: np.ndarray         # (k,) bool
    step: np.ndarray            # (k,) int32
    retry_after_us: np.ndarray  # (k,) uint32
    uid: np.ndarray             # (k, 2) int32 — (hi, lo)
    value: Optional[np.ndarray] = None  # fixed mode: (k, u) int32
    vlen: Optional[np.ndarray] = None   # heap mode: (k,) int64; -1 = none
    voff: Optional[np.ndarray] = None
    blob: bytes = b""

    def __len__(self) -> int:
        return int(self.status.shape[0])

    def row_data(self, i: int) -> Optional[bytes]:
        if self.vlen is None or self.vlen[i] < 0:
            return None
        o = int(self.voff[i]) if self.voff is not None else 0
        return self.blob[o: o + int(self.vlen[i])]

    def select(self, idx) -> "RspBatch":
        idx = np.asarray(idx)
        return RspBatch(
            status=self.status[idx], reason=self.reason[idx],
            req_id=self.req_id[idx], found=self.found[idx],
            has_uid=self.has_uid[idx], step=self.step[idx],
            retry_after_us=self.retry_after_us[idx], uid=self.uid[idx],
            value=None if self.value is None else self.value[idx],
            vlen=None if self.vlen is None else self.vlen[idx],
            voff=None if self.voff is None else self.voff[idx],
            blob=self.blob)

    def to_responses(self) -> List[Response]:
        """Struct rows — mirrors decode_response's nulling rules (value
        and data are only surfaced on S_OK)."""
        out = []
        for i in range(len(self)):
            st = int(self.status[i])
            value = data = None
            if st == S_OK:
                if self.value is not None:
                    value = self.value[i].tolist()
                data = self.row_data(i)
            out.append(Response(
                status=st, reason=int(self.reason[i]),
                req_id=int(self.req_id[i]), found=bool(self.found[i]),
                step=int(self.step[i]),
                retry_after_us=int(self.retry_after_us[i]),
                uid=((int(self.uid[i, 0]), int(self.uid[i, 1]))
                     if self.has_uid[i] else None),
                value=value, data=data))
        return out

    @staticmethod
    def from_responses(rsps: List[Response], u: int,
                       vbytes: int = 0) -> "RspBatch":
        k = len(rsps)
        b = RspBatch(
            status=np.array([r.status for r in rsps], np.uint8),
            reason=np.array([r.reason for r in rsps], np.uint8),
            req_id=np.array([r.req_id for r in rsps], np.uint32),
            found=np.array([r.found for r in rsps], bool),
            has_uid=np.array([r.uid is not None for r in rsps], bool),
            step=np.array([r.step for r in rsps], np.int32),
            retry_after_us=np.array([r.retry_after_us for r in rsps],
                                    np.uint32),
            uid=np.array([(r.uid if r.uid is not None else (0, 0))
                          for r in rsps], np.int32).reshape(k, 2))
        if vbytes:
            vlen = np.full(k, -1, np.int64)
            voff = np.zeros(k, np.int64)
            parts = []
            off = 0
            for i, r in enumerate(rsps):
                if r.data is not None and r.status == S_OK:
                    raw = bytes(r.data)
                    vlen[i] = len(raw)
                    voff[i] = off
                    parts.append(raw)
                    off += len(raw)
            b.vlen, b.voff, b.blob = vlen, voff, b"".join(parts)
        else:
            val = np.zeros((k, u), np.int32)
            for i, r in enumerate(rsps):
                if r.value is not None:
                    v = np.asarray(list(r.value), np.int32)
                    val[i, : v.shape[0]] = v
            b.value = val
        return b


def encode_response_batch(b: RspBatch, u: int, vbytes: int = 0) -> bytes:
    """k responses -> one record stream, byte-identical to concatenating
    ``encode_response`` over the rows."""
    k = len(b)
    status = np.asarray(b.status, np.uint8)

    def heads(width: int) -> np.ndarray:
        M = np.zeros((k, width), np.uint8)
        _put_col(M, 0, np.full(k, RSP_MAGIC), "<u2")
        M[:, 2] = status
        M[:, 3] = np.asarray(b.reason, np.uint8)
        _put_col(M, 4, b.req_id, "<u4")
        M[:, 8] = np.asarray(b.found, bool).astype(np.uint8)
        M[:, 9] = np.asarray(b.has_uid, bool).astype(np.uint8)
        _put_col(M, 12, b.step, "<i4")
        _put_col(M, 16, b.retry_after_us, "<u4")
        _put_col(M, 20, np.asarray(b.uid, np.int32)[:, 0], "<i4")
        _put_col(M, 24, np.asarray(b.uid, np.int32)[:, 1], "<i4")
        return M

    if vbytes:
        vlen = (np.asarray(b.vlen, np.int64) if b.vlen is not None
                else np.full(k, -1, np.int64))
        # the struct codec's rule: only S_OK rows carry a payload tail
        vlen = np.where(status == S_OK, vlen, -1)
        if k and int(vlen.max(initial=-1)) > vbytes:
            raise ValueError(f"payload is {int(vlen.max())} bytes > "
                             f"max_value_bytes={vbytes}")
        plen = np.maximum(vlen, 0)
        recs = _RSP.size + 4 + plen
        offs = np.concatenate(([0], np.cumsum(recs)[:-1])) if k \
            else np.zeros(0, np.int64)
        out = np.zeros(int(recs.sum()), np.uint8)
        H = heads(_RSP.size + 4)
        _put_col(H, _RSP.size,
                 np.where(vlen < 0, _DLEN_NONE, vlen).astype(np.uint32),
                 "<u4")
        _codec.scatter_records(out, offs, H)
        voff = (np.asarray(b.voff, np.int64) if b.voff is not None
                else np.zeros(k, np.int64))
        src = _codec.ragged_gather(np.frombuffer(b.blob, np.uint8),
                                   voff, plen)
        _codec.ragged_scatter(out, offs + _RSP.size + 4, plen, src)
        return out.tobytes()
    M = heads(rsp_nbytes(u))
    val = b.value if b.value is not None else np.zeros((k, u), np.int32)
    val = np.asarray(val, np.int32)
    if val.shape != (k, u):
        raise ValueError(f"value matrix shape {val.shape} != ({k}, {u})")
    if u:
        M[:, _RSP.size:] = np.ascontiguousarray(val).view(
            np.uint8).reshape(k, 4 * u)
    return M.tobytes()


def decode_response_batch(buf: bytes, u: int, vbytes: int = 0) -> RspBatch:
    """Inverse of ``encode_response_batch`` (torn/garbage triage rules
    match the struct decoder, batch-wide)."""
    buf = bytes(buf)
    if vbytes:
        offs, dls = [], []
        off, hsz = 0, _RSP.size
        while off < len(buf):
            if off + hsz + 4 > len(buf):
                raise ValueError(
                    f"torn batch: truncated response header at byte {off} "
                    f"({len(buf) - off} trailing bytes)")
            (dlen,) = struct.unpack_from("<I", buf, off + hsz)
            if dlen == _DLEN_NONE:
                dls.append(-1)
                end = off + hsz + 4
            else:
                if dlen > vbytes:
                    raise ValueError(f"payload tail declares {dlen} bytes "
                                     f"(max {vbytes})")
                if off + hsz + 4 + dlen > len(buf):
                    raise ValueError(
                        f"torn batch: payload tail at byte {off} wants "
                        f"{dlen} bytes, have {len(buf) - off - hsz - 4}")
                dls.append(dlen)
                end = off + hsz + 4 + dlen
            offs.append(off)
            off = end
        k = len(offs)
        offs_a = np.asarray(offs, np.int64)
        M = _codec.gather_records(np.frombuffer(buf, np.uint8), offs_a,
                                  hsz + 4)
        b = _decode_rsp_heads(M)
        b.vlen = np.asarray(dls, np.int64)
        b.voff = offs_a + hsz + 4
        b.blob = buf
        return b
    stride = rsp_nbytes(u)
    if len(buf) % stride:
        raise ValueError(
            f"torn batch: {len(buf)} bytes is not a whole number of "
            f"{stride}-byte responses ({len(buf) % stride} trailing bytes)")
    k = len(buf) // stride
    M = np.frombuffer(buf, np.uint8).reshape(k, stride)
    b = _decode_rsp_heads(M)
    b.value = np.ascontiguousarray(M[:, _RSP.size:]).view(
        np.int32).reshape(k, u)
    return b


def _decode_rsp_heads(M: np.ndarray) -> RspBatch:
    k = M.shape[0]
    magic = _get_col(M, 0, "<u2")
    if k and (magic != RSP_MAGIC).any():
        i = int(np.nonzero(magic != RSP_MAGIC)[0][0])
        raise ValueError(f"bad response magic 0x{int(magic[i]):04x} "
                         f"at row {i}")
    uid = np.stack([_get_col(M, 20, "<i4"), _get_col(M, 24, "<i4")],
                   axis=1) if k else np.zeros((0, 2), np.int32)
    return RspBatch(
        status=M[:, 2].copy(), reason=M[:, 3].copy(),
        req_id=_get_col(M, 4, "<u4"), found=M[:, 8] != 0,
        has_uid=M[:, 9] != 0, step=_get_col(M, 12, "<i4"),
        retry_after_us=_get_col(M, 16, "<u4"), uid=uid)


# -- kind/magic dispatch (one decoder entry per direction) -------------------

def encode_any_request(req, u: int, vbytes: int = 0) -> bytes:
    if isinstance(req, ReadRequest):
        return encode_read_request(req)
    return encode_request(req, u, vbytes)


def decode_any_request(buf: bytes, u: int, vbytes: int = 0):
    """Decode either request layout off its magic word."""
    buf = bytes(buf)
    if len(buf) >= 2:
        (magic,) = struct.unpack_from("<H", buf, 0)
        if magic == RREQ_MAGIC:
            return decode_read_request(buf)
    return decode_request(buf, u, vbytes)


def encode_any_response(rsp, u: int, vbytes: int = 0) -> bytes:
    if isinstance(rsp, ReadResponse):
        return encode_read_response(rsp, u, vbytes)
    return encode_response(rsp, u, vbytes)


def decode_any_response(buf: bytes, u: int, vbytes: int = 0):
    buf = bytes(buf)
    if len(buf) >= 2:
        (magic,) = struct.unpack_from("<H", buf, 0)
        if magic == RRSP_MAGIC:
            return decode_read_response(buf, u, vbytes)
    return decode_response(buf, u, vbytes)
