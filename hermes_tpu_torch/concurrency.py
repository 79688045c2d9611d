"""The host concurrency model, declared as data: the port's copy of
``hermes_tpu/concurrency.py``, with its own registry.

Per class: which attributes are shared mutable state, which lock
attribute guards each of them, and which are deliberately lock-free with
a written reason (the ``audited(tag)`` escape hatch: a suppression is an
info finding, never silence).

Consumers:

  * ``hermes_tpu_torch/analysis/hostlint.py``: the static AST pass holds
    the package to this registry (a guarded access outside ``with
    <lock>:``, a blocking call under a lock, nested-``with`` lock-order
    cycles, undeclared locks, unowned threads);
  * ``hermes_tpu_torch/analysis/lockgraph.py``: the dynamic sanitizer,
    whose ``ObsLock`` instances are minted through :func:`make_lock`;
  * ``python -m hermes_tpu_torch.gates``: the ``hostlint`` gate.

The rules the table encodes:

  * A lock guards ATTRIBUTES, not code paths: every read or write of a
    guarded attribute outside ``__init__`` happens inside ``with
    self.<lock>:`` of the declaring class.
  * ``audited(tag, *attrs)`` declares deliberately lock-free fields; the
    wildcard ``"*"`` covers every otherwise undeclared mutable attribute
    of the class (single-threaded-by-contract classes such as the KVS).
  * ``BlockingAudit`` declares the one sanctioned blocking call under a
    lock (``FramedSocket.send``'s sendall: the lock exists to serialize
    whole-frame writes, and SO_SNDTIMEO bounds the stall).

Stdlib-only imports: the torch-free shm worker processes import this
module through ``serving/ipc.py``.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional, Tuple

#: env switch: "1" swaps every lock minted via make_lock for the
#: instrumented analysis/lockgraph.ObsLock, so serving soaks double as
#: dynamic lock-order sanitizer runs
LOCKLINT_ENV = "HERMES_LOCKLINT"


def locklint_enabled() -> bool:
    return os.environ.get(LOCKLINT_ENV, "") not in ("", "0")


def make_lock(name: str):
    """The serving tier's lock factory: a plain ``threading.Lock`` in
    production, the instrumented ``lockgraph.ObsLock`` under
    ``HERMES_LOCKLINT=1``.  ``name`` must be ``"Class.attr"`` — the
    identity the dynamic held-before graph and the hold-time series key
    on (instances share the name; per-instance graphs would never see a
    cross-object ordering).  The lockgraph import is deferred so the
    production path stays free of the analysis package."""
    if locklint_enabled():
        from hermes_tpu_torch.analysis.lockgraph import ObsLock

        return ObsLock(name)
    return threading.Lock()


class Guard(NamedTuple):
    """One lock attribute and the attributes it guards."""

    lock: str            # lock attribute name on the class, e.g. "_map_lock"
    attrs: Tuple[str, ...]


class Audited(NamedTuple):
    """Deliberately lock-free attributes + the justification tag."""

    attrs: Tuple[str, ...]   # attribute names, or ("*",) for the wildcard
    tag: str


class BlockingAudit(NamedTuple):
    """One sanctioned blocking call under one lock (downgraded to info)."""

    lock: str            # lock attribute whose critical section may block
    call: str            # blocking callee name, e.g. "sendall"
    tag: str


class ClassGuards(NamedTuple):
    """The concurrency declaration of one class."""

    cls: str                       # bare class name
    module: str                    # dotted module the class lives in
    locks: Tuple[str, ...] = ()    # every lock attribute the class owns
    guards: Tuple[Guard, ...] = ()
    audited: Tuple[Audited, ...] = ()
    blocking: Tuple[BlockingAudit, ...] = ()
    thread_owner: Optional[str] = None  # attr close() joins threads from
    notes: str = ""


def audited(tag: str, *attrs: str) -> Audited:
    """Declarative twin of ``layouts.audited``: same tag contract (non-
    empty, no square brackets — the tag rides finding records)."""
    if not tag or any(c in tag for c in "[]"):
        raise ValueError("audit tag must be a non-empty string without "
                         "square brackets")
    if not attrs:
        raise ValueError("audited() needs at least one attribute name")
    return Audited(attrs=tuple(attrs), tag=tag)


#: the port's whole-package table.  Order: serving tier, transport, obs,
#: store, WAL, then the sanitizer's own machinery (held to it as well).
REGISTRY: Tuple[ClassGuards, ...] = (
    ClassGuards(
        cls="TcpRpcServer", module="hermes_tpu_torch.serving.rpc",
        locks=("_lock", "_map_lock"),
        guards=(Guard("_map_lock", ("_next_iid", "_conn_of", "_conns",
                                    "_threads", "undecodable")),),
        audited=(
            audited("single-writer-publish: set once by the dying pump "
                    "thread; every other thread only polls it", "pump_error"),
            audited("threading.Event is internally synchronized", "_stop"),
        ),
        thread_owner="_threads",
        notes="_lock guards the shared Frontend (submit/pump critical "
              "section), which keeps no lock of its own — see the "
              "Frontend entry's wildcard audit.",
    ),
    ClassGuards(
        cls="ColumnarTcpServer", module="hermes_tpu_torch.serving.rpc",
        locks=("_lock", "_map_lock"),
        guards=(Guard("_map_lock", ("_next_cid", "_sock_of", "_conns",
                                    "_threads", "undecodable")),),
        audited=(
            audited("single-writer-publish: set once by the dying pump "
                    "thread; every other thread only polls it", "pump_error"),
            audited("threading.Event is internally synchronized", "_stop"),
        ),
        thread_owner="_threads",
        notes="same lock split as TcpRpcServer: _lock is the frontend "
              "critical section, _map_lock the connection bookkeeping.",
    ),
    ClassGuards(
        cls="LoopbackServer", module="hermes_tpu_torch.serving.rpc",
        audited=(audited("single-threaded in-process server: no socket, "
                         "no thread, driven by one soak loop", "*"),),
    ),
    ClassGuards(
        cls="ColumnarLoopback", module="hermes_tpu_torch.serving.rpc",
        audited=(audited("single-threaded in-process server: no socket, "
                         "no thread, driven by one soak loop", "*"),),
    ),
    ClassGuards(
        cls="RpcClient", module="hermes_tpu_torch.serving.rpc",
        audited=(audited("single-threaded blocking client by contract "
                         "(one owner thread per client instance)", "*"),),
    ),
    ClassGuards(
        cls="ColumnarClient", module="hermes_tpu_torch.serving.rpc",
        audited=(audited("single-threaded blocking client by contract "
                         "(one owner thread per client instance)", "*"),),
    ),
    ClassGuards(
        cls="Frontend", module="hermes_tpu_torch.serving.server",
        audited=(audited("server-serialized: every access happens under "
                         "the owning RPC server's _lock (TcpRpcServer."
                         "_reader_body/_pump_loop) or inside a single-"
                         "threaded loopback drive", "*"),),
    ),
    ClassGuards(
        cls="ColumnarFrontend", module="hermes_tpu_torch.serving.server",
        audited=(audited("server-serialized: every access happens under "
                         "the owning RPC server's _lock or inside a "
                         "single-threaded loopback drive", "*"),),
    ),
    ClassGuards(
        cls="CompletionRing", module="hermes_tpu_torch.serving.server",
        audited=(audited("frontend-serialized: owned by ColumnarFrontend "
                         "and touched only under its owner's "
                         "serialization", "*"),),
    ),
    ClassGuards(
        cls="RespMetaRing", module="hermes_tpu_torch.serving.server",
        audited=(audited("frontend-serialized: owned by a Frontend/"
                         "ColumnarFrontend and touched only under its "
                         "owner's serialization", "*"),),
    ),
    ClassGuards(
        cls="ShmWorker", module="hermes_tpu_torch.serving.ipc",
        locks=("_ring_lock", "_map_lock"),
        guards=(
            Guard("_ring_lock", ("rows_in",)),
            Guard("_map_lock", ("_next_cid", "_sock_of", "_conns",
                                "_threads", "undecodable",
                                "backpressured")),
        ),
        audited=(
            audited("single-thread: only the response-drain thread "
                    "touches the rsp ring consumer cursor and this "
                    "counter", "rows_out"),
            audited("threading.Event is internally synchronized", "_stop"),
            audited("spsc-by-contract: the request ring's cursor-"
                    "mutating producer calls all run under _ring_lock; "
                    "the spec reads outside it are frozen-dataclass "
                    "immutable", "req_ring", "rsp_ring"),
        ),
        thread_owner="_threads",
        notes="_ring_lock makes the reader threads collectively ONE "
              "producer on the request ring (the SPSC contract); "
              "_map_lock is the ColumnarTcpServer-style connection "
              "bookkeeping split.",
    ),
    ClassGuards(
        cls="StoreOwner", module="hermes_tpu_torch.serving.ipc",
        audited=(audited("single-threaded by contract: the owner pump "
                         "thread (OneStoreServer) or the soak loop is "
                         "the only entrant; ring consumer/producer "
                         "cursors and counters never see a second "
                         "thread", "*"),),
    ),
    ClassGuards(
        cls="OneStoreServer", module="hermes_tpu_torch.serving.ipc",
        audited=(
            audited("single-writer-publish: set once by the dying pump "
                    "thread; every other thread only polls it",
                    "pump_error"),
            audited("threading.Event is internally synchronized", "_stop"),
            audited("sequential handoff: the pump thread is the sole "
                    "mutator while running; close() joins it before "
                    "touching owner/ring/process state, and the boot "
                    "path runs before the thread starts", "*"),
        ),
        thread_owner="_pump_t",
        notes="worker shutdown rides SIGTERM, not a shared mp.Event: "
              "mp.Event.set() handshakes with sleepers and deadlocks "
              "against a SIGKILLed waiter (the crash path the kill "
              "soak gates).",
    ),
    ClassGuards(
        cls="SpscColumnRing", module="hermes_tpu_torch.transport.shm",
        audited=(audited("spsc-by-contract: exactly one producer and "
                         "one consumer process/thread (callers "
                         "serialize their own side — ShmWorker._ring_"
                         "lock); the cross-process handshake is the "
                         "begin/end/ack generation protocol, not a "
                         "lock", "*"),),
    ),
    ClassGuards(
        cls="FramedSocket", module="hermes_tpu_torch.transport.tcp",
        locks=("_send_lock",),
        audited=(audited("single-reader: recv runs on exactly one thread "
                         "per socket (the server's per-connection reader "
                         "or the blocking client's owner thread)",
                         "corrupt_dropped"),),
        blocking=(BlockingAudit(
            "_send_lock", "sendall",
            "frame-atomicity: the send lock exists precisely to "
            "serialize whole-frame writes from concurrent senders; "
            "SO_SNDTIMEO bounds the stall on the serving path"),),
        notes="_send_lock guards the socket's WRITE STREAM, not an "
              "attribute: two threads sharing one FramedSocket must "
              "never splice frames mid-stream.",
    ),
    ClassGuards(
        cls="MetricsRegistry", module="hermes_tpu_torch.obs.metrics",
        locks=("_lock",),
        guards=(Guard("_lock", ("_metrics",)),),
        notes="the registry map is fed from pump + reader threads; "
              "individual metric objects stay lock-free (GIL-atomic int "
              "adds — a rare lost increment is acceptable for metrics; "
              "exact counts come from the device Meta sums).  _lock is "
              "a PLAIN threading.Lock, never make_lock: the registry is "
              "the sink the lock sanitizer feeds its hold-time series "
              "into, and instrumenting the sink's own lock would "
              "recurse.",
    ),
    ClassGuards(
        cls="FlightRecorder", module="hermes_tpu_torch.obs.flightrec",
        audited=(audited("gil-atomic: bounded deque appends from "
                         "whichever thread writes obs records; dump() "
                         "snapshots via list() copies", "*"),),
    ),
    ClassGuards(
        cls="KVS", module="hermes_tpu_torch.kvs",
        audited=(audited("externally serialized: the KVS step loop "
                         "(queues, inflight maps, batch tables) is "
                         "single-threaded; the serving tier serializes "
                         "every entry point under the owning server's "
                         "_lock", "*"),),
    ),
    ClassGuards(
        cls="ValueHeap", module="hermes_tpu_torch.heap.core",
        audited=(audited("store-serialized: lives under the KVS's "
                         "single-threaded step loop (class docstring: "
                         "NOT thread-safe)", "*"),),
    ),
    ClassGuards(
        cls="GroupCommitWal", module="hermes_tpu_torch.wal.log",
        locks=("_lock",),
        guards=(Guard("_lock", ("_buf", "_next_lsn", "_durable_lsn",
                                "_dirty", "_flush_evt")),),
        audited=(
            audited("threading.Event is internally synchronized",
                    "_stop", "_wake"),
            audited("flusher-thread-private: the open segment file and "
                    "its rotation bookkeeping are touched only by the "
                    "flusher (close() joins it before the final seal)",
                    "_f", "_seg_path", "_seg_bytes", "_seg_max_step",
                    "_sealed_steps", "_seg_seq"),
            audited("single-writer-publish: set once by the dying "
                    "flusher thread; every other thread only polls it",
                    "_error"),
            audited("gil-atomic counters: stats-only, exact durability "
                    "accounting rides _durable_lsn under _lock",
                    "records", "rounds", "remaps", "fsyncs", "wal_bytes",
                    "retired_segments"),
        ),
        thread_owner="_flusher_t",
        notes="the group-commit split: producers only append to _buf "
              "and bump _next_lsn under _lock; the flusher drains the "
              "batch under _lock but encodes/writes/fsyncs with the "
              "lock RELEASED (the whole point — fsync off the hot "
              "path), then re-acquires to publish _durable_lsn and "
              "swap the generation Event.  sync() waits on the Event "
              "outside the lock.",
    ),
    ClassGuards(
        cls="LockGraph", module="hermes_tpu_torch.analysis.lockgraph",
        locks=("_graph_lock",),
        guards=(Guard("_graph_lock", ("_edges", "_stats", "_registry")),),
        audited=(audited("threading.local is per-thread by construction",
                         "_held"),),
        notes="the sanitizer's own bookkeeping, held only for dict "
              "updates; the one static edge out of it (the series feed "
              "into MetricsRegistry._lock) is one-directional, and the "
              "registry lock stays uninstrumented, so the pair cannot "
              "deadlock.",
    ),
    ClassGuards(
        cls="ObsLock", module="hermes_tpu_torch.analysis.lockgraph",
        locks=("_lk",),
        notes="the instrumented drop-in lock itself; all bookkeeping "
              "lives in its LockGraph (per-thread via threading.local, "
              "shared via _graph_lock).",
    ),
)


def validate(registry: Tuple[ClassGuards, ...] = REGISTRY) -> None:
    """Import-time schema check (the layouts.py pattern): one entry per
    (module, class); an attribute is guarded XOR audited; guards name
    declared locks; tags are well-formed."""
    seen = set()
    for e in registry:
        if not e.cls or not e.module:
            raise ValueError("registry entry needs cls and module names")
        key = (e.module, e.cls)
        if key in seen:
            raise ValueError(f"duplicate registry entry for {key}")
        seen.add(key)
        declared: dict = {}
        for g in e.guards:
            if g.lock not in e.locks:
                raise ValueError(
                    f"{e.cls}: guard names lock {g.lock!r} not in the "
                    f"entry's declared locks {e.locks}")
            for a in g.attrs:
                if a in declared:
                    raise ValueError(
                        f"{e.cls}.{a}: declared twice ({declared[a]} and "
                        f"guard {g.lock})")
                declared[a] = f"guard {g.lock}"
        for au in e.audited:
            if not au.tag or any(c in au.tag for c in "[]"):
                raise ValueError(f"{e.cls}: malformed audit tag {au.tag!r}")
            for a in au.attrs:
                if a in declared:
                    raise ValueError(
                        f"{e.cls}.{a}: declared twice ({declared[a]} and "
                        f"audited)")
                declared[a] = "audited"
        for b in e.blocking:
            if b.lock not in e.locks:
                raise ValueError(
                    f"{e.cls}: blocking audit names lock {b.lock!r} not "
                    f"in the entry's declared locks {e.locks}")
            if not b.tag or any(c in b.tag for c in "[]"):
                raise ValueError(f"{e.cls}: malformed blocking-audit tag "
                                 f"{b.tag!r}")


def by_class(registry: Tuple[ClassGuards, ...] = REGISTRY) -> dict:
    """{(module, cls): entry} — the static pass's lookup table."""
    return {(e.module, e.cls): e for e in registry}


validate()
