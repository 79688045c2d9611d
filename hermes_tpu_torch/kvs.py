"""Client-facing KVS API over the port's runtime.

Port of the client core of ``hermes_tpu/kvs.py``: callers enqueue
operations on (replica, session) slots; every ``step()`` injects one op
per idle session into the device-side op stream, runs one protocol round,
and resolves the completions that came back.  Gets are local (served from
the replica's table, stalling while the key is Invalid); puts and RMWs run
the INV/ACK/VAL round and linearize at quorum.

Values are ``value_words - 2`` int32 payload words: words 0-1 of every
stored value carry the device-derived unique write id (the
linearizability witness), so checked runs work unchanged over client
traffic.  With ``cfg.max_value_bytes > 0`` values are byte payloads in the
value heap (``heap/``): the extent lands in the heap at submission and
only its packed ref word (payload word 0) rides the round.

Keys are dense slot ids ``[0, n_keys)`` by default; ``sparse_keys=True``
takes arbitrary unsigned 64-bit client keys through the exact index of
``keyindex.py``: completions echo the client key, and inserting more than
``n_keys`` distinct keys raises ``keyindex.KeyspaceFull``.

``multi_get`` and ``scan`` are the local-read path (``core/readpath.py``):
one dispatch answers every Valid key from the resident table; the rest
(Invalid, read-your-writes fence unmet, no healthy replica) go through the
round path.

Robustness and durability (ROADMAP A5b and A9):

  * ``cfg.op_timeout_rounds``: the stuck-op watchdog reports a client op
    pending past the budget once (a ``stuck_op`` event, a diagnostic in
    ``stuck_ops`` and a flight-recorder dump; ``strict_timeouts`` raises
    ``StuckOpError``); with ``cfg.op_retry_limit`` an op wedged on a
    fenced coordinator is salvaged and re-enqueued on a healthy replica.
  * ``cfg.trace_sample``: a seeded sampler traces ~1 in N submitted ops
    (``op_queue`` and ``op_rounds`` spans on the attached obs timeline).
  * ``cfg.wal_dir``: the write-ahead log taps the harvest; under
    ``wal_sync='commit'`` a round's futures resolve only once its log
    batch is fsynced, the relaxed modes label their completions, and a
    full dirty window sheds new updates as ``retry_after``.  A crashed
    replica's in-flight futures resolve as ``lost``
    (``chaos.recovery``).

``backend="sharded"`` runs the sharded engine (one table copy a replica,
``core/group.py``) with every replica in this process, on ``device`` (or
on the ``LocalGroup`` given as ``group=``, as a fleet places it):
gets and local reads are served from the serving replica's own copy,
and the heap GC rewrites the ref words of every copy.

Membership and elastic operations (ROADMAP A11a):

  * ``cfg.min_healthy_for_writes``: degraded mode.  With fewer healthy
    (live, unfrozen, unretired) replicas than the floor, new writes are
    shed at once as ``kind='rejected'`` (``C_REJECTED`` in a batch) and
    counted in ``shed_writes``, while gets are still served; the
    transitions are ``degraded`` / ``degraded_clear`` trace events.
  * ``shrink`` / ``grow``: live resize under traffic.  A retired replica
    takes no new ops (queued and new ones resolve ``rejected``, counted
    in ``rejected_ops``); its in-flight ops drain to normal completion
    before the runtime fences and removes it.
  * ``net_phase``: the active adversary windows a ``ChaosRunner``
    publishes, tagged onto stuck-op diagnostics.

Live key-range migration (``elastic.migrate_range``, ROADMAP A11b):

  * ``fence_slots`` marks a dense-slot range draining or migrated away:
    ops on it (per-op, batch, queued, retried, ``multi_get`` and
    ``scan``) resolve ``rejected`` instead of entering a store that no
    longer owns the key; ``release_slots`` is the abort path.
  * ``range_inflight`` is the drain's poll; ``salvage_slots`` the forced
    cutover (in-flight updates folded as ``maybe_w``, futures ``lost``,
    volatile state wiped).
  * ``drill_phase`` (fence / drain / flip) and, in a fleet, the group
    label tag stuck-op diagnostics.

Usage::

    kvs = KVS(HermesConfig(n_replicas=3, n_keys=1024, value_words=6))
    f1 = kvs.put(replica=0, session=0, key=7, value=[1, 2, 3, 4])
    f2 = kvs.get(replica=1, session=0, key=7)
    kvs.run_until([f1, f2])
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import readpath
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.heap import HeapFull, ValueHeap
from hermes_tpu_torch.keyindex import KeyIndex
from hermes_tpu_torch.runtime import FastRuntime, host_copies

# client-level completion code for ops LOST to a replica crash
# (chaos.recovery.restart_replica) or a retry with nowhere to go: the
# op MAY have applied.  Negative, so it never collides with the device
# C_* codes.
C_LOST = -2
# client-level completion code for ops REJECTED: a write shed in degraded
# mode or an op sent to a replica retired by a live shrink.  The op never
# entered the store: a rejected op definitively did NOT happen.
C_REJECTED = -3
# client-level completion code for updates shed by WAL backpressure
# (cfg.wal_dirty_window): the write never entered the store; the client
# retries after the flusher drains.
C_RETRY_AFTER = -4


class StuckOpError(RuntimeError):
    """Strict-mode stuck-op watchdog verdict (cfg.op_timeout_rounds): at
    least one client op out-aged the timeout; ``diagnostics`` carries the
    per-session evidence (coordinator, session, phase, age)."""

    def __init__(self, diagnostics):
        self.diagnostics = diagnostics
        super().__init__(
            f"{len(diagnostics)} client op(s) stuck past op_timeout_rounds: "
            + "; ".join(
                f"r{d['replica']}/s{d['session']} {d['kind']} key={d['key']} "
                f"phase={d['phase']}"
                + (f" drill={d['drill']}" if "drill" in d else "")
                + (f" net={d['net']}" if "net" in d else "")
                + (f" tenant={d['tenant']}" if "tenant" in d else "")
                + (f" deadline_left_us={d['deadline_left_us']}"
                   if "deadline_left_us" in d else "")
                + f" age={d['age_rounds']}"
                for d in diagnostics[:4]))


@dataclasses.dataclass
class Completion:
    """Result of one client op: kind 'get' | 'put' | 'rmw' | 'rmw_abort'
    | 'lost' (replica crash or exhausted retries: the op MAY have
    applied) | 'rejected' (degraded mode or a retired replica: it did NOT
    apply) | 'retry_after' (WAL backpressure: it did NOT apply)."""

    kind: str
    key: int
    value: Optional[List[int]] = None  # payload read (get / rmw read-part)
    # heap mode: the byte payload behind the row's ref word (None = the
    # key was never written, the null ref)
    data: Optional[bytes] = None
    uid: Optional[Tuple[int, int]] = None  # unique id of the written value
    step: int = -1
    # sparse-key mode: False when a get probed a key never written (it
    # completes at once, value None, and claims no dense slot)
    found: bool = True
    # committed updates only: the globally re-anchored protocol (ver, fc),
    # what a caller hands to KVS.pin_read_fence
    ts: Optional[Tuple[int, int]] = None
    # committed updates on a WAL store only: 'commit' (the log record was
    # fsynced before this resolved) or '<mode>:not-fsynced-at-resolve'
    durability: Optional[str] = None


class Future:
    def __init__(self):
        self._result: Optional[Completion] = None

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> Completion:
        if self._result is None:
            raise RuntimeError("op not complete; call KVS.step()/run_until()")
        return self._result


class BatchFutures:
    """Array-form futures of one ``KVS.submit_batch`` call: results land in
    preallocated numpy columns — ``code`` (0 while pending, else the
    completion code), ``value`` (payload read), ``uid`` (written value id),
    ``found`` (sparse mode: False for gets of never-written keys),
    ``step`` (completing round), ``tsv``/``tsf`` (committed timestamp),
    and in heap mode ``data`` (the byte payload read, resolved eagerly at
    completion off the heap's mirror, before any later GC can move it)."""

    def __init__(self, kinds: np.ndarray, keys: np.ndarray, u: int):
        n = kinds.shape[0]
        self.kind = kinds
        self.key = keys
        self.code = np.zeros(n, np.int32)
        self.value = np.zeros((n, u), np.int32)
        self.uid = np.zeros((n, 2), np.int32)
        self.found = np.ones(n, bool)
        self.data: List[Optional[bytes]] = [None] * n
        self.step = np.full(n, -1, np.int32)
        self.tsv = np.zeros(n, np.int64)
        self.tsf = np.zeros(n, np.int32)
        # the store's durability label for committed updates (one per
        # store, set by submit_batch)
        self.durability: Optional[str] = None

    def __len__(self) -> int:
        return self.code.shape[0]

    def done_count(self) -> int:
        return int(np.count_nonzero(self.code))

    def all_done(self) -> bool:
        return bool((self.code != 0).all())

    _KINDSTR = {t.OP_READ: "get", t.OP_WRITE: "put", t.OP_RMW: "rmw"}
    _CLIENT_KINDS = {C_LOST: "lost", C_REJECTED: "rejected",
                     C_RETRY_AFTER: "retry_after"}

    def completion(self, i: int) -> Completion:
        if self.code[i] == 0:
            raise RuntimeError("op not complete; run KVS.run_batch()")
        c = int(self.code[i])
        if c in self._CLIENT_KINDS:
            return Completion(kind=self._CLIENT_KINDS[c],
                              key=int(self.key[i]), step=int(self.step[i]),
                              found=False)
        kind = ("rmw_abort" if c == t.C_RMW_ABORT
                else self._KINDSTR[int(self.kind[i])])
        done = Completion(kind=kind, key=int(self.key[i]),
                          step=int(self.step[i]), found=bool(self.found[i]))
        if c in (t.C_READ, t.C_RMW) and self.found[i]:
            done.value = self.value[i].tolist()
            done.data = self.data[i]
        if c in (t.C_WRITE, t.C_RMW):
            done.uid = (int(self.uid[i, 0]), int(self.uid[i, 1]))
            done.ts = (int(self.tsv[i]), int(self.tsf[i]))
            done.durability = self.durability
        return done

    def future(self, i: int) -> Future:
        fut = Future()
        if self.code[i] != 0:
            fut._result = self.completion(i)
        return fut


class MultiGetResult:
    """Result of one ``KVS.multi_get``/``scan`` call, in the columns of
    BatchFutures:

      ``key``   (n,) the CLIENT keys echoed (sparse callers see the keys
                they submitted, uint64, never dense slots)
      ``code``  (n,) 0 pending, else types.C_READ
      ``value`` (n, value_words-2) payload words (uid words stripped)
      ``found`` (n,) bool (sparse mode: False for never-written keys)
      ``local`` (n,) bool: answered by the local-read path (False = the
                round-path fallback)
      ``step``  (n,) protocol round the answer is anchored to
      ``data``  heap mode: the byte payload per key

    Keys the local path could not serve ride a fallback ``BatchFutures``
    through the round path; drive it with ``KVS.step()`` until
    ``all_done()``."""

    def __init__(self, keys: np.ndarray, u: int, heap=None):
        n = keys.shape[0]
        self.key = keys
        self.code = np.zeros(n, np.int32)
        self.value = np.zeros((n, u), np.int32)
        self.found = np.ones(n, bool)
        self.local = np.zeros(n, bool)
        self.step = np.full(n, -1, np.int32)
        self._fallback: Optional[Tuple[BatchFutures, np.ndarray]] = None
        self._heap = heap
        self.data: List[Optional[bytes]] = [None] * n

    def __len__(self) -> int:
        return self.key.shape[0]

    def _pull(self) -> None:
        if self._fallback is None:
            return
        bf, gix = self._fallback
        done = (bf.code != 0) & (self.code[gix] == 0)
        if done.any():
            di = gix[done]
            self.code[di] = bf.code[done]
            self.value[di] = bf.value[done]
            self.found[di] = bf.found[done]
            self.step[di] = bf.step[done]
            if self._heap is not None:
                for j, i in zip(np.nonzero(done)[0], di):
                    self.data[int(i)] = bf.data[int(j)]

    def done_count(self) -> int:
        self._pull()
        return int(np.count_nonzero(self.code))

    def all_done(self) -> bool:
        return self.done_count() == len(self)

    @property
    def local_served(self) -> int:
        return int(np.count_nonzero(self.local))

    @property
    def fallbacks(self) -> int:
        return 0 if self._fallback is None else int(self._fallback[1].size)


class KVS:
    """A replicated, linearizable KVS served by the Hermes protocol: one
    instance drives all R replicas of a single-device deployment; each
    (replica, session) slot takes one op at a time, queued FIFO beyond
    that."""

    def __init__(self, cfg: HermesConfig, backend: str = "batched",
                 record: bool = False, sparse_keys: bool = False,
                 strict_timeouts: bool = False, device="cuda",
                 group=None):
        if cfg.value_words < 3:
            raise ValueError("KVS needs value_words >= 3 (2 uid words + payload)")
        if cfg.read_unroll != 1:
            raise ValueError(
                "KVS uses a one-deep rewritable stream (one client op per "
                "session in flight); read_unroll > 1 would re-execute the "
                "same op within a round")
        if cfg.device_stream:
            raise ValueError("KVS drives ops through the stream; device_stream "
                             "would replace client requests with hash-generated ops")
        # One-deep, rewritable stream: wrap_stream makes idle sessions reload
        # slot op_idx % 1 == 0 every round, so the host injects ops by
        # rewriting the (R, S, 1) stream between rounds.
        self.cfg = dataclasses.replace(cfg, ops_per_session=1, wrap_stream=True)
        r, s, u = cfg.n_replicas, cfg.n_sessions, cfg.value_words - 2
        self._op = np.zeros((r, s, 1), np.int32)  # OP_NOP
        self._key = np.zeros((r, s, 1), np.int32)
        self._uval = np.zeros((r, s, 1, u), np.int32)
        stream = st.OpStream(op=self._op, key=self._key, uval=self._uval)
        self.rt = FastRuntime(self.cfg, backend=backend, record=record,
                              stream=stream, device=device, group=group)
        # the runtime's rebase drain steps THROUGH this layer so drained
        # completions resolve their futures; its boundaries flush the
        # deferred round of the pipelined mode
        self.rt.comp_sink = self.step
        self.rt.comp_flush = self.flush
        self._depth = self.cfg.pipeline_depth
        self._pending = None  # (round_idx, device comp, done_mask, code)
        self._queues: Dict[Tuple[int, int], collections.deque] = (
            collections.defaultdict(collections.deque))
        self._inflight: Dict[Tuple[int, int], Tuple[str, Future, int]] = {}
        # per-slot op kind mirror: one numpy mask finds finished slots
        self._kindarr = np.zeros((r, s), np.int32)
        self._ready: set = set()
        self._queued_slots: set = set()
        self._dirty = True
        # batched client path: active submit_batch calls keyed by id, and
        # per-slot (batch id, batch index)
        self._bat: Dict[int, dict] = {}
        self._next_bid = 0
        self._slot_bid = np.full((r, s), -1, np.int32)
        self._slot_bix = np.zeros((r, s), np.int32)
        # stuck-op watchdog: the round each slot's current op was injected
        # (-1 = idle), the diagnostics surfaced so far, and the ops already
        # reported (once per op); bounded retry: per-slot next examination
        # round and backoff windows elapsed
        self._slot_inject = np.full((r, s), -1, np.int64)
        self._stuck_flagged: set = set()
        self.stuck_ops: List[dict] = []
        self.strict_timeouts = strict_timeouts
        self._retry_next: Dict[Tuple[int, int], int] = {}
        self._retry_k: Dict[Tuple[int, int], int] = {}
        self.retried_ops = 0
        # live resize: replicas retired by shrink() take no new ops; ops
        # sent to them resolve 'rejected' (rejected_ops).  Degraded mode
        # sheds new writes while too few replicas are healthy
        # (shed_writes).  net_phase: the active adversary windows a
        # ChaosRunner publishes into the stuck-op diagnostics
        self._retired: set = set()
        self.rejected_ops = 0
        self.shed_writes = 0
        # range migration: fenced dense slots (draining or migrated away)
        # reject new ops; drill_phase tags the active migration stage
        # (fence / drain / flip) into stuck-op diagnostics
        self._fence_mask = np.zeros(cfg.n_keys, bool)
        self.drill_phase: Optional[str] = None
        self._degraded = False
        self.net_phase: Optional[dict] = None
        # a serving front end that drives this KVS installs a per-op
        # diagnostics hook: the watchdog calls it with the stuck
        # (replica, session) and merges what it returns (tenant, the
        # deadline budget left) into the diagnostic
        self.diag_hook = None
        # sparse-key mode: 64-bit client keys -> dense slots
        self.index: Optional[KeyIndex] = (KeyIndex(cfg.n_keys) if sparse_keys
                                          else None)
        # the local-read path: _ryw is the read-your-writes fence, per
        # session token the re-anchored (ver, fc) of its latest committed
        # write per dense slot; a local read of that slot must see a row
        # ts >= the fence or fall back to the round path.  Entries prune
        # on first satisfaction (the row ts only grows).
        self._reader: Optional[readpath.LocalReader] = None
        self._ryw: Dict[object, Dict[int, Tuple[int, int]]] = {}
        self.local_reads = 0
        self.fallback_reads = 0
        self.ryw_fallbacks = 0
        # the value heap: dead extents compact at rebase boundaries
        # (rt.rebase_hook) and on allocation pressure (append raises
        # HeapFull -> heap_gc -> one retry)
        if self.cfg.use_heap:
            self.heap: Optional[ValueHeap] = ValueHeap(self.cfg,
                                                       device=self.rt.device)
            self.rt.rebase_hook = self._heap_rebase_hook
        else:
            self.heap = None
        self._in_heap_gc = False
        # refs appended for a call still being staged: a pressure GC
        # between two appends of one submit_batch must root and remap
        # them (_heap_staging); each entry is a 1-D int32 view
        self._staging: List[np.ndarray] = []
        # the write-ahead log rides the harvest (rt.attach_wal); under
        # wal_sync='commit' a harvested round parks in _wal_defer, keyed
        # by its log batch's LSN, until the flusher reports it durable
        if self.cfg.use_wal:
            from hermes_tpu_torch.wal import GroupCommitWal

            self.wal = GroupCommitWal(self.cfg)
            self.rt.attach_wal(self.wal, heap=self.heap)
        else:
            self.wal = None
        self._wal_defer: collections.deque = collections.deque()
        self.wal_shed = 0
        self._wal_bp = False
        # per-op tracing: a seeded sampler mints a trace id for ~1 in
        # cfg.trace_sample submissions; the id rides the FUTURE, never the
        # device stream, so the round is the same at any rate
        if self.cfg.trace_sample:
            from hermes_tpu_torch.obs.tracing import TraceSampler

            self._sampler = TraceSampler(self.cfg.trace_sample,
                                         seed=self.cfg.workload.seed)
        else:
            self._sampler = None
        self._trace_seq = 0
        # an id minted upstream (the serving front end, off the wire
        # field), taken by the next _enqueue instead of a sampled one
        self._staged_trace = 0
        self._op_tracer_cache = None

    def _op_tracer(self):
        """Span writer bound to the runtime's CURRENT obs context (None
        while none is attached)."""
        obs = self.rt.obs
        if obs is None:
            return None
        c = self._op_tracer_cache
        if c is None or c.obs is not obs:
            from hermes_tpu_torch.obs.tracing import OpTracer

            c = self._op_tracer_cache = OpTracer(obs)
        return c

    # -- client ops ----------------------------------------------------------

    def _enqueue(self, kind, replica, session, key, value) -> Future:
        cfg = self.cfg
        if not (0 <= replica < cfg.n_replicas):
            raise ValueError(f"replica {replica} out of range [0, {cfg.n_replicas})")
        if not (0 <= session < cfg.n_sessions):
            raise ValueError(f"session {session} out of range [0, {cfg.n_sessions})")
        if kind != "get" and self._degraded_now():
            # degraded mode: shed the write loudly, before the sparse
            # index could spend a slot on it (counted in shed_writes only)
            self.shed_writes += 1
            fut = Future()
            fut._result = Completion(kind="rejected", key=int(key),
                                     found=False)
            return fut
        if kind != "get" and self._wal_backpressured():
            # the log's dirty window is full: shed the update loudly,
            # before the sparse index could spend a slot on it
            self.wal_shed += 1
            fut = Future()
            fut._result = Completion(kind="retry_after", key=int(key),
                                     found=False)
            return fut
        if self.index is not None:
            client_key = int(key)
            if not (0 <= client_key < (1 << 64) - 1):
                raise ValueError("sparse keys are unsigned 64-bit "
                                 "(0xFFFF...FF reserved)")
            # writes allocate (a written key keeps its dense slot); gets
            # probe without inserting: an absent key's read completes at
            # once as not-found instead of using up a slot
            if kind == "get":
                slot = self.index.slot(client_key, insert=False)
                if slot < 0:
                    fut = Future()
                    fut._result = Completion(kind="get", key=client_key,
                                             found=False)
                    return fut
            else:
                slot = self.index.slot(client_key, insert=True)
        else:
            if not (0 <= key < cfg.n_keys):
                raise ValueError(f"key {key} out of range [0, {cfg.n_keys})")
            client_key, slot = int(key), int(key)
        if replica in self._retired or self._fence_mask[slot]:
            # a replica retired by a live shrink, or a fenced range
            # (draining or migrated away): the op never enters the store,
            # and the client is told now
            return self._rejected_future(client_key)
        fut = Future()
        # trace mint: adopt an id staged by the serving layer, else
        # sample one; the submit sequence ticks for EVERY accepted
        # submission, so replays sample the same ops
        trace, self._staged_trace = self._staged_trace, 0
        if not trace and self._sampler is not None:
            trace = self._sampler.sample(self._trace_seq)
        if trace:
            fut._trace = trace
            fut._trace_r0 = self.rt.step_idx
        self._trace_seq += 1
        self._queues[(replica, session)].append(
            (kind, slot, client_key, value, fut, 0))
        self._queued_slots.add((replica, session))
        if (replica, session) not in self._inflight:
            self._ready.add((replica, session))
        return fut

    def _degraded_now(self) -> bool:
        """Degraded mode (cfg.min_healthy_for_writes): too few healthy,
        unretired replicas to commit new writes.  Transitions land on the
        obs timeline as ``degraded`` / ``degraded_clear``."""
        floor = self.cfg.min_healthy_for_writes
        if not floor:
            return False
        healthy = [r for r in self.rt.healthy_replicas()
                   if r not in self._retired]
        degraded = len(healthy) < floor
        if degraded != self._degraded:
            self._degraded = degraded
            self.rt._trace("degraded" if degraded else "degraded_clear",
                           healthy=len(healthy), floor=floor)
        return degraded

    def degraded(self) -> bool:
        """True while degraded mode sheds new writes."""
        return self._degraded_now()

    def _rejected_future(self, client_key: int) -> Future:
        self.rejected_ops += 1
        fut = Future()
        fut._result = Completion(kind="rejected", key=client_key, found=False)
        return fut

    def _reject_queued(self, rs_key) -> None:
        """Resolve every op queued on a retired replica's slot
        ``rejected``."""
        q = self._queues[rs_key]
        while q:
            _k, _sl, ck, _v, fut, _n = q.popleft()
            fut._result = Completion(kind="rejected", key=ck, found=False)
            self.rejected_ops += 1
        self._queued_slots.discard(rs_key)

    def _wal_backpressured(self) -> bool:
        """More appended-but-not-durable records than
        cfg.wal_dirty_window.  Transitions land on the obs timeline;
        while backpressured the flusher is kicked at every probe."""
        if self.wal is None:
            return False
        bp = self.wal.backpressured()
        if bp != self._wal_bp:
            self._wal_bp = bp
            self.rt._trace(
                "wal_backpressure" if bp else "wal_backpressure_clear",
                dirty=self.wal.dirty_records(),
                window=self.cfg.wal_dirty_window)
        if bp:
            self.wal.kick()
        return bp

    def get(self, replica: int, session: int, key: int) -> Future:
        """Local linearizable read from ``replica``'s own table."""
        return self._enqueue("get", replica, session, key, None)

    def put(self, replica: int, session: int, key: int, value: Sequence[int]) -> Future:
        """Replicated write: commits after the INV/ACK round."""
        return self._enqueue("put", replica, session, key, self._payload(value))

    def rmw(self, replica: int, session: int, key: int, value: Sequence[int]) -> Future:
        """Conditional update: writes ``value`` and returns the value it
        displaced; aborts (kind='rmw_abort') on a concurrent higher-ts
        update."""
        return self._enqueue("rmw", replica, session, key, self._payload(value))

    def _payload(self, value) -> np.ndarray:
        u = self.cfg.value_words - 2
        if self.heap is not None:
            # heap mode: the payload IS bytes; the extent lands in the
            # log now and only the packed ref word rides the round
            if not isinstance(value, (bytes, bytearray, memoryview)):
                raise TypeError(
                    "heap mode (cfg.max_value_bytes > 0) takes byte "
                    f"payloads, got {type(value).__name__}; fixed-word "
                    "values need max_value_bytes=0")
            out = np.zeros(u, np.int32)
            out[0] = self._heap_append(bytes(value))
            return out
        arr = np.asarray(list(value), np.int32)
        if arr.ndim != 1 or arr.shape[0] > u:
            raise ValueError(f"value must be <= {u} int32 words")
        return np.pad(arr, (0, u - arr.shape[0]))

    def _heap_append(self, data: bytes) -> int:
        """Land one extent, compacting ONCE on allocation pressure; a heap
        that stays full after compaction is out of space and HeapFull
        propagates."""
        try:
            return self.heap.append(data)
        except HeapFull:
            if self._in_heap_gc:
                raise
            self.heap_gc(reason="full")
            return self.heap.append(data)

    @contextlib.contextmanager
    def _heap_staging(self, refs: np.ndarray):
        """Root the nonzero entries of ``refs`` (a 1-D int32 view) for any
        GC that fires inside the with-block, which remaps them in place."""
        self._staging.append(refs)
        try:
            yield refs
        finally:
            self._staging.remove(refs)

    # -- batched client path (array-in, futures-out) -------------------------

    GET, PUT, RMW = t.OP_READ, t.OP_WRITE, t.OP_RMW

    def submit_batch(self, kinds, keys, values=None) -> BatchFutures:
        """Enqueue a whole op mix: ``kinds`` (n,) of KVS.GET/PUT/RMW,
        ``keys`` (n,) client keys, ``values`` (n, <=value_words-2) int32
        payloads (in heap mode a sequence of n byte payloads, anything for
        gets).  Ops flow through idle slots in submission order; drive the
        returned BatchFutures with run_batch()/step()."""
        opc = np.ascontiguousarray(np.asarray(kinds, np.int32))
        n = opc.shape[0]
        bad = ~np.isin(opc, (t.OP_READ, t.OP_WRITE, t.OP_RMW))
        if bad.any():
            raise ValueError(f"unknown op kind(s) {np.unique(opc[bad])}")
        keys_arr = np.asarray(keys)
        if keys_arr.shape != (n,):
            raise ValueError("keys must be shape (n,)")
        u = self.cfg.value_words - 2
        uval = np.zeros((n, u), np.int32)
        if values is not None and self.heap is not None:
            # heap mode: each update's extent lands NOW and only the
            # packed ref word enters the op stream
            if len(values) != n:
                raise ValueError(f"values must carry {n} byte payloads")
            upd = opc != t.OP_READ
            # the ref column is a GC root while the batch is staged: a
            # pressure compaction between two appends remaps the refs
            # already written here
            with self._heap_staging(uval[:, 0]):
                for i in np.nonzero(upd)[0]:
                    v = values[int(i)]
                    if not isinstance(v, (bytes, bytearray, memoryview)):
                        raise TypeError(
                            "heap mode takes byte payloads per update, got "
                            f"{type(v).__name__} at index {int(i)}")
                    uval[i, 0] = self._heap_append(bytes(v))
        elif values is not None:
            v = np.asarray(values, np.int32)
            if v.ndim != 2 or v.shape[0] != n or v.shape[1] > u:
                raise ValueError(f"values must be (n, <={u}) int32 words")
            uval[:, : v.shape[1]] = v
        elif self.heap is not None and (opc != t.OP_READ).any():
            # an update without a byte payload would commit the null ref
            raise TypeError(
                "heap mode (cfg.max_value_bytes > 0) needs a byte payload "
                "per update op; got values=None with "
                f"{int((opc != t.OP_READ).sum())} update(s) in the batch")
        bf = BatchFutures(opc.copy(), keys_arr.copy(), u)
        bf.durability = self._wal_label()
        if self._degraded_now():
            # degraded mode: shed the writes before the index mapping (a
            # shed op claims no dense slot); gets are still served
            shed = opc != t.OP_READ
            if shed.any():
                bf.code[shed] = C_REJECTED
                bf.found[shed] = False
                self.shed_writes += int(shed.sum())
        if self._wal_backpressured():
            # shed NEW updates loudly before the index mapping
            shed = (opc != t.OP_READ) & (bf.code == 0)
            if shed.any():
                bf.code[shed] = C_RETRY_AFTER
                bf.found[shed] = False
                self.wal_shed += int(shed.sum())
        if self.index is not None:
            k64 = keys_arr.astype(np.uint64)
            slots = np.zeros(n, np.int32)
            wr = (opc != t.OP_READ) & (bf.code == 0)
            if wr.any():
                slots[wr] = self.index.get_slots(k64[wr])
            rd = (opc == t.OP_READ) & (bf.code == 0)
            if rd.any():
                got = self.index.get_slots(k64[rd], insert=False)
                gi = np.nonzero(rd)[0]
                miss = got < 0
                # absent keys: the get completes at once as not-found
                # without claiming a dense slot (the get() rule)
                bf.code[gi[miss]] = t.C_READ
                bf.found[gi[miss]] = False
                slots[gi[~miss]] = got[~miss]
        else:
            kmin, kmax = ((int(keys_arr.min()), int(keys_arr.max())) if n
                          else (0, 0))
            if n and not (0 <= kmin and kmax < self.cfg.n_keys):
                raise ValueError(f"keys out of range [0, {self.cfg.n_keys})")
            slots = keys_arr.astype(np.int32)
        if self._fence_mask.any():
            # ops on fenced slots complete at once as C_REJECTED: never
            # injected, never silently dropped
            fenced = (bf.code == 0) & self._fence_mask[slots]
            if fenced.any():
                bf.code[fenced] = C_REJECTED
                bf.found[fenced] = False
                self.rejected_ops += int(fenced.sum())
        pend = np.nonzero(bf.code == 0)[0].astype(np.int32)
        if pend.size:
            self._bat[self._next_bid] = dict(
                bf=bf, gix=pend, opc=opc[pend], slots=slots[pend],
                uval=uval[pend], cursor=0)
            self._next_bid += 1
        return bf

    def run_batch(self, bf: BatchFutures, max_steps: int = 50_000) -> bool:
        """Step until every op of ``bf`` resolves (or the budget runs out)."""
        for _ in range(max_steps):
            if bf.all_done():
                return True
            self.step()
        self.flush()  # pipelined: the last round's resolution may be deferred
        return bf.all_done()

    def _inject_batches(self) -> None:
        free = self._kindarr == t.OP_NOP
        for r in self._retired:
            free[r] = False  # retired replicas take no new injections
        if self._depth > 1 or self._wal_defer:
            # a slot retired at the last sync point whose resolution is
            # still deferred (pipelined, or parked until its WAL batch is
            # durable) keeps its (bid, bix) mapping until it resolves
            free &= self._slot_bid < 0
            for rs_key in self._inflight:
                free[rs_key] = False
        # slots with queued per-op traffic keep their FIFO promise
        for rs_key in self._queued_slots:
            free[rs_key] = False
        rows, cols = np.nonzero(free)
        if rows.size == 0:
            return
        p = 0
        for bid, b in self._bat.items():
            if p >= rows.size:
                break
            cur, total = b["cursor"], b["opc"].shape[0]
            if cur >= total:
                continue
            take = min(total - cur, rows.size - p)
            rr, cc = rows[p: p + take], cols[p: p + take]
            sl = slice(cur, cur + take)
            self._op[rr, cc, 0] = b["opc"][sl]
            self._key[rr, cc, 0] = b["slots"][sl]
            self._uval[rr, cc, 0] = b["uval"][sl]
            self._kindarr[rr, cc] = b["opc"][sl]
            self._slot_bid[rr, cc] = bid
            self._slot_bix[rr, cc] = b["gix"][sl]
            self._slot_inject[rr, cc] = self.rt.step_idx
            b["cursor"] = cur + take
            p += take
            self._dirty = True

    # -- stepping ------------------------------------------------------------

    _OPC = {"get": t.OP_READ, "put": t.OP_WRITE, "rmw": t.OP_RMW}

    def _inject_ready(self) -> None:
        """Inject queued per-op traffic into idle slots (every idle slot
        with queued work is in _ready); a slot owned by a batch op waits."""
        waiting = set()
        for rs_key in self._ready:
            q = self._queues.get(rs_key)
            if rs_key in self._inflight or not q:
                continue
            if rs_key[0] in self._retired:
                # the replica retired after these ops were queued
                # (shrink() sweeps the queues too)
                self._reject_queued(rs_key)
                continue
            if self._slot_bid[rs_key] >= 0:
                waiting.add(rs_key)
                continue
            kind, slot, client_key, value, fut, nretry = q.popleft()
            if self._fence_mask[slot]:
                # the range fenced after this op was queued (fence_slots
                # sweeps the queues; an op enqueued mid-drain lands here):
                # reject it, keep the slot ready for what sits behind it
                if not q:
                    self._queued_slots.discard(rs_key)
                fut._result = Completion(kind="rejected", key=client_key,
                                         found=False)
                self.rejected_ops += 1
                waiting.add(rs_key)
                continue
            if not q:
                self._queued_slots.discard(rs_key)
            r, s = rs_key
            self._op[r, s, 0] = self._OPC[kind]
            self._key[r, s, 0] = slot
            if value is not None:
                self._uval[r, s, 0] = value
            self._inflight[rs_key] = (kind, fut, client_key, value, nretry)
            self._kindarr[r, s] = self._OPC[kind]
            self._slot_inject[r, s] = self.rt.step_idx
            trace = getattr(fut, "_trace", 0)
            if trace:
                # close the client-queue span (submit -> injection) and pin
                # the inject round for the op_rounds span
                fut._trace_inject = self.rt.step_idx
                tr = self._op_tracer()
                if tr is not None:
                    tr.span("op_queue", trace, r0=fut._trace_r0,
                            r1=self.rt.step_idx, replica=r, session=s,
                            op=kind, key=client_key)
            self._dirty = True
        self._ready.clear()
        self._ready |= waiting

    def _sync_stream(self) -> None:
        """Push the staged host op arrays to the device-side stream: into
        the stream the compiled round bound, in place (a new stream only
        when a shape changed)."""
        if not self._dirty:
            return
        staged = st.OpStream(op=self._op, key=self._key, uval=self._uval)
        if not fst.copy_stream(self.rt.stream, staged):
            self.rt.stream = fst.prep_stream(staged, self.rt.device)
        self._dirty = False

    def _done_mask(self, code: np.ndarray, ckey: np.ndarray) -> np.ndarray:
        """Finished slots: kind matches code and the completion echoes the
        injected key."""
        k = self._kindarr
        return (
            (((k == t.OP_READ) & (code == t.C_READ))
             | ((k == t.OP_WRITE) & (code == t.C_WRITE))
             | ((k == t.OP_RMW)
                & ((code == t.C_RMW) | (code == t.C_RMW_ABORT))))
            & (ckey == self._key[:, :, 0])
        )

    def _retire(self, done_mask: np.ndarray) -> None:
        """Blank completed slots in the staged stream so the NEXT round
        cannot re-issue them."""
        rows, cols = np.nonzero(done_mask)
        if rows.size:
            self._op[rows, cols, 0] = t.OP_NOP
            self._kindarr[rows, cols] = t.OP_NOP
            self._slot_inject[rows, cols] = -1
            self._dirty = True

    def _resolve(self, done_mask, code, rval, wval, round_idx: int,
                 ver, fc) -> int:
        """Resolve the futures of one round's completed (already retired)
        slots; returns the op count.  A per-op committed update pins its
        re-anchored timestamp as the read-your-writes fence of its
        (replica, session) lane."""
        ndone = 0
        bdone = done_mask & (self._slot_bid >= 0)
        if bdone.any():
            rows, cols = np.nonzero(bdone)
            bids = self._slot_bid[rows, cols]
            for bid in np.unique(bids):
                m = bids == bid
                rr, cc = rows[m], cols[m]
                b = self._bat[bid]
                bf: BatchFutures = b["bf"]
                gi = self._slot_bix[rr, cc]
                bf.code[gi] = code[rr, cc]
                bf.value[gi] = rval[rr, cc, 2:]
                bf.uid[gi] = wval[rr, cc, :2]
                bf.step[gi] = round_idx
                if self.heap is not None:
                    # heap mode: resolve read payloads eagerly while the
                    # extents are provably not compacted (GC flushes every
                    # completion before it moves bytes)
                    ccode = code[rr, cc]
                    crefs = rval[rr, cc, 2]
                    for j in np.nonzero(
                            (ccode == t.C_READ) | (ccode == t.C_RMW))[0]:
                        ref = int(crefs[j])
                        bf.data[int(gi[j])] = (
                            self.heap.read(ref) if ref else None)
                bf.tsv[gi] = ver[rr, cc]
                bf.tsf[gi] = fc[rr, cc]
                if b["cursor"] >= b["opc"].shape[0] and bf.all_done():
                    del self._bat[bid]
            self._slot_bid[rows, cols] = -1
            ndone += rows.size
            # freed slots with waiting per-op traffic become injectable
            for rs_key in self._queued_slots:
                if self._slot_bid[rs_key] < 0 and rs_key not in self._inflight:
                    self._ready.add(rs_key)
        for r, s in np.argwhere(done_mask & ~bdone):
            r, s = int(r), int(s)
            kind, fut, client_key, _value, _nretry = self._inflight.pop((r, s))
            self._retry_next.pop((r, s), None)
            self._retry_k.pop((r, s), None)
            c = int(code[r, s])
            done = Completion(
                kind="rmw_abort" if c == t.C_RMW_ABORT else kind,
                key=client_key, step=round_idx)
            if c in (t.C_READ, t.C_RMW):
                done.value = rval[r, s, 2:].tolist()
                if self.heap is not None:
                    ref = int(rval[r, s, 2])
                    done.data = self.heap.read(ref) if ref else None
            if c in (t.C_WRITE, t.C_RMW):
                done.uid = (int(wval[r, s, 0]), int(wval[r, s, 1]))
                done.ts = (int(ver[r, s]), int(fc[r, s]))
                done.durability = self._wal_label()
                # RYW fence: this lane's later local reads of the slot
                # must observe ts >= this committed write
                slot = (client_key if self.index is None
                        else self.index.slot(client_key, insert=False))
                self._ryw.setdefault((r, s), {})[int(slot)] = done.ts
            trace = getattr(fut, "_trace", 0)
            if trace:
                # device-rounds span: injection round -> resolution round
                tr = self._op_tracer()
                if tr is not None:
                    tr.span("op_rounds", trace,
                            r0=getattr(fut, "_trace_inject", round_idx),
                            r1=round_idx, replica=r, session=s,
                            op=done.kind, key=client_key)
            fut._result = done
            if self._queues.get((r, s)):
                self._ready.add((r, s))
            ndone += 1
        return ndone

    # -- stuck-op watchdog and bounded retry -----------------------------------

    _PHASE = {t.S_IDLE: "idle", t.S_READ: "read-stall", t.S_ISSUE: "issue",
              t.S_INFL: "ack-wait", t.S_DONE: "done"}

    def _watchdog(self) -> None:
        """Surface client ops pending past ``cfg.op_timeout_rounds``: one
        ``stuck_op`` obs event and one ``stuck_ops`` diagnostic per op
        (coordinator, session, phase, gathered-ack bitmap, age in rounds)
        the first time it out-ages the budget, and a flight dump.  The
        session rows are read from the device only when a NEW stuck op
        exists.  Strict mode raises StuckOpError after reporting."""
        tmo = self.cfg.op_timeout_rounds
        if not tmo:
            return
        active = self._slot_inject >= 0
        if not active.any():
            return
        age = self.rt.step_idx - self._slot_inject
        stuck = active & (age > tmo)
        fresh = []
        for r, s in zip(*np.nonzero(stuck)):
            tag = (int(r), int(s), int(self._slot_inject[r, s]))
            if tag not in self._stuck_flagged:
                self._stuck_flagged.add(tag)
                fresh.append((int(r), int(s)))
        new_diags = []
        if fresh:
            sess = self.rt.fs.sess
            status = sess.status.cpu().numpy()
            acks = sess.acks.cpu().numpy()
            for r, s in fresh:
                # the CLIENT's key (sparse mode stages dense slots)
                if (r, s) in self._inflight:
                    ckey = self._inflight[(r, s)][2]
                elif self._slot_bid[r, s] >= 0:
                    b = self._bat.get(int(self._slot_bid[r, s]))
                    ckey = (int(b["bf"].key[int(self._slot_bix[r, s])])
                            if b is not None else int(self._key[r, s, 0]))
                else:
                    ckey = int(self._key[r, s, 0])
                diag = dict(
                    replica=r, session=s,
                    key=int(ckey),
                    kind=BatchFutures._KINDSTR.get(
                        int(self._kindarr[r, s]), "?"),
                    phase=self._PHASE.get(int(status[r, s]), "?"),
                    acks=int(acks[r, s]),
                    age_rounds=int(age[r, s]),
                    at_step=self.rt.step_idx,
                )
                if self.rt.fleet_group is not None:
                    # a fleet's stuck op names its group
                    diag["group"] = self.rt.fleet_group
                if self.drill_phase is not None:
                    # a migration stage is active: the wedged op is
                    # attributable to it from the timeline alone
                    diag["drill"] = self.drill_phase
                if self.net_phase is not None:
                    # an adversary window is active: the diagnostic names
                    # it, so no log cross-reference is needed
                    diag["net"] = self.net_phase
                if self.diag_hook is not None:
                    # a serving front end is attached: tag the op's
                    # tenant and the deadline budget it has left
                    extra = self.diag_hook(r, s)
                    if extra:
                        diag.update(extra)
                new_diags.append(diag)
                self.stuck_ops.append(diag)
                self.rt._trace("stuck_op", **diag)
        if new_diags and self.rt.obs is not None:
            # dump BEFORE any strict raise, so the archive holds the
            # diagnostics
            self.rt.obs.flight_dump("stuck_op", extra=dict(diags=new_diags))
        if self.cfg.op_retry_limit:
            self._escalate_stuck(stuck)
        if self.strict_timeouts and new_diags:
            raise StuckOpError(new_diags)

    def _escalate_stuck(self, stuck: np.ndarray) -> None:
        """Bounded retry with backoff (cfg.op_retry_limit): a stuck per-op
        future whose coordinator is FENCED (not live, frozen or retired)
        is salvaged and re-submitted on a healthy replica; one on a healthy
        coordinator is re-examined after an exponential backoff window
        (it may yet commit: a blind retry would double-write)."""
        step = self.rt.step_idx
        healthy = set(self.rt.healthy_replicas()) - self._retired
        for rs_key in [k for k in list(self._inflight) if stuck[k]]:
            if rs_key not in self._inflight:
                continue  # resolved by an earlier salvage's pipeline flush
            r, s = rs_key
            nxt = self._retry_next.get(rs_key)
            if nxt is None:
                self._retry_next[rs_key] = step  # examine now
            elif step < nxt:
                continue
            if r in healthy:
                k = self._retry_k.get(rs_key, 0)
                self._retry_k[rs_key] = k + 1
                self._retry_next[rs_key] = step + (
                    self.cfg.op_timeout_rounds * self.cfg.op_backoff ** (k + 1))
                continue
            self._salvage_retry(r, s, sorted(healthy))

    def _salvage_retry(self, r: int, s: int, healthy: list) -> None:
        """Salvage one wedged per-op future off fenced coordinator ``r``
        (the crash model, per slot: history fold as maybe_w for updates,
        volatile wipe so the dead uid never re-mints, staged slot
        cleared) and re-enqueue it on a healthy replica with the SAME
        future; exhausted retries (or no healthy replica) resolve it as
        ``lost``, and an op on a range fenced meanwhile as ``rejected``."""
        from hermes_tpu_torch.chaos import recovery as recovery_lib

        rt = self.rt
        rt.flush_pipeline()  # a deferred round may have completed this op
        if (r, s) not in self._inflight or self._slot_inject[r, s] < 0:
            self._retry_next.pop((r, s), None)
            self._retry_k.pop((r, s), None)
            return
        kind, fut, ck, value, nretry = self._inflight.pop((r, s))
        slot = int(self._key[r, s, 0])
        mask = np.zeros((self.cfg.n_replicas, self.cfg.n_sessions), bool)
        mask[r, s] = True
        if kind != "get" and rt.recorder is not None:
            # the wedged broadcast may still commit via replay: the history
            # must be ALLOWED, not required, to linearize it
            rt.recorder.fold_pending(rt._sess_view(), mask=mask)
        recovery_lib.wipe_volatile(rt, mask)
        self._op[r, s, 0] = t.OP_NOP
        self._kindarr[r, s] = t.OP_NOP
        self._slot_inject[r, s] = -1
        self._dirty = True
        self._retry_next.pop((r, s), None)
        self._retry_k.pop((r, s), None)
        terminal = None
        if self._fence_mask[slot]:
            terminal = "rejected"  # the range migrated away mid-wedge
        elif nretry >= self.cfg.op_retry_limit or not healthy:
            terminal = "lost"  # retries exhausted, or nowhere to go
        if terminal is not None:
            fut._result = Completion(kind=terminal, key=ck, found=False)
            if terminal == "rejected":
                self.rejected_ops += 1
            rt._trace("op_retry_exhausted", replica=r, session=s, key=ck,
                      outcome=terminal, retries=nretry)
        else:
            target = healthy[(r + 1 + nretry) % len(healthy)]
            self.retried_ops += 1
            rt._trace("op_retry", replica=r, session=s, key=ck,
                      target=target, attempt=nretry + 1)
            self._queues[(target, s)].append(
                (kind, slot, ck, value, fut, nretry + 1))
            self._queued_slots.add((target, s))
            if (target, s) not in self._inflight:
                self._ready.add((target, s))
        if self._queues.get((r, s)):
            self._ready.add((r, s))  # traffic queued behind the salvaged op

    def step(self) -> int:
        """Inject queued ops, run one protocol round, resolve completions.
        Returns the number of ops completed (with ``cfg.pipeline_depth >=
        2``, those resolved from the PREVIOUS round)."""
        self._inject_ready()
        if self._bat:
            self._inject_batches()
        if self._depth > 1:
            n = self._step_pipelined()
            self._watchdog()
            return n
        self._sync_stream()
        comp = self.rt.step_once()
        code = np.asarray(comp.code)
        done_mask = self._done_mask(code, np.asarray(comp.key))
        self._retire(done_mask)
        n = self._gated_resolve(done_mask, code, np.asarray(comp.rval),
                                np.asarray(comp.wval), self.rt.step_idx - 1,
                                np.asarray(comp.ver), np.asarray(comp.fc))
        self._watchdog()
        return n

    def _step_pipelined(self) -> int:
        """Dispatch round k, then — while the device runs it — resolve round
        k-1's futures and stage the next client ops.  The one synchronous
        fetch is round k's small code/key columns: round k+1's stream must
        retire round k's completed slots (so the KVS runs at most one bulk
        round behind, whatever cfg.pipeline_depth says)."""
        self._sync_stream()
        comp = self.rt.dispatch_round()
        k = self.rt.step_idx - 1
        ndone = self._flush_round()
        self._inject_ready()
        if self._bat:
            self._inject_batches()
        # copies (on the CPU too): the ring slot is written again later
        code, ckey = (x.numpy() for x in host_copies([comp.code, comp.key]))
        done_mask = self._done_mask(code, ckey)
        self._retire(done_mask)
        self._pending = (k, comp, done_mask, code)
        return ndone

    def _flush_round(self) -> int:
        """Harvest the deferred round (pipelined mode) and resolve what
        durability allows: under wal_sync='commit' the round parks until
        its log batch fsyncs.  Never blocks on the disk."""
        if self._pending is None:
            return self._drain_wal_defer()
        pk, pcomp, done_mask, code = self._pending
        self._pending = None
        comp_np = self.rt.harvest_comp(pcomp, round_idx=pk)
        return self._gated_resolve(done_mask, code, np.asarray(comp_np.rval),
                                   np.asarray(comp_np.wval), pk,
                                   np.asarray(comp_np.ver),
                                   np.asarray(comp_np.fc))

    def flush(self) -> int:
        """Resolve EVERY in-flight completion: the deferred pipelined
        round and, under wal_sync='commit', every durability-parked round
        after a forced group commit.  Installed as the runtime's
        ``comp_flush`` hook."""
        n = self._flush_round()
        if self._wal_defer:
            n += self._drain_wal_defer(wait=True)
        return n

    # -- durability gating -----------------------------------------------------

    def _gated_resolve(self, done_mask, code, rval, wval, round_idx,
                       ver, fc) -> int:
        """Resolve one harvested round now or, under wal_sync='commit',
        park it under the round's WAL batch LSN until the flusher reports
        that batch durable.  Rounds resolve in round order."""
        wal = self.wal
        if wal is None or self.cfg.wal_sync != "commit":
            if wal is not None:
                wal.kick()  # relaxed modes: fsync soon, just don't wait
            return self._resolve(done_mask, code, rval, wval, round_idx,
                                 ver, fc)
        self._wal_defer.append((self.rt.wal_last_lsn, done_mask, code,
                                rval, wval, round_idx, ver, fc))
        wal.kick()
        return self._drain_wal_defer()

    def _drain_wal_defer(self, wait: bool = False) -> int:
        """Resolve parked rounds whose log batches are durable; ``wait``
        forces the group commit first (a ``wal_sync`` span)."""
        wal = self.wal
        if wal is None or not self._wal_defer:
            return 0
        if wait:
            target = self._wal_defer[-1][0]
            obs = self.rt.obs
            if obs is not None:
                with obs.tracer.span("wal_sync", lsn=target,
                                     parked_rounds=len(self._wal_defer)):
                    wal.sync(target)
            else:
                wal.sync(target)
        n = 0
        durable = wal.durable_lsn()
        while self._wal_defer and self._wal_defer[0][0] <= durable:
            _lsn, done_mask, code, rval, wval, k, ver, fc = (
                self._wal_defer.popleft())
            n += self._resolve(done_mask, code, rval, wval, k, ver, fc)
        return n

    def _wal_label(self) -> Optional[str]:
        """The durability label committed updates carry: 'commit' when
        resolution waited for the fsync, a loud
        ':not-fsynced-at-resolve' suffix for the relaxed modes."""
        if self.wal is None:
            return None
        mode = self.cfg.wal_sync
        return ("commit" if mode == "commit"
                else f"{mode}:not-fsynced-at-resolve")

    def run_until(self, futures: Sequence[Future], max_steps: int = 10_000) -> bool:
        """Step until every future resolves (or the step budget runs out)."""
        for _ in range(max_steps):
            if all(f.done() for f in futures):
                return True
            self.step()
        self.flush()
        return all(f.done() for f in futures)

    # -- the local-read path (core/readpath.py) ------------------------------

    def _get_reader(self) -> readpath.LocalReader:
        if self._reader is None:
            self._reader = readpath.LocalReader(self.rt)
        return self._reader

    def _record_local_reads(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Feed locally served reads into the recorded history (either
        recorder), so the read path is checked, not assumed: each read
        linearizes at the coming round's read point (inv = resp = 2 * step
        in the doubled clock: after the last harvested round's commits,
        before the next round's)."""
        rec = self.rt.recorder
        if rec is None or slots.size == 0:
            return
        n = slots.shape[0]
        step = np.full((1, n), self.rt.step_idx, np.int32)
        rec.record_step(st.Completions(
            code=np.full((1, n), t.C_READ, np.int32),
            key=slots.reshape(1, n).astype(np.int32),
            wval=np.zeros((1, n, self.cfg.value_words), np.int32),
            rval=vals.reshape(1, n, -1).astype(np.int32),
            ver=np.zeros((1, n), np.int32),
            fc=np.zeros((1, n), np.int32),
            invoke_step=step,
            commit_step=step,
        ))

    def _ryw_unserved(self, session, slots: np.ndarray, serve: np.ndarray,
                      pts: np.ndarray) -> None:
        """Clear ``serve`` bits whose row timestamp has not caught up with
        the session's own committed writes (the read-your-writes fence):
        the round-path read stalls until the key revalidates at >= the
        fence ts.  Satisfied entries prune (the row ts only grows).
        ``session`` is any hashable token: per-op writes pin under their
        (replica, session) lane, batch writers through ``pin_read_fence``."""
        fence = self._ryw.get(session) if session is not None else None
        if not fence:
            return
        base = self._ver_base_of(slots)
        for j in np.nonzero(serve)[0]:
            slot = int(slots[j])
            want = fence.get(slot)
            if want is None:
                continue
            row = (int(pts[j]) >> fst.PTS_FC_BITS) + int(base[j]), \
                int(pts[j]) & fst.FC_MASK
            if row < want:
                serve[j] = False
                self.ryw_fallbacks += 1
            else:
                del fence[slot]

    def _ver_base_of(self, slots: np.ndarray) -> np.ndarray:
        """Per-slot rebase delta re-anchoring device-era row timestamps
        into the recorder's global version space (zero before the first
        rebase)."""
        vb = self.rt._ver_base
        if vb is None:
            return np.zeros(slots.shape[0], np.int64)
        return vb[np.asarray(slots)]

    def _serve_reads(self, res: MultiGetResult, slots: np.ndarray,
                     pend: np.ndarray, session, ans) -> None:
        """Shared tail of multi_get/scan: fill the locally answerable rows
        of ``res`` from a ReadAnswer aligned with the pending subset, and
        send the rest through the round path as a fallback read batch."""
        pi = np.nonzero(pend)[0]
        if pi.size == 0:
            return
        serve = np.zeros(pi.size, bool)
        if ans is not None:
            serve = np.asarray(ans.valid).copy()
            self._ryw_unserved(session, slots[pi], serve,
                               np.asarray(ans.pts))
            si = pi[serve]
            if si.size:
                vals = np.asarray(ans.val)[serve]
                res.code[si] = t.C_READ
                res.value[si] = vals[:, 2:]
                res.local[si] = True
                res.step[si] = self.rt.step_idx
                self.local_reads += int(si.size)
                if self.heap is not None:
                    # the row's ref word came with its uid in the one
                    # gather: resolve the bytes off the mirror now
                    for i, ref in zip(si, vals[:, 2]):
                        res.data[int(i)] = (self.heap.read(int(ref))
                                            if int(ref) else None)
                self._record_local_reads(slots[si], vals)
        fb = pi[~serve]
        if fb.size:
            # Invalid at the serving replica (a write is in flight), RYW
            # fence unmet, or no healthy replica: the round path serves
            # these; its read stalls until the key is Valid
            self.fallback_reads += int(fb.size)
            bf = self.submit_batch(
                np.full(fb.size, t.OP_READ, np.int32),
                np.asarray(res.key)[fb])
            res._fallback = (bf, fb)

    def multi_get(self, keys, session=None, wait: bool = True,
                  max_steps: int = 50_000) -> MultiGetResult:
        """Batched local read: ONE dispatch answers every Valid key of
        ``keys`` from the resident table, with no protocol round.  Keys
        the local path must not answer (Invalid, the ``session``'s
        read-your-writes fence unmet, no healthy replica) go through the
        round path instead of returning stale bytes; keys of a fenced
        range resolve ``C_REJECTED``.  ``session`` is the
        calling lane or token whose committed writes fence its reads.
        With ``wait`` (default) the fallback batch is driven to the end
        before returning."""
        # sparse client keys are unsigned 64-bit: coerce explicitly (a bare
        # asarray of a python int above int64 makes the batch float64)
        keys_arr = np.atleast_1d(
            np.asarray(keys, np.uint64) if self.index is not None
            else np.asarray(keys))
        n = keys_arr.shape[0]
        u = self.cfg.value_words - 2
        res = MultiGetResult(keys_arr.copy(), u, heap=self.heap)
        if n == 0:
            return res
        if self.index is not None:
            slots = self.index.get_slots(keys_arr, insert=False)
            miss = slots < 0
            if miss.any():
                # absent sparse keys: not-found at once, no slot claimed
                res.code[miss] = t.C_READ
                res.found[miss] = False
                res.step[miss] = self.rt.step_idx
                slots = np.where(miss, 0, slots)
        else:
            kmin = int(keys_arr.min())
            kmax = int(keys_arr.max())
            if not (0 <= kmin and kmax < self.cfg.n_keys):
                raise ValueError(f"keys out of range [0, {self.cfg.n_keys})")
            slots = keys_arr.astype(np.int32)
        pend = res.code == 0
        if self._fence_mask.any():
            fenced = pend & self._fence_mask[slots]
            if fenced.any():
                res.code[fenced] = C_REJECTED
                res.found[fenced] = False
                self.rejected_ops += int(fenced.sum())
                pend &= ~fenced
        if pend.any():
            # the ReadAnswer is aligned with the pending subset, the order
            # _serve_reads consumes
            ans = self._get_reader().multi_get(slots[np.nonzero(pend)[0]])
            self._serve_reads(res, slots, pend, session, ans)
        if wait and res._fallback is not None:
            self.run_batch(res._fallback[0], max_steps=max_steps)
            res._pull()
        return res

    def scan(self, lo: int, hi: int, session=None, wait: bool = True,
             max_steps: int = 50_000) -> MultiGetResult:
        """Range scan over dense slots ``[lo, hi)``: one contiguous slice
        of the table.  Dense mode echoes slot ids as keys; sparse mode
        clamps to the allocated frontier and echoes each slot's CLIENT key
        (slots allocate in first-write order, so a sparse scan is a
        write-order scan).  The Valid/RYW fallback and fence rules of
        ``multi_get``."""
        if not (0 <= lo < hi <= self.cfg.n_keys):
            raise ValueError(
                f"scan range [{lo}, {hi}) outside [0, {self.cfg.n_keys})")
        u = self.cfg.value_words - 2
        if self.index is not None:
            hi = min(hi, self.index.n_used)
            if lo >= hi:
                return MultiGetResult(np.zeros(0, np.uint64), u,
                                      heap=self.heap)
            keys_arr = self.index._rev[lo:hi].copy()
        else:
            keys_arr = np.arange(lo, hi, dtype=np.int64)
        slots = np.arange(lo, hi, dtype=np.int32)
        res = MultiGetResult(keys_arr, u, heap=self.heap)
        pend = np.ones(hi - lo, bool)
        if self._fence_mask.any():
            fenced = self._fence_mask[lo:hi]
            if fenced.any():
                res.code[fenced] = C_REJECTED
                res.found[fenced] = False
                self.rejected_ops += int(fenced.sum())
                pend &= ~fenced
        ans = self._get_reader().scan(lo, hi)
        if ans is not None and not pend.all():
            pi = np.nonzero(pend)[0]  # align with the pending subset
            ans = type(ans)(valid=np.asarray(ans.valid)[pi],
                            val=np.asarray(ans.val)[pi],
                            pts=np.asarray(ans.pts)[pi])
        self._serve_reads(res, slots, pend, session, ans)
        if wait and res._fallback is not None:
            self.run_batch(res._fallback[0], max_steps=max_steps)
            res._pull()
        return res

    def pin_read_fence(self, session, client_key: int,
                       ts: Tuple[int, int]) -> None:
        """Pin a read-your-writes fence under any session token: the
        caller saw a commit with protocol timestamp ``ts``
        (Completion.ts, or BatchFutures.tsv/tsf) and wants every later
        ``multi_get(..., session=token)`` of the key to observe it or go
        through the round path.  Per-op writes pin their own lane; this is
        the hook for batch writers."""
        slot = (int(client_key) if self.index is None
                else self.index.slot(int(client_key), insert=False))
        if slot < 0:
            return  # absent sparse key: nothing committed to fence on
        self._ryw.setdefault(session, {})[slot] = (int(ts[0]), int(ts[1]))

    def read_stats(self) -> dict:
        """Local-read accounting: locally served and round-path fallback
        reads, RYW fence misses, and read dispatches issued."""
        rd = self._reader
        return dict(local_reads=self.local_reads,
                    fallback_reads=self.fallback_reads,
                    ryw_fallbacks=self.ryw_fallbacks,
                    read_dispatches=0 if rd is None else rd.dispatches)

    # -- value-heap GC (heap/) -------------------------------------------------

    def _heap_rebase_hook(self) -> None:
        """The runtime's ``rebase_hook``: compaction rides every version
        rebase; the store is already quiesced, drained and flushed there,
        so the GC skips its own drain."""
        if not self._in_heap_gc:
            self.heap_gc(quiesce=False, reason="rebase")

    _REF_COL = 4 * (fst.BANK_VAL + 2)  # byte offset of payload word 0

    def _heap_roots(self):
        """Every place a live heap ref can hide while the store is
        drained: the key rows [0, K) of every table copy (a copy's row K
        is its drop row, where masked scatters land, and roots nothing),
        the staged stream (ops injected, not yet consumed), queued per-op
        traffic, the uninjected rows of batches and the staging arrays.
        Returns (the ref column of every copy, flattened; the staged
        mask; all roots)."""
        col = fst.copies(self.rt.fs.table.bank, self.cfg.n_keys)[
            ..., self._REF_COL:self._REF_COL + 4]
        refcol = fst._bank_to_i32(col)[..., 0].reshape(-1).cpu().numpy()
        roots = [refcol.astype(np.int64)]
        staged_mask = self._kindarr != t.OP_NOP
        roots.append(self._uval[:, :, 0, 0][staged_mask].astype(np.int64))
        for rs_key in self._queued_slots:
            for item in self._queues[rs_key]:
                if item[3] is not None:
                    roots.append(np.asarray([item[3][0]], np.int64))
        for b in self._bat.values():
            roots.append(b["uval"][b["cursor"]:, 0].astype(np.int64))
        for arr in self._staging:
            roots.append(arr[arr != 0].astype(np.int64))
        return refcol, staged_mask, np.concatenate(roots)

    def heap_gc(self, quiesce: bool = True, reason: str = "full",
                max_quiesce_rounds: int = 512) -> dict:
        """Compact the value heap: quiesce-drain in-flight writes (new
        intake and issues pause while pending broadcasts finish), flush
        every completion, copy the LIVE extents to the front of a fresh
        log, and remap the ref words wherever they live (table rows on
        the device, staged stream, client queues, pending batches).

        If in-flight ops cannot drain (a frozen coordinator pins them) the
        compaction is skipped loudly (a ``heap_gc_skipped`` event): an
        undrained op's device-side ref cannot be remapped.  ``reason``
        names the trigger; the collection lands on the obs timeline as a
        ``heap_gc`` span and event and a ``heap_util`` gauge.  Returns the
        post-GC heap stats (an empty dict when skipped)."""
        if self.heap is None:
            raise RuntimeError("heap_gc needs cfg.max_value_bytes > 0")
        if self._in_heap_gc:
            return {}
        rt = self.rt
        self._in_heap_gc = True
        try:
            if rt.obs is not None:
                with rt.obs.tracer.span("heap_gc", step=rt.step_idx,
                                        reason=reason):
                    return self._heap_gc_body(quiesce, reason,
                                              max_quiesce_rounds)
            return self._heap_gc_body(quiesce, reason, max_quiesce_rounds)
        finally:
            self._in_heap_gc = False

    def _heap_gc_body(self, quiesce: bool, reason: str,
                      max_quiesce_rounds: int) -> dict:
        rt = self.rt
        if quiesce:
            prev = rt.quiesce
            rt.quiesce = True
            try:
                for _ in range(max_quiesce_rounds):
                    if rt._inflight_count() == 0:
                        break
                    self.step()
            finally:
                rt.quiesce = prev
        rt.flush_pipeline()
        self.flush()
        if rt._inflight_count() != 0:
            rt._trace("heap_gc_skipped", reason=reason,
                      inflight=rt._inflight_count())
            return {}
        refcol, staged_mask, roots = self._heap_roots()
        old, new = self.heap.compact(roots)
        # key rows [0, K) of every copy (batched: the one shared copy,
        # sharded: all R): rewrite the ref-word column in one byte-column
        # update, by arithmetic (_i32_to_bank); the drop rows stay as they
        # were
        newcol = ValueHeap.remap(refcol, old, new).astype(np.int32)
        if not np.array_equal(newcol, refcol):
            rows = fst.copies(rt.fs.table.bank, self.cfg.n_keys)
            col = torch.from_numpy(newcol).to(rows.device).reshape(
                rows.shape[0], -1, 1)
            rows[..., self._REF_COL:self._REF_COL + 4] = fst._i32_to_bank(col)
        # staged stream rows (injected, unconsumed) remap in place; idle
        # rows' stale payloads are zeroed so a dead ref can never pass for
        # a live one at the next collection
        vals = self._uval[:, :, 0, 0]
        vals[staged_mask] = ValueHeap.remap(
            vals[staged_mask], old, new).astype(np.int32)
        vals[~staged_mask] = 0
        self._dirty = True
        # queued per-op payload arrays mutate in place (the deque items
        # hold the very array the injection will read)
        for rs_key in self._queued_slots:
            for item in self._queues[rs_key]:
                if item[3] is not None:
                    item[3][0] = int(ValueHeap.remap(
                        np.asarray([item[3][0]], np.int64), old, new)[0])
        for b in self._bat.values():
            pend = b["uval"][b["cursor"]:, 0]
            b["uval"][b["cursor"]:, 0] = ValueHeap.remap(
                pend.astype(np.int64), old, new).astype(np.int32)
        for arr in self._staging:
            nz = arr != 0
            if nz.any():
                arr[nz] = ValueHeap.remap(
                    arr[nz].astype(np.int64), old, new).astype(arr.dtype)
        if self.wal is not None and old.size:
            # log the ref rewrite (bookkeeping: each record's extent bytes
            # stay authoritative for replay)
            self.wal.note_remap(old, new)
        stats = self.heap.stats()
        if rt.obs is not None:
            rt.obs.registry.gauge(
                "heap_util",
                help="live heap bytes / heap capacity").set(
                    stats["live_bytes"] / stats["capacity_bytes"])
        rt._trace("heap_gc", reason=reason,
                  live_bytes=stats["live_bytes"],
                  used_bytes=stats["used_bytes"],
                  reclaimed_bytes=self.heap.gc_reclaimed_bytes)
        return stats

    def heap_stats(self) -> Optional[dict]:
        """Heap accounting (None when the heap is off)."""
        return None if self.heap is None else self.heap.stats()

    # -- live resize -------------------------------------------------------------

    # -- range migration (elastic.migrate_range) -----------------------------

    def fence_slots(self, lo: int, hi: int) -> int:
        """Reject-new over dense slots ``[lo, hi)``, the first step of a
        key-range migration's drain.  Queued-but-uninjected ops on the
        range are rejected NOW (their futures resolve 'rejected');
        in-flight ops keep running (the drain flushes them).  The fence
        stays until ``release_slots``; after a flip it stays for good on
        the source: the range has a new owner.  Returns the number of
        queued ops rejected.  Sparse-key mode requires ``hi <=
        len(index)``: fresh client keys allocate slots at the dense
        frontier, and a fence over unallocated slots would let new keys
        land INSIDE a draining range."""
        if not (0 <= lo < hi <= self.cfg.n_keys):
            raise ValueError(f"range [{lo}, {hi}) outside "
                             f"[0, {self.cfg.n_keys})")
        if self.index is not None and hi > self.index.n_used:
            raise ValueError(
                f"fence [{lo}, {hi}) reaches past the allocated slot "
                f"frontier ({self.index.n_used}): a fresh sparse key could "
                "allocate into the draining range; migrate allocated "
                "ranges only")
        self._fence_mask[lo:hi] = True
        rejected = 0
        # queued per-op traffic on the range
        for rs_key in list(self._queued_slots):
            q = self._queues[rs_key]
            keep = collections.deque()
            while q:
                item = q.popleft()
                if lo <= item[1] < hi:
                    item[4]._result = Completion(kind="rejected",
                                                 key=item[2], found=False)
                    rejected += 1
                else:
                    keep.append(item)
            if keep:
                self._queues[rs_key] = keep
            else:
                self._queued_slots.discard(rs_key)
        # staged-but-uninjected batch items on the range
        for bid, b in list(self._bat.items()):
            n = b["opc"].shape[0]
            idx = np.arange(n)
            rej = (idx >= b["cursor"]) & (b["slots"] >= lo) & (b["slots"] < hi)
            if rej.any():
                bf: BatchFutures = b["bf"]
                bf.code[b["gix"][rej]] = C_REJECTED
                bf.found[b["gix"][rej]] = False
                rejected += int(rej.sum())
                keep = ~rej
                for f in ("opc", "slots", "uval", "gix"):
                    b[f] = b[f][keep]
                if b["cursor"] >= b["opc"].shape[0] and bf.all_done():
                    del self._bat[bid]
        self.rejected_ops += rejected
        return rejected

    def release_slots(self, lo: int, hi: int) -> None:
        """Clear a fence (the migration's abort path; after a flip the
        source's fence stays: the keys live elsewhere now)."""
        self._fence_mask[lo:hi] = False

    def range_inflight(self, lo: int, hi: int) -> int:
        """Client ops in flight whose dense slot is in ``[lo, hi)``: the
        drain-progress poll of a range migration (host arrays only)."""
        active = self._kindarr != t.OP_NOP
        in_range = (self._key[:, :, 0] >= lo) & (self._key[:, :, 0] < hi)
        return int(np.count_nonzero(active & in_range))

    def salvage_slots(self, lo: int, hi: int) -> int:
        """Forced cutover: client ops on ``[lo, hi)`` that did NOT drain
        are salvaged, never silently dropped — the recorder folds the
        in-flight updates as ``maybe_w`` (their broadcast may yet commit
        through the replay; the checker may, but need not, linearize
        them), their futures resolve 'lost' (``C_LOST`` in a batch), and
        their session and replay slots lose their volatile state exactly
        as in a crash (``chaos.recovery.wipe_volatile``), so the range's
        coordination dies with the migration.  Returns the ops
        salvaged."""
        from hermes_tpu_torch.chaos import recovery as recovery_lib

        rt = self.rt
        rt.flush_pipeline()  # land every completion already produced
        key = self._key[:, :, 0]
        mask = (self._kindarr != t.OP_NOP) & (key >= lo) & (key < hi)
        if rt.recorder is not None and mask.any():
            rt.recorder.fold_pending(rt._sess_view(), mask=mask)
        # replay slots re-broadcasting range keys die with the cutover: a
        # post-flip replay commit on the source would change rows the
        # destination already copied
        rp_key = rt.fs.replay.key.cpu().numpy()
        rp_active = rt.fs.replay.active.cpu().numpy()
        replay_mask = rp_active & (rp_key >= lo) & (rp_key < hi)
        salvaged = 0
        if mask.any() or replay_mask.any():
            recovery_lib.wipe_volatile(rt, mask, replay_mask)
        if mask.any():
            for r, s in np.argwhere(mask):
                r, s = int(r), int(s)
                if (r, s) in self._inflight:
                    _kind, fut, ck, _v, _n = self._inflight.pop((r, s))
                    fut._result = Completion(kind="lost", key=ck, found=False)
                    salvaged += 1
                elif self._slot_bid[r, s] >= 0:
                    bid = int(self._slot_bid[r, s])
                    b = self._bat.get(bid)
                    if b is not None:
                        bf: BatchFutures = b["bf"]
                        gi = int(self._slot_bix[r, s])
                        bf.code[gi] = C_LOST
                        bf.found[gi] = False
                        if b["cursor"] >= b["opc"].shape[0] and bf.all_done():
                            del self._bat[bid]
                    self._slot_bid[r, s] = -1
                    salvaged += 1
            rows, cols = np.nonzero(mask)
            self._op[rows, cols, 0] = t.OP_NOP
            self._kindarr[rows, cols] = t.OP_NOP
            self._slot_inject[rows, cols] = -1
            self._dirty = True
            # freed slots with queued per-op traffic become injectable
            # again (the re-ready a crash does): an op queued BEHIND a
            # salvaged one would otherwise strand
            for rs_key in self._queued_slots:
                if mask[rs_key]:
                    self._ready.add(rs_key)
        return salvaged

    def _replica_busy(self, replica: int) -> bool:
        return (any(rs[0] == replica for rs in self._inflight)
                or bool((self._slot_bid[replica] >= 0).any()))

    def shrink(self, replica: int, drain_steps: int = 2000) -> None:
        """Live resize out under traffic: retire ``replica`` (no new
        injections; its queued ops resolve ``rejected``), drain its
        in-flight ops to normal completion, then fence + remove it from
        quorums (``FastRuntime.shrink``).  A replica that cannot drain
        (its quorum is gone) raises and stays unretired; crash-restart it
        instead."""
        if not (int(self.rt.live[0]) >> replica) & 1:
            # checked before any client state changes: a non-live replica
            # retired here would reject its traffic after a later rejoin
            raise ValueError(f"replica {replica} is not live")
        self._retired.add(replica)
        for rs_key in [k for k in self._queued_slots if k[0] == replica]:
            self._reject_queued(rs_key)
        for _ in range(drain_steps):
            if not self._replica_busy(replica):
                break
            self.step()
        else:
            self._retired.discard(replica)
            raise RuntimeError(
                f"shrink: replica {replica} did not drain its in-flight "
                f"ops in {drain_steps} rounds (quorum gone?); use "
                "chaos.restart_replica for a non-cooperative removal")
        self.flush()
        self.rt.shrink(replica)

    def grow(self, replica: int, from_replica: Optional[int] = None) -> None:
        """Live resize in: value-sync ``replica`` through the join,
        re-admit it into quorums and take client ops again."""
        self.rt.grow(replica, from_replica)
        self._retired.discard(replica)
        # slots freed while retired may hold queued traffic again
        for rs_key in self._queued_slots:
            if rs_key[0] == replica and rs_key not in self._inflight:
                self._ready.add(rs_key)

    # -- crash support (chaos.recovery.restart_replica) ----------------------

    def _on_replica_crash(self, replica: int) -> int:
        """Client-side fallout of a host-crash of ``replica``: its
        in-flight futures resolve as kind='lost' (batch slots get C_LOST);
        whether a write took effect is decided by replay, and the history
        records it as a maybe_w.  Queued, uninjected traffic survives and
        re-injects after the rejoin.  Returns the client ops lost."""
        lost = 0
        for rs_key in [k for k in self._inflight if k[0] == replica]:
            _kind, fut, client_key, _v, _n = self._inflight.pop(rs_key)
            fut._result = Completion(kind="lost", key=client_key, found=False)
            lost += 1
        for s in np.nonzero(self._slot_bid[replica] >= 0)[0]:
            bid = int(self._slot_bid[replica, s])
            b = self._bat.get(bid)
            if b is not None:
                bf: BatchFutures = b["bf"]
                gi = int(self._slot_bix[replica, s])
                bf.code[gi] = C_LOST
                bf.found[gi] = False
                if b["cursor"] >= b["opc"].shape[0] and bf.all_done():
                    del self._bat[bid]
            lost += 1
        self._slot_bid[replica] = -1
        self._op[replica] = t.OP_NOP
        self._kindarr[replica] = t.OP_NOP
        self._slot_inject[replica] = -1
        self._dirty = True
        for rs_key in [k for k in self._retry_next if k[0] == replica]:
            self._retry_next.pop(rs_key, None)
            self._retry_k.pop(rs_key, None)
        for rs_key in self._queued_slots:
            if rs_key[0] == replica:
                self._ready.add(rs_key)
        return lost

    # -- membership / failure passthrough ------------------------------------

    def freeze(self, replica: int) -> None:
        self.rt.freeze(replica)

    def remove(self, replica: int) -> None:
        self.rt.remove(replica)

    def join(self, replica: int, from_replica: int) -> None:
        self.rt.join(replica, from_replica)

    def counters(self) -> dict:
        return self.rt.counters()


def drive_mix(kvs: KVS, op_keys, is_get, value_of, max_steps: int = 50_000):
    """Drive a get/put client mix through ``KVS.submit_batch``;
    ``value_of(i)`` supplies op i's payload.  Returns (batch_futures,
    drained, enqueue_seconds, drive_seconds)."""
    import time

    is_get = np.asarray(is_get, bool)
    n = len(op_keys)
    t0 = time.perf_counter()
    kinds = np.where(is_get, KVS.GET, KVS.PUT).astype(np.int32)
    u = kvs.cfg.value_words - 2
    values = np.zeros((n, u), np.int32)
    for i in np.nonzero(~is_get)[0]:
        v = np.asarray(value_of(int(i)), np.int32)
        values[i, : v.shape[0]] = v
    bf = kvs.submit_batch(kinds, np.asarray(op_keys), values)
    enqueue_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drained = kvs.run_batch(bf, max_steps=max_steps)
    return bf, drained, enqueue_s, time.perf_counter() - t0
