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
traffic.  Keys are dense slot ids ``[0, n_keys)``.

Not ported yet (ROADMAP A5), each refused loudly when its knob is set:
sparse keys, the value heap, the WAL, the stuck-op watchdog and retry,
degraded mode, per-op tracing; ``multi_get``/``scan``, the elastic
operations and the sharded backend are absent.

Usage::

    kvs = KVS(HermesConfig(n_replicas=3, n_keys=1024, value_words=6))
    f1 = kvs.put(replica=0, session=0, key=7, value=[1, 2, 3, 4])
    f2 = kvs.get(replica=1, session=0, key=7)
    kvs.run_until([f1, f2])
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.runtime import FastRuntime


@dataclasses.dataclass
class Completion:
    """Result of one client op: kind 'get' | 'put' | 'rmw' | 'rmw_abort'."""

    kind: str
    key: int
    value: Optional[List[int]] = None  # payload read (get / rmw read-part)
    uid: Optional[Tuple[int, int]] = None  # unique id of the written value
    step: int = -1
    found: bool = True
    # committed updates only: the globally re-anchored protocol (ver, fc)
    ts: Optional[Tuple[int, int]] = None


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
    ``step`` (completing round), ``tsv``/``tsf`` (committed timestamp)."""

    def __init__(self, kinds: np.ndarray, keys: np.ndarray, u: int):
        n = kinds.shape[0]
        self.kind = kinds
        self.key = keys
        self.code = np.zeros(n, np.int32)
        self.value = np.zeros((n, u), np.int32)
        self.uid = np.zeros((n, 2), np.int32)
        self.found = np.ones(n, bool)
        self.step = np.full(n, -1, np.int32)
        self.tsv = np.zeros(n, np.int64)
        self.tsf = np.zeros(n, np.int32)

    def __len__(self) -> int:
        return self.code.shape[0]

    def done_count(self) -> int:
        return int(np.count_nonzero(self.code))

    def all_done(self) -> bool:
        return bool((self.code != 0).all())

    _KINDSTR = {t.OP_READ: "get", t.OP_WRITE: "put", t.OP_RMW: "rmw"}

    def completion(self, i: int) -> Completion:
        if self.code[i] == 0:
            raise RuntimeError("op not complete; run KVS.run_batch()")
        c = int(self.code[i])
        kind = ("rmw_abort" if c == t.C_RMW_ABORT
                else self._KINDSTR[int(self.kind[i])])
        done = Completion(kind=kind, key=int(self.key[i]),
                          step=int(self.step[i]), found=bool(self.found[i]))
        if c in (t.C_READ, t.C_RMW):
            done.value = self.value[i].tolist()
        if c in (t.C_WRITE, t.C_RMW):
            done.uid = (int(self.uid[i, 0]), int(self.uid[i, 1]))
            done.ts = (int(self.tsv[i]), int(self.tsf[i]))
        return done

    def future(self, i: int) -> Future:
        fut = Future()
        if self.code[i] != 0:
            fut._result = self.completion(i)
        return fut


class KVS:
    """A replicated, linearizable KVS served by the Hermes protocol: one
    instance drives all R replicas of a single-device deployment; each
    (replica, session) slot takes one op at a time, queued FIFO beyond
    that."""

    def __init__(self, cfg: HermesConfig, backend: str = "batched",
                 record: bool = False, sparse_keys: bool = False,
                 device="cuda"):
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
        refused = [name for name, on in (
            ("sparse_keys", sparse_keys),
            ("max_value_bytes (value heap)", cfg.use_heap),
            ("wal_dir (write-ahead log)", cfg.use_wal),
            ("op_timeout_rounds (stuck-op watchdog)", cfg.op_timeout_rounds),
            ("op_retry_limit (bounded retry)", cfg.op_retry_limit),
            ("min_healthy_for_writes (degraded mode)",
             cfg.min_healthy_for_writes),
            ("trace_sample (per-op tracing)", cfg.trace_sample),
        ) if on]
        if refused:
            raise NotImplementedError(
                f"hermes_tpu_torch.kvs.KVS does not implement {refused} yet "
                "(ROADMAP A5); unset them or use the JAX package")
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
                              stream=stream, device=device)
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

    # -- client ops ----------------------------------------------------------

    def _enqueue(self, kind, replica, session, key, value) -> Future:
        cfg = self.cfg
        if not (0 <= replica < cfg.n_replicas):
            raise ValueError(f"replica {replica} out of range [0, {cfg.n_replicas})")
        if not (0 <= session < cfg.n_sessions):
            raise ValueError(f"session {session} out of range [0, {cfg.n_sessions})")
        if not (0 <= key < cfg.n_keys):
            raise ValueError(f"key {key} out of range [0, {cfg.n_keys})")
        fut = Future()
        self._queues[(replica, session)].append((kind, int(key), value, fut))
        self._queued_slots.add((replica, session))
        if (replica, session) not in self._inflight:
            self._ready.add((replica, session))
        return fut

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
        arr = np.asarray(list(value), np.int32)
        if arr.ndim != 1 or arr.shape[0] > u:
            raise ValueError(f"value must be <= {u} int32 words")
        return np.pad(arr, (0, u - arr.shape[0]))

    # -- batched client path (array-in, futures-out) -------------------------

    GET, PUT, RMW = t.OP_READ, t.OP_WRITE, t.OP_RMW

    def submit_batch(self, kinds, keys, values=None) -> BatchFutures:
        """Enqueue a whole op mix: ``kinds`` (n,) of KVS.GET/PUT/RMW,
        ``keys`` (n,), ``values`` (n, <=value_words-2) int32 payloads.  Ops
        flow through idle slots in submission order; drive the returned
        BatchFutures with run_batch()/step()."""
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
        if values is not None:
            v = np.asarray(values, np.int32)
            if v.ndim != 2 or v.shape[0] != n or v.shape[1] > u:
                raise ValueError(f"values must be (n, <={u}) int32 words")
            uval[:, : v.shape[1]] = v
        kmin, kmax = (int(keys_arr.min()), int(keys_arr.max())) if n else (0, 0)
        if n and not (0 <= kmin and kmax < self.cfg.n_keys):
            raise ValueError(f"keys out of range [0, {self.cfg.n_keys})")
        bf = BatchFutures(opc.copy(), keys_arr.copy(), u)
        if n:
            self._bat[self._next_bid] = dict(
                bf=bf, gix=np.arange(n, dtype=np.int32), opc=opc,
                slots=keys_arr.astype(np.int32), uval=uval, cursor=0)
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
        if self._depth > 1:
            # pipelined: a slot retired at the last sync point whose
            # resolution is still deferred keeps its (bid, bix) mapping
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
            if self._slot_bid[rs_key] >= 0:
                waiting.add(rs_key)
                continue
            kind, key, value, fut = q.popleft()
            if not q:
                self._queued_slots.discard(rs_key)
            r, s = rs_key
            self._op[r, s, 0] = self._OPC[kind]
            self._key[r, s, 0] = key
            if value is not None:
                self._uval[r, s, 0] = value
            self._inflight[rs_key] = (kind, fut, key)
            self._kindarr[r, s] = self._OPC[kind]
            self._dirty = True
        self._ready.clear()
        self._ready |= waiting

    def _sync_stream(self) -> None:
        """Push the staged host op arrays to the device-side stream."""
        if not self._dirty:
            return
        self.rt.stream = fst.prep_stream(
            st.OpStream(op=self._op, key=self._key, uval=self._uval),
            self.rt.device)
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
            self._dirty = True

    def _resolve(self, done_mask, code, rval, wval, round_idx: int,
                 ver, fc) -> int:
        """Resolve the futures of one round's completed (already retired)
        slots; returns the op count."""
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
            kind, fut, key = self._inflight.pop((r, s))
            c = int(code[r, s])
            done = Completion(
                kind="rmw_abort" if c == t.C_RMW_ABORT else kind,
                key=key, step=round_idx)
            if c in (t.C_READ, t.C_RMW):
                done.value = rval[r, s, 2:].tolist()
            if c in (t.C_WRITE, t.C_RMW):
                done.uid = (int(wval[r, s, 0]), int(wval[r, s, 1]))
                done.ts = (int(ver[r, s]), int(fc[r, s]))
            fut._result = done
            if self._queues.get((r, s)):
                self._ready.add((r, s))
            ndone += 1
        return ndone

    def step(self) -> int:
        """Inject queued ops, run one protocol round, resolve completions.
        Returns the number of ops completed (with ``cfg.pipeline_depth >=
        2``, those resolved from the PREVIOUS round)."""
        self._inject_ready()
        if self._bat:
            self._inject_batches()
        if self._depth > 1:
            return self._step_pipelined()
        self._sync_stream()
        comp = self.rt.step_once()
        code = np.asarray(comp.code)
        done_mask = self._done_mask(code, np.asarray(comp.key))
        self._retire(done_mask)
        return self._resolve(done_mask, code, np.asarray(comp.rval),
                             np.asarray(comp.wval), self.rt.step_idx - 1,
                             np.asarray(comp.ver), np.asarray(comp.fc))

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
        code, ckey = comp.code.cpu().numpy(), comp.key.cpu().numpy()
        done_mask = self._done_mask(code, ckey)
        self._retire(done_mask)
        self._pending = (k, comp, done_mask, code)
        return ndone

    def _flush_round(self) -> int:
        """Harvest and resolve the deferred round (pipelined mode)."""
        if self._pending is None:
            return 0
        pk, pcomp, done_mask, code = self._pending
        self._pending = None
        comp_np = self.rt.harvest_comp(pcomp, round_idx=pk)
        return self._resolve(done_mask, code, np.asarray(comp_np.rval),
                             np.asarray(comp_np.wval), pk,
                             np.asarray(comp_np.ver), np.asarray(comp_np.fc))

    def flush(self) -> int:
        """Resolve every in-flight completion (the deferred pipelined
        round); installed as the runtime's ``comp_flush`` hook."""
        return self._flush_round()

    def run_until(self, futures: Sequence[Future], max_steps: int = 10_000) -> bool:
        """Step until every future resolves (or the step budget runs out)."""
        for _ in range(max_steps):
            if all(f.done() for f in futures):
                return True
            self.step()
        self.flush()
        return all(f.done() for f in futures)

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
