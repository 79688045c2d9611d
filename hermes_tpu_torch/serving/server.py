"""The serving front-end: the robustness envelope between
clients and the replicated store.

``Frontend`` owns one ``kvs.KVS`` (single group) or ``fleet.Fleet``
(key-routed groups — the fleet-aware serving front-end of ROADMAP item
2) and drives client RPCs through it:

  * ADMISSION (serving/admission.py): overload ladder -> per-tenant
    session quota -> bounded intake queue -> per-tenant token bucket
    (charged last — refusals never burn rate budget).
    Every refusal is a loud ``S_RETRY_AFTER`` with a reason and a retry
    hint — queue-full is an explicit wire signal, never silent
    buffering.
  * DEADLINES: the client's relative deadline is stamped absolute at
    intake; an op that expires in the intake queue resolves
    ``S_DEADLINE`` WITHOUT being injected, and an admitted op that
    out-ages its deadline resolves ``S_DEADLINE`` at the completion
    scan (for updates a deadline is a MAYBE — the broadcast may still
    commit, exactly the crash-'lost' semantics; the abandoned future is
    kept until the store resolves it so quota accounting stays exact).
  * SHED LADDER: rung transitions land on the obs timeline as
    ``shed``/``shed_clear`` events and per-tenant counters; rung 1
    composes with the store's ``min_healthy_for_writes`` degraded mode
    (degraded => writes shed at the front door).
  * WATCHDOG TAGS: the stuck-op diagnostics (and
    ``StuckOpError``) carry the op's tenant id and remaining deadline
    budget through ``kvs.diag_hook`` — the ``drill=``/``net_phase``
    pattern, per op.

The clock is caller-supplied: ``VirtualClock`` for deterministic soaks
(the driver advances it by ``scfg.round_us`` per pump — same-seed runs
replay byte-identically, the chaos-schedule discipline applied to
serving), ``time.monotonic`` under real sockets (serving/rpc.py).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from hermes_tpu_torch.serving import wire
from hermes_tpu_torch.serving.admission import AdmissionControl
from hermes_tpu_torch.transport import codec as _codec


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Front-end envelope knobs (one frozen dataclass, config.py style)."""

    tenant_rate_per_s: float = 4000.0   # sustained per-tenant admission rate
    tenant_burst: float = 64.0          # token-bucket burst
    tenant_quota: int = 32              # client-visible in-flight cap/tenant
    queue_cap: int = 128                # bounded intake queue
    shed_write_frac: float = 0.6        # ladder rung 1 at this queue fill
    shed_read_frac: float = 0.9         # ladder rung 2 at this queue fill
    hot_keys: Tuple[int, ...] = ()      # reads on these survive rung 2
    default_deadline_us: int = 0        # applied when a request carries 0
    round_us: int = 1000                # virtual microseconds per pump
    retry_after_floor_s: float = 0.001  # minimum retry hint
    store_inflight_cap: Optional[int] = None  # ops handed to the store at
    # once (None = one per store session lane); the intake queue holds the
    # rest — THAT bound is what makes backpressure observable
    resp_meta_cap: int = 1 << 17  # per-response (tenant, status, latency)
    # retention ring: exact for the finite soak/bench drivers (which size
    # well under it), bounded for a long-lived TCP server — the always-on
    # exact accounting is AdmissionControl's counters, not this ring
    trace_sample: int = 0  # per-op tracing (obs/tracing.py):
    # 0 = off, N = mint a trace id for ~1 in N submitted ops (seeded,
    # deterministic — same ops trace on every replay).  A request already
    # carrying a nonzero wire trace id is ALWAYS traced (the client
    # sampled it); the id rides the formerly-pad u16 of wire._REQ.
    trace_seed: int = 0

    def __post_init__(self) -> None:
        if self.tenant_quota < 1 or self.queue_cap < 1:
            raise ValueError("tenant_quota and queue_cap must be >= 1")
        if self.trace_sample < 0:
            raise ValueError("trace_sample must be >= 0 (0 disables)")
        if not (0.0 < self.shed_write_frac <= self.shed_read_frac <= 1.0):
            raise ValueError(
                "want 0 < shed_write_frac <= shed_read_frac <= 1 (writes "
                "shed first, then non-hot reads)")
        if self.round_us <= 0:
            raise ValueError("round_us must be > 0")
        if self.resp_meta_cap < 1:
            raise ValueError("resp_meta_cap must be >= 1")
        object.__setattr__(self, "hot_key_set", frozenset(
            int(k) for k in self.hot_keys))


class VirtualClock:
    """Deterministic serving clock: the soak driver advances it."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, ds: float) -> None:
        self.t += ds


class RespMetaRing:
    """Bounded columnar response-meta history — the twin of
    the old per-row ``deque`` of (tenant, status, latency) tuples: a
    fixed-capacity numpy ring the hot paths append COLUMNS into
    (``extend`` is one fancy-index write per batch; the scalar
    ``append`` stays for the row-at-a-time Frontend).  Latency NaN
    encodes a refusal's absent measurement; iteration yields the exact
    (tenant, status, latency-or-None) tuples the soak census loops
    always consumed, oldest first."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.tenant = np.zeros(self.cap, np.int32)
        self.status = np.zeros(self.cap, np.uint8)
        self.lat = np.full(self.cap, np.nan)
        self.n = 0  # total rows ever appended (monotone)

    def append(self, tenant: int, status: int,
               latency_s: Optional[float]) -> None:
        i = self.n % self.cap
        self.tenant[i] = tenant
        self.status[i] = status
        self.lat[i] = np.nan if latency_s is None else latency_s
        self.n += 1

    def extend(self, tenants, statuses, lats=None) -> None:
        """Column append: ``lats=None`` records NaN for every row (the
        immediate-refusal shape).  Batches larger than the capacity
        keep their LAST ``cap`` rows — same semantics as appending row
        by row into a maxlen deque."""
        k = int(np.asarray(statuses).shape[0])
        if not k:
            return
        drop = max(0, k - self.cap)
        idx = (self.n + drop + np.arange(k - drop)) % self.cap
        self.tenant[idx] = np.asarray(tenants)[drop:]
        self.status[idx] = np.asarray(statuses)[drop:]
        self.lat[idx] = (np.nan if lats is None
                         else np.asarray(lats, float)[drop:])
        self.n += k

    def _window(self) -> np.ndarray:
        held = min(self.n, self.cap)
        return (self.n - held + np.arange(held)) % self.cap

    def __len__(self) -> int:
        return min(self.n, self.cap)

    def __iter__(self):
        idx = self._window()
        for t, s, lc in zip(self.tenant[idx].tolist(),
                            self.status[idx].tolist(),
                            self.lat[idx].tolist()):
            yield (t, s, None if math.isnan(lc) else lc)

    def latencies(self, statuses) -> List[float]:
        """Measured latencies of rows whose status is in ``statuses``
        (one vectorized mask, the hot-path replacement for the old
        list comprehension over tuples)."""
        idx = self._window()
        lat = self.lat[idx]
        m = (np.isin(self.status[idx], np.asarray(list(statuses)))
             & ~np.isnan(lat))
        return lat[m].tolist()


class _ReadFuture:
    """Future-shaped adapter over a MultiGetResult/FleetReads: done when
    every key answered (locally or via the round-path fallback the pump's
    store.step() drives)."""

    def __init__(self, res):
        self.res = res

    def done(self) -> bool:
        return self.res.all_done()


class Frontend:
    """One serving front-end over a KVS or Fleet facade."""

    def __init__(self, store, scfg: Optional[ServingConfig] = None,
                 clock=None):
        self.store = store
        self.scfg = scfg or ServingConfig()
        self.is_fleet = hasattr(store, "router") and hasattr(store, "groups")
        base = store.cfg.base if self.is_fleet else store.cfg
        self.u = base.value_words - 2
        # value heap: > 0 switches the wire to length-prefixed
        # byte payloads (both ends derive it from the shared config, like
        # ``u``) and the issue path to store byte puts
        self.vbytes = base.max_value_bytes
        if self.u < 1:
            raise ValueError("serving needs value_words >= 3 (the store "
                             "carries write uids in words 0-1)")
        self.n_keys = (store.cfg.total_keys if self.is_fleet
                       else base.n_keys)
        self.clock = clock if clock is not None else time.monotonic
        self.adm = AdmissionControl(self.scfg)
        self._intake: collections.deque = collections.deque()
        self._pending: Dict[int, dict] = {}   # req_id -> entry (admit order)
        self._abandoned: List[dict] = []      # RPC resolved, store op open
        self._responses: List[wire.Response] = []
        self._resp_meta = RespMetaRing(self.scfg.resp_meta_cap)
        self._lane_seq: Dict[int, int] = collections.defaultdict(int)
        self.requests = 0
        self.responses = 0
        self.shed_level = 0
        self._fleet_deg: Optional[bool] = None  # any-group scan, per round
        self._lanes: List[tuple] = []
        if self.is_fleet:
            cap = sum(g.cfg.n_replicas * g.cfg.n_sessions
                      for g in store.groups)
            for g in store.groups:
                g.kvs.diag_hook = (
                    lambda r, s, _g=g.gid: self._diag_for(_g, r, s))
        else:
            cfg = store.cfg
            cap = cfg.n_replicas * cfg.n_sessions
            self._lanes = [(r, s) for r in range(cfg.n_replicas)
                           for s in range(cfg.n_sessions)]
            store.diag_hook = lambda r, s: self._diag_for(None, r, s)
        self._store_cap = (self.scfg.store_inflight_cap
                           if self.scfg.store_inflight_cap is not None
                           else cap)
        self._store_inflight = 0
        # per-op tracing: front-door sampler + span writer.
        # Single-op requests only — the batched-read header has no free
        # u16 (count occupies it), so K_MGET/K_SCAN stay untraced.
        if self.scfg.trace_sample:
            from hermes_tpu_torch.obs.tracing import TraceSampler

            self._sampler = TraceSampler(self.scfg.trace_sample,
                                         seed=self.scfg.trace_seed)
        else:
            self._sampler = None
        self._op_tracer_cache = None
        self._round_key_ops: dict = {}  # key -> admitted ops this round

    # -- plumbing ------------------------------------------------------------

    def _rt(self):
        return (self.store.groups[0].rt if self.is_fleet else self.store.rt)

    def _trace(self, name: str, **fields) -> None:
        rt = self._rt()
        rt._trace(name, **fields)
        if rt.obs is not None:
            rt.obs.registry.counter(f"serving_{name}").inc()

    def _count(self, name: str, n: int = 1) -> None:
        rt = self._rt()
        if rt.obs is not None:
            rt.obs.registry.counter(f"serving_{name}").inc(n)

    def _op_tracer(self):
        """Span writer bound to the store runtime's current obs context
        (None while none is attached)."""
        rt = self._rt()
        if rt.obs is None:
            return None
        c = self._op_tracer_cache
        if c is None or c.obs is not rt.obs:
            from hermes_tpu_torch.obs.tracing import OpTracer

            c = self._op_tracer_cache = OpTracer(rt.obs)
        return c

    def _trace_resolve(self, entry: dict, status: int, now: float) -> None:
        """Close a sampled op's end-to-end span at RPC resolution:
        admission round -> resolution round, with the terminal status
        (the critical-path denominator obs/report.py breaks down)."""
        trace = entry.get("trace", 0)
        if not trace:
            return
        tr = self._op_tracer()
        if tr is None:
            return
        req = entry["req"]
        tags = dict(tenant=req.tenant, op=req.kind, key=req.key,
                    status=int(status))
        lane = entry.get("lane")
        if lane is not None and lane[0] is not None:
            tags["group"] = lane[0]
        tr.span("fe_resolve", trace, r0=entry["r_admit"],
                r1=self._rt().step_idx,
                dur_s=now - entry["t_admit"], **tags)

    def _degraded_for_key(self, key: int) -> bool:
        if self.is_fleet:
            return self.store.degraded(key)
        return self.store.degraded()

    def _diag_for(self, group, r, s) -> Optional[dict]:
        """Watchdog tag lookup: the oldest un-resolved op on lane
        (group, r, s) names its tenant + remaining deadline budget.
        Abandoned entries (RPC already resolved S_DEADLINE, store op
        still open) are scanned too — a long-stuck op has usually
        out-aged its deadline by the time the watchdog fires."""
        now = self.clock()
        for entry in list(self._pending.values()) + self._abandoned:
            if entry.get("lane") == (group, r, s):
                d = dict(tenant=entry["req"].tenant)
                if entry["deadline"] is not None:
                    d["deadline_left_us"] = int(
                        round((entry["deadline"] - now) * 1e6))
                return d
        return None

    def _update_level(self, degraded: Optional[bool] = None,
                      fresh: bool = True) -> None:
        # non-fleet degradation is key-independent, so submit can hand us
        # the value it already computed; fleet ladder pressure is the
        # any-group scan regardless of the op's key — and that scan can
        # only change when membership does (once per store round), so the
        # per-request path (fresh=False) reuses the last pump's scan
        # instead of walking every group's healthy set per request
        if self.is_fleet:
            if fresh or self._fleet_deg is None:
                self._fleet_deg = any(g.kvs.degraded()
                                      for g in self.store.groups)
            degraded = self._fleet_deg
        elif degraded is None:
            degraded = self._degraded_for_key(0)
        level = self.adm.ladder_level(len(self._intake), degraded)
        if level != self.shed_level:
            if level > 0:
                self._trace("shed", level=level, queue=len(self._intake))
            else:
                self._trace("shed_clear", queue=len(self._intake))
            self.shed_level = level

    def _respond(self, rsp: wire.Response, tenant: int,
                 latency_s: Optional[float] = None,
                 queue: bool = True) -> wire.Response:
        # queue=False: an immediate refusal submit() hands straight back
        # to its caller — accounted here, but NOT queued for pump(), or
        # the transport would deliver it a second time (and on the TCP
        # path the re-send would carry the restored CLIENT req_id, which
        # can collide with another connection's pending internal id)
        if queue:
            self._responses.append(rsp)
        self._resp_meta.append(tenant, rsp.status, latency_s)
        self.responses += 1
        return rsp

    def pop_responses(self) -> List[wire.Response]:
        out, self._responses = self._responses, []
        return out

    # -- intake --------------------------------------------------------------

    def submit(self, req) -> Optional[object]:
        """Run one request through admission.  Returns an immediate
        refusal Response, or None when admitted (the resolution arrives
        from a later ``pump``).  Accepts the single-op ``wire.Request``
        and the batched ``wire.ReadRequest`` (K_MGET/K_SCAN)."""
        if isinstance(req, wire.ReadRequest):
            return self._submit_read(req)
        now = self.clock()
        self.requests += 1
        if req.kind not in ("get", "put", "rmw") \
                or not (0 <= req.key < self.n_keys):
            return self._respond(wire.Response(
                status=wire.S_REJECTED, req_id=req.req_id), req.tenant,
                queue=False)
        if self.vbytes and req.kind != "get" and (
                req.data is None or len(req.data) > self.vbytes):
            # heap mode: an update must carry a byte payload the store
            # can hold — refused loudly at the door, never a deep error
            return self._respond(wire.Response(
                status=wire.S_REJECTED, req_id=req.req_id), req.tenant,
                queue=False)
        degraded = self._degraded_for_key(req.key)
        self._update_level(degraded, fresh=False)
        reason, wait = self.adm.admit(req.kind, req.key, req.tenant, now,
                                      len(self._intake), degraded)
        if reason != wire.R_NONE:
            self._count("retry_after")
            return self._respond(wire.Response(
                status=wire.S_RETRY_AFTER, req_id=req.req_id, reason=reason,
                retry_after_us=int(math.ceil(wait * 1e6))), req.tenant,
                queue=False)
        self.adm.note_admitted(req.tenant)
        # key-heat tally (obs/series.py): admitted ops per key
        # this serving round, harvested into the heat series at pump time
        self._round_key_ops[req.key] = \
            self._round_key_ops.get(req.key, 0) + 1
        # trace mint: adopt a client-sampled wire id, else
        # sample on the monotone request sequence; the id follows the
        # entry through issue and resolution (and is staged into the
        # store so the KVS-level spans share it)
        trace = int(getattr(req, "trace", 0) or 0)
        if not trace and self._sampler is not None:
            trace = self._sampler.sample(self.requests - 1)
        dl_us = req.deadline_us or self.scfg.default_deadline_us
        self._intake.append(dict(
            req=req, t_admit=now, trace=trace,
            r_admit=self._rt().step_idx,
            deadline=(now + dl_us * 1e-6) if dl_us else None))
        return None

    def _read_probe_key(self, req: wire.ReadRequest) -> int:
        """The key the admission ladder judges a batched read by: its
        first NON-hot key, so rung 2 sheds the batch unless EVERY key is
        hot — reads shed at rung 2 exactly as today, and a batch cannot
        smuggle cold keys past the ladder behind one hot one.  A scan
        range wider than the hot set provably CONTAINS a cold key
        (len(hot)+1 distinct keys cannot all be hot), so probing that
        many from lo always finds one — never judge a range by its
        endpoints, which may both be hot over a cold interior."""
        hot = self.scfg.hot_key_set
        if req.kind == "mget":
            keys = req.keys
        else:
            keys = range(req.lo, min(req.hi, req.lo + len(hot) + 1))
        for k in keys:
            if k not in hot:
                return int(k)
        return int(next(iter(keys)))

    def _submit_read(self, req: wire.ReadRequest):
        """Admission for one batched read RPC (ONE admission unit: one
        quota slot, one queue entry, one rate token — the batch is one
        client-visible op)."""
        now = self.clock()
        self.requests += 1
        bad = (req.kind not in ("mget", "scan")
               or (req.kind == "mget" and not (
                   req.keys and len(req.keys) <= wire.MGET_MAX_KEYS
                   and all(0 <= k < self.n_keys for k in req.keys)))
               or (req.kind == "scan"
                   and not (0 <= req.lo < req.hi <= self.n_keys)))
        if bad:
            return self._respond(wire.ReadResponse(
                status=wire.S_REJECTED, req_id=req.req_id), req.tenant,
                queue=False)
        self._update_level(None, fresh=False)
        # degraded mode never sheds reads (rung 1 is write-only), so the
        # ladder decision for a read depends on queue pressure alone —
        # and the probe key only matters at rung 2, so the O(batch) cold
        # hunt is skipped entirely while the queue is below that mark
        probe = (self._read_probe_key(req)
                 if self.adm.ladder_level(len(self._intake), False) >= 2
                 else (req.keys[0] if req.kind == "mget" else req.lo))
        reason, wait = self.adm.admit(
            "get", probe, req.tenant, now, len(self._intake), False)
        if reason != wire.R_NONE:
            self._count("retry_after")
            return self._respond(wire.ReadResponse(
                status=wire.S_RETRY_AFTER, req_id=req.req_id, reason=reason,
                retry_after_us=int(math.ceil(wait * 1e6))), req.tenant,
                queue=False)
        self.adm.note_admitted(req.tenant)
        dl_us = req.deadline_us or self.scfg.default_deadline_us
        self._intake.append(dict(
            req=req, t_admit=now,
            deadline=(now + dl_us * 1e-6) if dl_us else None))
        return None

    # -- the pump ------------------------------------------------------------

    def _issue(self, entry: dict) -> None:
        """Hand one admitted op to the store on a deterministic lane."""
        req = entry["req"]
        seq = self._lane_seq[req.tenant]
        self._lane_seq[req.tenant] = seq + 1
        if isinstance(req, wire.ReadRequest):
            # batched read: issued straight to the store's
            # local-read fast path; only Invalid keys ride round-path
            # fallback slots, which the pump's store.step() drives.
            # Read-your-writes is TENANT-scoped here: the frontend pins a
            # per-tenant fence token on every commit it delivers
            # (_result_response -> store.pin_read_fence), and the read
            # carries the same token — lane rotation on the write path
            # cannot defeat it.
            args = dict(session=("tenant", req.tenant), wait=False)
            res = (self.store.multi_get(req.keys, **args)
                   if req.kind == "mget"
                   else self.store.scan(req.lo, req.hi, **args))
            entry["fut"] = _ReadFuture(res)
            self._pending[req.req_id] = entry
            self._store_inflight += 1
            return
        value = None
        if req.kind != "get":
            # heap mode stores the request's byte payload verbatim (the
            # KVS appends the extent and rounds only the packed ref)
            value = bytes(req.data) if self.vbytes else req.value
        trace = entry.get("trace", 0)
        if self.is_fleet:
            session = req.tenant * 7919 + seq
            fut, lane = self.store.route_op(req.kind, session, req.key,
                                            value)
            entry["lane"] = lane
        else:
            r, s = self._lanes[(req.tenant * 7919 + seq) % len(self._lanes)]
            entry["lane"] = (None, r, s)
            if trace:
                # hand the minted id to the KVS so its op_queue/op_rounds
                # spans carry the SAME trace (consumed by the next
                # _enqueue; the fleet path keeps frontend spans only —
                # route_op picks the group internally)
                self.store._staged_trace = trace
            fut = getattr(self.store, req.kind)(r, s, req.key, *(
                (value,) if value is not None else ()))
        entry["fut"] = fut
        self._pending[req.req_id] = entry
        self._store_inflight += 1
        if trace:
            tr = self._op_tracer()
            if tr is not None:
                # intake-queue wait: admission round -> store-issue round
                tags = dict(tenant=req.tenant, op=req.kind, key=req.key)
                lane = entry.get("lane")
                if lane is not None and lane[0] is not None:
                    tags["group"] = lane[0]
                tr.span("fe_queue", trace, r0=entry["r_admit"],
                        r1=self._rt().step_idx,
                        dur_s=self.clock() - entry["t_admit"], **tags)

    _STATUS = {"get": wire.S_OK, "put": wire.S_OK, "rmw": wire.S_OK,
               "rmw_abort": wire.S_RMW_ABORT, "lost": wire.S_LOST,
               "rejected": wire.S_REJECTED}

    def _deadline_rsp(self, req):
        """The S_DEADLINE refusal in the request's own response layout."""
        if isinstance(req, wire.ReadRequest):
            return wire.ReadResponse(status=wire.S_DEADLINE,
                                     req_id=req.req_id)
        return wire.Response(status=wire.S_DEADLINE, req_id=req.req_id,
                             found=False)

    def _result_response(self, entry: dict):
        req = entry["req"]
        if isinstance(req, wire.ReadRequest):
            import numpy as np

            from hermes_tpu_torch.kvs import C_REJECTED
            from hermes_tpu_torch.core import types as t

            res = entry["fut"].res
            res._pull()
            served = res.code == t.C_READ
            rrsp = wire.ReadResponse(
                status=wire.S_OK, req_id=req.req_id,
                step=int(res.step.max()) if len(res) else -1,
                found=(np.asarray(res.found) & served).tolist(),
                local=np.asarray(res.local).tolist(),
                codes=np.where(res.code == C_REJECTED, wire.RK_REJECTED,
                               wire.RK_OK).tolist(),
                values=np.asarray(res.value).tolist())
            if self.vbytes:
                rrsp.data = list(res.data)
            return rrsp
        c = entry["fut"].result()
        rsp = wire.Response(status=self._STATUS[c.kind], req_id=req.req_id,
                            found=c.found, step=c.step)
        if c.value is not None:
            rsp.value = c.value
            rsp.data = c.data
        if c.uid is not None:
            rsp.uid = c.uid
            if c.ts is not None:
                # the tenant just SAW this write commit: pin its fence
                # token so the tenant's later K_MGET/K_SCAN reads must
                # observe this timestamp or take the round path (RYW
                # through the serving front-end, per tenant)
                self.store.pin_read_fence(("tenant", req.tenant),
                                          req.key, c.ts)
        return rsp

    def pump(self) -> List[wire.Response]:
        """One serving round: issue from the intake queue (deadline-
        checked), run one store round, harvest completions and expired
        deadlines.  Returns the responses produced this round."""
        now = self.clock()
        # intake expiry FIRST, over the whole queue — an op stuck behind a
        # full store must still resolve S_DEADLINE on time, not wait for
        # its pop turn
        if self._intake:
            keep = collections.deque()
            for entry in self._intake:
                req = entry["req"]
                if entry["deadline"] is not None and now > entry["deadline"]:
                    self.adm.note_resolved(req.tenant, wire.S_DEADLINE)
                    self._count("deadline")
                    self._respond(self._deadline_rsp(req), req.tenant,
                                  now - entry["t_admit"])
                    self._trace_resolve(entry, wire.S_DEADLINE, now)
                else:
                    keep.append(entry)
            self._intake = keep
        # intake -> store (expired ops were resolved above, never injected)
        while self._intake and self._store_inflight < self._store_cap:
            self._issue(self._intake.popleft())
        self.store.step()
        now = self.clock()
        # harvest completions + completion-side deadline enforcement
        done_ids = []
        for rid, entry in self._pending.items():
            fut = entry["fut"]
            late = (entry["deadline"] is not None
                    and now > entry["deadline"])
            if fut.done():
                rsp = (self._deadline_rsp(entry["req"]) if late
                       else self._result_response(entry))
                if late:
                    self._count("deadline")
                self.adm.note_resolved(entry["req"].tenant, rsp.status)
                self._respond(rsp, entry["req"].tenant,
                              now - entry["t_admit"])
                self._trace_resolve(entry, rsp.status, now)
                self._store_inflight -= 1
                done_ids.append(rid)
            elif late:
                # the RPC resolves NOW; the store op stays abandoned until
                # the protocol finishes it (quota freed, lane not yet)
                self.adm.note_resolved(entry["req"].tenant, wire.S_DEADLINE)
                self._count("deadline")
                self._respond(self._deadline_rsp(entry["req"]),
                              entry["req"].tenant, now - entry["t_admit"])
                self._trace_resolve(entry, wire.S_DEADLINE, now)
                self._abandoned.append(entry)
                done_ids.append(rid)
        for rid in done_ids:
            del self._pending[rid]
        still = []
        for entry in self._abandoned:
            if entry["fut"].done():
                self._store_inflight -= 1
            else:
                still.append(entry)
        self._abandoned = still
        self._update_level()
        rt = self._rt()
        if rt.obs is not None:
            # ladder history (obs/series.py): intake depth and
            # shed rung per serving round, keyed by the store's round
            # index — the backpressure trend a controller steers on
            reg = rt.obs.registry
            reg.series("intake_depth_series").append(
                rt.step_idx, len(self._intake))
            reg.series("shed_level_series").append(
                rt.step_idx, self.shed_level)
            # per-range key heat (ROADMAP item 6's controller input):
            # the round's hottest single key's op count and its distinct
            # key spread — the skew trend shed rung 2 would steer on
            reg.series("key_heat_max_series").append(
                rt.step_idx, max(self._round_key_ops.values(), default=0))
            reg.series("key_distinct_series").append(
                rt.step_idx, len(self._round_key_ops))
        self._round_key_ops.clear()
        return self.pop_responses()

    def flush(self) -> List[wire.Response]:
        """Force the store's deferred (pipelined) completions out and
        harvest them."""
        if self.is_fleet:
            self.store.flush()
        else:
            self.store.flush()
            self.store.rt.flush_pipeline()
        return self.pump()

    def drain(self, max_rounds: int = 10_000) -> bool:
        """Pump until every admitted op (including abandoned deadline
        maybes) resolves.  True when fully drained.  The responses
        produced while draining stay queued for ``pop_responses`` — a
        drained op resolved loudly, so its Response must remain
        observable, not vanish into the drain loop."""
        kept: List[wire.Response] = []
        done = False
        for _ in range(max_rounds):
            if not (self._intake or self._pending or self._abandoned):
                # a drained envelope is the ladder's floor: re-evaluate so
                # a pressure-driven rung emits its shed_clear even when no
                # further request arrives to observe it
                self._update_level()
                done = True
                break
            kept.extend(self.pump())
        if not done:
            kept.extend(self.flush())
        self._responses = kept + self._responses
        return not (self._intake or self._pending or self._abandoned)

    # -- accounting ----------------------------------------------------------

    def latencies(self, statuses=(wire.S_OK, wire.S_RMW_ABORT,
                                  wire.S_DEADLINE, wire.S_REJECTED,
                                  wire.S_LOST)) -> List[float]:
        """Admission-to-resolution latency (serving clock, seconds) of
        every ADMITTED op whose terminal status is in ``statuses``."""
        return self._resp_meta.latencies(statuses)

    def counters(self) -> dict:
        per = self.adm.counters()
        agg: Dict[str, int] = {}
        for row in per.values():
            for k, v in row.items():
                agg[k] = agg.get(k, 0) + v
        return dict(requests=self.requests, responses=self.responses,
                    shed_level=self.shed_level, queue=len(self._intake),
                    store_inflight=self._store_inflight,
                    tenants=per, fleet=self.is_fleet, totals=agg)


# -- the columnar data plane -------------------------------------------------
#
# ``ColumnarFrontend`` is the batch twin of ``Frontend``: whole columnar
# request batches (wire.ReqBatch) run the admission ladder in O(1)
# numpy passes per batch (admission.admit_batch — proven row-for-row
# equivalent to the scalar ladder), admitted rows live in a
# preallocated ``CompletionRing`` instead of per-request Future/dict
# objects, the pump resolves a round's completions as COLUMN writes off
# ``kvs.BatchFutures``, and responses drain as one ``RspBatch`` per
# connection per pump (one encode per connection on the transport).
# Single-op verbs only (get/put/rmw); the batched-read verbs
# (K_MGET/K_SCAN) and fleet routing stay on the scalar Frontend — and
# because the columnar plane serves no reads-with-fences, it does not
# pin per-tenant read fences on commit (the scalar path's RYW
# plumbing).  KVS-level op spans are also scalar-only (submit_batch has
# no per-op trace staging); the columnar plane closes fe_resolve spans
# for sampled rows so traced soaks still cover the front-end phase.

_RING_OPEN = 0xFF  # status column sentinel: slot allocated, unresolved


class CompletionRing:
    """The preallocated completion plane: an admitted op's identity is a
    SLOT INDEX into these columns (conn + client req_id restore the wire
    identity at emit time), allocated from a free stack and recycled the
    pump after the response is built.  No per-op Python objects exist
    between admission and emit."""

    def __init__(self, cap: int, u: int, vbytes: int):
        size = 1 << max(4, int(cap - 1).bit_length())
        self.cap = size
        self.u = u
        self.vbytes = vbytes
        # free stack: pop from the end, push back on release
        self.free = np.arange(size - 1, -1, -1, np.int32)
        self.n_free = size
        # request-side columns (written at admission)
        self.conn = np.zeros(size, np.int32)
        self.client_rid = np.zeros(size, np.uint32)
        self.tenant = np.zeros(size, np.int32)
        self.kind = np.zeros(size, np.uint8)      # wire K_* codes
        self.key = np.zeros(size, np.int64)
        self.trace = np.zeros(size, np.uint16)
        self.deadline = np.full(size, np.inf)     # absolute; inf = none
        self.t_admit = np.zeros(size)
        self.r_admit = np.zeros(size, np.int32)
        # resolution columns (written by the pump's harvest)
        self.status = np.full(size, _RING_OPEN, np.uint8)
        self.reason = np.zeros(size, np.uint8)
        self.found = np.zeros(size, bool)
        self.has_uid = np.zeros(size, bool)
        self.step = np.full(size, -1, np.int32)
        self.retry_us = np.zeros(size, np.uint32)
        self.uid = np.zeros((size, 2), np.int32)
        # payload: fixed word matrix, or (heap mode) a preallocated byte
        # ARENA — one (size, vbytes) row per slot plus a length column
        # (-1 = no payload), so the emit path can assemble a response
        # blob with codec.ragged_gather instead of a per-row Python
        # join (the old per-slot ``bytes`` list is gone)
        self.value = (np.zeros((size, u), np.int32) if not vbytes else None)
        self.heap = (np.zeros((size, vbytes), np.uint8) if vbytes
                     else None)
        self.dlen = (np.full(size, -1, np.int64) if vbytes else None)

    def set_data(self, s: int, b: Optional[bytes]) -> None:
        """Write one slot's heap payload (None clears)."""
        if b is None:
            self.dlen[s] = -1
            return
        n = len(b)
        self.heap[s, :n] = np.frombuffer(b, np.uint8)
        self.dlen[s] = n

    def get_data(self, s: int) -> Optional[bytes]:
        n = int(self.dlen[s])
        return None if n < 0 else self.heap[s, :n].tobytes()

    def alloc(self, k: int) -> np.ndarray:
        if k > self.n_free:
            raise RuntimeError(
                f"completion ring exhausted: want {k} slots, {self.n_free} "
                f"free of {self.cap} — the ring is sized for queue_cap + "
                "store_inflight_cap, so this is an accounting bug, not "
                "backpressure")
        out = self.free[self.n_free - k: self.n_free].copy()
        self.n_free -= k
        return out

    def release(self, slots: np.ndarray) -> None:
        k = int(slots.size)
        if not k:
            return
        self.free[self.n_free: self.n_free + k] = slots
        self.n_free += k
        self.status[slots] = _RING_OPEN
        if self.vbytes:
            self.dlen[slots] = -1

    def in_use(self) -> int:
        return self.cap - self.n_free


class ColumnarFrontend:
    """The columnar serving data plane over one ``kvs.KVS``.

    Same envelope semantics as ``Frontend`` — refusal reasons and
    retry hints row-for-row identical to the scalar ladder, deadlines
    enforced at intake and completion, loud statuses everywhere — at
    columnar throughput: admission, issue, harvest, and emit each touch
    a whole batch per numpy pass."""

    def __init__(self, store, scfg: Optional[ServingConfig] = None,
                 clock=None, ring_slack: int = 64):
        if hasattr(store, "router") and hasattr(store, "groups"):
            raise ValueError(
                "the columnar plane serves a single KVS; fleet routing "
                "(and the batched-read verbs) stay on the scalar Frontend")
        from hermes_tpu_torch.core import types as t
        from hermes_tpu_torch.kvs import C_LOST, C_REJECTED

        # the wire op codes ARE the store op codes (K_GET==OP_READ, ...):
        # the issue path relies on passing the kind column through verbatim
        assert (wire.K_GET, wire.K_PUT, wire.K_RMW) == (
            t.OP_READ, t.OP_WRITE, t.OP_RMW)
        self._C_READ, self._C_WRITE = t.C_READ, t.C_WRITE
        self._C_RMW, self._C_RMW_ABORT = t.C_RMW, t.C_RMW_ABORT
        self._C_LOST, self._C_REJECTED = C_LOST, C_REJECTED
        # completion code -> wire status, indexed by code + 3
        lut = np.zeros(8, np.uint8)
        lut[C_LOST + 3] = wire.S_LOST
        lut[C_REJECTED + 3] = wire.S_REJECTED
        lut[t.C_READ + 3] = wire.S_OK
        lut[t.C_WRITE + 3] = wire.S_OK
        lut[t.C_RMW + 3] = wire.S_OK
        lut[t.C_RMW_ABORT + 3] = wire.S_RMW_ABORT
        self._code_lut = lut

        self.store = store
        self.scfg = scfg or ServingConfig()
        self.u = store.cfg.value_words - 2
        self.vbytes = store.cfg.max_value_bytes
        if self.u < 1:
            raise ValueError("serving needs value_words >= 3 (the store "
                             "carries write uids in words 0-1)")
        self.n_keys = store.cfg.n_keys
        self.clock = clock if clock is not None else time.monotonic
        self.adm = AdmissionControl(self.scfg)
        cap = store.cfg.n_replicas * store.cfg.n_sessions
        self._store_cap = (self.scfg.store_inflight_cap
                           if self.scfg.store_inflight_cap is not None
                           else cap)
        self.ring = CompletionRing(
            self.scfg.queue_cap + self._store_cap + ring_slack,
            self.u, self.vbytes)
        self._intake: List[np.ndarray] = []   # FIFO of slot-id arrays
        self._intake_len = 0
        # open store batches: bf + slots + per-row resolved/harvested/
        # released masks (a row may resolve S_DEADLINE while its store op
        # is still open — the slot is held until the store finishes it,
        # the batch twin of the scalar _abandoned list)
        self._open: List[dict] = []
        self._store_inflight = 0
        self._resp_meta = RespMetaRing(self.scfg.resp_meta_cap)
        self.requests = 0
        self.responses = 0
        self.shed_level = 0
        if self.scfg.trace_sample:
            from hermes_tpu_torch.obs.tracing import TraceSampler

            self._sampler = TraceSampler(self.scfg.trace_sample,
                                         seed=self.scfg.trace_seed)
        else:
            self._sampler = None
        self._op_tracer_cache = None
        self._round_key_ops: dict = {}

    # -- plumbing ------------------------------------------------------------

    def _rt(self):
        return self.store.rt

    def _trace(self, name: str, **fields) -> None:
        rt = self._rt()
        rt._trace(name, **fields)
        if rt.obs is not None:
            rt.obs.registry.counter(f"serving_{name}").inc()

    def _count(self, name: str, n: int = 1) -> None:
        rt = self._rt()
        if rt.obs is not None and n:
            rt.obs.registry.counter(f"serving_{name}").inc(n)

    def _op_tracer(self):
        rt = self._rt()
        if rt.obs is None:
            return None
        c = self._op_tracer_cache
        if c is None or c.obs is not rt.obs:
            from hermes_tpu_torch.obs.tracing import OpTracer

            c = self._op_tracer_cache = OpTracer(rt.obs)
        return c

    def _update_level(self, degraded: Optional[bool] = None) -> None:
        if degraded is None:
            degraded = self.store.degraded()
        level = self.adm.ladder_level(self._intake_len, degraded)
        if level != self.shed_level:
            if level > 0:
                self._trace("shed", level=level, queue=self._intake_len)
            else:
                self._trace("shed_clear", queue=self._intake_len)
            self.shed_level = level

    # -- intake --------------------------------------------------------------

    def submit_batch(self, batch: wire.ReqBatch, conn=0):
        """Run a whole request batch through admission in one pass.
        Returns the IMMEDIATE refusals (S_REJECTED validity failures and
        loud S_RETRY_AFTER rows) — possibly empty; admitted rows resolve
        through later ``pump`` calls.  ``conn`` tags admitted rows so
        the pump can emit one response batch per connection: a scalar
        tags the whole batch (one transport connection, the
        contract — refusals return as an RspBatch in batch row order),
        while an int ndarray tags PER ROW (the shm merge path,
        where one owner batch carries every worker's connections —
        refusals return as {conn: RspBatch}, the same shape ``pump``
        emits)."""
        vec_conn = isinstance(conn, np.ndarray)
        now = self.clock()
        k = len(batch)
        self.requests += k
        if k == 0:
            return _empty_rsp_batch(self.u, self.vbytes)
        status = np.full(k, _RING_OPEN, np.uint8)
        reason = np.zeros(k, np.uint8)
        retry_us = np.zeros(k, np.uint32)
        kind = np.asarray(batch.kind, np.uint8)
        key = np.asarray(batch.key, np.int64)
        # validity (the scalar path's pre-admission S_REJECTED checks):
        # unknown kind, key out of range, heap update without a payload
        valid = (np.isin(kind, (wire.K_GET, wire.K_PUT, wire.K_RMW))
                 & (key >= 0) & (key < self.n_keys))
        writes = kind != wire.K_GET
        if self.vbytes:
            vlen = (np.asarray(batch.vlen, np.int64)
                    if batch.vlen is not None else np.full(k, -1, np.int64))
            valid &= ~writes | ((vlen >= 0) & (vlen <= self.vbytes))
        status[~valid] = wire.S_REJECTED
        vi = np.nonzero(valid)[0]
        degraded = self.store.degraded()
        self._update_level(degraded)
        reasons, waits = self.adm.admit_batch(
            writes[vi], key[vi], batch.tenant[vi], now,
            self._intake_len, degraded)
        refused = reasons != wire.R_NONE
        ri = vi[refused]
        status[ri] = wire.S_RETRY_AFTER
        reason[ri] = reasons[refused]
        retry_us[ri] = np.ceil(waits[refused] * 1e6).astype(np.uint32)
        self._count("retry_after", int(ri.size))
        ai = vi[~refused]
        if ai.size:
            # trace mint: adopt client-sampled wire ids, else sample on
            # the monotone request index (one vectorized splitmix64
            # pass, bit-exact with the old per-row loop)
            trace = np.asarray(batch.trace[ai], np.uint16).copy()
            if self._sampler is not None:
                base = self.requests - k
                z = np.nonzero(trace == 0)[0]
                if z.size:
                    trace[z] = self._sampler.sample_array(
                        (base + ai[z]).astype(np.uint64))
            rg = self.ring
            slots = rg.alloc(int(ai.size))
            rg.conn[slots] = conn[ai] if vec_conn else conn
            rg.client_rid[slots] = batch.req_id[ai]
            rg.tenant[slots] = batch.tenant[ai]
            rg.kind[slots] = kind[ai]
            rg.key[slots] = key[ai]
            rg.trace[slots] = trace
            dl = batch.deadline_us[ai].astype(np.int64)
            if self.scfg.default_deadline_us:
                dl = np.where(dl == 0, self.scfg.default_deadline_us, dl)
            rg.deadline[slots] = np.where(dl > 0, now + dl * 1e-6, np.inf)
            rg.t_admit[slots] = now
            rg.r_admit[slots] = self._rt().step_idx
            rg.status[slots] = _RING_OPEN
            if self.vbytes:
                # payload tails land in the arena in one ragged pass
                # (blob extents -> slot rows); gets carry vlen=-1 by
                # the wire codec's rule, matching old row_data(None)
                vl = (np.asarray(batch.vlen, np.int64)[ai]
                      if batch.vlen is not None
                      else np.full(ai.size, -1, np.int64))
                vo = (np.asarray(batch.voff, np.int64)[ai]
                      if batch.voff is not None
                      else np.zeros(ai.size, np.int64))
                # clamp defensively: the wire decoder already refuses
                # dlen > vbytes, but a hand-built batch must not be
                # able to scatter past its arena row
                vl = np.minimum(vl, self.vbytes)
                pl = np.maximum(vl, 0)
                src = _codec.ragged_gather(
                    np.frombuffer(batch.blob, np.uint8), vo, pl)
                _codec.ragged_scatter(
                    rg.heap.reshape(-1),
                    slots.astype(np.int64) * self.vbytes, pl, src)
                rg.dlen[slots] = vl
            else:
                rg.value[slots] = (batch.value[ai]
                                   if batch.value is not None
                                   else 0)
            self._intake.append(slots)
            self._intake_len += int(slots.size)
            ku, kc = np.unique(key[ai], return_counts=True)
            for kk, cc in zip(ku.tolist(), kc.tolist()):
                self._round_key_ops[kk] = \
                    self._round_key_ops.get(kk, 0) + cc
        # immediate refusals (in batch row order)
        done = status != _RING_OPEN
        di = np.nonzero(done)[0]
        nd = int(di.size)
        self.responses += nd
        self._resp_meta.extend(batch.tenant[di], status[di])
        rb = wire.RspBatch(
            status=status[di], reason=reason[di],
            req_id=np.asarray(batch.req_id)[di].astype(np.uint32),
            found=np.ones(nd, bool),  # refusal Responses default found=True
            has_uid=np.zeros(nd, bool), step=np.full(nd, -1, np.int32),
            retry_after_us=retry_us[di],
            uid=np.zeros((nd, 2), np.int32))
        if self.vbytes:
            rb.vlen = np.full(nd, -1, np.int64)
        else:
            rb.value = np.zeros((nd, self.u), np.int32)
        if not vec_conn:
            return rb
        out: Dict[int, wire.RspBatch] = {}
        cdi = np.asarray(conn)[di]
        for cid in np.unique(cdi).tolist():
            out[int(cid)] = rb.select(np.nonzero(cdi == cid)[0])
        return out

    # -- resolution helpers --------------------------------------------------

    def _mark_deadline(self, slots: np.ndarray) -> None:
        """Write the S_DEADLINE resolution columns (found=False, no
        result payload — the scalar ``_deadline_rsp`` shape)."""
        rg = self.ring
        rg.status[slots] = wire.S_DEADLINE
        rg.reason[slots] = wire.R_NONE
        rg.found[slots] = False
        rg.has_uid[slots] = False
        rg.step[slots] = -1
        rg.retry_us[slots] = 0
        rg.uid[slots] = 0
        if rg.value is not None:
            rg.value[slots] = 0
        else:
            rg.dlen[slots] = -1

    def _finish(self, slots: np.ndarray, now: float,
                emit: List[np.ndarray]) -> None:
        """Account + meta + spans for freshly-resolved slots, and queue
        them for this pump's per-connection emit."""
        rg = self.ring
        sts = rg.status[slots]
        self.adm.note_resolved_batch(rg.tenant[slots], sts)
        self._count("deadline", int((sts == wire.S_DEADLINE).sum()))
        lats = now - rg.t_admit[slots]
        self._resp_meta.extend(rg.tenant[slots], sts, lats)
        self.responses += int(slots.size)
        traced = np.nonzero(rg.trace[slots] != 0)[0]
        if traced.size:
            tr = self._op_tracer()
            if tr is not None:
                r1 = self._rt().step_idx
                for j in traced.tolist():
                    s = int(slots[j])
                    tr.span(
                        "fe_resolve", int(rg.trace[s]),
                        r0=int(rg.r_admit[s]), r1=r1,
                        dur_s=now - float(rg.t_admit[s]),
                        tenant=int(rg.tenant[s]),
                        op=wire._KIND_NAMES[int(rg.kind[s])],
                        key=int(rg.key[s]), status=int(rg.status[s]))
        emit.append(slots)

    def _rsp_batch(self, slots: np.ndarray) -> wire.RspBatch:
        rg = self.ring
        rb = wire.RspBatch(
            status=rg.status[slots], reason=rg.reason[slots],
            req_id=rg.client_rid[slots], found=rg.found[slots],
            has_uid=rg.has_uid[slots], step=rg.step[slots],
            retry_after_us=rg.retry_us[slots], uid=rg.uid[slots])
        if self.vbytes:
            # one ragged gather straight off the slot arena replaces the
            # per-row blob join: only S_OK rows with a
            # payload contribute extents, same as the old loop
            have = ((rg.status[slots] == wire.S_OK)
                    & (rg.dlen[slots] >= 0))
            vlen = np.where(have, rg.dlen[slots], -1)
            plen = np.maximum(vlen, 0)
            voff = np.concatenate(
                ([0], np.cumsum(plen)[:-1])) if slots.size \
                else np.zeros(0, np.int64)
            blob = _codec.ragged_gather(
                rg.heap.reshape(-1),
                slots.astype(np.int64) * self.vbytes, plen)
            rb.vlen, rb.voff, rb.blob = vlen, voff, blob.tobytes()
        else:
            rb.value = rg.value[slots]
        return rb

    # -- the pump ------------------------------------------------------------

    def pump(self) -> Dict[int, wire.RspBatch]:
        """One serving round, all columns: intake expiry -> issue (ONE
        store.submit_batch) -> store.step() -> harvest (column writes
        off BatchFutures) + completion-side deadlines -> one RspBatch
        per connection.  Returns {conn: RspBatch} for this round's
        resolutions."""
        now = self.clock()
        rg = self.ring
        emit: List[np.ndarray] = []
        expired_free: List[np.ndarray] = []
        # 1. intake expiry FIRST, over the whole queue (scalar rule: an
        # op stuck behind a full store still resolves S_DEADLINE on time)
        if self._intake_len:
            kept: List[np.ndarray] = []
            n_left = 0
            for slots in self._intake:
                late = now > rg.deadline[slots]
                if late.any():
                    ds = slots[late]
                    self._mark_deadline(ds)
                    self._finish(ds, now, emit)
                    expired_free.append(ds)
                    slots = slots[~late]
                if slots.size:
                    kept.append(slots)
                    n_left += int(slots.size)
            self._intake = kept
            self._intake_len = n_left
        # 2. issue: fill the store's free depth with the intake prefix,
        # one submit_batch for the whole round
        room = self._store_cap - self._store_inflight
        if room > 0 and self._intake_len:
            take: List[np.ndarray] = []
            while self._intake and room > 0:
                s = self._intake[0]
                if s.size <= room:
                    take.append(s)
                    self._intake.pop(0)
                    room -= int(s.size)
                else:
                    take.append(s[:room])
                    self._intake[0] = s[room:]
                    room = 0
            slots = (np.concatenate(take) if len(take) > 1 else take[0])
            self._intake_len -= int(slots.size)
            if self.vbytes:
                vals = [rg.get_data(s) for s in slots.tolist()]
            else:
                vals = rg.value[slots]
            bf = self.store.submit_batch(
                rg.kind[slots].astype(np.int32), rg.key[slots], vals)
            n = int(slots.size)
            self._open.append(dict(
                bf=bf, slots=slots,
                resolved=np.zeros(n, bool),
                harvested=np.zeros(n, bool),
                released=np.zeros(n, bool)))
            self._store_inflight += n
            traced = np.nonzero(rg.trace[slots] != 0)[0]
            if traced.size:
                tr = self._op_tracer()
                if tr is not None:
                    r1 = self._rt().step_idx
                    for j in traced.tolist():
                        s = int(slots[j])
                        tr.span(
                            "fe_queue", int(rg.trace[s]),
                            r0=int(rg.r_admit[s]), r1=r1,
                            dur_s=now - float(rg.t_admit[s]),
                            tenant=int(rg.tenant[s]),
                            op=wire._KIND_NAMES[int(rg.kind[s])],
                            key=int(rg.key[s]))
        # 3. one store round
        self.store.step()
        now = self.clock()
        # 4. harvest completions + completion-side deadline enforcement,
        # in issue order (deterministic)
        for ob in self._open:
            bf, slots = ob["bf"], ob["slots"]
            code = np.asarray(bf.code)
            done = code != 0
            newly_done = done & ~ob["harvested"]
            if newly_done.any():
                self._store_inflight -= int(newly_done.sum())
                ob["harvested"] |= newly_done
            res = done & ~ob["resolved"]
            if res.any():
                ds = slots[res]
                c = code[res]
                late = now > rg.deadline[ds]
                st = self._code_lut[c + 3]
                rg.status[ds] = np.where(late, wire.S_DEADLINE, st)
                maybe = (c == self._C_LOST) | (c == self._C_REJECTED)
                fnd = np.asarray(bf.found)[res] & ~maybe
                rg.found[ds] = np.where(late, False, fnd)
                rg.reason[ds] = wire.R_NONE
                rg.retry_us[ds] = 0
                rg.step[ds] = np.where(late, -1, np.asarray(bf.step)[res])
                hu = (((c == self._C_WRITE) | (c == self._C_RMW))
                      & ~late)
                rg.has_uid[ds] = hu
                rg.uid[ds] = np.where(hu[:, None],
                                      np.asarray(bf.uid)[res], 0)
                readable = (((c == self._C_READ) | (c == self._C_RMW))
                            & fnd & ~late)
                if rg.value is not None:
                    rg.value[ds] = np.where(readable[:, None],
                                            np.asarray(bf.value)[res], 0)
                else:
                    ridx = np.nonzero(res)[0]
                    for j, s, keep in zip(ridx.tolist(), ds.tolist(),
                                          readable.tolist()):
                        rg.set_data(s, bf.data[j] if keep else None)
                ob["resolved"] |= res
                self._finish(ds, now, emit)
            # completion-side deadline on rows the store still holds:
            # the RPC resolves NOW, the slot stays until the store
            # finishes the op (the scalar _abandoned semantics)
            pend = ~done & ~ob["resolved"]
            if pend.any():
                ds_all = slots[pend]
                late = now > rg.deadline[ds_all]
                if late.any():
                    ds = ds_all[late]
                    self._mark_deadline(ds)
                    idx = np.nonzero(pend)[0][late]
                    ob["resolved"][idx] = True
                    self._finish(ds, now, emit)
        self._update_level()
        rt = self._rt()
        if rt.obs is not None:
            reg = rt.obs.registry
            reg.series("intake_depth_series").append(
                rt.step_idx, self._intake_len)
            reg.series("shed_level_series").append(
                rt.step_idx, self.shed_level)
            reg.series("key_heat_max_series").append(
                rt.step_idx, max(self._round_key_ops.values(), default=0))
            reg.series("key_distinct_series").append(
                rt.step_idx, len(self._round_key_ops))
        self._round_key_ops.clear()
        # 5. emit: one response batch per connection, then recycle slots
        out: Dict[int, wire.RspBatch] = {}
        if emit:
            all_slots = np.concatenate(emit)
            conns = rg.conn[all_slots]
            for cid in np.unique(conns).tolist():
                out[cid] = self._rsp_batch(all_slots[conns == cid])
        for ds in expired_free:
            rg.release(ds)
        still: List[dict] = []
        for ob in self._open:
            freeable = ob["resolved"] & ob["harvested"] & ~ob["released"]
            if freeable.any():
                rg.release(ob["slots"][freeable])
                ob["released"] |= freeable
            if not ob["released"].all():
                still.append(ob)
        self._open = still
        return out

    def idle(self) -> bool:
        return not self._intake and not self._open

    def flush(self) -> Dict[int, wire.RspBatch]:
        """Force the store's deferred (pipelined) completions out and
        harvest them."""
        self.store.flush()
        self.store.rt.flush_pipeline()
        return self.pump()

    def drain(self, max_rounds: int = 10_000
              ) -> Tuple[bool, List[Dict[int, wire.RspBatch]]]:
        """Pump until every admitted op resolves; returns (drained,
        per-pump emit dicts) — drained responses stay observable."""
        emitted: List[Dict[int, wire.RspBatch]] = []
        for _ in range(max_rounds):
            if self.idle():
                self._update_level()
                return True, emitted
            emitted.append(self.pump())
        emitted.append(self.flush())
        return self.idle(), emitted

    # -- accounting ----------------------------------------------------------

    def latencies(self, statuses=(wire.S_OK, wire.S_RMW_ABORT,
                                  wire.S_DEADLINE, wire.S_REJECTED,
                                  wire.S_LOST)) -> List[float]:
        return self._resp_meta.latencies(statuses)

    def counters(self) -> dict:
        per = self.adm.counters()
        agg: Dict[str, int] = {}
        for row in per.values():
            for k, v in row.items():
                agg[k] = agg.get(k, 0) + v
        return dict(requests=self.requests, responses=self.responses,
                    shed_level=self.shed_level, queue=self._intake_len,
                    store_inflight=self._store_inflight,
                    ring_in_use=self.ring.in_use(),
                    tenants=per, fleet=False, totals=agg)


def _empty_rsp_batch(u: int, vbytes: int) -> wire.RspBatch:
    rb = wire.RspBatch(
        status=np.zeros(0, np.uint8), reason=np.zeros(0, np.uint8),
        req_id=np.zeros(0, np.uint32), found=np.zeros(0, bool),
        has_uid=np.zeros(0, bool), step=np.zeros(0, np.int32),
        retry_after_us=np.zeros(0, np.uint32),
        uid=np.zeros((0, 2), np.int32))
    if vbytes:
        rb.vlen = np.zeros(0, np.int64)
    else:
        rb.value = np.zeros((0, u), np.int32)
    return rb


def verify_columnar(fe: ColumnarFrontend) -> dict:
    """The serving envelope invariants, ring edition:

      1. response conservation — every batched request produced exactly
         one response row;
      2. admission accounting exactness per tenant, in-flight zero;
      3. the envelope is empty — intake, open store batches, and the
         completion ring all drained (every slot back on the free
         stack).
    """
    assert fe.requests == fe.responses, (
        f"response conservation broken: {fe.requests} requests but "
        f"{fe.responses} responses")
    for t, row in fe.adm.counters().items():
        assert row["inflight"] == 0, (
            f"tenant {t} still shows {row['inflight']} in flight")
        resolved = (row["completed"] + row["deadline"] + row["rejected"]
                    + row["lost"])
        assert row["admitted"] == resolved, (
            f"tenant {t} admission accounting broken: "
            f"admitted={row['admitted']} != resolved={resolved} ({row})")
    assert not fe._intake and not fe._open, (
        "columnar envelope not empty after drain")
    assert fe.ring.in_use() == 0, (
        f"completion ring leaked {fe.ring.in_use()} slots")
    agg = fe.counters()["totals"]
    return dict(requests=fe.requests, responses=fe.responses,
                admitted=agg.get("admitted", 0),
                completed=agg.get("completed", 0),
                deadline=agg.get("deadline", 0),
                retry_after=agg.get("retry_after", 0),
                shed=agg.get("shed", 0),
                rejected=agg.get("rejected", 0), lost=agg.get("lost", 0))


def verify_serving(fe: Frontend) -> dict:
    """Serving envelope invariants (run after a drained soak):

      1. response conservation — every request produced exactly ONE
         response (refusal or resolution; nothing silently buffered or
         dropped);
      2. admission accounting exactness — per tenant,
         admitted == completed + deadline + rejected + lost and the
         in-flight count is back to zero;
      3. the envelope is empty — intake queue, pending map, and
         abandoned list all drained.

    Raises AssertionError on the first violation; returns evidence.
    """
    assert fe.requests == fe.responses, (
        f"response conservation broken: {fe.requests} requests but "
        f"{fe.responses} responses")
    for t, row in fe.adm.counters().items():
        assert row["inflight"] == 0, (
            f"tenant {t} still shows {row['inflight']} in flight")
        resolved = (row["completed"] + row["deadline"] + row["rejected"]
                    + row["lost"])
        assert row["admitted"] == resolved, (
            f"tenant {t} admission accounting broken: "
            f"admitted={row['admitted']} != resolved={resolved} ({row})")
    assert not fe._intake and not fe._pending and not fe._abandoned, (
        "serving envelope not empty after drain")
    agg = fe.counters()["totals"]
    return dict(requests=fe.requests, responses=fe.responses,
                admitted=agg.get("admitted", 0),
                completed=agg.get("completed", 0),
                deadline=agg.get("deadline", 0),
                retry_after=agg.get("retry_after", 0),
                shed=agg.get("shed", 0),
                rejected=agg.get("rejected", 0), lost=agg.get("lost", 0))
