"""Deterministic open-loop serving soaks.

One driver for the CI gate, the CLI quickstart, and the tests: a seeded
Poisson arrival schedule (optionally shaped by chaos ``overload``
windows) drives a byte-honest ``LoopbackServer`` on a ``VirtualClock``
that advances ``scfg.round_us`` per pump — so a soak is a pure function
of (store config, serving config, mix spec, rate, seed): the executed
response byte log replays IDENTICALLY, the chaos-schedule determinism
contract applied to overload.

Capacity measurement (``measure_capacity``) is closed-loop: every store
lane kept full, throughput service-bound — the honest denominator for
"soak at >= 2x capacity".
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from hermes_tpu_torch.serving import wire
from hermes_tpu_torch.serving.rpc import LoopbackServer
from hermes_tpu_torch.stats import percentile_nearest_rank
from hermes_tpu_torch.serving.server import (Frontend, ServingConfig,
                                             VirtualClock, verify_serving)
from hermes_tpu_torch.workload.openloop import (ClosedLoop, MixSpec,
                                                ShapedArrivals, make_mix)


def measure_capacity(store, scfg: ServingConfig, spec: MixSpec, n: int,
                     seed: int) -> dict:
    """Closed-loop service rate through the full serving path: ``n`` ops
    offered as fast as admission refills, every refusal retried next
    round (closed-loop clients wait, they don't walk away).  Returns
    ops/virtual-second + ops/round."""
    clock = VirtualClock()
    fe = Frontend(store, scfg, clock=clock)
    lb = LoopbackServer(fe)
    cl = ClosedLoop(spec, fe.n_keys, n, seed, value_words=fe.u)
    round_s = scfg.round_us * 1e-6
    resolved, retry = 0, []
    rounds = 0
    next_rid = 1
    while resolved < n and rounds < 100_000:
        # closed-loop offer: retries first, then fresh ops, until the
        # front door refuses (rate/quota/queue) or the mix runs dry
        offer = retry
        retry = []
        while True:
            if offer:
                req = offer.pop(0)
            else:
                op = cl.next_op()
                if op is None:
                    break
                req = wire.Request(
                    kind=op["kind"], req_id=next_rid, tenant=op["tenant"],
                    key=op["key"], value=op["value"])
                next_rid += 1
            rsp = lb.submit(req)
            if rsp is not None:
                if rsp.status == wire.S_RETRY_AFTER:
                    # the door is closed this round: stash this op AND
                    # everything still waiting behind it for the next one
                    retry.append(req)
                    retry.extend(offer)
                    break
                resolved += 1
        resolved += len(lb.pump())
        clock.advance(round_s)
        rounds += 1
    lb.drain()
    done = fe.counters()["totals"]
    served = (done.get("completed", 0) + done.get("deadline", 0)
              + done.get("rejected", 0) + done.get("lost", 0))
    ops_per_round = served / max(1, rounds)
    return dict(ops=served, rounds=rounds,
                ops_per_round=round(ops_per_round, 3),
                ops_per_vs=round(ops_per_round / round_s, 1))


def run_open_loop(store, scfg: ServingConfig, spec: MixSpec,
                  rate_per_s: float, n: int, seed: int, deadline_us: int,
                  chaos_runner=None, arrivals: Optional[ShapedArrivals] = None,
                  max_rounds: int = 200_000) -> dict:
    """The open-loop Poisson soak: arrivals fire on THEIR schedule (the
    client does not wait for the server), every request resolves loudly,
    and the whole run replays byte-identically from the seed.

    ``chaos_runner``: an already-constructed ``chaos.ChaosRunner`` over
    ``store`` (its ``load=`` may be the arrival schedule for overload
    verbs); it is TICKED each round — the frontend pump is what steps
    the store.  Returns the summary dict (responses stay on the
    LoopbackServer for byte-log comparison).
    """
    clock = VirtualClock()
    fe = Frontend(store, scfg, clock=clock)
    lb = LoopbackServer(fe)
    if chaos_runner is not None and chaos_runner.load is not None:
        # the runner's shaper and the soak's arrival schedule must be ONE
        # object, or the overload verbs shape a schedule nobody consumes
        # (the silent-skip failure mode the net-fault routability rule
        # exists to prevent)
        if arrivals is None:
            arrivals = chaos_runner.load
        elif arrivals is not chaos_runner.load:
            raise ValueError("chaos_runner.load and arrivals= are "
                             "different objects: the overload storm would "
                             "shape a schedule this soak never consumes")
    if arrivals is None:
        arrivals = ShapedArrivals(rate_per_s, n, seed)
    if chaos_runner is not None and chaos_runner.load is None \
            and any(e.kind.startswith("overload")
                    for e in chaos_runner.schedule):
        raise ValueError("chaos schedule has overload verbs: construct "
                         "ChaosRunner(..., load=arrivals) and pass the "
                         "same arrivals here")
    mix = make_mix(spec, fe.n_keys, n, seed, value_words=fe.u)
    round_s = scfg.round_us * 1e-6
    sent = 0
    rounds = 0
    # flight recorder: an obs-attached soak dumps its black
    # box on an operator SIGTERM and on envelope-invariant failure — a
    # long soak that dies must leave a post-mortem (no-op unless a dump
    # dir is configured; obs/flightrec.py)
    obs = fe._rt().obs
    restore_sigterm = None
    if obs is not None:
        from hermes_tpu_torch.obs.flightrec import install_sigterm

        restore_sigterm = install_sigterm(
            obs.flight, extra=dict(where="serving_soak", seed=seed))
    try:
        while rounds < max_rounds:
            if chaos_runner is not None:
                chaos_runner.tick(rounds)
            k = arrivals.due(clock.t)
            for _ in range(k):
                if sent >= n:
                    break
                i = sent
                req = wire.Request(
                    kind=("get", "put", "rmw")[int(mix["kind"][i])],
                    req_id=i + 1, tenant=int(mix["tenant"][i]),
                    key=int(mix["key"][i]), deadline_us=deadline_us,
                    value=mix["value"][i].tolist())
                sent += 1
                lb.submit(req)
            lb.pump()
            clock.advance(round_s)
            rounds += 1
            if sent >= n and not (fe._intake or fe._pending
                                  or fe._abandoned):
                break
        lb.drain()
        # one authoritative status census off the response meta (covers
        # both submit()-time refusals and pump()-time resolutions)
        statuses: dict = {}
        for _t, st, _lat in fe._resp_meta:
            name = wire.STATUS_NAMES[st]
            statuses[name] = statuses.get(name, 0) + 1
        lat = sorted(fe.latencies())
        pctl = lambda q: percentile_nearest_rank(lat, q)
        try:
            ev = verify_serving(fe)
        except AssertionError:
            if obs is not None:
                obs.flight_dump("verify_serving_failed",
                                extra=dict(seed=seed, rounds=rounds))
            raise
    finally:
        if restore_sigterm is not None:
            restore_sigterm()
    totals = fe.counters()["totals"]
    return dict(
        ops_offered=n, sent=sent, rounds=rounds,
        statuses=statuses, admitted=ev["admitted"],
        retry_after=ev["retry_after"], shed=ev["shed"],
        deadline=ev["deadline"], lost=ev["lost"],
        completed=ev["completed"], rejected=ev["rejected"],
        p50_latency_us=(None if pctl(0.5) is None
                        else round(pctl(0.5) * 1e6, 1)),
        p99_latency_us=(None if pctl(0.99) is None
                        else round(pctl(0.99) * 1e6, 1)),
        deadline_us=deadline_us,
        virtual_seconds=round(clock.t, 6),
        response_log_sha=_sha(lb.response_log()),
        tenants=fe.counters()["tenants"],
        _frontend=fe, _server=lb,
    )


def run_columnar_soak(store, scfg: ServingConfig, spec: MixSpec,
                      rate_per_s: float, n: int, seed: int,
                      deadline_us: int,
                      arrivals: Optional[ShapedArrivals] = None,
                      max_rounds: int = 200_000) -> dict:
    """The open-loop soak on the COLUMNAR data plane: the
    same seeded Poisson schedule and op mix as ``run_open_loop``, but
    each round's due arrivals go through the wire as ONE columnar batch
    and responses drain as one encode per pump — still a pure function
    of (store config, serving config, mix spec, rate, seed), so the
    response byte log replays identically."""
    from hermes_tpu_torch.serving.rpc import ColumnarLoopback
    from hermes_tpu_torch.serving.server import (ColumnarFrontend,
                                                 verify_columnar)

    clock = VirtualClock()
    fe = ColumnarFrontend(store, scfg, clock=clock)
    lb = ColumnarLoopback(fe)
    if fe.vbytes:
        raise ValueError(
            "the columnar soak drives fixed-width stores (the open-loop "
            "mix generator mints word values); heap-mode coverage lives "
            "in the codec property tests and the frontend unit tests")
    if arrivals is None:
        arrivals = ShapedArrivals(rate_per_s, n, seed)
    mix = make_mix(spec, fe.n_keys, n, seed, value_words=fe.u)
    # columnize the whole mix ONCE; each round slices a view
    kind_col = (np.asarray(mix["kind"], np.uint8) + 1)  # 0/1/2 -> K_*
    rid_col = np.arange(1, n + 1, dtype=np.uint32)
    tenant_col = np.asarray(mix["tenant"], np.uint16)
    trace_col = np.zeros(n, np.uint16)  # server-minted sampling
    dl_col = np.full(n, deadline_us, np.uint32)
    key_col = np.asarray(mix["key"], np.int64)
    val_col = np.asarray(mix["value"], np.int32).reshape(n, fe.u)
    round_s = scfg.round_us * 1e-6
    sent = 0
    rounds = 0
    obs = fe._rt().obs
    restore_sigterm = None
    if obs is not None:
        from hermes_tpu_torch.obs.flightrec import install_sigterm

        restore_sigterm = install_sigterm(
            obs.flight, extra=dict(where="columnar_soak", seed=seed))
    try:
        while rounds < max_rounds:
            k = min(arrivals.due(clock.t), n - sent)
            if k:
                b = wire.ReqBatch(
                    kind=kind_col[sent:sent + k],
                    req_id=rid_col[sent:sent + k],
                    tenant=tenant_col[sent:sent + k],
                    trace=trace_col[sent:sent + k],
                    deadline_us=dl_col[sent:sent + k],
                    key=key_col[sent:sent + k],
                    value=val_col[sent:sent + k])
                lb.submit_batch(b, conn=0)
                sent += k
            lb.pump()
            clock.advance(round_s)
            rounds += 1
            if sent >= n and fe.idle():
                break
        lb.drain()
        statuses: dict = {}
        for _t, st, _lat in fe._resp_meta:
            name = wire.STATUS_NAMES[st]
            statuses[name] = statuses.get(name, 0) + 1
        lat = sorted(fe.latencies())
        pctl = lambda q: percentile_nearest_rank(lat, q)
        try:
            ev = verify_columnar(fe)
        except AssertionError:
            if obs is not None:
                obs.flight_dump("verify_columnar_failed",
                                extra=dict(seed=seed, rounds=rounds))
            raise
    finally:
        if restore_sigterm is not None:
            restore_sigterm()
    return dict(
        ops_offered=n, sent=sent, rounds=rounds,
        statuses=statuses, admitted=ev["admitted"],
        retry_after=ev["retry_after"], shed=ev["shed"],
        deadline=ev["deadline"], lost=ev["lost"],
        completed=ev["completed"], rejected=ev["rejected"],
        p50_latency_us=(None if pctl(0.5) is None
                        else round(pctl(0.5) * 1e6, 1)),
        p99_latency_us=(None if pctl(0.99) is None
                        else round(pctl(0.99) * 1e6, 1)),
        deadline_us=deadline_us,
        virtual_seconds=round(clock.t, 6),
        response_log_sha=_sha(lb.response_log()),
        tenants=fe.counters()["tenants"],
        _frontend=fe, _server=lb,
    )


def measure_columnar_floor(n_ops: int = 8192, batch: int = 1024,
                           seed: int = 14, store=None,
                           scfg: Optional[ServingConfig] = None,
                           device="cuda") -> dict:
    """WALL-CLOCK closed-loop throughput of the columnar loopback path
    — the serving-throughput floor leg of ``bench.run_serve_bench``: the
    full byte-honest pipeline (columnar encode -> CRC frame -> decode ->
    batch admission -> ring -> store -> columnar response encode) on the
    real clock.  Every op resolves; refusals would be S_RETRY_AFTER rows
    and are RETRIED (closed-loop clients wait) — with the generous
    default envelope none occur, and the count is reported loudly."""
    import time as _time

    from hermes_tpu_torch.serving.rpc import ColumnarLoopback
    from hermes_tpu_torch.serving.server import (ColumnarFrontend,
                                                 verify_columnar)

    if store is None:
        from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
        from hermes_tpu_torch.kvs import KVS

        store = KVS(HermesConfig(
            n_replicas=4, n_keys=64, n_sessions=128, value_words=8,
            pipeline_depth=2,
            workload=WorkloadConfig(read_frac=0.5, seed=seed)),
            device=device)
    scfg = scfg or ServingConfig(
        tenant_rate_per_s=1e9, tenant_burst=1e9,
        tenant_quota=4 * batch, queue_cap=4 * batch)
    fe = ColumnarFrontend(store, scfg)  # real clock: wall-honest floor
    lb = ColumnarLoopback(fe)
    spec = MixSpec(read_frac=0.5, rmw_frac=0.1, tenants=4)
    mix = make_mix(spec, fe.n_keys, n_ops, seed, value_words=fe.u)
    kind_col = (np.asarray(mix["kind"], np.uint8) + 1)
    rid_col = np.arange(1, n_ops + 1, dtype=np.uint32)
    tenant_col = np.asarray(mix["tenant"], np.uint16)
    zeros16 = np.zeros(n_ops, np.uint16)
    zeros32 = np.zeros(n_ops, np.uint32)
    key_col = np.asarray(mix["key"], np.int64)
    val_col = np.asarray(mix["value"], np.int32).reshape(n_ops, fe.u)

    def _slice(lo, hi):
        return wire.ReqBatch(
            kind=kind_col[lo:hi], req_id=rid_col[lo:hi],
            tenant=tenant_col[lo:hi], trace=zeros16[lo:hi],
            deadline_us=zeros32[lo:hi], key=key_col[lo:hi],
            value=val_col[lo:hi])

    # warm the store on a throwaway prefix (kernel builds, allocator)
    # so the floor measures the data plane, not first-call costs
    warm = min(batch, n_ops)
    lb.submit_batch(_slice(0, warm), conn=0)
    while not fe.idle():
        lb.pump()
    retried = 0
    sent = warm
    retry_q: List[wire.ReqBatch] = []

    def _offer(b):
        nonlocal retried
        rb = lb.submit_batch(b, conn=0)
        if len(rb):  # closed-loop: refused rows go around again
            idx = np.nonzero(rb.status == wire.S_RETRY_AFTER)[0]
            if idx.size:
                retried += int(idx.size)
                retry_q.append(b.select(idx))

    t0 = _time.perf_counter()
    while sent < n_ops or retry_q or not fe.idle():
        inflight = fe.requests - fe.responses
        if retry_q:
            _offer(retry_q.pop(0))
        elif sent < n_ops and inflight < batch:
            k = min(batch, n_ops - sent)
            _offer(_slice(sent, sent + k))
            sent += k
        lb.pump()
    seconds = _time.perf_counter() - t0
    verify_columnar(fe)
    measured = n_ops - warm
    return dict(ops=measured, seconds=round(seconds, 6),
                ops_per_sec=round(measured / seconds, 1),
                batch=batch, retried=retried,
                wire_rx_bytes=lb.wire_rx, wire_tx_bytes=lb.wire_tx,
                n_replicas=store.cfg.n_replicas,
                n_sessions=store.cfg.n_sessions)


def _sha(b: bytes) -> str:
    import hashlib

    return hashlib.sha256(b).hexdigest()


def committed_uids(fe: Frontend, lb: LoopbackServer) -> List[tuple]:
    """Write uids the CLIENT saw commit (S_OK puts/rmws) — the
    ``committed_write_lost`` witness set.  The byte log interleaves
    fixed-size single-op responses with variable-size read
    responses; each record's extent comes from its magic + count."""
    import struct

    out = []
    u, vbytes = lb.u, lb.vbytes
    off = 0
    raw = lb.response_log()
    while off + 2 <= len(raw):
        # records are variable even for single ops in heap mode: each
        # record's extent comes from its own magic/count/length prefix
        # (wire.response_extent — the one walker primitive)
        step = wire.response_extent(raw, off, u, vbytes)
        (magic,) = struct.unpack_from("<H", raw, off)
        if magic == wire.RRSP_MAGIC:
            # batched read response: reads never mint uids — skip it
            off += step
            continue
        rsp = wire.decode_response(raw[off: off + step], u, vbytes)
        off += step
        if rsp.status == wire.S_OK and rsp.uid is not None:
            out.append(rsp.uid)
    return out
