"""Serving-path benchmark cells: the port of
``hermes_tpu/serving/bench.py`` (the reference's BENCH_LATENCY.json
payload).

End-to-end honesty: every latency here is measured AT THE CLIENT SOCKET
(t_send just before the framed request hits the socket, t_recv when the
framed response decodes) through a real localhost ``TcpRpcServer`` —
not a dispatch-loop estimate.  Two operating points:

  * ``latency`` — a small store at ``pipeline_depth=2`` (the serving
    pipeline's latency end), open loop at a moderate rate: what one op
    costs the client wall-to-wall.  Its verdict field compares its p50
    with the reference's 28 ms dispatch-loop figure
    (``DISPATCH_LOOP_P50_MS``).
  * ``throughput`` — windowed closed loop (W ops in flight), larger
    session count: the serving rate the socket path sustains, with the
    same client-side percentiles.

The scenario matrix runs the latency point over the uniform / zipfian /
hot-key mixes (seed anchored to CHECKED_ZIPFIAN.json).  Every cell
builds its store on ``device=`` (default the card, ``"cpu"`` for the
tests); CPU cells run reduced shapes (``host_cfg(mode, on_card=False)``)
and the payload says so in its ``note``.  A cell that lost requests,
workers or its server says so in its ``error`` field.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from hermes_tpu_torch.serving import wire
from hermes_tpu_torch.serving.rpc import RpcClient, TcpRpcServer
from hermes_tpu_torch.serving.server import Frontend, ServingConfig
from hermes_tpu_torch.workload.openloop import (MixSpec, make_mix,
                                                poisson_arrivals,
                                                scenario_matrix,
                                                scenario_seed)


# the reference's dispatch-loop p50 commit figure (its BENCH_r05,
# rounds_per_dispatch=50, measured on a TPU) that its latency point is
# gated against; kept so the port's payload carries the same verdict
# field — it is a TPU number, not one of the port's
DISPATCH_LOOP_P50_MS = 28.0


def improves_dispatch_loop(p50_us: Optional[float]) -> bool:
    return p50_us is not None and p50_us < DISPATCH_LOOP_P50_MS * 1e3


def host_cfg(mode: str, on_card: bool = False):
    """Operating-point store shapes.  CPU cells are reduced (the full
    bench shape is hours of CPU); on the card they are the reference's
    on-chip shapes: 8 replicas, 2^10 keys x 8 sessions for latency and
    2^20 keys x 4,096 sessions for throughput."""
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    kw = dict(value_words=8, replay_slots=16, ops_per_session=64,
              pipeline_depth=2, op_timeout_rounds=64,
              workload=WorkloadConfig(read_frac=0.5, seed=0))
    if mode == "latency":
        kw.update(n_replicas=8 if on_card else 4, n_keys=1 << 10,
                  n_sessions=8)
    else:
        kw.update(n_replicas=8 if on_card else 4,
                  n_keys=1 << (20 if on_card else 12),
                  n_sessions=4096 if on_card else 64)
    return HermesConfig(**kw)


def _pctl(sorted_vals: List[float], q: float) -> Optional[float]:
    from hermes_tpu_torch.stats import percentile_nearest_rank

    return percentile_nearest_rank(sorted_vals, q)


def _mk_reqs(client: RpcClient, mix: dict, n: int,
             deadline_us: int) -> List[wire.Request]:
    return [wire.Request(
        kind=("get", "put", "rmw")[int(mix["kind"][i])],
        req_id=client.next_id(), tenant=int(mix["tenant"][i]),
        key=int(mix["key"][i]), deadline_us=deadline_us,
        value=mix["value"][i].tolist()) for i in range(n)]


def run_socket_cell(cfg, scfg: ServingConfig, spec: MixSpec, n: int,
                    mode: str, rate_per_s: float = 0.0, window: int = 16,
                    deadline_us: int = 0, seed: int = 14,
                    warmup: int = 16, device="cuda") -> dict:
    """One measured socket cell: spin a TcpRpcServer over a fresh KVS,
    drive ``n`` ops (open-loop at ``rate_per_s``, or closed-loop with
    ``window`` in flight), return client-socket percentiles and the
    store's rounds."""
    from hermes_tpu_torch.kvs import KVS

    kvs = KVS(cfg, device=device)
    fe = Frontend(kvs, scfg)
    server = TcpRpcServer(fe)
    lat_by_status: Dict[str, List[float]] = {}
    statuses: Dict[str, int] = {}
    try:
        client = RpcClient(server.addr, fe.u)
        warm_mix = make_mix(spec, fe.n_keys, warmup, seed ^ 0xBEEF,
                            value_words=fe.u)
        for req in _mk_reqs(client, warm_mix, warmup, 0):
            client.send(req)
            client.recv_next()
        mix = make_mix(spec, fe.n_keys, n, seed, value_words=fe.u)
        reqs = _mk_reqs(client, mix, n, deadline_us)
        t_send: Dict[int, float] = {}
        t_recv: Dict[int, float] = {}
        rsp_of: Dict[int, wire.Response] = {}

        def recv_loop():
            # daemon thread: the socket may be closed under it when the
            # main thread gives up (join timeout on a slow host) — exit
            # quietly and let the cell report partial counts
            try:
                while len(t_recv) < n:
                    rsp = client.recv_next()
                    if rsp is None:
                        return
                    rsp_of[rsp.req_id] = rsp
                    t_recv[rsp.req_id] = time.perf_counter()
            except OSError:
                return

        t0 = time.perf_counter()
        if mode == "open":
            arr = poisson_arrivals(rate_per_s, n, seed)
            rx = threading.Thread(target=recv_loop, daemon=True)
            rx.start()
            for i, req in enumerate(reqs):
                lead = t0 + arr[i] - time.perf_counter()
                if lead > 0:
                    time.sleep(lead)
                t_send[req.req_id] = time.perf_counter()
                try:
                    client.send(req)
                except OSError:
                    break  # stream died: the error field reports the loss
            rx.join(timeout=60.0)
        else:  # closed loop, window in flight
            inflight = 0
            cursor = 0
            try:
                while len(t_recv) < n:
                    while inflight < window and cursor < n:
                        req = reqs[cursor]
                        cursor += 1
                        t_send[req.req_id] = time.perf_counter()
                        client.send(req)
                        inflight += 1
                    rsp = client.recv_next()
                    if rsp is None:
                        break
                    t_recv[rsp.req_id] = time.perf_counter()
                    rsp_of[rsp.req_id] = rsp
                    inflight -= 1
            except OSError:
                pass  # timeout / reset mid-run: report the partial cell
                # through the error field instead of crashing the bench
        wall = time.perf_counter() - t0
        client.close()
    finally:
        server.close()
    # a cell that lost its server mid-run must say so — percentiles over
    # an answered prefix would otherwise pass for a clean measurement
    err = None
    if server.pump_error is not None:
        err = f"server pump died: {server.pump_error!r}"
    elif len(t_recv) < n:
        err = f"answered {len(t_recv)}/{n} ops (stream died or client gave up)"
    for rid, t1 in list(t_recv.items()):
        rsp = rsp_of[rid]
        statuses[rsp.status_name] = statuses.get(rsp.status_name, 0) + 1
        lat_by_status.setdefault(rsp.status_name, []).append(
            (t1 - t_send[rid]) * 1e6)
    served = sorted(lat_by_status.get("ok", [])
                    + lat_by_status.get("rmw_abort", []))
    every = sorted(x for v in lat_by_status.values() for x in v)
    return dict(
        mode=mode, scenario=spec.name, ops=n, answered=len(t_recv),
        wall_s=round(wall, 4),
        ops_per_sec=round(len(t_recv) / max(wall, 1e-9), 1),
        statuses=statuses,
        p50_us=None if not served else round(_pctl(served, 0.5), 1),
        p99_us=None if not served else round(_pctl(served, 0.99), 1),
        p50_all_us=None if not every else round(_pctl(every, 0.5), 1),
        p99_all_us=None if not every else round(_pctl(every, 0.99), 1),
        rate_per_s=rate_per_s if mode == "open" else None,
        window=window if mode != "open" else None,
        pipeline_depth=cfg.pipeline_depth,
        rounds=kvs.rt.step_idx,
        error=err,
    )


def measure_decode_rate(n: int = 4096, u: int = 6, reps: int = 20,
                        seed: int = 14) -> dict:
    """Columnar wire-decode bandwidth: one drained-buffer
    request stream of ``n`` records decoded into columns per rep,
    best-of-``reps`` wall time -> MB/s.  The number the tentpole's
    one-numpy-pass claim is accountable to."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = wire.ReqBatch(
        kind=rng.choice([wire.K_GET, wire.K_PUT, wire.K_RMW], n)
            .astype(np.uint8),
        req_id=np.arange(1, n + 1, dtype=np.uint32),
        tenant=rng.integers(0, 8, n).astype(np.uint16),
        trace=np.zeros(n, np.uint16),
        deadline_us=np.zeros(n, np.uint32),
        key=rng.integers(0, 1 << 10, n).astype(np.int64),
        value=rng.integers(-99, 99, (n, u)).astype(np.int32))
    raw = wire.encode_request_batch(b, u)
    wire.decode_request_batch(raw, u)  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        wire.decode_request_batch(raw, u)
        best = min(best, time.perf_counter() - t0)
    return dict(records=n, bytes=len(raw),
                decode_us=round(best * 1e6, 1),
                mb_per_s=round(len(raw) / best / 1e6, 1),
                records_per_s=round(n / best, 1))


def run_columnar_worker_cell(n_workers: int, n_ops: int = 4096,
                             batch: int = 256, seed: int = 14,
                             device="cuda") -> dict:
    """Closed-loop columnar ops/s through ``n_workers`` accept-sharded
    worker PROCESSES (SO_REUSEPORT, launch.start_serve_workers): one
    client thread per worker, each driving framed columnar batches over
    its own connection.  Error-field honesty: a cell that lost workers
    or clients mid-run says so instead of reporting a partial rate."""
    import numpy as np

    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.launch import start_serve_workers
    from hermes_tpu_torch.serving.rpc import ColumnarClient
    from hermes_tpu_torch.workload.openloop import make_mix

    cfg = HermesConfig(
        n_replicas=4, n_keys=64, n_sessions=64, value_words=8,
        pipeline_depth=2, workload=WorkloadConfig(read_frac=0.5, seed=seed))
    scfg = ServingConfig(tenant_rate_per_s=1e9, tenant_burst=1e9,
                         tenant_quota=4 * batch, queue_cap=4 * batch)
    u = cfg.value_words - 2
    spec = MixSpec(read_frac=0.5, rmw_frac=0.1, tenants=4)
    per_client = n_ops // n_workers
    err: List[str] = []
    answered = [0] * n_workers
    try:
        fleet = start_serve_workers(n_workers, cfg=cfg, scfg=scfg,
                                    device=device)
    except Exception as e:  # noqa: BLE001 — no SO_REUSEPORT, boot fail
        return dict(workers=n_workers, ops=n_ops, answered=0,
                    ops_per_sec=None, error=f"worker boot failed: {e!r}")
    # warmup happens OUTSIDE the timed wall: each client warms its own
    # worker's store (one batch through its own connection: kernel
    # builds, the allocator), then everyone meets at the barrier and the
    # clock starts
    gate = threading.Barrier(n_workers + 1, timeout=180.0)
    try:
        def client_loop(w: int) -> None:
            try:
                cl = ColumnarClient(fleet.addr, u)
                mix = make_mix(spec, cfg.n_keys, per_client,
                               seed + 101 * w, value_words=u)
                kind = (np.asarray(mix["kind"], np.uint8) + 1)
                key = np.asarray(mix["key"], np.int64)
                ten = np.asarray(mix["tenant"], np.uint16)
                val = np.asarray(mix["value"], np.int32
                                 ).reshape(per_client, u)

                def shoot(lo: int, hi: int) -> int:
                    k = hi - lo
                    b = wire.ReqBatch(
                        kind=kind[lo:hi], req_id=cl.next_ids(k),
                        tenant=ten[lo:hi], trace=np.zeros(k, np.uint16),
                        deadline_us=np.zeros(k, np.uint32),
                        key=key[lo:hi], value=val[lo:hi])
                    return len(cl.call_batch(b))

                shoot(0, min(batch, per_client))  # warm, untimed
                gate.wait()
                for lo in range(0, per_client, batch):
                    answered[w] += shoot(lo, min(lo + batch, per_client))
                cl.close()
            except Exception as e:  # noqa: BLE001
                err.append(f"client {w}: {e!r}")
                try:
                    gate.abort()
                except Exception:  # noqa: BLE001
                    pass

        threads = [threading.Thread(target=client_loop, args=(w,),
                                    daemon=True) for w in range(n_workers)]
        for t in threads:
            t.start()
        try:
            gate.wait()
        except threading.BrokenBarrierError:
            pass  # a client died warming up; its err entry says why
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=120.0)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            err.append("client thread(s) still running at join timeout")
        if fleet.alive() < n_workers:
            err.append(f"only {fleet.alive()}/{n_workers} workers alive "
                       "at the end of the run")
    finally:
        fleet.stop()
    total = sum(answered)
    if total < n_workers * per_client:
        err.append(f"answered {total}/{n_workers * per_client} ops")
    return dict(
        workers=n_workers, ops=n_workers * per_client, answered=total,
        batch=batch, wall_s=round(wall, 4),
        ops_per_sec=None if err else round(total / max(wall, 1e-9), 1),
        # honesty label: these cells scale because every
        # worker owns a PRIVATE store — N CUDA contexts, not one.
        # The shared-store numbers live in the one_store_workers_N
        # cells (run_one_store_cell).
        topology="private-store-per-worker",
        error="; ".join(err) if err else None)


def _one_store_client_main(w: int, addr, u: int, n_keys: int,
                           per_client: int, batch: int, seed: int,
                           ready_q, go_ev, out_q) -> None:
    """One closed-loop bench client PROCESS for the one-store cell
    (module-level so ``spawn`` can import it).  Client processes — not
    threads — keep the parent's GIL free for the owner pump, so the
    cell measures the shm plane, not client-side encode contention."""
    import numpy as np

    from hermes_tpu_torch.serving.rpc import ColumnarClient
    from hermes_tpu_torch.workload.openloop import MixSpec, make_mix

    try:
        cl = ColumnarClient(addr, u)
        spec = MixSpec(read_frac=0.5, rmw_frac=0.1, tenants=4)
        n_mix = per_client + batch  # one extra untimed warmup batch
        mix = make_mix(spec, n_keys, n_mix, seed + 101 * w,
                       value_words=u)
        kind = (np.asarray(mix["kind"], np.uint8) + 1)
        key = np.asarray(mix["key"], np.int64)
        ten = np.asarray(mix["tenant"], np.uint16)
        val = np.asarray(mix["value"], np.int32).reshape(n_mix, u)

        def _encode(lo: int, hi: int) -> bytes:
            k = hi - lo
            return wire.encode_request_batch(wire.ReqBatch(
                kind=kind[lo:hi], req_id=cl.next_ids(k),
                tenant=ten[lo:hi], trace=np.zeros(k, np.uint16),
                deadline_us=np.zeros(k, np.uint32),
                key=key[lo:hi], value=val[lo:hi]), u)

        # pre-encode every frame OUTSIDE the timed window, and stay
        # columnar on the receive side (row counts off RspBatch, no
        # per-row Response objects): on a small host the clients share
        # cores with the owner pump, so client-side per-op Python is
        # time STOLEN from the store
        frames = [(_encode(lo, min(lo + batch, n_mix)),
                   min(lo + batch, n_mix) - lo)
                  for lo in range(0, n_mix, batch)]
        warm_raw, warm_rows = frames[0]
        cl.fsock.send(warm_raw)
        got = 0
        while got < warm_rows:
            rb = cl.recv_batch()
            if rb is None:
                raise ConnectionError("server closed during warmup")
            got += len(rb)
        statuses = np.zeros(256, np.int64)
        ready_q.put(w)
        go_ev.wait()
        # closed loop at window 2: one batch resolving while the next
        # is already on the wire, so the owner's merge never starves
        # between a client's batches
        t0 = time.perf_counter()
        n = 0
        outstanding = 0
        cursor = 1  # frame 0 was the warmup
        total = sum(rows for _, rows in frames[1:])
        while n < total:
            while cursor < len(frames) and outstanding < 2 * batch:
                raw, rows = frames[cursor]
                cl.fsock.send(raw)
                outstanding += rows
                cursor += 1
            rb = cl.recv_batch()
            if rb is None:
                raise ConnectionError("server closed mid-run")
            k = len(rb)
            n += k
            outstanding -= k
            statuses += np.bincount(rb.status, minlength=256)
        wall = time.perf_counter() - t0
        st = {wire.STATUS_NAMES.get(i, str(i)): int(c)
              for i, c in enumerate(statuses) if c}
        out_q.put((w, n, wall, None, st))
        cl.close()
    except Exception as e:  # noqa: BLE001 — the cell reports it
        out_q.put((w, 0, 0.0, repr(e), {}))


def run_one_store_cell(n_workers: int, n_clients: Optional[int] = None,
                       n_ops: int = 131072, batch: int = 2048,
                       n_sessions: int = 2048, n_keys: int = 2048,
                       seed: int = 14, device="cuda") -> dict:
    """Closed-loop columnar ops/s through ``n_workers`` shm front-end
    processes feeding ONE store (serving/ipc.py) — the
    shared-store counterpart of ``run_columnar_worker_cell``'s
    private-store scale-out, quoted against ``columnar_loopback``.  Client PROCESSES
    drive framed columnar batches over SO_REUSEPORT-sharded sockets;
    the parent runs only the owner pump.  The store is the scale-out
    shape (``n_sessions`` lanes): the whole point of the plane is that
    one process's socket work cannot feed a large store — the loopback
    floor's 128-session shape would cap the cell at the client edge,
    not the store.  Error-field honesty as everywhere: lost workers,
    short counts, or a pump error make the cell say so instead of
    quoting a partial rate.  The cell also returns the store's rounds
    and the frontend's request and response counts."""
    import multiprocessing as mp
    import queue as _queue

    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving.ipc import OneStoreServer

    n_clients = n_clients or 2 * n_workers
    per_client = n_ops // n_clients
    cfg = HermesConfig(
        n_replicas=4, n_keys=n_keys, n_sessions=n_sessions,
        value_words=8, pipeline_depth=2,
        workload=WorkloadConfig(read_frac=0.5, seed=seed))
    scfg = ServingConfig(tenant_rate_per_s=1e9, tenant_burst=1e9,
                         tenant_quota=1 << 20,
                         queue_cap=4 * batch * n_clients)
    err: List[str] = []
    store = KVS(cfg, device=device)
    try:
        srv = OneStoreServer(store, scfg, n_workers=n_workers,
                             nslots=8, slot_rows=batch)
    except Exception as e:  # noqa: BLE001 — no SO_REUSEPORT, boot fail
        return dict(workers=n_workers, clients=n_clients, ops=n_ops,
                    answered=0, ops_per_sec=None, topology="one-store",
                    error=f"one-store boot failed: {e!r}")
    ctx = mp.get_context("spawn")
    ready_q, out_q, go_ev = ctx.Queue(), ctx.Queue(), ctx.Event()
    clients = [ctx.Process(
        target=_one_store_client_main,
        args=(c, srv.addr, srv.fe.u, cfg.n_keys, per_client, batch,
              seed, ready_q, go_ev, out_q),
        daemon=True) for c in range(n_clients)]
    answered = 0
    walls: List[float] = []
    try:
        for p in clients:
            p.start()
        ready = 0
        while ready < n_clients:
            try:
                ready_q.get(timeout=180.0)
                ready += 1
            except _queue.Empty:
                err.append(f"only {ready}/{n_clients} clients warmed up")
                break
        go_ev.set()
        t0 = time.perf_counter()
        statuses: Dict[str, int] = {}
        for _ in range(ready):
            try:
                _w, n, wall, e, st = out_q.get(timeout=300.0)
            except _queue.Empty:
                err.append("client result(s) missing at timeout")
                break
            answered += n
            walls.append(wall)
            for name, c in st.items():
                statuses[name] = statuses.get(name, 0) + c
            if e is not None:
                err.append(f"client {_w}: {e}")
        parent_wall = time.perf_counter() - t0
        for p in clients:
            p.join(timeout=10.0)
        if srv.alive() < n_workers:
            err.append(f"only {srv.alive()}/{n_workers} workers alive "
                       "at the end of the run")
        if srv.pump_error is not None:
            err.append(f"owner pump died: {srv.pump_error!r}")
    finally:
        for p in clients:
            if p.is_alive():
                p.terminate()
        srv.close()
    if answered < n_clients * per_client:
        err.append(f"answered {answered}/{n_clients * per_client} ops")
    # rate over the slowest client's closed-loop wall: every client ran
    # the whole window, so total/max(wall) is the sustained aggregate
    wall = max(walls) if walls else parent_wall
    ipc = srv.owner.counters()
    return dict(
        workers=n_workers, clients=n_clients,
        ops=n_clients * per_client, answered=answered, batch=batch,
        n_sessions=n_sessions, n_keys=n_keys, wall_s=round(wall, 4),
        ops_per_sec=None if err else round(answered / max(wall, 1e-9), 1),
        topology="one-store", statuses=statuses, ipc=ipc,
        rounds=store.rt.step_idx, requests=srv.fe.requests,
        responses=srv.fe.responses,
        error="; ".join(err) if err else None)


def run_serve_bench(n: Optional[int] = None, seed: Optional[int] = None,
                    scenarios: bool = True, device="cuda",
                    columnar: bool = True) -> dict:
    """The BENCH_LATENCY payload: latency + throughput operating points
    (client-socket truth) and the scenario matrix on the latency point,
    every store on ``device=`` (the card unless the caller asks for the
    CPU; raises when the card is asked for and absent).  ``columnar=
    False`` leaves out the columnar and one-store cells."""
    import torch

    from hermes_tpu_torch.device import resolve

    dev = resolve(device)
    on_card = dev.type == "cuda"
    seed = scenario_seed() if seed is None else seed
    n = (400 if on_card else 200) if n is None else n
    scfg = ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e5,
                         tenant_quota=64, queue_cap=256)
    lat_cfg = host_cfg("latency", on_card)
    thr_cfg = host_cfg("throughput", on_card)
    # moderate open-loop rate for the latency point: well under the
    # closed-loop capacity so queueing delay does not pollute the
    # service-latency number (overload truth lives in the serving gate)
    cells = {}
    probe = run_socket_cell(lat_cfg, scfg, MixSpec(name="uniform"),
                            max(32, n // 4), mode="closed", window=8,
                            seed=seed, device=device)
    cap = probe["ops_per_sec"]
    cells["latency"] = run_socket_cell(
        lat_cfg, scfg, MixSpec(name="uniform"), n, mode="open",
        rate_per_s=max(10.0, 0.2 * cap), seed=seed, device=device)
    cells["throughput"] = run_socket_cell(
        thr_cfg, scfg, MixSpec(name="uniform"), 2 * n, mode="closed",
        window=64, seed=seed, device=device)
    # columnar cells: wire-decode bandwidth, the in-process
    # loopback floor, and accept-sharded worker scaling at 1/2/4
    # workers — each quoted against the scalar throughput cell above
    scalar_ops = cells["throughput"]["ops_per_sec"] or 0.0
    if columnar:
        _columnar_cells(cells, scalar_ops, seed, device)
    out = dict(
        cells=cells, capacity_probe=probe,
        dispatch_loop_p50_ms=DISPATCH_LOOP_P50_MS,
        latency_p50_improves=improves_dispatch_loop(
            cells["latency"]["p50_us"]),
        platform="gpu" if on_card else "cpu",
        device=(torch.cuda.get_device_name(dev) if on_card else "cpu"),
        seed=seed,
        note="p50/p99 measured from the client socket (framed RPC over "
             "localhost TCP), NOT dispatch-loop estimates; "
             "dispatch_loop_p50_ms is the reference's dispatch-loop "
             "figure (a TPU number) the verdict field compares with",
    )
    if scenarios:
        mat = {}
        for spec in scenario_matrix():
            mat[spec.name] = run_socket_cell(
                lat_cfg, scfg, spec, max(64, n // 2), mode="open",
                rate_per_s=max(10.0, 0.2 * cap), seed=seed, device=device)
        out["scenarios"] = mat
    bad = {name: c["error"]
           for name, c in [("capacity_probe", probe), *cells.items(),
                           *out.get("scenarios", {}).items()]
           if c.get("error")}
    if bad:
        out["errors"] = bad
    if not on_card:
        out["note"] += ("; CPU run at reduced shapes (host_cfg "
                        "on_card=False), not a measurement of the card")
    return out


def _columnar_cells(cells: dict, scalar_ops: float, seed: int,
                    device) -> None:
    """The columnar cells of ``run_serve_bench``: wire-decode bandwidth,
    the in-process loopback floor, accept-sharded worker scaling at
    1/2/4 workers and the one-store cells at 2/4 workers — each quoted
    against the scalar throughput cell."""
    cells["columnar_decode"] = measure_decode_rate(seed=seed)
    try:
        from hermes_tpu_torch.serving.soak import measure_columnar_floor

        fl = measure_columnar_floor(seed=seed, device=device)
        fl["speedup_vs_scalar"] = round(
            fl["ops_per_sec"] / max(scalar_ops, 1e-9), 1)
        fl["scalar_ops_per_sec"] = scalar_ops
        cells["columnar_loopback"] = fl
    except Exception as e:  # noqa: BLE001 — recorded, and any cell
        # whose error is set fails the run that reads it
        cells["columnar_loopback"] = dict(ops_per_sec=None,
                                          error=f"floor failed: {e!r}")
    for w in (1, 2, 4):
        c = run_columnar_worker_cell(w, seed=seed, device=device)
        if c["ops_per_sec"] is not None:
            c["speedup_vs_scalar"] = round(
                c["ops_per_sec"] / max(scalar_ops, 1e-9), 1)
        cells[f"columnar_workers_{w}"] = c
    # one-store cells: N shm front-end processes feeding ONE store
    # (the shared-store truth the private-store cells above are not),
    # quoted against the loopback floor, the single-process ceiling the
    # plane exists to beat
    floor_ops = cells["columnar_loopback"].get("ops_per_sec") or 0.0
    for w in (2, 4):
        c = run_one_store_cell(w, seed=seed, device=device)
        if c["ops_per_sec"] is not None:
            c["speedup_vs_scalar"] = round(
                c["ops_per_sec"] / max(scalar_ops, 1e-9), 1)
            c["speedup_vs_loopback"] = round(
                c["ops_per_sec"] / max(floor_ops, 1e-9), 2)
            c["loopback_ops_per_sec"] = floor_ops
        cells[f"one_store_workers_{w}"] = c
