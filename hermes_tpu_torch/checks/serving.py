"""The serving gate, the port's ``scripts/check_serving.py``: overload is
shed loudly, deadlines hold, and the serving planes keep their floors.

  1. ``check_engines`` -- the closed-loop capacity probe, then an
     open-loop soak at twice that capacity over the batched and the
     sharded KVS at pipeline depth 2: every request resolved loudly
     (``verify_serving``), the deadline fires, the admitted p99 within the
     deadline and one round, the checker green with
     ``committed_write_lost == []``, and a byte-identical response log
     across two runs;
  2. ``check_fleet`` -- the same envelope through a two-group ``Fleet``:
     the mix spans both groups, every group's checker is green,
     ``verify_fleet`` holds, and no write the client saw commit is lost;
  3. ``check_overload_storm`` -- ``Schedule.overload_storm`` windows burst
     the arrivals of a hot-key soak: the envelope holds and the executed
     chaos log and response log replay byte for byte;
  4. ``check_read_soak`` -- YCSB-B with a ``K_MGET`` batch every 8th
     arrival at twice capacity: loud, ``stale_read == []``; rung 2 keeps
     all-hot batched reads and sheds a batch with a cold key and a scan;
  5. ``check_columnar`` -- the columnar soak under the same envelope and
     its replay, a deadline sub-leg on a throttled store, and the
     columnar floor: ``serving.soak.measure_columnar_floor`` at least 50x
     the scalar baseline cell pinned below, with the port's own scalar
     closed-loop cell measured and reported beside it;
  6. ``check_shm`` -- the one-store soak over real shm rings and its
     replay, the real two-worker one-store topology with a kill -9 of one
     worker, and the one-store floor: ``serving.bench.
     run_one_store_cell(2)`` at least twice the columnar loopback cell,
     both measured in this run, with its topology label.

Both floors are measured here, in the gate's own process on ``--device``;
no file at the root of the repo is read or written.

    python -m hermes_tpu_torch.checks.serving [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import sys

from hermes_tpu_torch import checks

SEED = 14
# tight enough that a 2x-capacity soak's tail crosses it (the deadline
# machinery must fire, not just exist), loose enough that the bulk commits
DEADLINE_US = 8_000
ROUND_US = 1000

# The columnar floor's bar: 50x the scalar closed-loop cell that the JAX
# package measured on its CPU host (pinned on purpose by
# scripts/check_serving.py:445 so the bar does not move with the scalar
# path).  351.8 ops/s is that host's figure, not one of the card.
SCALAR_BASELINE_OPS = 351.8
SCALAR_BASELINE_SOURCE = "pr10_recorded_cell"
COLUMNAR_FLOOR_X = 50.0
# the one-store floor: two shm front ends feeding one store against the
# one-process columnar loopback, cell against cell in this run
ONE_STORE_FLOOR_X = 2.0


def _cfg(n_replicas=4, **over):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    kw = dict(
        n_replicas=n_replicas, n_keys=64, n_sessions=4, replay_slots=6,
        ops_per_session=96, value_words=6, replay_age=6,
        replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
        pipeline_depth=2, op_timeout_rounds=48,
        workload=WorkloadConfig(read_frac=0.5, seed=SEED),
    )
    kw.update(over)
    return HermesConfig(**kw)


def _scfg(**over):
    from hermes_tpu_torch.serving import ServingConfig

    kw = dict(tenant_rate_per_s=200_000.0, tenant_burst=64.0,
              tenant_quota=12, queue_cap=48, round_us=ROUND_US,
              shed_write_frac=0.6, shed_read_frac=0.9)
    kw.update(over)
    return ServingConfig(**kw)


def _store(backend: str, record=True, device="cuda"):
    from hermes_tpu_torch.kvs import KVS

    return KVS(_cfg(), backend=backend, record="array" if record else False,
               device=device)


def _assert_envelope(res: dict, report_key: str, report: dict,
                     require_shed: bool = True,
                     require_deadline: bool = False) -> None:
    """Every op resolved loudly, the tail bounded by the deadline."""
    st = res["statuses"]
    resolved = (res["completed"] + res["deadline"] + st.get("rejected", 0)
                + res["lost"] + st.get("retry_after", 0))
    assert res["ops_offered"] == res["sent"], res
    assert resolved == res["sent"], (
        f"{report_key}: {res['sent']} requests but only {resolved} loud "
        f"resolutions ({st})")
    assert res["lost"] == 0, f"{report_key}: clean soak lost ops ({st})"
    if require_shed:
        assert st.get("retry_after", 0) > 0, (
            f"{report_key}: a >=2x-capacity soak shed nothing: the "
            f"admission path is not engaging ({st})")
    if require_deadline:
        assert res["deadline"] > 0, (
            f"{report_key}: the overload tail never crossed the "
            f"{DEADLINE_US}us deadline: the enforcement path did not "
            f"fire ({st})")
    bound = DEADLINE_US + ROUND_US
    assert res["p99_latency_us"] is not None \
        and res["p99_latency_us"] <= bound, (
        f"{report_key}: admitted-op p99 {res['p99_latency_us']}us exceeds "
        f"the deadline bound {bound}us")
    report[report_key] = {k: v for k, v in res.items()
                          if not k.startswith("_")}


def _check_lost(uids, ops, aborted, what: str) -> None:
    from hermes_tpu_torch.checker import linearizability as lin

    assert uids, f"{what} committed nothing the client saw"
    lost = lin.committed_write_lost(uids, ops, aborted)
    assert not lost, (f"{what}: committed-and-observed writes contradicted "
                      f"by the history: {lost[:4]}")


def _check_history(store, res, what="soak") -> None:
    from hermes_tpu_torch.serving.soak import committed_uids

    v = store.rt.check()
    assert v.ok, f"checker FAIL: {[f.reason[:160] for f in v.failures[:2]]}"
    _check_lost(committed_uids(res["_frontend"], res["_server"]),
                store.rt.history_ops(), store.rt.recorder.aborted_uids, what)


def _uniform():
    from hermes_tpu_torch.workload.openloop import MixSpec

    return MixSpec(name="uniform", tenants=4)


def _capacity(store, spec):
    from hermes_tpu_torch.serving import measure_capacity

    return measure_capacity(store, _scfg(), spec, n=240, seed=SEED)


def check_engines(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.serving import run_open_loop

    for backend in ("batched", "sharded"):
        cap = _capacity(_store(backend, record=False, device=device),
                        _uniform())
        rate = 2.0 * cap["ops_per_vs"]
        shas = []
        for rep in range(2):
            store = _store(backend, device=device)
            res = run_open_loop(store, _scfg(), _uniform(), rate_per_s=rate,
                                n=500, seed=SEED, deadline_us=DEADLINE_US)
            if rep == 0:
                _assert_envelope(res, f"{backend}_soak", report,
                                 require_deadline=True)
                _check_history(store, res)
                report[f"{backend}_soak"]["capacity_probe"] = cap
                report[f"{backend}_soak"]["rate_per_vs"] = rate
            shas.append(res["response_log_sha"])
        assert shas[0] == shas[1], (
            f"{backend}: same seed replayed to a DIFFERENT response log "
            f"({shas})")
        report[f"{backend}_replay_identical"] = True


def check_fleet(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch.config import FleetConfig
    from hermes_tpu_torch.fleet import Fleet, verify_fleet
    from hermes_tpu_torch.serving import run_open_loop
    from hermes_tpu_torch.serving.soak import committed_uids
    from hermes_tpu_torch.workload.openloop import make_mix

    spec = _uniform()
    fcfg = FleetConfig(groups=2, base=_cfg())
    cap = _capacity(Fleet(fcfg, device=device), spec)
    rate = 2.0 * cap["ops_per_vs"]
    fleet = Fleet(fcfg, record="array", device=device)
    res = run_open_loop(fleet, _scfg(), spec, rate_per_s=rate, n=500,
                        seed=SEED, deadline_us=DEADLINE_US)
    _assert_envelope(res, "fleet_soak", report)
    fe = res["_frontend"]
    mix = make_mix(spec, fe.n_keys, 500, SEED, value_words=fe.u)
    gids, _ = fleet.router.locate(np.asarray(mix["key"], np.int64))
    assert set(np.asarray(gids).tolist()) == {0, 1}, "mix spanned one group"
    verdicts = fleet.check()
    assert verdicts["ok"], f"fleet checker FAIL {verdicts}"
    verify_fleet(fleet)
    # the client-visible commits through the router: each a definite
    # committed write in some group's history and aborted in none
    aborted = set()
    for g in fleet.groups:
        aborted |= set(g.rt.recorder.aborted_uids)
    _check_lost(committed_uids(fe, res["_server"]),
                [o for g in fleet.groups for o in g.rt.history_ops()],
                aborted, "fleet soak")
    report["fleet_soak"]["group_verdicts"] = verdicts["groups"]
    report["fleet_soak"]["capacity_probe"] = cap


def storm_soak(device="cuda"):
    """One hot-key soak under ``Schedule.overload_storm``: (summary, the
    executed chaos log)."""
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.serving import run_open_loop
    from hermes_tpu_torch.workload.openloop import (MixSpec, ShapedArrivals,
                                                    hot_set)

    # a real hot-key mix with its hot set handed to the shed ladder, so
    # rung 2's retention is exercised through the storm
    spec = MixSpec(name="hotkey", distribution="hotkey", hot_frac=0.8,
                   hot_keys=4, tenants=4)
    sched = chaos.Schedule.overload_storm(SEED, steps=400, n_windows=2,
                                          x_range=(3.0, 6.0))
    assert len(sched) == 2
    store = _store("batched", device=device)
    arrivals = ShapedArrivals(1200.0, 400, SEED)
    runner = chaos.ChaosRunner(store, chaos.Schedule(list(sched)),
                               load=arrivals)
    res = run_open_loop(store, _scfg(hot_keys=hot_set(spec)), spec,
                        rate_per_s=1200.0, n=400, seed=SEED,
                        deadline_us=DEADLINE_US, chaos_runner=runner,
                        arrivals=arrivals)
    return res, runner.log_json()


def check_overload_storm(report: dict, device="cuda") -> None:
    outs = [storm_soak(device) for _ in range(2)]
    res = outs[0][0]
    _assert_envelope(res, "overload_storm", report, require_shed=False)
    applied = [e for e in json.loads(outs[0][1]) if e["kind"] == "overload"]
    assert applied, "no overload window applied"
    assert outs[0][1] == outs[1][1], "executed chaos logs differ"
    assert outs[0][0]["response_log_sha"] == outs[1][0]["response_log_sha"], \
        "overload-storm response logs differ across replays"
    report["overload_storm"]["windows_applied"] = applied
    report["overload_storm_replay_identical"] = True


def read_soak(device="cuda"):
    """The YCSB-B soak with a ``K_MGET`` batch every 8th arrival at twice
    the probed capacity: (store, frontend, loopback, capacity probe,
    rate, batched reads sent)."""
    from hermes_tpu_torch.serving import (Frontend, LoopbackServer,
                                          VirtualClock, wire)
    from hermes_tpu_torch.workload.openloop import (MixSpec, ShapedArrivals,
                                                    make_mix)
    from hermes_tpu_torch.workload.ycsb import READ_MIXES

    spec = MixSpec(name="ycsb_b", tenants=4, **READ_MIXES["b"])
    cap = _capacity(_store("batched", record=False, device=device), spec)
    rate = 2.0 * cap["ops_per_vs"]
    store = _store("batched", device=device)
    clock = VirtualClock()
    fe = Frontend(store, _scfg(), clock=clock)
    lb = LoopbackServer(fe)
    n = 400
    mix = make_mix(spec, fe.n_keys, n, SEED, value_words=fe.u)
    arrivals = ShapedArrivals(rate, n, SEED)
    round_s = ROUND_US * 1e-6
    sent = mgets = rounds = 0
    while rounds < 200_000:
        for _ in range(arrivals.due(clock.t)):
            if sent >= n:
                break
            i = sent
            sent += 1
            if i % 8 == 7:
                # every 8th arrival is a batched read of 8 mix keys
                ks = [int(k) for k in mix["key"][max(0, i - 8): i]]
                lb.submit(wire.ReadRequest(
                    kind="mget", req_id=i + 1,
                    tenant=int(mix["tenant"][i]), keys=ks or [0],
                    deadline_us=DEADLINE_US))
                mgets += 1
            else:
                lb.submit(wire.Request(
                    kind=("get", "put", "rmw")[int(mix["kind"][i])],
                    req_id=i + 1, tenant=int(mix["tenant"][i]),
                    key=int(mix["key"][i]), deadline_us=DEADLINE_US,
                    value=mix["value"][i].tolist()))
        lb.pump()
        clock.advance(round_s)
        rounds += 1
        if sent >= n and not (fe._intake or fe._pending or fe._abandoned):
            break
    lb.drain()
    return store, fe, lb, cap, rate, mgets


def check_read_soak(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.checker import linearizability as lin
    from hermes_tpu_torch.serving import (Frontend, LoopbackServer,
                                          VirtualClock, verify_serving, wire)
    from hermes_tpu_torch.serving.soak import committed_uids
    from hermes_tpu_torch.workload.openloop import MixSpec, hot_set

    store, fe, lb, cap, rate, mgets = read_soak(device)
    ev = verify_serving(fe)
    assert mgets > 10, "read soak drove no batched reads"
    v = store.rt.check()
    assert v.ok, (f"read soak checker FAIL: "
                  f"{[f.reason[:160] for f in v.failures[:2]]}")
    stale = lin.stale_read(store.rt.history_ops())
    assert not stale, f"read soak produced STALE reads: {stale[:3]}"
    uids = committed_uids(fe, lb)
    lost = lin.committed_write_lost(uids, store.rt.history_ops(),
                                    store.rt.recorder.aborted_uids)
    assert not lost, f"read soak contradicted committed writes: {lost[:3]}"
    report["read_soak"] = dict(
        capacity_probe=cap, rate_per_vs=rate, mget_requests=mgets,
        read_stats=store.read_stats(), **ev)

    # rung 2 through the batched verbs: with the queue jammed past
    # shed_read_frac an all-hot mget still serves, while a batch carrying
    # one cold key sheds (R_SHED_READ), and so does a scan
    spec2 = MixSpec(name="hotkey", distribution="hotkey", hot_keys=4)
    scfg2 = _scfg(hot_keys=hot_set(spec2), queue_cap=16,
                  shed_write_frac=0.3, shed_read_frac=0.5, tenant_quota=32)
    fe2 = Frontend(_store("batched", record=False, device=device), scfg2,
                   clock=VirtualClock())
    lb2 = LoopbackServer(fe2)
    # jam the intake queue past the rung-2 watermark without pumping
    # (hot-key gets admit at every rung, so the jam can build)
    for i in range(int(scfg2.queue_cap * scfg2.shed_read_frac) + 2):
        r = lb2.submit(wire.Request(kind="get", req_id=1000 + i, tenant=0,
                                    key=i % 4))
        assert r is None, "queue jam refused too early"
    hot_rsp = lb2.submit(wire.ReadRequest(kind="mget", req_id=1, tenant=1,
                                          keys=[0, 1, 2, 3]))
    cold_rsp = lb2.submit(wire.ReadRequest(kind="mget", req_id=2, tenant=1,
                                           keys=[0, 1, 2, 40]))
    scan_rsp = lb2.submit(wire.ReadRequest(kind="scan", req_id=3, tenant=1,
                                           lo=0, hi=32))
    assert hot_rsp is None, "rung 2 shed an ALL-HOT batched read"
    assert cold_rsp is not None \
        and cold_rsp.status == wire.S_RETRY_AFTER \
        and cold_rsp.reason == wire.R_SHED_READ, cold_rsp
    assert scan_rsp is not None \
        and scan_rsp.status == wire.S_RETRY_AFTER, scan_rsp
    lb2.drain()
    verify_serving(fe2)
    report["read_rung2"] = dict(hot_admitted=True, cold_shed=True,
                                scan_shed=True)


def columnar_soak(rate: float, record=True, device="cuda", **scfg_over):
    """One columnar soak over the batched store: (store, summary)."""
    from hermes_tpu_torch.serving.soak import run_columnar_soak

    store = _store("batched", record=record, device=device)
    n = 300 if scfg_over else 500
    return store, run_columnar_soak(store, _scfg(**scfg_over), _uniform(),
                                    rate_per_s=rate, n=n, seed=SEED,
                                    deadline_us=DEADLINE_US)


def scalar_cell(device="cuda") -> dict:
    """The port's own scalar closed-loop cell: ``run_serve_bench``'s
    throughput point (window 64, ``host_cfg("throughput", on_card)``,
    its envelope, requests and seed) through a localhost socket."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.serving import ServingConfig
    from hermes_tpu_torch.serving.bench import host_cfg, run_socket_cell
    from hermes_tpu_torch.workload.openloop import MixSpec, scenario_seed

    on_card = device_lib.resolve(device).type == "cuda"
    scfg = ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e5,
                         tenant_quota=64, queue_cap=256)
    return run_socket_cell(host_cfg("throughput", on_card), scfg,
                           MixSpec(name="uniform"), 800 if on_card else 400,
                           mode="closed", window=64, seed=scenario_seed(),
                           device=device)


def check_columnar(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.serving.soak import measure_columnar_floor

    cap = _capacity(_store("batched", record=False, device=device),
                    _uniform())
    rate = 2.0 * cap["ops_per_vs"]
    shas = []
    for rep in range(2):
        store, res = columnar_soak(rate, device=device)
        if rep == 0:
            # the columnar plane drains the 2x-capacity load before the
            # deadline; shed must still engage (the deadline has its own
            # throttled sub-leg below)
            _assert_envelope(res, "columnar_soak", report)
            _check_history(store, res, "columnar soak")
            report["columnar_soak"]["capacity_probe"] = cap
            report["columnar_soak"]["rate_per_vs"] = rate
        shas.append(res["response_log_sha"])
    assert shas[0] == shas[1], (
        f"columnar: same seed replayed to a DIFFERENT response log "
        f"({shas})")
    report["columnar_replay_identical"] = True

    # deadline enforcement: one op in flight at a time, so the intake
    # backs up past the deadline: expiries fire while the rest commit
    _, res = columnar_soak(rate, record=False, device=device,
                           store_inflight_cap=1, tenant_quota=64,
                           queue_cap=256)
    _assert_envelope(res, "columnar_deadline_soak", report,
                     require_shed=False, require_deadline=True)

    # the throughput floor against the pinned bar, the port's own scalar
    # cell measured and reported beside it
    floor = COLUMNAR_FLOOR_X * SCALAR_BASELINE_OPS
    fl = measure_columnar_floor(device=device)
    assert not fl.get("error"), f"columnar floor cell: {fl['error']}"
    scalar = scalar_cell(device)
    assert not scalar["error"], f"scalar cell: {scalar['error']}"
    assert fl["retried"] == 0 or fl["retried"] < fl["ops"], fl
    assert fl["ops_per_sec"] >= floor, (
        f"columnar floor MISSED: {fl['ops_per_sec']} ops/s < "
        f"{COLUMNAR_FLOOR_X:g}x scalar baseline {SCALAR_BASELINE_OPS} "
        f"({floor:.0f}) [{SCALAR_BASELINE_SOURCE}]: {fl}")
    report["columnar_floor"] = dict(
        **fl, scalar_baseline_ops_per_sec=SCALAR_BASELINE_OPS,
        baseline_source=SCALAR_BASELINE_SOURCE,
        required_ops_per_sec=round(floor, 1),
        speedup_vs_scalar=round(fl["ops_per_sec"] / SCALAR_BASELINE_OPS, 1),
        current_scalar_ops_per_sec=scalar["ops_per_sec"],
        speedup_vs_current_scalar=round(
            fl["ops_per_sec"] / scalar["ops_per_sec"], 1),
        scalar_cell={k: scalar[k] for k in (
            "ops", "answered", "wall_s", "ops_per_sec", "statuses",
            "window", "rounds")})


def _shm_batch(cl, u, n_keys, rng, tenant, k=64):
    import numpy as np

    from hermes_tpu_torch.serving import wire

    kind = np.where(rng.random(k) < 0.5, wire.K_GET,
                    wire.K_PUT).astype(np.uint8)
    return wire.ReqBatch(
        kind=kind, req_id=cl.next_ids(k),
        tenant=np.full(k, tenant, np.uint16), trace=np.zeros(k, np.uint16),
        deadline_us=np.zeros(k, np.uint32),
        key=rng.integers(0, n_keys, k).astype(np.int64),
        value=rng.integers(0, 99, (k, u)).astype(np.int32))


def _clients_on_both_workers(srv, rng, n_keys, n_clients=4,
                             attempts=64):
    """``n_clients`` columnar clients, at least one on each of the
    server's two workers.  The kernel's SO_REUSEPORT hash places a
    connection; a client's first batch (64 rows, answered) shows which
    worker's ring took it.  Returns [(client, worker)] and the rows they
    were answered."""
    from hermes_tpu_torch.serving.rpc import ColumnarClient

    placed, spare, answered = [], [], 0
    for _ in range(attempts):
        cl = ColumnarClient(srv.addr, srv.fe.u)
        before = list(srv.owner.rows_by_worker)
        out = cl.call_batch(_shm_batch(cl, srv.fe.u, n_keys, rng,
                                       len(placed) + len(spare)))
        assert len(out) == 64, "one-store round trip dropped rows"
        moved = [w for w, (a, b) in enumerate(
            zip(before, srv.owner.rows_by_worker)) if b > a]
        assert len(moved) == 1, f"one batch reached workers {moved}"
        answered += 64
        on = {w for _, w in placed}
        if len(placed) < n_clients - 1 or moved[0] not in on or len(on) > 1:
            placed.append((cl, moved[0]))
        else:  # the last place is kept for the other worker
            spare.append(cl)
        if len(placed) == n_clients:
            break
    for cl in spare:
        cl.close()
    assert len({w for _, w in placed}) == 2, (
        f"{attempts} connections never reached both workers")
    return placed, answered


def one_store_topology(device="cuda") -> dict:
    """Two shm worker processes sharding accepts on one port, feeding ONE
    store: 4 clients (at least one on each worker) push 4,096 rows
    (twice the rings' slot room), then worker 0 is SIGKILLed; the clients
    on worker 1 keep being answered and those on worker 0 see EOF."""
    import os
    import signal
    import time

    import numpy as np

    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving import wire
    from hermes_tpu_torch.serving.ipc import OneStoreServer

    cfg = HermesConfig(n_replicas=4, n_keys=1 << 10, n_sessions=64,
                       value_words=6)
    scfg = _scfg(tenant_rate_per_s=1e9, tenant_burst=1e9,
                 tenant_quota=1 << 20, queue_cap=4096)
    srv = OneStoreServer(KVS(cfg, device=device), scfg, n_workers=2,
                         nslots=8, slot_rows=128)
    rng = np.random.default_rng(SEED)
    retried = 0
    try:
        assert srv.alive() == 2, "one-store server booted short"
        placed, answered = _clients_on_both_workers(srv, rng, cfg.n_keys)
        for _ in range(16):  # 4 clients x 16 batches x 64 = 4096 rows
            for ci, (cl, _w) in enumerate(placed):
                out = cl.call_batch(
                    _shm_batch(cl, srv.fe.u, cfg.n_keys, rng, ci))
                assert len(out) == 64, "one-store round trip dropped rows"
                for r in out.values():
                    assert r.status in (wire.S_OK, wire.S_RETRY_AFTER), r
                    answered += 1
                    retried += r.status == wire.S_RETRY_AFTER
        os.kill(srv.procs[0].pid, signal.SIGKILL)
        srv.procs[0].join(5)
        assert srv.alive() == 1, "SIGKILL left the worker alive"
        time.sleep(0.5)
        survived = eof = 0
        for ci, (cl, w) in enumerate(placed):
            try:
                out = cl.call_batch(
                    _shm_batch(cl, srv.fe.u, cfg.n_keys, rng, ci))
                assert len(out) == 64 and w == 1, (
                    "a client of the killed worker was answered")
                survived += 1
            except (ConnectionError, OSError):
                assert w == 0, "a client of the live worker saw EOF"
                eof += 1
        assert survived >= 1 and survived + eof == 4, (
            f"worker kill: {survived} survived + {eof} EOF != 4 clients")
        assert srv.pump_error is None, srv.pump_error
        for cl, _w in placed:
            cl.close()
    finally:
        srv.close()
    assert srv.owner.dead[0] and not srv.owner.dead[1], (
        "owner did not tombstone exactly the killed worker")
    assert srv.fe.requests == srv.fe.responses, (
        f"one-store conservation broke across the worker kill: "
        f"{srv.fe.requests} requests vs {srv.fe.responses} responses")
    return dict(workers=2, clients=4, rows_answered=answered,
                retry_after=int(retried), kill_survived=survived,
                kill_eof=eof, ipc=srv.owner.counters(),
                requests=srv.fe.requests, responses=srv.fe.responses)


def one_store_floor(loopback: dict, one_store: dict) -> dict:
    """The one-store floor's verdict on two cells of this run: the
    one-store cell carries no error and its label, and sustains
    ``ONE_STORE_FLOOR_X`` times the columnar loopback cell."""
    assert loopback.get("ops_per_sec") and not loopback.get("error"), (
        f"columnar loopback cell missing or error-carrying: {loopback}")
    assert one_store.get("ops_per_sec") and not one_store.get("error"), (
        f"one_store_workers_2 cell missing or error-carrying: {one_store}")
    assert one_store.get("topology") == "one-store", (
        f"one_store_workers_2 lost its topology label: {one_store}")
    ratio = float(one_store["ops_per_sec"]) / float(loopback["ops_per_sec"])
    assert ratio >= ONE_STORE_FLOOR_X, (
        f"one_store floor MISSED: one_store_workers_2 "
        f"{one_store['ops_per_sec']} ops/s is only {ratio:.2f}x the "
        f"columnar_loopback cell {loopback['ops_per_sec']} (need >= "
        f"{ONE_STORE_FLOOR_X:g}x)")
    return dict(ops_per_sec=one_store["ops_per_sec"],
                loopback_ops_per_sec=loopback["ops_per_sec"],
                speedup_vs_loopback=round(ratio, 2),
                required_speedup=ONE_STORE_FLOOR_X,
                workers=one_store.get("workers"),
                topology=one_store.get("topology"),
                statuses=one_store.get("statuses"))


def check_shm(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.serving.bench import run_one_store_cell
    from hermes_tpu_torch.serving.ipc import run_shm_soak
    from hermes_tpu_torch.serving.soak import measure_columnar_floor

    # the deterministic one-store soak over real shm rings: 2 workers, 4
    # slots of 64 rows a ring, 512 ops a worker (twice the rings' room,
    # so every slot cycles and the ring-full skip path engages)
    runs = [run_shm_soak(n_workers=2, ops_per_worker=512, batch=64,
                         nslots=4, seed=SEED, device=device)
            for _ in range(2)]
    a = runs[0]
    assert a["ok"] and a["checker_ok"], a
    assert a["worker_log_sha"] == runs[1]["worker_log_sha"], (
        "shm soak replayed to DIFFERENT per-worker response logs "
        f"({a['worker_log_sha']} vs {runs[1]['worker_log_sha']})")
    assert a["ipc"] == runs[1]["ipc"] \
        and a["verify"] == runs[1]["verify"], (
        "shm soak counters differ across replays")
    ipc, ver = a["ipc"], a["verify"]
    assert ipc["rows_in"] == ipc["rows_out"] == 1024, ipc
    assert ipc["torn_slots"] == 0 and ipc["dead_drop_rows"] == 0, ipc
    assert ipc["dead_workers"] == [], ipc
    # conservation across the ring boundary
    assert ver["requests"] == ver["responses"] == 1024, ver
    assert ver["lost"] == 0, ver
    store = a["_store"]
    _check_lost(a["_client_uids"], store.rt.history_ops(),
                store.rt.recorder.aborted_uids, "shm soak")
    report["shm_soak"] = {k: v for k, v in a.items()
                          if not k.startswith("_")}
    report["shm_replay_identical"] = True
    report["one_store_topology"] = one_store_topology(device)
    loopback = measure_columnar_floor(seed=SEED, device=device)
    one_store = run_one_store_cell(2, seed=SEED, device=device)
    report["one_store_cells"] = dict(columnar_loopback=loopback,
                                     one_store_workers_2=one_store)
    report["one_store_floor"] = one_store_floor(loopback, one_store)


LEGS = (check_engines, check_fleet, check_overload_storm, check_read_soak,
        check_columnar, check_shm)


def main(argv=None) -> int:
    return checks.run_legs("serving", LEGS, argv, "serving", __doc__)


if __name__ == "__main__":
    sys.exit(main())
