"""The port's serving front end (hermes_tpu_torch/serving: the wire
codecs, admission, ``Frontend``, the loopback and TCP RPC paths, the
open-loop soak) and its load shapes (workload/openloop.py) against the
reference's (hermes_tpu/serving, hermes_tpu/workload/openloop.py), case
for case with ``tests/test_serving.py`` at its shapes and seeds.

Every drive runs on both packages with the same arguments (the port on
the CPU) and must give the reference's wire bytes: equal encodings,
equal admission verdicts, token-bucket state and per-tenant counters,
equal response byte logs (``response_log_sha``) of the open-loop soak
with and without an overload storm, at pipeline depth 1 and 2 (the
reference settled at 2, ROADMAP C; the port's own replay runs
unsettled), and equal stuck-op diagnostics with their tenant and
deadline tags.  The TCP servers run end to end over localhost."""

import socket

import numpy as np
import pytest

from torch_servepair import (BOTH, PORT, REF, cfg, fleet, kvs, public,
                             rsp_bytes, same, scfg)


# -- wire codec --------------------------------------------------------------

def test_torch_wire_request_response_roundtrip():
    def drive(ns):
        w = ns.wire
        req = w.Request(kind="rmw", req_id=99, tenant=3, key=41,
                        deadline_us=12345, value=[5, 6], trace=77)
        raw = w.encode_request(req, 4)
        out = w.decode_request(raw, 4)
        assert out.value == [5, 6, 0, 0] and out.trace == 77
        rsp = w.Response(status=w.S_RETRY_AFTER, req_id=99,
                         reason=w.R_QUEUE_FULL, retry_after_us=777)
        rraw = w.encode_response(rsp, 4)
        back = w.decode_response(rraw, 4)
        assert back.reason_name == "queue_full"
        ok = w.Response(status=w.S_OK, req_id=5, found=True, step=12,
                        value=[1, -2, 3, 4], uid=(7, 8))
        heap_req = w.Request(kind="put", req_id=3, tenant=1, key=2,
                             data=b"\x00\xffabc")
        heap_rsp = w.Response(status=w.S_OK, req_id=3, found=True,
                              step=4, data=b"xyz\x80", uid=(1, 2))
        mget = w.ReadRequest(kind="mget", req_id=6, tenant=2,
                             keys=[3, 1, 4], deadline_us=9)
        scan = w.ReadRequest(kind="scan", req_id=7, tenant=0, lo=2, hi=9)
        rr = w.ReadResponse(status=w.S_OK, req_id=6, step=3,
                            found=[True, False, True],
                            local=[True, True, False],
                            codes=[w.RK_OK, w.RK_REJECTED, w.RK_OK],
                            values=[[1, 2, 3, 4], [0] * 4, [5, 6, 7, 8]])
        return (raw, rraw, w.encode_response(ok, 4),
                w.encode_any_request(heap_req, 4, 16),
                w.encode_any_response(heap_rsp, 4, 16),
                w.encode_any_request(mget, 4), w.encode_any_request(scan, 4),
                w.encode_any_response(rr, 4))

    got = same(drive)
    # the port decodes the reference's bytes to the same message
    w = PORT.wire
    assert w.decode_request(got[0], 4).key == 41
    assert w.decode_any_request(got[5], 4).keys == [3, 1, 4]
    assert w.decode_any_response(got[7], 4).found == [True, False, True]
    assert w.decode_any_request(got[3], 4, 16).data == b"\x00\xffabc"


def test_torch_wire_rejects_bad_magic_and_size():
    def drive(ns):
        w = ns.wire
        raw = bytearray(w.encode_request(
            w.Request(kind="get", req_id=1, tenant=0, key=0), 2))
        raw[0] ^= 0xFF
        out = []
        for bad in (bytes(raw), b"\x00" * 7):
            with pytest.raises(ValueError) as ei:
                w.decode_request(bad, 2)
            out.append(str(ei.value))
        assert "magic" in out[0] and "size" in out[1]
        out.append(w.peek_req_id(bytes(raw)))
        lens = range(0, 4200)
        for vb in (0, 40):
            out.append([n for n in lens if w.plausible_request_len(2, vb)(n)])
            out.append([n for n in lens
                        if w.plausible_response_len(2, vb)(n)])
        return out

    same(drive)


def test_torch_framed_socket_drops_corrupt_frame():
    from hermes_tpu.transport.tcp import FramedSocket as RefFramed
    from hermes_tpu_torch.transport import codec
    from hermes_tpu_torch.transport.tcp import FramedSocket

    a, b = socket.socketpair()
    # the reference's sender, the port's receiver
    tx, rx = RefFramed(a), FramedSocket(b)
    bad = codec.frame_pack(np.frombuffer(b"hello", np.uint8)).copy()
    bad[-1] ^= 0xFF  # corrupt the payload AFTER the crc was computed
    a.sendall(bad.tobytes())
    tx.send(b"world")
    assert rx.recv() == b"world"  # corrupt frame skipped, not applied
    assert rx.corrupt_dropped == 1
    tx.close(), rx.close()


def test_torch_framed_socket_corrupt_length_tears_down_not_desyncs():
    from hermes_tpu_torch.transport import codec
    from hermes_tpu_torch.transport.tcp import FramedSocket

    a, b = socket.socketpair()
    tx, rx = FramedSocket(a), FramedSocket(b, expect_lens={5})
    bad = bytearray(codec.frame_pack(
        np.frombuffer(b"hello", np.uint8)).tobytes())
    assert bad[4] == 5
    bad[4] = 6  # corrupted length: still plausible-looking, wrong
    a.sendall(bytes(bad))
    tx.send(b"world")
    with pytest.raises(codec.FrameCorrupt, match="length"):
        rx.recv()
    a2, b2 = socket.socketpair()
    tx2, rx2 = FramedSocket(a2), FramedSocket(b2, expect_lens={5})
    bad2 = codec.frame_pack(np.frombuffer(b"howdy", np.uint8)).copy()
    bad2[-1] ^= 0xFF
    a2.sendall(bad2.tobytes())
    tx2.send(b"again")
    assert rx2.recv() == b"again"
    assert rx2.corrupt_dropped == 1
    tx.close(), rx.close(), tx2.close(), rx2.close()


# -- generators --------------------------------------------------------------

def test_torch_poisson_arrivals_byte_identical():
    a = PORT.openloop.poisson_arrivals(500.0, 300, seed=21)
    assert a.tobytes() == REF.openloop.poisson_arrivals(
        500.0, 300, seed=21).tobytes()
    assert a.tobytes() != PORT.openloop.poisson_arrivals(
        500.0, 300, seed=22).tobytes()
    assert (np.diff(a) > 0).all()
    with pytest.raises(ValueError, match="rate_per_s"):
        PORT.openloop.poisson_arrivals(0.0, 3, 1)


def test_torch_make_mix_deterministic_and_shaped():
    def drive(ns):
        ol = ns.openloop
        m1 = ol.make_mix(ol.MixSpec(tenants=3), 64, 200, seed=5,
                         value_words=4)
        hot = ol.make_mix(ol.MixSpec(distribution="hotkey", hot_frac=1.0,
                                     hot_keys=2), 64, 100, seed=5)
        assert set(hot["key"].tolist()) <= {0, 1}
        return ([m1[k].tobytes() for k in ("kind", "key", "tenant",
                                           "value")]
                + [hot["key"].tobytes()])

    same(drive)


def test_torch_shaped_arrivals_overload_compresses_deterministically():
    def drive(ns):
        sa = ns.openloop.ShapedArrivals(100.0, 50, seed=3)
        out = []
        for i in range(50):
            if i == 20:
                sa.set_rate_x(4.0)
            out.append(sa.peek())
            sa._next = None  # consume
        assert out[30] < ns.openloop.poisson_arrivals(100.0, 50, 3)[30]
        sb = ns.openloop.ShapedArrivals(300.0, 40, seed=9)
        dues = [sb.due(t * 0.01) for t in range(20)]
        return out, dues, len(sb)

    same(drive)


def test_torch_overload_verb_parse_format_and_refusal():
    def drive(ns):
        chaos = ns.chaos
        sched = chaos.Schedule.parse(
            "@5 overload x=3.5 until=20\n@30 overload_clear\n")
        assert chaos.Schedule.parse(sched.format()).format() == \
            sched.format()
        storm = chaos.Schedule.overload_storm(9, steps=100, n_windows=2)
        store = kvs(ns, cfg(ns))
        with pytest.raises(ValueError, match="load shaper"):
            chaos.ChaosRunner(store, sched)  # no load= attached
        sa = ns.openloop.ShapedArrivals(100.0, 10, seed=1)
        runner = chaos.ChaosRunner(store, sched, load=sa)
        runner.tick(5)
        x5 = sa.rate_x
        runner.tick(20)  # window expires
        return sched.format(), storm.format(), x5, sa.rate_x

    got = same(drive)
    assert got[2:] == (3.5, 1.0)


def test_torch_heal_closes_open_overload_window():
    def drive(ns):
        sched = ns.chaos.Schedule.parse("@2 overload x=4\n@6 heal\n")
        sa = ns.openloop.ShapedArrivals(100.0, 10, seed=1)
        runner = ns.chaos.ChaosRunner(kvs(ns, cfg(ns)), sched, load=sa)
        runner.tick(2)
        x2 = sa.rate_x
        runner.tick(6)
        return x2, sa.rate_x

    assert same(drive) == (4.0, 1.0)


# -- admission ---------------------------------------------------------------

def test_torch_token_bucket_exact():
    def drive(ns):
        tb = ns.admission.TokenBucket(rate_per_s=10.0, burst=2.0)
        takes = [tb.take(0.0), tb.take(0.0), tb.take(0.0), tb.take(0.05),
                 tb.take(0.1)]
        return takes, tb.wait_s(0.1), tb.tokens, tb._t_last

    got = same(drive)
    assert got[0] == [True, True, False, False, True]
    assert got[1] == pytest.approx(0.1)


def test_torch_quota_accounting_exact_under_concurrent_tenants():
    def drive(ns):
        w = ns.wire
        clock = ns.server.VirtualClock()
        quota = 3
        fe = ns.server.Frontend(kvs(ns, cfg(ns)),
                                scfg(ns, tenant_quota=quota, queue_cap=64),
                                clock=clock)
        refusals, emitted = [], []
        rid = 0
        for _ in range(6):
            for t in (0, 1):
                for _ in range(5):  # 5 > quota: some must be refused
                    rid += 1
                    rsp = fe.submit(w.Request(kind="put", req_id=rid,
                                              tenant=t, key=rid % 64,
                                              value=[rid]))
                    if rsp is not None:
                        assert rsp.reason == w.R_QUOTA
                        refusals.append(rsp)
            for row in fe.adm.counters().values():
                assert row["inflight"] <= quota
            emitted += fe.pump()
            clock.advance(0.001)
        assert fe.drain()
        emitted += fe.pop_responses()
        ev = ns.server.verify_serving(fe)
        assert ev["requests"] == ev["responses"] == rid
        return (rsp_bytes(ns, fe, refusals), rsp_bytes(ns, fe, emitted),
                ev, fe.counters())

    same(drive)


def test_torch_backpressure_queue_full_is_loud():
    def drive(ns):
        w = ns.wire
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(kvs(ns, cfg(ns)),
                                scfg(ns, tenant_quota=1000, queue_cap=4,
                                     store_inflight_cap=1), clock=clock)
        refusals = []
        for i in range(20):
            rsp = fe.submit(w.Request(kind="put", req_id=i + 1, tenant=0,
                                      key=i % 64, value=[i]))
            if rsp is not None:
                assert rsp.status == w.S_RETRY_AFTER
                assert rsp.retry_after_us > 0
                refusals.append(rsp)
        assert len(refusals) >= 14  # nothing was silently buffered
        while not fe.drain(200):
            clock.advance(0.001)
        ev = ns.server.verify_serving(fe)
        return rsp_bytes(ns, fe, refusals), ev, fe.counters()

    same(drive)


def test_torch_deadline_enforced_at_completion_and_is_a_maybe():
    def drive(ns):
        w = ns.wire
        store = kvs(ns, cfg(ns, op_timeout_rounds=0))
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(store, scfg(ns), clock=clock)
        store.rt.freeze(1)  # a frozen ack peer stalls every write
        assert fe.submit(w.Request(kind="put", req_id=1, tenant=0, key=5,
                                   deadline_us=3000, value=[42])) is None
        rsps = []
        for _ in range(8):
            rsps += fe.pump()
            clock.advance(0.001)
        dl = [r for r in rsps if r.status == w.S_DEADLINE]
        assert dl and dl[0].req_id == 1, rsps
        assert fe._abandoned  # the store op is still open: a MAYBE
        abandoned = len(fe._abandoned)
        store.rt.thaw(1)
        assert fe.drain()
        ev = ns.server.verify_serving(fe)
        return rsp_bytes(ns, fe, rsps), abandoned, ev, fe.counters()

    same(drive)


def test_torch_deadline_enforced_at_intake_queue():
    def drive(ns):
        w = ns.wire
        store = kvs(ns, cfg(ns))
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(store, scfg(ns, store_inflight_cap=1,
                                            queue_cap=32), clock=clock)
        store.rt.freeze(1)  # the head op wedges the single store slot
        for i in range(5):
            assert fe.submit(w.Request(kind="put", req_id=i + 1, tenant=0,
                                       key=i, deadline_us=2000,
                                       value=[i])) is None
        rsps = []
        for _ in range(6):
            rsps += fe.pump()
            clock.advance(0.001)
        expired = [r for r in rsps if r.status == w.S_DEADLINE
                   and r.req_id > 1]
        assert len(expired) == 4  # expired IN the queue, never injected
        assert fe._lane_seq[0] == 1  # only the head was ever issued
        store.rt.thaw(1)
        assert fe.drain()
        ev = ns.server.verify_serving(fe)
        return rsp_bytes(ns, fe, rsps), ev, fe.counters()

    same(drive)


# -- shed ladder -------------------------------------------------------------

def test_torch_degraded_mode_sheds_writes_first_reads_serve():
    def drive(ns):
        w = ns.wire
        store = kvs(ns, cfg(ns, min_healthy_for_writes=3))
        obs = store.rt.attach_obs(ns.obs.Observability())
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(store, scfg(ns), clock=clock)
        store.rt.freeze(2)  # healthy 2 < floor 3 => degraded
        wr = fe.submit(w.Request(kind="put", req_id=1, tenant=0, key=3,
                                 value=[1]))
        assert wr is not None and wr.reason == w.R_SHED_WRITE
        rd = fe.submit(w.Request(kind="get", req_id=2, tenant=0, key=3))
        assert rd is None  # reads still admitted at rung 1
        fe.pump()
        clock.advance(0.001)
        store.rt.thaw(2)
        assert fe.drain()
        events = [(rec.get("name"), rec.get("level"), rec.get("queue"))
                  for rec in obs.records if rec.get("kind") == "event"
                  and rec.get("name") in ("shed", "shed_clear")]
        names = [e[0] for e in events]
        assert "shed" in names and "shed_clear" in names
        counters = {k: v for k, v in obs.registry.snapshot().items()
                    if k.startswith("serving_")}
        return (rsp_bytes(ns, fe, [wr] + fe.pop_responses()), events,
                counters, ns.server.verify_serving(fe))

    same(drive)


def test_torch_rung2_sheds_cold_reads_hot_keys_survive():
    def drive(ns):
        w = ns.wire
        store = kvs(ns, cfg(ns))
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(store, scfg(ns, queue_cap=10,
                                            shed_write_frac=0.3,
                                            shed_read_frac=0.5,
                                            hot_keys=(1,),
                                            store_inflight_cap=1),
                                clock=clock)
        store.rt.freeze(1)  # wedge the store so the intake queue fills
        rid = 0
        for i in range(6):  # fill past shed_read_frac * 10 = 5
            rid += 1
            fe.submit(w.Request(kind="get", req_id=rid, tenant=0,
                                key=10 + i))
        assert fe.shed_level == 2
        cold = fe.submit(w.Request(kind="get", req_id=7, tenant=0, key=20))
        assert cold is not None and cold.reason == w.R_SHED_READ
        hot = fe.submit(w.Request(kind="get", req_id=8, tenant=0, key=1))
        assert hot is None  # the hot key keeps serving
        wr = fe.submit(w.Request(kind="put", req_id=9, tenant=0, key=2,
                                 value=[9]))
        assert wr is not None and wr.reason == w.R_SHED_WRITE
        store.rt.thaw(1)
        assert fe.drain()
        return (rsp_bytes(ns, fe, [cold, wr] + fe.pop_responses()),
                ns.server.verify_serving(fe), fe.counters())

    same(drive)


# -- watchdog tags ------------------------------------------------------------

def test_torch_stuck_op_diag_carries_tenant_and_deadline_budget():
    def drive(ns):
        w = ns.wire
        store = kvs(ns, cfg(ns, op_timeout_rounds=4), strict_timeouts=True)
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(store, scfg(ns), clock=clock)
        store.rt.freeze(1)
        assert fe.submit(w.Request(kind="put", req_id=1, tenant=5, key=9,
                                   deadline_us=1_000_000,
                                   value=[1])) is None
        with pytest.raises(ns.kvs_mod.StuckOpError) as ei:
            for _ in range(12):
                fe.pump()
                clock.advance(0.001)
        diag = ei.value.diagnostics[0]
        assert diag["tenant"] == 5
        assert 0 < diag["deadline_left_us"] <= 1_000_000
        return ei.value.diagnostics, str(ei.value)

    got = same(drive)
    assert "tenant=5" in got[1] and "deadline_left_us=" in got[1]


# -- fleet + misc ------------------------------------------------------------

def test_torch_fleet_frontend_routes_and_checks():
    def drive(ns):
        fcfg = ns.FleetConfig(groups=2, base=cfg(ns, pipeline_depth=2))
        fl = fleet(ns, fcfg, record="array")
        res = ns.soak.run_open_loop(fl, scfg(ns),
                                    ns.openloop.MixSpec(tenants=3),
                                    rate_per_s=4000.0, n=120, seed=11,
                                    deadline_us=50_000)
        assert res["statuses"].get("ok", 0) > 0
        mix = ns.openloop.make_mix(ns.openloop.MixSpec(tenants=3),
                                   fcfg.total_keys, 120, 11, value_words=4)
        gids, _ = fl.router.locate(np.asarray(mix["key"], np.int64))
        assert set(np.asarray(gids).tolist()) == {0, 1}
        assert fl.check()["ok"]
        ns.fleet.verify_fleet(fl)
        return public(res)

    same(drive)


def test_torch_frontend_rejects_out_of_range_key_loudly():
    def drive(ns):
        fe = ns.server.Frontend(kvs(ns, cfg(ns)), scfg(ns),
                                clock=ns.server.VirtualClock())
        rsp = fe.submit(ns.wire.Request(kind="put", req_id=1, tenant=0,
                                        key=10_000, value=[1]))
        assert rsp is not None and rsp.status == ns.wire.S_REJECTED
        return rsp_bytes(ns, fe, [rsp]), ns.server.verify_serving(fe)

    same(drive)


def test_torch_loopback_put_get_roundtrip_through_frames():
    def drive(ns):
        w = ns.wire
        clock = ns.server.VirtualClock()
        fe = ns.server.Frontend(kvs(ns, cfg(ns, pipeline_depth=2)),
                                scfg(ns), clock=clock)
        lb = ns.rpc.LoopbackServer(fe)
        got = {}
        for rid, req in ((1, w.Request(kind="put", req_id=1, tenant=0,
                                       key=7, value=[3, 1, 4])),
                         (2, w.Request(kind="get", req_id=2, tenant=0,
                                       key=7))):
            assert lb.submit(req) is None
            for _ in range(40):
                for rsp in lb.pump():
                    got[rsp.req_id] = rsp
                clock.advance(0.001)
                if rid in got:
                    break
        assert got[1].status == w.S_OK and got[1].uid is not None
        assert got[2].status == w.S_OK and got[2].value[:3] == [3, 1, 4]
        return lb.response_log(), lb.wire_rx, lb.wire_tx

    same(drive)


def _soak(ns, depth, storm, settled=True, trace=0):
    """``test_open_loop_soak_replays_byte_identically``'s soak, with an
    overload storm through ``ChaosRunner(load=arrivals)`` when asked."""
    store = kvs(ns, cfg(ns, pipeline_depth=depth), settled=settled,
                record="array")
    obs = (store.rt.attach_obs(ns.obs.Observability()) if trace
           else None)
    sc = scfg(ns, tenant_quota=6, queue_cap=24, trace_sample=trace,
              trace_seed=3)
    runner = arrivals = None
    if storm:
        arrivals = ns.openloop.ShapedArrivals(6000.0, 150, 17)
        runner = ns.chaos.ChaosRunner(
            store, ns.chaos.Schedule.overload_storm(5, steps=60,
                                                    n_windows=2),
            load=arrivals)
    res = ns.soak.run_open_loop(store, sc, ns.openloop.MixSpec(tenants=3),
                                rate_per_s=6000.0, n=150, seed=17,
                                deadline_us=9000, chaos_runner=runner,
                                arrivals=arrivals)
    v = store.rt.check()
    assert v.ok, [f.reason[:160] for f in v.failures[:2]]
    # counter conservation: every response is one of the statuses
    assert sum(res["statuses"].values()) == res["ops_offered"]
    spans = None
    if obs is not None:
        spans = ns.tracing.canonical_span_bytes(obs.records)
        assert b"fe_resolve" in spans and b"fe_queue" in spans
    return public(res), spans, (runner.log_json() if runner else None)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("storm", [False, True])
def test_torch_open_loop_soak_replays_byte_identically(depth, storm):
    got = same(lambda ns: _soak(ns, depth, storm))
    if storm:
        assert got[0]["retry_after"] > 0  # the storm made the ladder act
    # the port's own replay, unsettled, gives the same bytes again
    assert _soak(PORT, depth, storm) == got


def test_torch_traced_soak_spans_equal_reference():
    """``trace_sample``: the fe_queue/fe_resolve spans (and the KVS's
    op spans under the staged trace ids) equal the reference's."""
    same(lambda ns: _soak(ns, 1, False, trace=4))


def test_torch_measure_capacity_resolves_everything():
    def drive(ns):
        cap = ns.soak.measure_capacity(kvs(ns, cfg(ns, pipeline_depth=2)),
                                       scfg(ns),
                                       ns.openloop.MixSpec(tenants=2),
                                       n=80, seed=3)
        assert cap["ops_per_round"] > 0 and cap["ops"] >= 80
        return cap

    same(drive)


def test_torch_verify_serving_red_on_lost_response():
    for ns in BOTH:
        fe = ns.server.Frontend(kvs(ns, cfg(ns)), scfg(ns),
                                clock=ns.server.VirtualClock())
        fe.requests += 1  # a request that never got a response
        with pytest.raises(AssertionError, match="conservation"):
            ns.server.verify_serving(fe)


def test_torch_scenario_matrix_and_seed_anchor():
    def drive(ns):
        ol = ns.openloop
        seed = ol.scenario_seed()
        assert isinstance(seed, int) and seed == ol.scenario_seed()
        return (seed, [s for s in ol.scenario_matrix()],
                [s for s in ol.scenario_matrix(value_bytes=64)],
                ol.hot_set(ol.MixSpec(distribution="hotkey", hot_keys=3)))

    got = same(lambda ns: _as_dicts(drive(ns)))
    assert [s["name"] for s in got[1]] == ["uniform", "zipfian", "hotkey",
                                           "ycsb_b", "ycsb_c", "ycsb_d"]


def _as_dicts(out):
    import dataclasses

    seed, m1, m2, hot = out
    return (seed, [dataclasses.asdict(s) for s in m1],
            [dataclasses.asdict(s) for s in m2], hot)


def test_torch_closed_loop_equals_reference():
    def drive(ns):
        ol = ns.openloop
        cl = ol.ClosedLoop(ol.MixSpec(tenants=2, value_bytes=48), 64, 30,
                           seed=4, value_words=4)
        return [cl.next_op() for _ in range(31)]

    got = same(drive)
    assert got[-1] is None and got[0]["data"] is not None


def _tcp_frontend():
    fe = PORT.server.Frontend(kvs(PORT, cfg(PORT, pipeline_depth=2)),
                              scfg(PORT))
    return fe, PORT.rpc.TcpRpcServer(fe)


def test_torch_tcp_rpc_server_end_to_end():
    fe, srv = _tcp_frontend()
    try:
        cl = PORT.rpc.RpcClient(srv.addr, fe.u)
        put = cl.call("put", 9, value=[7, 7])
        assert put.status == PORT.wire.S_OK and put.uid is not None
        get = cl.call("get", 9)
        assert get.status == PORT.wire.S_OK and get.value[:2] == [7, 7]
        mg = cl.call_mget([9, 3])
        assert mg.status == PORT.wire.S_OK and mg.values[0][:2] == [7, 7]
        sc = cl.call_scan(8, 11)
        assert sc.status == PORT.wire.S_OK and len(sc.found) == 3
        cl.close()
    finally:
        srv.close()
    assert srv.pump_error is None


def test_torch_tcp_rpc_req_id_collision_across_connections():
    fe, srv = _tcp_frontend()
    try:
        a = PORT.rpc.RpcClient(srv.addr, fe.u)
        b = PORT.rpc.RpcClient(srv.addr, fe.u)
        assert a._next_id == b._next_id == 1
        pa = a.call("put", 3, value=[11, 0], tenant=1)
        pb = b.call("put", 4, value=[22, 0], tenant=2)
        assert pa.status == PORT.wire.S_OK and pb.status == PORT.wire.S_OK
        ga = a.call("get", 3, tenant=1)
        gb = b.call("get", 4, tenant=2)
        assert ga.value[:2] == [11, 0], "client A got someone else's answer"
        assert gb.value[:2] == [22, 0], "client B got someone else's answer"
        assert ga.req_id == gb.req_id == 2
        a.close()
        b.close()
    finally:
        srv.close()


def test_torch_admission_refusal_does_not_charge_token_bucket():
    def drive(ns):
        w = ns.wire
        sc = scfg(ns, tenant_quota=1, tenant_rate_per_s=10.0,
                  tenant_burst=2.0, hot_keys=(0,))
        adm = ns.admission.AdmissionControl(sc)
        out = [adm.admit("put", 0, 7, 0.0, 0, False)]
        adm.note_admitted(7)
        out += [adm.admit("put", 0, 7, 0.0, 0, False) for _ in range(5)]
        out += [adm.admit("get", 0, 8, 0.0, sc.queue_cap, False)
                for _ in range(3)]
        assert out[0][0] == w.R_NONE and out[1][0] == w.R_QUOTA
        assert out[-1][0] == w.R_QUEUE_FULL
        return (out, adm.tenant(7).bucket.tokens,
                adm.tenant(8).bucket.tokens, adm.counters())

    got = same(drive)
    assert got[1] == 1.0 and got[2] == 2.0


def test_torch_tcp_rpc_undecodable_request_refused_loudly():
    from hermes_tpu_torch.transport.tcp import FramedSocket

    fe, srv = _tcp_frontend()
    w = PORT.wire
    try:
        fsock = FramedSocket(socket.create_connection(srv.addr,
                                                      timeout=10.0))
        req = w.Request(kind="put", req_id=77, tenant=0, key=1, value=[5])
        fsock.send(w.encode_request(req, fe.u + 3))  # wrong width
        rsp = w.decode_response(fsock.recv(), fe.u)
        assert rsp.status == w.S_REJECTED and rsp.req_id == 77
        assert srv.undecodable == 1
        fsock.close()
    finally:
        srv.close()


def test_torch_chip_smoke_serving_rehearsal(monkeypatch):
    """``chip_smoke``'s serve, serve-columnar and serve-socket phases on
    the CPU at a cut shape (2^12 keys, 64 sessions; 32,768 columnar ops):
    every check they make on the card holds, each kernel's plain version
    counted as its wrapper's launch.  (serve-one-store spawns processes;
    ``tests/test_torch_shm_ipc.py`` holds its topology.)"""
    from types import SimpleNamespace

    import torch

    import chip_smoke as cs
    from hermes_tpu_torch import chaos, config, serving
    from hermes_tpu_torch.core import kernels, megaround, types
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving import bench, soak
    from hermes_tpu_torch.workload import openloop

    counters = {"stats_block": kernels.stats_block,
                "mega_route": megaround.mega_route,
                "mega_apply": megaround.mega_apply,
                "mega_replay": megaround.mega_replay}
    for mod, name in ((kernels, "stats_block"), (megaround, "mega_route"),
                      (megaround, "mega_apply"),
                      (megaround, "mega_replay")):
        def counted(*a, _p=getattr(mod, name + "_plain"),
                    _w=getattr(mod, name), **k):
            _w.launches += 1
            return _p(*a, **k)

        monkeypatch.setattr(mod, name + "_plain", counted)
    monkeypatch.setattr(cs, "COLUMNAR_OPS", 32768)
    monkeypatch.setattr(cs, "COLUMNAR_PER_ROUND", 384)
    monkeypatch.setattr(cs, "SOCKET_N", 200)
    sv = SimpleNamespace(
        kvs_cfg=lambda **over: config.bench_cfg("a", over=dict(
            device_stream=False, read_unroll=1, n_keys=1 << 12,
            n_sessions=64, **over)),
        HermesConfig=config.HermesConfig, device="cpu", KVS=KVS,
        kernels=kernels, types=types, chaos=chaos,
        ShapedArrivals=openloop.ShapedArrivals, MixSpec=openloop.MixSpec,
        ServingConfig=serving.ServingConfig,
        run_open_loop=serving.run_open_loop,
        run_columnar_soak=soak.run_columnar_soak,
        run_serve_bench=bench.run_serve_bench,
        sync=lambda: None)
    served = cs.phase_serve(torch, sv, "cpu")
    assert served["launches"]["stats_block"] > 0
    col = cs.phase_serve_columnar(torch, sv, counters, "cpu")
    assert col["launches"]["mega_route"] == col["runs"][1]["rounds"]
    assert col["runs"][0]["busy_share_mean"] > 0.5
    sock = cs.phase_serve_socket(torch, sv, "cpu")
    assert sock["launches"]["stats_block"] > 0


def test_torch_chip_smoke_serve_fleet_rehearsal(monkeypatch, capsys):
    """``chip_smoke.phase_serve_fleet`` on the CPU at a cut shape: a
    two-group fleet behind ``Frontend`` under the overload storm, every
    check it makes on the card (both groups spanned, the checkers,
    ``verify_fleet``, no client-seen commit lost, ops issued = device ops
    = recorded, the envelope acting, ``stats_block`` once a group
    round)."""
    import json

    import torch

    import chip_smoke as cs
    from torch_servepair import smoke_namespace

    sv = smoke_namespace(monkeypatch)
    out = cs.phase_serve_fleet(torch, sv, "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve-fleet" and line["spanned"] == [0, 1]
    assert line["committed_write_lost"] == []
    assert line["issued"] == line["device_ops"] == line["recorded"] > 0
    assert out["launches"]["stats_block"] == sum(line["rounds"]) + sum(
        line["small"]["cpu"]["rounds"])
