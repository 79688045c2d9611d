"""The port's columnar serving data plane (hermes_tpu_torch/serving: the
batch codecs, ``admit_batch``, ``CompletionRing`` / ``ColumnarFrontend``,
the columnar loopback and TCP servers, SO_REUSEPORT accept sharding)
against the reference's, case for case with
``tests/test_serving_columnar.py`` at its shapes and seeds.

The batch codecs encode to the reference's bytes (both payload modes,
torn and garbage frames refused with the reference's messages); the
batch ladder gives the reference's scalar ladder's verdicts, hints,
counters and bucket floats; the frontend's refusals and resolutions
encode to the reference's bytes; the columnar soak's response log
(``response_log_sha``) equals the reference's (settled at depth 2,
ROADMAP C) and replays unsettled on the port."""

import dataclasses
import socket
import threading

import numpy as np
import pytest

from torch_servepair import BOTH, PORT, REF, kvs, public, same

W = PORT.wire


def _cfg(ns, **over):
    kw = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=6,
              ops_per_session=96, value_words=6, pipeline_depth=2,
              workload=ns.WorkloadConfig(read_frac=0.5, seed=7))
    kw.update(over)
    return ns.HermesConfig(**kw)


def _scfg(ns, **over):
    kw = dict(tenant_rate_per_s=1e6, tenant_burst=1e4, tenant_quota=16,
              queue_cap=64, round_us=1000)
    kw.update(over)
    return ns.server.ServingConfig(**kw)


# -- batch codec against the per-struct oracle --------------------------------


def _random_requests(w, rng, k, u, vbytes=0, traced=False):
    out = []
    for _ in range(k):
        kind = ("get", "put", "rmw")[int(rng.integers(3))]
        r = w.Request(
            kind=kind, req_id=int(rng.integers(1 << 32)),
            tenant=int(rng.integers(1 << 16)),
            key=int(rng.integers(-(1 << 40), 1 << 40)),
            deadline_us=int(rng.integers(1 << 32)),
            trace=int(rng.integers(1, 1 << 16)) if traced
            and rng.random() < 0.5 else 0)
        if vbytes:
            roll = rng.random()
            if kind != "get" and roll < 0.75:
                n = (0 if roll < 0.15 else
                     vbytes if roll < 0.3 else int(rng.integers(vbytes + 1)))
                r.data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind != "get":
            r.value = rng.integers(-(1 << 31), 1 << 31,
                                   int(rng.integers(u + 1))).tolist()
        out.append(r)
    return out


def _random_responses(w, rng, k, u, vbytes=0):
    out = []
    statuses = (w.S_OK, w.S_RMW_ABORT, w.S_REJECTED, w.S_RETRY_AFTER,
                w.S_DEADLINE, w.S_LOST)
    for _ in range(k):
        st = int(statuses[int(rng.integers(len(statuses)))])
        r = w.Response(
            status=st, req_id=int(rng.integers(1 << 32)),
            reason=int(rng.integers(6)), found=bool(rng.integers(2)),
            step=int(rng.integers(-1, 1 << 31)),
            retry_after_us=int(rng.integers(1 << 32)),
            uid=((int(rng.integers(-(1 << 31), 1 << 31)),
                  int(rng.integers(-(1 << 31), 1 << 31)))
                 if rng.random() < 0.5 else None))
        if vbytes:
            if st == w.S_OK and rng.random() < 0.75:
                n = int(rng.integers(vbytes + 1))
                r.data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif rng.random() < 0.75:
            r.value = rng.integers(-(1 << 31), 1 << 31, u).tolist()
        out.append(r)
    return out


@pytest.mark.parametrize("vbytes", [0, 24])
def test_torch_req_batch_codec_byte_identical_to_struct_oracle(vbytes):
    u = 3
    rngs = {ns.root: np.random.default_rng(19) for ns in BOTH}
    for k in (0, 1, 7, 257):
        encoded = {}
        for ns in BOTH:
            w = ns.wire
            reqs = _random_requests(w, rngs[ns.root], k, u, vbytes,
                                    traced=True)
            oracle = b"".join(w.encode_request(r, u, vbytes) for r in reqs)
            b = w.ReqBatch.from_requests(reqs, u, vbytes)
            assert w.encode_request_batch(b, u, vbytes) == oracle
            encoded[ns.root] = oracle
        oracle = encoded[REF.root]
        assert encoded[PORT.root] == oracle
        # the port decodes the reference's bytes row for row as the
        # reference's struct decoder does
        back = W.decode_request_batch(oracle, u, vbytes).to_requests()
        off = 0
        for r in back:
            step = len(W.encode_request(r, u, vbytes))
            want = REF.wire.decode_request(oracle[off: off + step], u,
                                           vbytes)
            assert dataclasses.asdict(r) == dataclasses.asdict(want)
            off += step
        assert off == len(oracle)


@pytest.mark.parametrize("vbytes", [0, 24])
def test_torch_rsp_batch_codec_byte_identical_to_struct_oracle(vbytes):
    u = 3
    rngs = {ns.root: np.random.default_rng(23) for ns in BOTH}
    for k in (0, 1, 7, 257):
        encoded = {}
        for ns in BOTH:
            w = ns.wire
            rsps = _random_responses(w, rngs[ns.root], k, u, vbytes)
            oracle = b"".join(w.encode_response(r, u, vbytes) for r in rsps)
            b = w.RspBatch.from_responses(rsps, u, vbytes)
            assert w.encode_response_batch(b, u, vbytes) == oracle
            encoded[ns.root] = oracle
        oracle = encoded[REF.root]
        assert encoded[PORT.root] == oracle
        back = W.decode_response_batch(oracle, u, vbytes).to_responses()
        off = 0
        for r in back:
            step = W.response_extent(oracle, off, u, vbytes)
            assert step == REF.wire.response_extent(oracle, off, u, vbytes)
            want = REF.wire.decode_response(oracle[off: off + step], u,
                                            vbytes)
            assert dataclasses.asdict(r) == dataclasses.asdict(want)
            off += step
        assert off == len(oracle)


def _errors(w, cases):
    out = []
    for fn in cases:
        with pytest.raises(ValueError) as ei:
            fn()
        out.append(str(ei.value))
    return out


def test_torch_batch_codec_torn_and_garbage_are_loud():
    def drive(ns):
        w = ns.wire
        u = 2
        reqs = _random_requests(w, np.random.default_rng(5), 4, u)
        raw = w.encode_request_batch(w.ReqBatch.from_requests(reqs, u), u)
        bad_magic = bytearray(raw)
        bad_magic[w.req_nbytes(u)] ^= 0xFF  # second record's magic
        bad_kind = bytearray(raw)
        bad_kind[w.req_nbytes(u) + 2] = 77  # second record's kind
        vb = 16
        hreqs = _random_requests(w, np.random.default_rng(6), 4, u, vb)
        hraw = w.encode_request_batch(
            w.ReqBatch.from_requests(hreqs, u, vb), u, vb)
        one = w.encode_request(w.Request(
            kind="put", req_id=1, tenant=0, key=0, data=b"abcd"), u, vb)
        huge = bytearray(one)
        huge[-8:-4] = (vb + 1).to_bytes(4, "little")  # dlen > vbytes
        rsps = _random_responses(w, np.random.default_rng(7), 3, u)
        rraw = w.encode_response_batch(w.RspBatch.from_responses(rsps, u), u)
        rbad = bytearray(rraw)
        rbad[0] ^= 0xFF
        msgs = _errors(w, [
            lambda: w.decode_request_batch(raw[:-3], u),
            lambda: w.decode_request_batch(bytes(bad_magic), u),
            lambda: w.decode_request_batch(bytes(bad_kind), u),
            lambda: w.decode_request_batch(hraw[:-1], u, vb),
            lambda: w.decode_request_batch(bytes(huge), u, vb),
            lambda: w.decode_response_batch(rraw[:-2], u),
            lambda: w.decode_response_batch(bytes(rbad), u)])
        for m, want in zip(msgs, ("torn batch", "magic", "kind",
                                  "torn batch", "payload tail",
                                  "torn batch", "magic")):
            assert want in m, (m, want)
        return msgs, raw, hraw, rraw

    same(drive)


def test_torch_batch_codec_refuses_oversize_payloads_on_encode():
    def drive(ns):
        w = ns.wire
        u, vb = 2, 8
        b = w.ReqBatch.from_requests([w.Request(
            kind="put", req_id=1, tenant=0, key=0, data=b"x" * vb)], u, vb)
        b.vlen = np.array([vb + 1], np.int64)  # lie about the extent
        return _errors(w, [
            lambda: w.encode_request_batch(b, u, vb),
            lambda: w.ReqBatch.from_requests([w.Request(
                kind="put", req_id=1, tenant=0, key=0,
                value=list(range(u + 1)))], u)])

    msgs = same(drive)
    assert "max_value_bytes" in msgs[0] and "int32 words" in msgs[1]


# -- batch admission against the reference's scalar ladder -------------------


def test_torch_admit_batch_state_exact_vs_scalar_ladder():
    """Over random batches the port's batch ladder returns the reference
    scalar ladder's reasons and hints, and leaves its tenant counters and
    bucket floats; the port's scalar ladder does too."""
    rng = np.random.default_rng(41)
    kw = dict(tenant_quota=5, queue_cap=12, tenant_rate_per_s=50.0,
              tenant_burst=6, shed_write_frac=0.5, shed_read_frac=0.8,
              hot_keys=(3, 9))
    a = REF.admission.AdmissionControl(_scfg(REF, **kw))
    b = PORT.admission.AdmissionControl(_scfg(PORT, **kw))
    c = PORT.admission.AdmissionControl(_scfg(PORT, **kw))
    now, q_a, q_b = 0.0, 0, 0
    for trial in range(40):
        k = int(rng.integers(0, 9))
        writes = rng.integers(2, size=k).astype(bool)
        keys = rng.integers(0, 16, k).astype(np.int64)
        tenants = rng.integers(0, 3, k)
        degraded = bool(rng.random() < 0.15)
        now += float(rng.random() * 0.1)
        exp_r, exp_w = [], []
        for i in range(k):
            args = ("put" if writes[i] else "get", int(keys[i]),
                    int(tenants[i]), now, q_a, degraded)
            rsn, wt = a.admit(*args)
            assert c.admit(*args) == (rsn, wt), f"trial {trial}"
            if rsn == W.R_NONE:
                a.note_admitted(int(tenants[i]))
                c.note_admitted(int(tenants[i]))
                q_a += 1
            exp_r.append(rsn), exp_w.append(wt)
        got_r, got_w = b.admit_batch(writes, keys, tenants, now, q_b,
                                     degraded)
        q_b += int((got_r == W.R_NONE).sum())
        assert got_r.tolist() == exp_r, f"trial {trial}"
        assert np.allclose(got_w, exp_w), f"trial {trial}"
        assert q_a == q_b
        assert a.counters() == b.counters() == c.counters()
        for t in a.tenants:
            ba, bb = a.tenants[t].bucket, b.tenants[t].bucket
            assert (ba.tokens, ba._t_last) == (bb.tokens, bb._t_last)
        for t, ts in a.tenants.items():
            drop = int(rng.integers(0, ts.inflight + 1))
            for _ in range(drop):
                a.note_resolved(t, W.S_OK)
                c.note_resolved(t, W.S_OK)
            if drop:
                b.note_resolved_batch(np.full(drop, t),
                                      np.full(drop, W.S_OK))
            q_a, q_b = q_a - drop, q_b - drop


# -- completion ring + columnar frontend envelope ----------------------------


def _batch(w, kind, keys, req_id0=1, tenant=0, u=4, deadline_us=0,
           value=None):
    k = len(keys)
    return w.ReqBatch(
        kind=np.asarray(kind, np.uint8),
        req_id=np.arange(req_id0, req_id0 + k, dtype=np.uint32),
        tenant=np.full(k, tenant, np.uint16),
        trace=np.zeros(k, np.uint16),
        deadline_us=np.full(k, deadline_us, np.uint32),
        key=np.asarray(keys, np.int64),
        value=(np.asarray(value, np.int32) if value is not None
               else np.zeros((k, u), np.int32)))


def _rb(ns, fe, rb) -> bytes:
    return ns.wire.encode_response_batch(rb, fe.u, fe.vbytes) if len(rb) \
        else b""


def _emitted(ns, fe, emitted) -> list:
    return [(cid, _rb(ns, fe, d[cid])) for d in emitted for cid in sorted(d)]


def test_torch_completion_ring_exhaustion_is_loud_and_release_reuses():
    def drive(ns):
        ring = ns.server.CompletionRing(cap=4, u=2, vbytes=0)
        first = ring.alloc(ring.cap)
        assert ring.in_use() == ring.cap
        with pytest.raises(RuntimeError, match="accounting bug"):
            ring.alloc(1)
        ring.release(first[:3])
        again = ring.alloc(3)
        assert (ring.status[again] == 0xFF).all()  # slots come back open
        return ring.cap, first.tolist(), again.tolist(), ring.n_free

    got = same(drive)
    assert set(got[2]) == set(got[1][:3])


def test_torch_columnar_validity_refusals_are_rejected_rows():
    def drive(ns):
        w = ns.wire
        fe = ns.server.ColumnarFrontend(kvs(ns, _cfg(ns)), _scfg(ns),
                                        clock=ns.server.VirtualClock())
        out = fe.submit_batch(_batch(w, [w.K_PUT, 9, w.K_GET],
                                     [1, 2, 10_000]))
        assert out.req_id.tolist() == [2, 3]
        assert out.status.tolist() == [w.S_REJECTED] * 2
        ok, emitted = fe.drain()
        assert ok
        tot = ns.server.verify_columnar(fe)
        assert tot["completed"] == 1 and tot["rejected"] == 0
        return _rb(ns, fe, out), _emitted(ns, fe, emitted), tot

    same(drive)


def test_torch_columnar_deadline_enforced_at_intake_backlog():
    def drive(ns):
        w = ns.wire
        clock = ns.server.VirtualClock()
        fe = ns.server.ColumnarFrontend(
            kvs(ns, _cfg(ns)), _scfg(ns, store_inflight_cap=1, queue_cap=32),
            clock=clock)
        out = fe.submit_batch(_batch(w, [w.K_PUT] * 8, list(range(8)),
                                     deadline_us=1500))
        assert len(out) == 0  # all admitted
        emitted = []
        for _ in range(200):
            if fe.idle():
                break
            emitted.append(fe.pump())
            clock.advance(0.001)
        st = np.concatenate([rb.status for d in emitted
                             for rb in d.values()])
        names = [w.STATUS_NAMES[int(s)] for s in st]
        assert names.count("deadline") >= 4
        assert set(names) <= {"ok", "deadline"}
        tot = ns.server.verify_columnar(fe)
        assert fe.ring.in_use() == 0
        return _emitted(ns, fe, emitted), tot, fe.counters()

    same(drive)


def test_torch_columnar_quota_refusal_carries_retry_hint():
    def drive(ns):
        w = ns.wire
        fe = ns.server.ColumnarFrontend(kvs(ns, _cfg(ns)),
                                        _scfg(ns, tenant_quota=3),
                                        clock=ns.server.VirtualClock())
        out = fe.submit_batch(_batch(w, [w.K_PUT] * 6, list(range(6))))
        assert out.status.tolist() == [w.S_RETRY_AFTER] * 3
        assert out.reason.tolist() == [w.R_QUOTA] * 3
        assert (out.retry_after_us > 0).all()
        ok, emitted = fe.drain()
        assert ok
        return (_rb(ns, fe, out), _emitted(ns, fe, emitted),
                ns.server.verify_columnar(fe))

    same(drive)


def test_torch_columnar_heap_payload_roundtrip():
    def drive(ns):
        w = ns.wire
        fe = ns.server.ColumnarFrontend(
            kvs(ns, _cfg(ns, max_value_bytes=32)), _scfg(ns),
            clock=ns.server.VirtualClock())
        payload = bytes(range(7)) + b"\xff\x80"
        put = w.ReqBatch(
            kind=np.array([w.K_PUT], np.uint8),
            req_id=np.array([1], np.uint32), tenant=np.zeros(1, np.uint16),
            trace=np.zeros(1, np.uint16),
            deadline_us=np.zeros(1, np.uint32),
            key=np.array([5], np.int64),
            vlen=np.array([len(payload)], np.int64),
            voff=np.zeros(1, np.int64), blob=payload)
        assert len(fe.submit_batch(put)) == 0
        ok1, em1 = fe.drain()
        get = dataclasses.replace(put, kind=np.array([w.K_GET], np.uint8),
                                  req_id=np.array([2], np.uint32),
                                  vlen=np.array([-1], np.int64), blob=b"")
        assert len(fe.submit_batch(get)) == 0
        ok2, emitted = fe.drain()
        assert ok1 and ok2
        got = [rb for d in emitted for rb in d.values()
               if 2 in rb.req_id.tolist()]
        assert got[-1].row_data(got[-1].req_id.tolist().index(2)) == payload
        return (_emitted(ns, fe, em1 + emitted),
                ns.server.verify_columnar(fe))

    same(drive)


def test_torch_columnar_frontend_refuses_fleet_stores():
    from hermes_tpu_torch.fleet import Fleet

    fl = Fleet(PORT.FleetConfig(groups=2, base=_cfg(PORT)), device="cpu")
    with pytest.raises(ValueError, match="single KVS"):
        PORT.server.ColumnarFrontend(fl, _scfg(PORT))


# -- loopback byte log + soak ------------------------------------------------


def _columnar_soak(ns, settled=True, **cfg_over):
    store = kvs(ns, _cfg(ns, **cfg_over), settled=settled, record="array")
    res = ns.soak.run_columnar_soak(store, _scfg(ns, tenant_quota=8),
                                    ns.openloop.MixSpec(tenants=2,
                                                        read_frac=0.4),
                                    rate_per_s=4000.0, n=120, seed=11,
                                    deadline_us=50_000)
    v = store.rt.check()
    assert v.ok, [f.reason[:160] for f in v.failures[:2]]
    fe, lb = res["_frontend"], res["_server"]
    uids = ns.soak.committed_uids(fe, lb)
    return public(res), uids, lb.response_log()


def test_torch_columnar_loopback_log_walkable_and_soak_replays():
    got = same(_columnar_soak)
    # the port's own replay, unsettled, gives the same bytes
    assert _columnar_soak(PORT, settled=False) == got
    res, uids, log = got
    rb = W.decode_response_batch(log, 4)
    ok_uid = (rb.status == W.S_OK) & rb.has_uid
    assert uids == [tuple(row) for row in rb.uid[ok_uid].tolist()]
    assert uids  # the soak committed writes
    assert sum(res["statuses"].values()) == 120


def test_torch_columnar_soak_mega_round_equals_fused():
    """The smoke's serve-columnar mega run at a small shape: the mega
    round's response log equals the fused round's (and the reference's
    fused one)."""
    fused = _columnar_soak(PORT, arb_mode="sort")
    mega = _columnar_soak(PORT, arb_mode="sort", mega_round=True)
    assert mega == fused
    assert _columnar_soak(REF, arb_mode="sort") == fused


def test_torch_columnar_soak_refuses_heap_stores():
    with pytest.raises(ValueError, match="fixed-width"):
        PORT.soak.run_columnar_soak(
            kvs(PORT, _cfg(PORT, max_value_bytes=16)), _scfg(PORT),
            PORT.openloop.MixSpec(), rate_per_s=100.0, n=4, seed=1,
            deadline_us=0)


# -- columnar TCP + accept sharding ------------------------------------------


def test_torch_columnar_tcp_server_end_to_end():
    fe = PORT.server.ColumnarFrontend(kvs(PORT, _cfg(PORT)), _scfg(PORT))
    server = PORT.rpc.ColumnarTcpServer(fe)
    try:
        cl = PORT.rpc.ColumnarClient(server.addr, fe.u)
        val = np.arange(4 * fe.u, dtype=np.int32).reshape(4, fe.u)
        puts = _batch(W, [W.K_PUT] * 4, [1, 2, 3, 4], u=fe.u,
                      req_id0=int(cl.next_ids(4)[0]), value=val)
        for rsp in cl.call_batch(puts).values():
            assert rsp.status_name == "ok"
        gets = _batch(W, [W.K_GET] * 4, [1, 2, 3, 4], u=fe.u,
                      req_id0=int(cl.next_ids(4)[0]))
        got = cl.call_batch(gets)
        for i, rid in enumerate(gets.req_id.tolist()):
            assert got[rid].status_name == "ok" and got[rid].found
            assert got[rid].value == val[i].tolist()
        cl.close()
    finally:
        server.close()
    assert server.pump_error is None and server.undecodable == 0


def test_torch_columnar_tcp_undecodable_batch_tears_down_loudly():
    fe = PORT.server.ColumnarFrontend(kvs(PORT, _cfg(PORT)), _scfg(PORT))
    server = PORT.rpc.ColumnarTcpServer(fe)
    try:
        cl = PORT.rpc.ColumnarClient(server.addr, fe.u)
        cl.fsock.send(b"\x00" * 10)  # frame-valid garbage
        assert cl.recv_batch() is None  # loud EOF, not silence
        cl.close()
    finally:
        server.close()
    assert server.undecodable == 1


def test_torch_serving_listener_reuseport_gate():
    from hermes_tpu_torch.transport.tcp import serving_listener

    a = serving_listener("127.0.0.1", 0, reuseport=True)
    port = a.getsockname()[1]
    b = serving_listener("127.0.0.1", port, reuseport=True)
    a.close(), b.close()
    plain = serving_listener("127.0.0.1", 0)
    with pytest.raises(OSError):
        serving_listener("127.0.0.1", plain.getsockname()[1])
    plain.close()
    if not hasattr(socket, "SO_REUSEPORT"):
        with pytest.raises(RuntimeError, match="SO_REUSEPORT"):
            serving_listener("127.0.0.1", 0, reuseport=True)


def test_torch_accept_sharding_in_process_under_concurrent_clients():
    servers = []
    port = 0
    try:
        for _ in range(2):
            fe = PORT.server.ColumnarFrontend(kvs(PORT, _cfg(PORT)),
                                              _scfg(PORT, tenant_quota=64))
            s = PORT.rpc.ColumnarTcpServer(fe, port=port, reuseport=True)
            port = s.addr[1]
            servers.append(s)
        errs, done = [], []

        def client(i):
            try:
                cl = PORT.rpc.ColumnarClient(("127.0.0.1", port),
                                             servers[0].u)
                b = _batch(W, [W.K_PUT] * 8, list(range(8)),
                           u=servers[0].u, tenant=i,
                           req_id0=int(cl.next_ids(8)[0]))
                rsps = cl.call_batch(b)
                assert len(rsps) == 8
                assert all(r.status_name in ("ok", "retry_after")
                           for r in rsps.values())
                done.append(i)
                cl.close()
            except Exception as e:  # noqa: BLE001
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
        assert not errs and len(done) == 8
    finally:
        for s in servers:
            s.close()
    assert all(s.pump_error is None for s in servers)


@pytest.mark.slow
def test_torch_sharded_worker_processes_serve_and_stop():
    """Full accept-sharding topology: spawned worker processes behind one
    SO_REUSEPORT port (``launch --serve-workers``), each with its own
    store on the CPU."""
    from hermes_tpu_torch.launch import start_serve_workers

    cfg = _cfg(PORT, n_sessions=8)
    u = cfg.value_words - 2
    with start_serve_workers(2, cfg=cfg, device="cpu") as fl:
        assert fl.alive() == 2
        oks = 0
        for w in range(3):
            cl = PORT.rpc.ColumnarClient(fl.addr, u)
            b = _batch(W, [W.K_PUT] * 4, [w, w + 1, w + 2, w + 3], u=u,
                       tenant=w, req_id0=int(cl.next_ids(4)[0]))
            oks += sum(r.status_name == "ok"
                       for r in cl.call_batch(b).values())
            cl.close()
        assert oks == 12
    assert fl.alive() == 0
