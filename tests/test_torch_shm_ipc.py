"""The port's shared-memory columnar IPC plane (hermes_tpu_torch/
transport/shm.py, hermes_tpu_torch/serving/ipc.py) against the
reference's, case for case with ``tests/test_shm_ipc.py``: the SPSC ring
protocol (wraparound, slot reuse, loud backpressure, torn-producer
tombstones, deferred acks, attach), the vectorised trace sampler against
both packages' scalar sampler, per-row conn tagging through
``submit_batch`` (the refusal and emit bytes equal the reference's), the
deterministic shm soak's per-worker response logs byte-identical to the
reference's, and (slow) the real multi-process one-store topology with
its shm workers on the CPU, including a kill -9 worker crash."""

import os
import signal
import time

import numpy as np
import pytest

from torch_servepair import PORT, REF, kvs, same

SHM = PORT.shm
IPC = PORT.ipc
W = PORT.wire


def _ring(nslots=4, rows=8):
    return SHM.SpscColumnRing.create(
        nslots, rows, (("a", "<i8", 0), ("m", "u1", 16)))


def _cfg(ns, **over):
    kw = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=6,
              ops_per_session=96, value_words=6)
    kw.update(over)
    return ns.HermesConfig(**kw)


def _scfg(ns, **over):
    kw = dict(tenant_rate_per_s=1e9, tenant_burst=1e9,
              tenant_quota=1 << 20, queue_cap=4096, round_us=1000)
    kw.update(over)
    return ns.server.ServingConfig(**kw)


# -- ring protocol properties -------------------------------------------------


def test_torch_ring_wraparound_and_slot_reuse():
    r = _ring(nslots=3, rows=4)
    try:
        for batch in range(40):  # 40 batches through 3 slots
            slot = r.try_claim()
            assert slot is not None
            n = 1 + batch % 4
            slot.cols["a"][:n] = np.arange(batch * 10, batch * 10 + n)
            slot.cols["m"][:n] = batch % 251
            r.commit(n)
            got = r.poll()
            assert got is not None and got.count == n
            assert got.cols["a"][:n].tolist() == list(
                range(batch * 10, batch * 10 + n))
            assert (got.cols["m"][:n] == batch % 251).all()
            r.ack()
        assert r.produced == r.consumed == 40
    finally:
        r.close()


def test_torch_ring_full_is_loud_not_silent():
    r = _ring(nslots=2, rows=4)
    try:
        for _ in range(2):
            assert r.try_claim() is not None
            r.commit(1)
        assert r.try_claim() is None      # the consumer owns every slot
        t0 = time.monotonic()
        with pytest.raises(SHM.ShmBackpressure, match="full"):
            r.claim_wait(timeout_s=0.05)
        assert time.monotonic() - t0 < 2.0
        assert r.poll() is not None
        r.ack()
        assert r.try_claim() is not None
    finally:
        r.close()


def test_torch_ring_torn_producer_tombstone():
    r = _ring(nslots=2, rows=4)
    try:
        slot = r.try_claim()
        slot.cols["a"][:2] = (7, 8)   # mid-write ...
        assert r.poll() is None       # ... never visible to the consumer
        assert r.torn()               # ... and flagged as torn
        r.commit(2)
        assert not r.torn()
        got = r.poll()
        assert got is not None and got.count == 2
        r.ack()
    finally:
        r.close()


def test_torch_ring_deferred_ack_gathers_multiple_slots():
    r = _ring(nslots=4, rows=2)
    try:
        for i in range(3):
            s = r.try_claim()
            s.cols["a"][:1] = i
            r.commit(1)
        views = [r.poll() for _ in range(3)]
        assert [int(v.cols["a"][0]) for v in views] == [0, 1, 2]
        assert r.poll() is None
        assert r.pending_ack() == 3
        assert r.ack(2) == 2          # partial FIFO release
        assert r.pending_ack() == 1
        assert r.ack() == 1
        assert r.consumed == 3
    finally:
        r.close()


def test_torch_ring_attach_shares_the_creator_mapping():
    """The port's ring attaches to a ring the reference created (and the
    other way round): one layout, one protocol."""
    for maker, attacher in ((REF.shm, PORT.shm), (PORT.shm, REF.shm)):
        r = maker.SpscColumnRing.create(
            2, 4, (("a", "<i8", 0), ("m", "u1", 16)))
        try:
            other = attacher.SpscColumnRing.attach(r.spec)
            try:
                s = r.try_claim()
                s.cols["a"][:3] = (5, 6, 7)
                r.commit(3)
                got = other.poll()
                assert got is not None and got.count == 3
                assert got.cols["a"][:3].tolist() == [5, 6, 7]
                other.ack()
                assert r.try_claim() is not None  # ack seen by creator
            finally:
                other.close()
        finally:
            r.close()


# -- vectorised trace sampler against the scalar oracle ----------------------


@pytest.mark.parametrize("rate", [1, 7, 64, 1000])
def test_torch_sample_array_bit_exact_with_scalar(rate):
    for seed in (0, 1, 12345):
        sm = PORT.tracing.TraceSampler(rate, seed=seed)
        rsm = REF.tracing.TraceSampler(rate, seed=seed)
        seqs = np.concatenate([np.arange(512, dtype=np.uint64),
                               np.arange(2**63 - 256, 2**63 + 256,
                                         dtype=np.uint64)])
        vec = sm.sample_array(seqs)
        ref = np.array([rsm.sample(int(s)) for s in seqs], np.uint16)
        assert (vec == ref).all()
        assert (vec == rsm.sample_array(seqs)).all()
        if rate == 1:
            assert (vec != 0).all()


# -- per-row conn tagging through submit_batch --------------------------------


def test_torch_submit_batch_vector_conn_groups_refusals_like_pump():
    def drive(ns):
        w, ipc = ns.wire, ns.ipc
        clock = ns.server.VirtualClock()
        fe = ns.server.ColumnarFrontend(kvs(ns, _cfg(ns)), _scfg(ns),
                                        clock=clock)
        u, k = fe.u, 12
        rng = np.random.default_rng(3)
        b = w.ReqBatch(
            kind=np.where(rng.random(k) < 0.5, w.K_GET,
                          w.K_PUT).astype(np.uint8),
            req_id=np.arange(1, k + 1, dtype=np.uint32),
            tenant=np.zeros(k, np.uint16), trace=np.zeros(k, np.uint16),
            deadline_us=np.zeros(k, np.uint32),
            key=rng.integers(0, 64, k).astype(np.int64),
            value=rng.integers(0, 99, (k, u)).astype(np.int32))
        bad = b.key.copy()
        bad[0] = -1
        bad[5] = 1 << 40
        b.key = bad
        conn = np.array([ipc.pack_conn(i % 2, 1 + i % 3) for i in range(k)],
                        np.int32)
        refusals = fe.submit_batch(b, conn=conn)
        assert isinstance(refusals, dict)
        assert set(refusals) == {int(conn[0]), int(conn[5])}
        out = [(c, w.encode_response_batch(rb, u))
               for c, rb in sorted(refusals.items())]
        seen = {}
        for _ in range(200):
            emitted = fe.pump()
            for c in sorted(emitted):
                seen[c] = seen.get(c, 0) + len(emitted[c])
                out.append((c, w.encode_response_batch(emitted[c], u)))
            if fe.idle():
                break
            clock.advance(1e-3)
        assert fe.idle()
        expected = {}
        for i in range(k):
            if i not in (0, 5):
                expected[int(conn[i])] = expected.get(int(conn[i]), 0) + 1
        assert seen == expected
        for c in seen:
            assert 0 <= ipc.conn_worker(c) < 2
            assert 1 <= ipc.conn_local(c) <= 3
            assert ipc.pack_conn(ipc.conn_worker(c), ipc.conn_local(c)) == c
        return out, ns.server.verify_columnar(fe)

    same(drive)
    assert (IPC.CONN_BITS, IPC.MAX_WORKERS) == (REF.ipc.CONN_BITS,
                                                REF.ipc.MAX_WORKERS)
    assert IPC.req_ring_fields(4) == REF.ipc.req_ring_fields(4)
    assert IPC.rsp_ring_fields(4) == REF.ipc.rsp_ring_fields(4)


# -- the deterministic shm soak -----------------------------------------------


def _shm_soak(ns, **kw):
    if ns.port:
        kw["device"] = "cpu"
    res = ns.ipc.run_shm_soak(**kw)
    assert res["ok"] and res["checker_ok"]
    return {k: v for k, v in res.items() if not k.startswith("_")}


def test_torch_run_shm_soak_byte_identical_replay():
    def kw(ns, seed=14):
        return dict(cfg=_cfg(ns, n_keys=128, n_sessions=8), scfg=_scfg(ns),
                    n_workers=2, ops_per_worker=192, batch=48, seed=seed)

    r1 = same(lambda ns: _shm_soak(ns, **kw(ns)))
    assert _shm_soak(PORT, **kw(PORT)) == r1
    assert r1["response_rows"] == [192, 192]
    assert r1["ipc"]["rows_in"] == r1["ipc"]["rows_out"] == 384
    r3 = _shm_soak(PORT, **kw(PORT, seed=15))
    assert r3["worker_log_sha"] != r1["worker_log_sha"]


def test_torch_run_shm_soak_backpressure_shape_is_deterministic():
    def drive(ns):
        return _shm_soak(ns, cfg=_cfg(ns, n_keys=128, n_sessions=8),
                         scfg=_scfg(ns), n_workers=3, ops_per_worker=128,
                         batch=32, seed=5, nslots=2, slot_rows=16)

    r1 = same(drive)
    assert drive(PORT) == r1
    assert r1["response_rows"] == [128, 128, 128]


def test_torch_store_owner_rejects_heap_stores():
    fe = PORT.server.ColumnarFrontend(
        kvs(PORT, _cfg(PORT, max_value_bytes=32)), _scfg(PORT))
    rings = [IPC.create_ring_pair(fe.u, 2, 8, 0)]
    try:
        with pytest.raises(ValueError, match="fixed-value"):
            IPC.StoreOwner(fe, rings)
    finally:
        for a, b in rings:
            a.close()
            b.close()


# -- the real multi-process topology ------------------------------------------


def _batch(cl, u, n_keys, rng, tenant, k=64):
    kind = np.where(rng.random(k) < 0.5, W.K_GET, W.K_PUT).astype(np.uint8)
    return W.ReqBatch(
        kind=kind, req_id=cl.next_ids(k),
        tenant=np.full(k, tenant, np.uint16),
        trace=np.zeros(k, np.uint16),
        deadline_us=np.zeros(k, np.uint32),
        key=rng.integers(0, n_keys, k).astype(np.int64),
        value=rng.integers(0, 99, (k, u)).astype(np.int32))


def _one_store():
    cfg = PORT.HermesConfig(n_replicas=4, n_keys=1 << 10, n_sessions=64,
                            value_words=6)
    srv = IPC.OneStoreServer(kvs(PORT, cfg), _scfg(PORT), n_workers=2,
                             nslots=8, slot_rows=128)
    return cfg, srv


@pytest.mark.slow
def test_torch_one_store_server_round_trip():
    cfg, srv = _one_store()
    rng = np.random.default_rng(7)
    try:
        assert srv.alive() == 2
        clients = [PORT.rpc.ColumnarClient(srv.addr, srv.fe.u)
                   for _ in range(4)]
        for ci, cl in enumerate(clients):
            out = cl.call_batch(_batch(cl, srv.fe.u, cfg.n_keys, rng, ci))
            assert len(out) == 64
            assert all(r.status in (W.S_OK, W.S_RETRY_AFTER)
                       for r in out.values())
        for cl in clients:
            cl.close()
    finally:
        srv.close()
    assert srv.pump_error is None
    assert srv.fe.requests == srv.fe.responses
    assert srv.owner.counters()["dead_workers"] == []


@pytest.mark.slow
def test_torch_one_store_survives_worker_kill():
    cfg, srv = _one_store()
    rng = np.random.default_rng(11)
    try:
        clients = [PORT.rpc.ColumnarClient(srv.addr, srv.fe.u)
                   for _ in range(6)]
        for ci, cl in enumerate(clients):
            assert len(cl.call_batch(
                _batch(cl, srv.fe.u, cfg.n_keys, rng, ci))) == 64
        os.kill(srv.procs[0].pid, signal.SIGKILL)
        srv.procs[0].join(5)
        assert srv.alive() == 1
        time.sleep(0.5)
        survived = eof = 0
        for ci, cl in enumerate(clients):
            try:
                out = cl.call_batch(
                    _batch(cl, srv.fe.u, cfg.n_keys, rng, ci))
                assert len(out) == 64
                survived += 1
            except (ConnectionError, OSError):
                eof += 1
        assert survived >= 1 and survived + eof == 6
        assert srv.pump_error is None
        for cl in clients:
            cl.close()
    finally:
        srv.close()
    assert srv.owner.dead[0] and not srv.owner.dead[1]
    assert srv.fe.requests == srv.fe.responses


def test_torch_chip_smoke_serve_workers_rehearsal(monkeypatch, capsys):
    """``chip_smoke.phase_serve_workers`` on the CPU: worker processes
    with private stores at 1, 2 and 4 workers, the loopback cell and the
    4-worker one-store cell, each answered in full, without error, under
    its topology label."""
    import json

    import torch

    import chip_smoke as cs
    from torch_servepair import smoke_namespace

    torch.set_num_threads(1)
    out = cs.phase_serve_workers(torch, smoke_namespace(monkeypatch), "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cells = line["cells"]
    assert sorted(cells) == ["columnar_loopback", "columnar_workers_1",
                             "columnar_workers_2", "columnar_workers_4",
                             "one_store_workers_4"]
    assert all(c["error"] is None and c["ops_per_sec"] > 0
               for c in cells.values())
    assert cells["one_store_workers_4"]["topology"] == "one-store"
    assert out["launches"]["stats_block"] > cells["one_store_workers_4"][
        "rounds"]
