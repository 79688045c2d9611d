"""The port's elastic operations (live resize in hermes_tpu_torch/runtime.py
and kvs.py, the drills of hermes_tpu_torch/elastic/drill.py) and its
degraded mode, against the reference's (hermes_tpu/elastic,
hermes_tpu/kvs.py).

Each drive of ``tests/test_elastic.py`` (resize under traffic, the
guards, a refused shrink leaving no retirement, a wedged drain refused,
the administrative shrink on the membership log, the rolling restart and
the rolling resize) and a degraded-mode drive (writes shed while too few
replicas are healthy, gets served, writes commit again once healed) runs
on both packages from the same config: completion kinds and values,
``rejected_ops``, ``shed_writes``, drill results and every leaf of the
final state must be equal, and both checkers green.  The reference is
settled at depth 2 (ROADMAP C)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import chaos as ref_chaos
from hermes_tpu import elastic as ref_elastic
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.membership import MembershipService as RefService
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import chaos, convert, elastic
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.kvs import C_REJECTED, KVS
from hermes_tpu_torch.membership import MembershipService
from hermes_tpu_torch.obs import Observability
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _cfgs(**over):
    kw = dict(n_replicas=4, n_keys=64, n_sessions=4, value_words=6,
              replay_slots=8, workload=RefWL(seed=3))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _drill_cfgs():
    return _cfgs(n_keys=96, ops_per_session=48, replay_age=6,
                 replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
                 pipeline_depth=2,
                 workload=RefWL(read_frac=0.4, rmw_frac=0.25, seed=7))


def _settle(rt):
    """Each dispatched reference round completes before host code goes
    on (ROADMAP C); what it computes is unchanged."""
    dispatch = rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, rt.fs))
        return comp

    rt.dispatch_round = settled


def _kvs_pair(rc, cfg, record=True, **kw):
    ref = RefKVS(rc, record=record, **kw)
    if rc.pipeline_depth > 1:
        _settle(ref.rt)
    return ref, KVS(cfg, record=record, device="cpu", **kw)


def _assert_state_equal(ref_rt, rt):
    got = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
    want = jax.device_get(ref_rt.fs)
    for part in ("table", "sess", "replay", "meta"):
        a, b = getattr(want, part), getattr(got, part)
        for f in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{part}.{f}")
    np.testing.assert_array_equal(rt.live, ref_rt.live)
    np.testing.assert_array_equal(rt.epoch, ref_rt.epoch)
    np.testing.assert_array_equal(rt.frozen, ref_rt.frozen)


def _res(f):
    c = f.result()
    return (c.kind, c.key, c.value, c.uid, c.step)


def _both(drive, rc, cfg, **kw):
    """Run ``drive(kvs)`` on the reference and the port: equal outputs,
    counters and state; returns the port's output and KVS."""
    ref, kvs = _kvs_pair(rc, cfg, **kw)
    want = drive(ref)
    got = drive(kvs)
    assert got == want
    assert (kvs.rejected_ops, kvs.shed_writes) == \
        (ref.rejected_ops, ref.shed_writes)
    assert sorted(kvs._retired) == sorted(ref._retired)
    _assert_state_equal(ref.rt, kvs.rt)
    return got, kvs


# -- live resize ---------------------------------------------------------------


def _resize_drive(kvs):
    futs = [kvs.put(r, s, (r * 4 + s) % 64, [r, s])
            for r in range(4) for s in range(4)]
    assert kvs.run_until(futs)
    queued = kvs.put(3, 0, 7, [1])  # swept by the shrink
    kvs.shrink(3)
    late = kvs.put(3, 1, 5, [9])  # to a retired replica: rejected now
    f2 = kvs.put(0, 0, 5, [9])
    assert kvs.run_until([f2])
    kvs.grow(3)
    g = kvs.get(3, 0, 5)
    assert kvs.run_until([g])
    return [_res(f) for f in futs + [queued, late, f2, g]]


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_resize_shrink_grow_under_traffic_identical(depth):
    rc, cfg = _cfgs(pipeline_depth=depth)
    got, kvs = _both(_resize_drive, rc, cfg)
    assert [k for k, *_ in got[16:18]] == ["rejected", "rejected"]
    assert got[18][0] == "put" and got[19][2][:1] == [9]
    assert kvs.rejected_ops == 2
    assert kvs.rt.check().ok


def test_torch_resize_guards():
    _, cfg = _cfgs()
    kvs = KVS(cfg, device="cpu")
    with pytest.raises(ValueError, match="already live"):
        kvs.rt.grow(2)
    kvs.shrink(2)
    with pytest.raises(ValueError, match="not live"):
        kvs.rt.shrink(2)
    kvs.grow(2)
    f = kvs.put(2, 0, 1, [1])
    assert kvs.run_until([f]) and f.result().kind == "put"
    rt = FastRuntime(cfg, device="cpu")
    for r in (1, 2, 3):
        rt.freeze(r)
    rt.remove(0)
    with pytest.raises(RuntimeError, match="donor"):
        rt.grow(0)


def test_torch_kvs_shrink_of_non_live_replica_leaves_no_retirement():
    def drive(kvs):
        kvs.rt.remove(2)  # a detector-style removal
        with pytest.raises(ValueError, match="not live"):
            kvs.shrink(2)
        assert 2 not in kvs._retired
        kvs.rt.join(2, from_replica=0)
        f = kvs.put(2, 0, 1, [1])
        assert kvs.run_until([f])
        return [_res(f)]

    rc, cfg = _cfgs()
    got, _ = _both(drive, rc, cfg, record=False)
    assert got[0][0] == "put"


def test_torch_shrink_refuses_a_wedged_drain():
    def drive(kvs):
        kvs.freeze(2)
        f = kvs.put(1, 0, 5, [1])
        for _ in range(3):
            kvs.step()
        with pytest.raises(RuntimeError, match="did not drain"):
            kvs.shrink(1, drain_steps=5)
        assert 1 not in kvs._retired
        return [f.done(), kvs.rt.step_idx]

    rc, cfg = _cfgs()
    got, _ = _both(drive, rc, cfg, record=False)
    assert got == [False, 8]


def test_torch_shrink_logs_an_administrative_remove():
    """A shrink lands on the membership log as 'shrink', not as a
    detector 'remove'; the grow as 'join'."""
    rc, cfg = _cfgs()
    out = []
    for rt, svc in ((RefRuntime(rc), RefService(rc, confirm_steps=3)),
                    (FastRuntime(cfg, device="cpu"),
                     MembershipService(cfg, confirm_steps=3))):
        rt.attach_membership(svc)
        rt.run(2)
        rt.shrink(1)
        rt.run(3)
        rt.grow(1)
        out.append([(e.step, e.kind, e.replica, e.live_mask)
                    for e in svc.events])
    assert out[0] == out[1] == [(2, "shrink", 1, 0b1101),
                                (5, "join", 1, 0b1111)]


# -- degraded mode ---------------------------------------------------------------


def _degraded_drive(kvs):
    obs = kvs.rt.attach_obs(Observability())
    assert not kvs.degraded()
    kvs.rt.freeze(1)
    kvs.rt.freeze(2)
    f_put = kvs.put(0, 0, 1, [5])
    f_get = kvs.get(0, 0, 1)
    assert f_put.done() and not f_get.done()  # reads are not shed
    bf = kvs.submit_batch(np.array([KVS.PUT, KVS.GET, KVS.RMW, KVS.GET]),
                          np.array([2, 2, 3, 4]),
                          np.array([[7, 7]]).repeat(4, axis=0))
    codes = bf.code.tolist()
    assert kvs.run_batch(bf)
    kvs.rt.thaw(1)
    kvs.rt.thaw(2)
    f2 = kvs.put(0, 1, 1, [6])
    assert kvs.run_until([f_get, f2], 300)
    ev = [r["name"] for r in obs.records
          if r.get("name", "").startswith("degraded")]
    return ([_res(f) for f in (f_put, f_get, f2)], codes,
            bf.code.tolist(), [bf.completion(i).kind for i in range(4)],
            ev, kvs.degraded())


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_degraded_mode_sheds_writes_serves_gets_identical(depth):
    rc, cfg = _cfgs(n_replicas=3, min_healthy_for_writes=2,
                    pipeline_depth=depth)
    got, kvs = _both(_degraded_drive, rc, cfg)
    res, codes, final, kinds, ev, degraded = got
    assert res[0][0] == "rejected" and res[1][0] == "get"
    assert res[2][0] == "put"
    assert codes == [C_REJECTED, 0, C_REJECTED, 0]
    assert kinds == ["rejected", "get", "rejected", "get"]
    assert final[1] == final[3] == t.C_READ
    assert ev == ["degraded", "degraded_clear"] and not degraded
    assert kvs.shed_writes == 3 and kvs.rejected_ops == 0
    assert kvs.rt.check().ok


def test_torch_degraded_shed_does_not_burn_sparse_slots():
    def drive(kvs):
        kvs.rt.freeze(1)
        kvs.rt.freeze(2)
        f = kvs.put(0, 0, 0xDEAD_BEEF_0001, [1])
        bf = kvs.submit_batch(np.array([KVS.PUT, KVS.GET]),
                              np.array([0xDEAD_BEEF_0002] * 2,
                                       dtype=np.uint64),
                              np.array([[2, 2], [0, 0]]))
        return [f.result().kind, bf.code.tolist(), bf.found.tolist(),
                kvs.index.n_used]

    rc, cfg = _cfgs(n_replicas=3, min_healthy_for_writes=2)
    got, kvs = _both(drive, rc, cfg, record=False, sparse_keys=True)
    assert got == ["rejected", [C_REJECTED, t.C_READ], [False, False], 0]
    assert kvs.shed_writes == 2


def test_torch_degraded_floor_counts_retired_replicas_out():
    """A replica retired by a shrink is not healthy for the floor."""
    _, cfg = _cfgs(min_healthy_for_writes=4)
    kvs = KVS(cfg, device="cpu")
    f = kvs.put(0, 0, 1, [1])
    assert kvs.run_until([f]) and f.result().kind == "put"
    kvs.shrink(3)
    assert kvs.degraded() and kvs.put(0, 1, 2, [2]).result().kind == \
        "rejected"
    kvs.grow(3)
    assert not kvs.degraded()


# -- the drills -------------------------------------------------------------------


def test_torch_rolling_restart_drill_identical_to_reference():
    rc, cfg = _drill_cfgs()
    ref = RefRuntime(rc, record=True)
    _settle(ref)
    want = ref_elastic.run_rolling_restart(ref, start=4, spacing=8,
                                           check=True)
    rt = FastRuntime(cfg, record=True, device="cpu")
    got = elastic.run_rolling_restart(rt, start=4, spacing=8, check=True)
    for k in ("restarts", "lost_ops", "lost_client_futures", "drained",
              "checked_ok", "events", "steps"):
        assert got[k] == want[k], k
    assert got["restarts"] == 4 and got["drained"] and got["checked_ok"]
    assert got["dip"]["windows"] == want["dip"]["windows"] > 0
    assert got["dip"]["dip_pct"] is not None
    assert "worst_window" in got["dip"]
    _assert_state_equal(ref, rt)


def test_torch_rolling_restart_schedule_identical_to_reference():
    """The drill's program through the runner directly, the detector
    attached: byte-identical logs and equal state."""
    rc, cfg = _drill_cfgs()
    ref = RefRuntime(rc, record=True)
    _settle(ref)
    ref.attach_membership(RefService(rc, confirm_steps=2))
    rr = ref_chaos.ChaosRunner(ref, ref_chaos.Schedule.rolling_restart(
        rc, start=4, spacing=8), spec=ref_chaos.ChaosSpec(min_healthy=2))
    rr.run(44, check=True)
    rt = FastRuntime(cfg, record=True, device="cpu")
    rt.attach_membership(MembershipService(cfg, confirm_steps=2))
    runner = chaos.ChaosRunner(rt, chaos.Schedule.rolling_restart(
        cfg, start=4, spacing=8), spec=chaos.ChaosSpec(min_healthy=2))
    res = runner.run(44, check=True)
    assert res["checked_ok"] and runner.log_json() == rr.log_json()
    assert [e.kind for e in rt.membership.events] == ["join"] * 4
    _assert_state_equal(ref, rt)


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_rolling_resize_drill_identical_to_reference(depth):
    rc, cfg = _cfgs(ops_per_session=1, pipeline_depth=depth)
    ref, kvs = _kvs_pair(rc, cfg)
    out = []
    for pkg, store in ((ref_elastic, ref), (elastic, kvs)):
        bf = pkg.submit_drill_mix(store, 600, seed=5)
        res = pkg.rolling_resize(store, hold_steps=4, check=True)
        assert store.run_batch(bf)
        out.append((res["resizes"], res["cycles"], res["rejected_ops"],
                    res["checked_ok"], res["dip"]["windows"],
                    bf.code.tolist(), bf.value.tolist(), bf.step.tolist()))
    assert out[0] == out[1]
    assert out[1][0] == 4 and out[1][3]
    assert res["dip"]["dip_pct"] is not None
    _assert_state_equal(ref.rt, kvs.rt)


def test_torch_rolling_resize_rejects_per_op_traffic_on_retired_replicas():
    """Per-op traffic queued on a replica while it is retired resolves
    ``rejected``; nothing is stranded."""
    _, cfg = _cfgs()
    kvs = KVS(cfg, record=True, device="cpu")
    kvs.shrink(2)
    futs = [kvs.put(r, s, 10 + 4 * r + s, [r]) for r in range(4)
            for s in range(4)]
    assert kvs.run_until(futs)
    kinds = [f.result().kind for f in futs]
    assert kinds == ["put"] * 8 + ["rejected"] * 4 + ["put"] * 4
    kvs.grow(2)
    assert kvs.rejected_ops == 4 and kvs.rt.check().ok
