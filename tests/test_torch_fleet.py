"""The port's fleet (hermes_tpu_torch/fleet: FleetRouter, Fleet,
verify_fleet, FleetChaosRunner, run_fleet_cells; config.FleetConfig;
launch.run_fleet and the fleet layout; the CLI's --fleet-groups) against
the reference's (hermes_tpu/fleet, hermes_tpu/config.py,
hermes_tpu/launch.py, hermes_tpu/cli.py).

Each drive of ``tests/test_fleet.py`` on the batched backend (routing at
the range edges, batches over three groups, draining-range rejects, the
cross-group migration with its version re-anchor, the capacity refusal,
per-group fault isolation and membership, the obs labels, the snapshot
scope), the fleet reads of ``tests/test_readpath.py`` and the heap fleet
of ``tests/test_heap.py`` runs on both packages from the same config:
completions, router state, every group's state leaves and recorded
history must be equal, every checker and ``verify_fleet`` green.  The
fleet chaos replay gives byte-identical executed logs in both packages;
fleet snapshots load both ways.  Tolerance: exact."""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import chaos as ref_chaos
from hermes_tpu import fleet as ref_fleet
from hermes_tpu import launch as ref_launch
from hermes_tpu.config import (FleetConfig as RefFleetConfig,
                               HermesConfig as RefConfig,
                               WorkloadConfig as RefWL)
from hermes_tpu.obs import Observability as RefObs
from hermes_tpu_torch import chaos, convert, fleet, launch
from hermes_tpu_torch.config import FleetConfig, HermesConfig
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.kvs import C_REJECTED
from hermes_tpu_torch.obs import Observability
from hermes_tpu_torch.obs.report import fleet_totals, render_report

torch.set_num_threads(1)

REF = SimpleNamespace(fleet=ref_fleet, chaos=ref_chaos, Obs=RefObs)
PORT = SimpleNamespace(fleet=fleet, chaos=chaos, Obs=Observability)


def _base_kw(**over):
    kw = dict(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=4,
              ops_per_session=64, value_words=6, replay_scan_every=4,
              rebroadcast_every=2, lease_steps=4,
              workload=RefWL(read_frac=0.4, seed=3))
    kw.update(over)
    return kw


def _fcfgs(groups=3, fleet_kw=None, **over):
    rb = RefConfig(**_base_kw(**over))
    pb = HermesConfig(**dataclasses.asdict(rb))
    fk = fleet_kw or {}
    return (RefFleetConfig(groups=groups, base=rb, **fk),
            FleetConfig(groups=groups, base=pb, **fk))


def _make(P, fcfg, **kw):
    if P is REF:
        return ref_fleet.Fleet(fcfg, **kw)
    return fleet.Fleet(fcfg, device="cpu", **kw)


def _group_state(rt):
    if hasattr(rt, "n_copies"):
        fs = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
    else:
        fs = jax.device_get(rt.fs)
    out = {}
    for part in ("table", "sess", "replay", "meta"):
        p = getattr(fs, part)
        for f in p._fields:
            out[f"{part}.{f}"] = np.asarray(getattr(p, f))
    out.update(live=np.asarray(rt.live), frozen=np.asarray(rt.frozen),
               step=np.asarray(rt.step_idx))
    out["ver_base"] = (np.zeros(0) if rt._ver_base is None
                       else np.asarray(rt._ver_base))
    return out


def _ops(rt):
    return [(o.kind, o.key, o.inv, o.resp, o.wuid, o.ruid, o.ts)
            for o in rt.history_ops()]


def _assert_same_fleet(ref, port, history=True):
    np.testing.assert_array_equal(ref.router.rr._owner,
                                  port.router.rr._owner)
    np.testing.assert_array_equal(ref.router.rr._drain,
                                  port.router.rr._drain)
    np.testing.assert_array_equal(ref.router._local, port.router._local)
    assert ref.rejected_ops == port.rejected_ops
    assert ref._mig_minted == port._mig_minted
    assert ref._retired_slots == port._retired_slots
    for a, b in zip(ref.groups, port.groups):
        sa, sb = _group_state(a.rt), _group_state(b.rt)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k],
                                          err_msg=f"group {a.gid} {k}")
        assert a.kvs.rejected_ops == b.kvs.rejected_ops
        if history and a.rt.recorder is not None:
            assert _ops(a.rt) == _ops(b.rt), f"group {a.gid} history"


def _res(f):
    c = f.result()
    return (c.kind, c.key, c.value, c.uid, c.step, c.found)


def _both(drive, fcfgs, history=True, **kw):
    rf, pf = _make(REF, fcfgs[0], **kw), _make(PORT, fcfgs[1], **kw)
    want = drive(REF, rf)
    got = drive(PORT, pf)
    assert got == want
    _assert_same_fleet(rf, pf, history)
    return got, pf


# -- config and router -------------------------------------------------------------


def _config_drive(FC, HC):
    base = HC(**_base_kw())
    out = [FC(groups=2, base=base).total_keys]
    for kw in (dict(ranges=((0, 16), (17, 32))),
               dict(ranges=((0, 40), (40, 80))), dict(overrides=({},)),
               dict(groups=0)):
        with pytest.raises(ValueError) as e:
            FC(**dict(dict(groups=2, base=base), **kw))
        out.append(str(e.value))
    f = FC(groups=2, base=dataclasses.replace(base, wal_dir="/w"),
           overrides=({"n_sessions": 8}, None))
    out += [dataclasses.asdict(f.group_cfg(g)) for g in range(2)]
    out.append(f.group_range(1))
    return out


def test_torch_fleet_config_equals_reference():
    got = _config_drive(FleetConfig, HermesConfig)
    assert got == _config_drive(RefFleetConfig, RefConfig)
    assert got[5]["n_sessions"] == 8 and got[6]["workload"]["seed"] == 4
    assert got[6]["wal_dir"] == os.path.join("/w", "group001")


def _router_drive(R, FC, HC):
    r = R.from_config(FC(groups=3, base=HC(**_base_kw())))
    out = [r.owned_ranges(), [r.locate(k) for k in (0, 31, 32, 63, 64, 95)],
           [r.owner(k) for k in (0, 31, 32, 63, 64, 95)]]
    for k in (96, -1):
        with pytest.raises(ValueError) as e:
            r.owner(k)
        out.append(str(e.value))
    r2 = R(64, [(0, 24), (24, 64)])
    r2.begin_drain(40, 44)
    out.append([bool(r2.draining(k)) for k in (40, 43, 44)])
    for kw in ({}, dict(dest_slots=[1, 2])):
        with pytest.raises(ValueError) as e:
            r2.flip(40, 44, 0, **kw)
        out.append(str(e.value))
    r2.flip(40, 44, 0, dest_slots=[28, 29, 30, 31])
    r2.check_injective()
    out.append(r2.locate(41))
    r.begin_drain(40, 41)
    r.flip(40, 41, 0, dest_slots=[7])
    with pytest.raises(AssertionError) as e:
        r.check_injective()
    out.append(str(e.value))
    return out


def test_torch_fleet_router_equals_reference():
    got = _router_drive(fleet.FleetRouter, FleetConfig, HermesConfig)
    assert got == _router_drive(ref_fleet.FleetRouter, RefFleetConfig,
                                RefConfig)
    assert got[0] == [(0, 32, 0), (32, 64, 1), (64, 96, 2)]
    assert got[8] == (0, 29) and "alias" in got[9]


# -- routed sessions, batches, drains, reads ---------------------------------------


def _routing_drive(P, f):
    keys = [1, 31, 32, 63, 64, 95]  # both edge keys of every group
    futs = [f.put(i, k, [k, 9]) for i, k in enumerate(keys)]
    assert f.run_until(futs)
    gets = [f.get(i, k) for i, k in enumerate(keys)]
    assert f.run_until(gets)
    n = 24
    rng = np.random.default_rng(7)
    bkeys = rng.permutation(np.arange(96))[:n].astype(np.int64)
    kinds = np.where(np.arange(n) % 3 == 0, f.GET, f.PUT).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)[:, None] * np.ones((1, 4), np.int32)
    fb = f.submit_batch(kinds, bkeys, vals)
    assert f.run_batch(fb)
    subs = [(g, len(bf), gix.tolist()) for g, bf, gix in fb._subs]
    f.router.begin_drain(32, 48)
    rej = f.put(0, 40, [1])
    ok = f.put(0, 50, [1])
    dkeys = np.array([33, 40, 47, 48, 2, 70], np.int64)
    db = f.submit_batch(np.full(6, f.PUT, np.int32), dkeys,
                        np.ones((6, 1), np.int32))
    dcode = db.code.tolist()
    assert f.run_batch(db) and f.run_until([ok])
    mg = f.multi_get([3, 40, 70, 5], session=9)
    sc = f.scan(60, 68)
    f.router.release(32, 48)
    again = f.put(0, 40, [2])
    assert f.run_until([again])
    return [[_res(x) for x in futs + gets + [rej, ok, again]],
            fb.code.tolist(), fb.value.tolist(), fb.group.tolist(), subs,
            dcode, db.group.tolist(),
            [db.completion(i).kind for i in range(6)],
            mg.code.tolist(), mg.value.tolist(), mg.group.tolist(),
            sc.code.tolist(), sc.value.tolist(), sc.group.tolist(),
            f.rejected_ops, f.counters(), f.read_stats()]


def test_torch_fleet_routing_batches_drains_and_reads_identical():
    out, pf = _both(_routing_drive, _fcfgs(), record=True)
    results = out[0]
    assert [r[2][:2] for r in results[6:12]] == [[k, 9] for k in
                                                 (1, 31, 32, 63, 64, 95)]
    assert [r[1] for r in results[6:12]] == [1, 31, 32, 63, 64, 95]
    assert len({g for g, *_ in out[4]}) == 3
    assert out[5][:3] == [C_REJECTED] * 3 and out[6][:3] == [-1] * 3
    assert out[7][3] == "put" and out[8][1] == C_REJECTED
    assert set(out[13]) == {1, 2} and out[14] == 5
    v = pf.check()
    assert v["ok"] and v["fleet_invariants"] == "ok"


def test_torch_fleet_batch_carries_commit_timestamps():
    """The merged batch carries each committed op's timestamp from its
    group (the reference's merged view leaves it zero)."""
    _, fc = _fcfgs(groups=2)
    f = fleet.Fleet(fc, device="cpu")
    fb = f.submit_batch(np.full(4, f.PUT, np.int32),
                        np.array([1, 40, 2, 41], np.int64),
                        np.ones((4, 2), np.int32))
    assert f.run_batch(fb)
    for i in range(4):
        c = fb.completion(i)
        assert c.kind == "put" and c.ts[0] >= 1
    (_g, bf, gix), = [s for s in fb._subs if s[0] == 1]
    np.testing.assert_array_equal(fb.tsv[gix], bf.tsv)


# -- cross-group migration ---------------------------------------------------------


def _migrate_drive(P, f):
    futs = [f.put(i % 4, k, [k, r]) for r in range(2)
            for i, k in enumerate(range(34, 40))]
    assert f.run_until(futs)
    src_rt = f.groups[1].rt
    n_rebased = src_rt.rebase_versions()
    deltas = src_rt._ver_base.copy()
    s = f.migrate(34, 40, dst_group=0)
    gets = [f.get(0, k) for k in range(34, 40)]
    assert f.run_until(gets)
    ev = P.fleet.verify_fleet(f)
    summary = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in s.items() if k != "drain_rounds"}
    return [n_rebased, summary, [_res(g) for g in gets], ev,
            f.router.owned_ranges(), deltas[2:8].tolist(),
            f.groups[0].rt._ver_base[s["dest_slots"]].tolist(),
            f.check()["ok"]]


def test_torch_fleet_migration_identical():
    fcfgs = _fcfgs(groups=2, fleet_kw=dict(ranges=((0, 32), (32, 64))),
                   n_keys=48)
    out, _ = _both(_migrate_drive, fcfgs, record=True)
    n_rebased, s, gets, ev, ranges, deltas, anchored, ok = out
    assert n_rebased > 0 and ok
    assert s["src_group"] == 1 and s["dst_group"] == 0
    assert all(d >= 32 for d in s["dest_slots"])
    assert [g[2][:2] for g in gets] == [[k, 1] for k in range(34, 40)]
    assert ev["migration_uids"] == 6 and anchored == deltas
    assert ranges == [(0, 32, 0), (32, 34, 1), (34, 40, 0), (40, 64, 1)]


def test_torch_fleet_migration_refusals_identical():
    def drive(P, f):
        out = []
        with pytest.raises(ValueError) as e:
            f.migrate(32, 40, dst_group=0)  # ranges == n_keys: no spare
        out.append(str(e.value))
        for args in ((30, 34, 1), (0, 4, 0), (0, 4, 5)):
            with pytest.raises(ValueError) as e:
                f.migrate(*args)
            out.append(str(e.value))
        fut = f.put(0, 33, [1])
        assert f.run_until([fut])
        out.append(_res(fut))
        return out

    out, _ = _both(drive, _fcfgs(groups=2))
    assert "spare slot" in out[0] and out[-1][0] == "put"


# -- fault isolation, membership, obs ----------------------------------------------


def test_torch_fleet_chaos_on_group0_never_fences_group1():
    def drive(P, f):
        sched0 = P.chaos.Schedule.parse(
            "@2 freeze 1\n@6 crash_restart 2\n@14 thaw 1\n")
        runner = P.fleet.FleetChaosRunner(
            f, [sched0, P.chaos.Schedule([])],
            spec=P.chaos.ChaosSpec(min_healthy=1))
        g1 = f.groups[1].rt
        touched = []
        runner.on_step = lambda s: touched.append(
            bool(g1.frozen.any()) or int(g1.live[0]) != g1.cfg.full_mask)
        res = runner.run(20, heal=True)
        return [runner.log_json(), touched, res["lost_ops"],
                res["drained"], g1.healthy_replicas(),
                [(e.step, e.kind, e.replica, e.group)
                 for g in f.groups for e in g.rt.membership.events]]

    out, _ = _both(drive, _fcfgs(groups=2), history=False, detect=1)
    log = json.loads(out[0])
    kinds = [e["kind"] for e in log[0]]
    assert "freeze" in kinds and "crash_restart" in kinds
    assert log[1] == [] and not any(out[1]) and out[4] == [0, 1, 2]


def test_torch_fleet_membership_group_scoped():
    def drive(P, f):
        g0, g1 = f.groups[0].rt, f.groups[1].rt
        out = [g0.membership is not g1.membership,
               (g0.membership.group, g1.membership.group)]
        g0.freeze(1)
        out += [g0.healthy_replicas(), g1.healthy_replicas()]
        for _ in range(3 * f.cfg.base.lease_steps):
            f.step()
        out += [[(e.kind, e.group, e.replica) for e in g0.membership.events],
                g1.membership.events, int(g1.live[0])]
        return out

    out, _ = _both(drive, _fcfgs(groups=2), history=False, detect=0)
    assert out[:4] == [True, (0, 1), [0, 2], [0, 1, 2]]
    assert ("remove", 0, 1) in out[4] and out[5] == []


def test_torch_verify_fleet_catches_uid_aliasing():
    for record in (True, "array"):
        _, fc = _fcfgs(groups=2)
        f = fleet.Fleet(fc, record=record, device="cpu")
        assert fleet.verify_fleet(f)["migration_uids"] == 0
        for grp in f.groups:
            grp.rt.recorder.record_migration(
                np.array([1]), np.array([[5, -7]]), np.array([1]),
                np.array([0]), step=grp.rt.step_idx + 1)
        with pytest.raises(AssertionError, match="aliasing"):
            fleet.verify_fleet(f)


def test_torch_fleet_obs_group_labels_and_aggregation():
    def drive(P, f):
        obs = P.Obs()
        f.attach_obs(obs)
        f.groups[1].rt.freeze(0)
        f.groups[1].rt.thaw(0)
        futs = [f.put(i, k, [k]) for i, k in enumerate((2, 40, 70))]
        assert f.run_until(futs)
        f.interval_report(obs)
        evs = [(r["name"], r.get("group")) for r in obs.records
               if r.get("kind") == "event"]
        return [evs, [r for r in obs.records if r.get("kind") == "metrics"]]

    rf, pf = _fcfgs()
    want = drive(REF, ref_fleet.Fleet(rf, record=True))
    obs = Observability()
    f = fleet.Fleet(pf, record=True, device="cpu")
    got = drive(PORT, f)
    assert [e for e in got[0]] == [e for e in want[0]]
    assert ("freeze", 1) in got[0]
    f.attach_obs(obs)
    f.interval_report(obs)
    ft = fleet_totals(obs.records)
    assert set(ft["groups"]) == {0, 1, 2}
    assert ft["fleet"]["n_write"] == sum(
        r["n_write"] for r in ft["groups"].values()) == 3
    assert "-- fleet (per-group / aggregate, 3 group(s)) --" in \
        render_report(obs.records)


# -- fleet chaos replay ---------------------------------------------------------------


def _replay_drive(P, f):
    fcfg = f.cfg
    kinds = np.full(30, P.fleet.Fleet.PUT, np.int32)
    keys = (np.arange(30) * 5) % fcfg.total_keys
    fb = f.submit_batch(kinds, keys, np.ones((30, 1), np.int32))
    scheds = P.fleet.fleet_schedules(fcfg, seed=11, steps=18)
    runner = P.fleet.FleetChaosRunner(f, scheds,
                                      spec=P.chaos.ChaosSpec(min_healthy=2))
    res = runner.run(18, check=True)
    assert res["checked_ok"] and res["drained"], res
    f.run_batch(fb)
    return [runner.log_json(), [s.format() for s in scheds],
            fb.code.tolist(), res["lost_ops"], res["group_verdicts"]]


def test_torch_fleet_chaos_replay_byte_identical():
    """The same seeded fleet program on both packages (and twice on the
    port): byte-identical executed logs and schedule texts, equal group
    states and histories."""
    fcfgs = _fcfgs(groups=2, n_replicas=4)
    out, _ = _both(_replay_drive, fcfgs, record=True, detect=2)
    again = _replay_drive(PORT, fleet.Fleet(fcfgs[1], record=True,
                                            detect=2, device="cpu"))
    assert again[0] == out[0]
    assert json.loads(out[0])[0] or json.loads(out[0])[1]


def test_torch_parse_fleet_equals_reference():
    text = "@2 freeze 1\ng1@4 freeze 0\ng2@6 thaw 0  # comment\n"
    got = [s.format() for s in fleet.parse_fleet(text, groups=3)]
    assert got == [s.format() for s in ref_fleet.parse_fleet(text, 3)]
    assert [len(s) for s in fleet.parse_fleet(text, 3)] == [1, 1, 1]
    for mod in (fleet, ref_fleet):
        with pytest.raises(ValueError, match="group 7"):
            mod.parse_fleet("g7@1 freeze 0\n", groups=3)


# -- sharded groups, snapshots, the heap ------------------------------------------------


def test_torch_fleet_sharded_groups_on_replica_groups():
    """Sharded fleet groups, one replica group each (a ``LocalGroup`` a
    group here, a disjoint CPU submesh in the reference)."""
    rfc, pfc = _fcfgs(groups=2, n_replicas=2, n_sessions=2)

    def drive(P, f):
        futs = [f.put(i, k, [k, 3]) for i, k in enumerate((1, 31, 32, 63))]
        assert f.run_until(futs)
        gets = [f.get(i, k) for i, k in enumerate((1, 31, 32, 63))]
        assert f.run_until(gets)
        return [[_res(g) for g in futs + gets], f.check()["ok"]]

    rf = ref_fleet.Fleet(rfc, backend="sharded", record=True,
                         meshes=ref_launch.fleet_meshes(2, 2))
    groups = launch.fleet_replica_groups(2, device="cpu")
    pf = fleet.Fleet(pfc, backend="sharded", record=True,
                     replica_groups=groups)
    assert drive(PORT, pf) == drive(REF, rf)
    _assert_same_fleet(rf, pf)
    assert all(g.rt.n_copies == 2 for g in pf.groups)
    with pytest.raises(ValueError, match="one replica group per fleet"):
        fleet.Fleet(pfc, backend="sharded", device="cpu")


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_torch_fleet_snapshots_cross_load(tmp_path, direction):
    """A fleet snapshot written by either package loads in the other:
    every group's state and the router scope restored; a fleet of
    another shape refuses it."""
    rfc, pfc = _fcfgs(groups=2, fleet_kw=dict(ranges=((0, 32), (32, 64))),
                      n_keys=48)

    def fill(P, f):
        futs = [f.put(i, k, [k, 4]) for i, k in enumerate((3, 40, 36))]
        assert f.run_until(futs)
        f.migrate(36, 38, dst_group=0)
        f.drain()

    rf, pf = _make(REF, rfc), _make(PORT, pfc)
    fill(REF, rf)
    fill(PORT, pf)
    _assert_same_fleet(rf, pf, history=False)
    d = str(tmp_path / "fleet")
    saver, loader = (pf, _make(REF, rfc)) if direction == "port_to_ref" \
        else (rf, _make(PORT, pfc))
    manifest = saver.save(d)
    assert manifest["groups"] == 2 and len(manifest["archives"]) == 2
    loader.load(d)
    _assert_same_fleet(rf, loader, history=False)
    gets = [loader.get(0, k) for k in (36, 37, 40)]
    assert loader.run_until(gets)
    assert [g.result().value[:2] for g in gets] == [[36, 4], [0, 0], [40, 4]]
    other = (_make(PORT, _fcfgs(groups=3)[1]) if direction == "ref_to_port"
             else _make(REF, _fcfgs(groups=3)[0]))
    with pytest.raises(ValueError, match="not a fleet snapshot"):
        other.load(d)


def _pay(i: int, n: int) -> bytes:
    return bytes(((i * 37 + j * 151 + 128) & 0xFF) for j in range(n))


def test_torch_fleet_heap_roundtrip_and_migration_identical():
    fcfgs = _fcfgs(groups=2, fleet_kw=dict(ranges=((0, 32), (32, 64))),
                   n_keys=48, value_words=3, n_replicas=3,
                   max_value_bytes=128, heap_bytes=1 << 14,
                   workload=RefWL(read_frac=0.5, seed=3))
    keys = np.arange(40, dtype=np.int64)
    pays = [_pay(i, (i * 5) % 120) for i in range(40)]

    def drive(P, f):
        fb = f.submit_batch(np.full(40, f.PUT, np.int32), keys, pays)
        assert f.run_batch(fb, max_steps=4000)
        res = f.multi_get(keys)
        assert res.all_done()
        s = f.migrate(0, 8, 1)
        res2 = f.multi_get(keys)
        assert res2.all_done()
        return [res.data, s["heap_extents"], res2.data, f.check()["ok"]]

    out, _ = _both(drive, fcfgs, record=True)
    assert out[0] == pays and out[2] == pays and out[1] == 8 and out[3]


# -- launch and bench ------------------------------------------------------------------


def test_torch_group_of_rank_partitions_the_grid():
    """The rank-to-group partition, a pure function: the (groups,
    replicas) grid laid out row-major over the ranks, as the reference's
    ``group_of_process`` lays it over the devices of processes."""
    assert launch.group_of_rank(4, 2) == [0, 1, 2, 3]  # one process
    assert [launch.group_of_rank(4, 2, 4, r) for r in range(4)] == \
        [[0], [1], [2], [3]]
    assert [launch.group_of_rank(2, 4, 8, r) for r in range(8)] == \
        [[0]] * 4 + [[1]] * 4
    assert [launch.group_of_rank(4, 2, 2, r) for r in range(2)] == \
        [[0, 1], [2, 3]]
    # a rank straddling two groups serves both
    assert [launch.group_of_rank(3, 2, 2, r) for r in range(2)] == \
        [[0, 1], [1, 2]]
    # every group is served, by the ranks its replicas sit on
    for G, R, W in ((4, 2, 8), (3, 4, 6), (2, 3, 3)):
        served = [launch.group_of_rank(G, R, W, r) for r in range(W)]
        assert sorted({g for s in served for g in s}) == list(range(G))
    assert ref_launch.group_of_process(4, 2) == launch.group_of_rank(4, 2)
    with pytest.raises(ValueError, match="do not split"):
        launch.group_of_rank(3, 1, 2, 0)
    with pytest.raises(ValueError, match="rank"):
        launch.group_of_rank(2, 2, 2, 5)
    groups = launch.fleet_replica_groups(3, device="cpu")
    assert len(groups) == 3 and all(isinstance(g, LocalGroup)
                                    for g in groups)
    assert len({id(g) for g in groups}) == 3


def test_torch_run_fleet_equals_reference_counters():
    """``run_fleet``: G sharded group runtimes stepped in lockstep, each
    labeled with its group, counters equal to the reference's on its CPU
    fleet grid (2 groups of 4 replicas over the 8 CPU devices); a fleet
    over ranks without a rendezvous, or split unevenly, is refused."""
    rb = RefConfig(n_replicas=4, n_keys=64, n_sessions=8,
                   ops_per_session=32, wrap_stream=True)
    rfc = RefFleetConfig(groups=2, base=rb)
    pfc = FleetConfig(groups=2,
                      base=HermesConfig(**dataclasses.asdict(rb)))
    rts = launch.run_fleet(pfc, 6, device="cpu")
    want = ref_launch.run_fleet(rfc, 6)
    for g, (a, b) in enumerate(zip(want, rts)):
        assert b.fleet_group == g == a.group and b.step_idx == 6
        ca, cb = a.counters(), b.counters()
        assert {k: int(ca[k]) for k in ("n_read", "n_write", "n_rmw")} == \
            {k: int(cb[k]) for k in ("n_read", "n_write", "n_rmw")}
    # over ranks (tests/test_torch_fleet_ranks.py runs it): a rendezvous
    # is needed, and a group split unevenly over its ranks is refused
    # before any process group is made
    with pytest.raises(ValueError, match="init_method"):
        launch.run_fleet(pfc, 1, world_size=2, device="cpu")
    with pytest.raises(ValueError, match="equal share"):
        launch.run_fleet(FleetConfig(groups=4, base=dataclasses.replace(
            pfc.base, n_replicas=3)), 1, world_size=6, device="cpu")


def test_torch_fleet_bench_cells_equal_reference_commits():
    """``run_fleet_cells`` on the CPU: per-group and concurrent commits
    equal the reference's over the same rounds (the round is
    deterministic), rates positive; ``one_card`` only for groups sharing
    one card."""
    rb = RefConfig(n_replicas=3, n_keys=256, n_sessions=16,
                   ops_per_session=64, wrap_stream=True, device_stream=True)
    rfc = RefFleetConfig(groups=2, base=rb)
    pfc = FleetConfig(groups=2,
                      base=HermesConfig(**dataclasses.asdict(rb)))
    got = fleet.run_fleet_cells(pfc, rounds=4, chunks=2, device="cpu")
    from hermes_tpu.fleet.bench import run_fleet_cells as ref_cells

    want = ref_cells(rfc, rounds=4, chunks=2)
    assert [c["commits"] for c in got["per_group"]] == \
        [c["commits"] for c in want["per_group"]]
    assert got["concurrent"]["commits"] == want["concurrent"]["commits"]
    assert all(c["writes_per_sec"] > 0 for c in got["per_group"])
    assert got["one_card"] is False and got["platform"] == "cpu"
    with pytest.raises(ValueError, match="device_stream"):
        fleet.run_fleet_cells(_fcfgs(groups=2)[1], device="cpu")


# -- the CLI --------------------------------------------------------------------------


def test_torch_cli_fleet_drive_matches_reference(capsys):
    from hermes_tpu import cli as ref_cli
    from hermes_tpu_torch import cli

    argv = ["--replicas", "3", "--keys", "64", "--sessions", "8",
            "--value-words", "6", "--fleet-groups", "3", "--fleet-ops",
            "300", "--check"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in want.items() if k != "wall_s"}
    assert got["ok"] and got["done"] == 300 and got["checked_ok"]


@pytest.mark.parametrize("argv,msg", [
    (["--fleet-groups", "2"], "--value-words >= 3"),
    (["--fleet-groups", "-1", "--value-words", "4"], "must be >= 1"),
    (["--fleet-groups", "2", "--value-words", "4", "--backend",
      "fast-sharded"], "launch --fleet-groups"),
    (["--fleet-groups", "2", "--value-words", "4", "--drill", "migrate"],
     "separate drives"),
])
def test_torch_cli_fleet_refuses_bad_flags(capsys, argv, msg):
    from hermes_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", *argv])
    assert e.value.code == 2 and msg in capsys.readouterr().err
