"""The port's fault schedules and their runner (hermes_tpu_torch/chaos/
schedule.py) against the reference's (hermes_tpu/chaos/schedule.py).

Schedules: the text form round-trips, and ``Schedule.random`` (and the
drill, partition and overload programs) give the reference's ``format()``
text byte for byte from the same seed.  The runner: the same schedule on
both packages' FastRuntime, with the failure detector attached, on both
backends at depth 1 and 2 gives the reference's ``log_json()`` byte for
byte, equal membership events and final state, a green checker and
conserved counters (every op of every stream completed or lost to a
crash).  The reference is settled at depth 2 (ROADMAP C).  The port's own
runs at depth 2 are unsettled.  Verbs whose carrier is not ported (the
wire and legacy net verbs without a NetChaos, overload, powercut without
a kill carrier, partition without a detector) are refused when the runner
is built."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import chaos as ref_chaos
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu.membership import MembershipService as RefService
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import chaos, convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS
from hermes_tpu_torch.membership import MembershipService
from hermes_tpu_torch.obs import Observability
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _cfgs(**over):
    kw = dict(n_replicas=5, n_keys=96, n_sessions=6, replay_slots=6,
              ops_per_session=24, replay_age=6, replay_scan_every=4,
              rebroadcast_every=2, lease_steps=6,
              workload=RefWL(read_frac=0.4, rmw_frac=0.25, seed=23))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _settle(rt):
    """Each dispatched reference round completes before host code goes
    on (ROADMAP C); what it computes is unchanged."""
    dispatch = rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, rt.fs))
        return comp

    rt.dispatch_round = settled


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("replica",))


def _assert_state_equal(ref_fs, fs, n_copies):
    got = convert.fast_state_to_numpy(fs, n_copies=n_copies)
    want = jax.device_get(ref_fs)
    for part in ("table", "sess", "replay", "meta"):
        a, b = getattr(want, part), getattr(got, part)
        for f in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{part}.{f}")


def _membership_rows(svc):
    return [(e.step, e.kind, e.replica, e.live_mask) for e in svc.events]


# -- the schedule text -----------------------------------------------------------


def test_torch_schedule_parse_format_roundtrip():
    text = ("@12 freeze 2\n@18 thaw 2\n@30 crash_restart 2 donor=0\n"
            "@40 hb_skew 1 skew=9 until=55\n@15 net_drop 0 dst=3 until=40\n"
            "@20 overload x=2.5 until=30\n@22 partition 0 until=50 u=0.25\n")
    sched = chaos.Schedule.parse(text)
    assert len(sched) == 7 and sched.events[0].step == 12
    assert chaos.Schedule.parse(sched.format()).events == sched.events
    assert sched.format() == ref_chaos.Schedule.parse(text).format()
    with pytest.raises(ValueError, match="line 2.*unknown chaos event kind"):
        chaos.Schedule.parse("@1 freeze 0\n@3 meteor 1\n")
    with pytest.raises(ValueError, match="line 1"):
        chaos.Schedule.parse("12 freeze 2\n")
    with pytest.raises(ValueError, match="unknown field"):
        chaos.Schedule.parse("@1 freeze 0 colour=3\n")
    with pytest.raises(ValueError, match="unknown chaos event kind"):
        chaos.Schedule([chaos.ChaosEvent(step=1, kind="meteor")])


SPECS = {
    "default": {},
    "crash": dict(p_crash=0.03),
    "every_verb": dict(p_net=0.06, p_wire=0.05, p_partition=0.04,
                       p_skew=0.05),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 7, 23, 1234])
def test_torch_schedule_random_formats_the_references_text(seed, spec):
    rc, cfg = _cfgs()
    got = chaos.Schedule.random(cfg, seed, 300,
                                chaos.ChaosSpec(**SPECS[spec])).format()
    want = ref_chaos.Schedule.random(
        rc, seed, 300, ref_chaos.ChaosSpec(**SPECS[spec])).format()
    assert got == want and got.count("\n") > 10


def test_torch_schedule_programs_format_the_references_text():
    rc, cfg = _cfgs()
    pairs = [
        (chaos.Schedule.rolling_restart(cfg, start=3, spacing=5),
         ref_chaos.Schedule.rolling_restart(rc, start=3, spacing=5)),
        (chaos.Schedule.partition_drill(cfg, 200, window=9, spacing=20),
         ref_chaos.Schedule.partition_drill(rc, 200, window=9, spacing=20)),
        (chaos.Schedule.overload_storm(11, 200, n_windows=3),
         ref_chaos.Schedule.overload_storm(11, 200, n_windows=3)),
    ]
    for got, want in pairs:
        assert got.format() == want.format() and len(got)


# -- the runner against the reference ------------------------------------------

# every verb the fast engines carry, in one declarative program
DECLARED = """
@3 freeze 1
@8 thaw 1
@10 hb_skew 2 skew=7 until=12
@12 remove 4
@16 crash_restart 0 donor=2
@20 partition 3 until=40
@24 join 4 donor=1
@42 heal
@46 freeze
@54 crash_restart
@60 thaw
"""


def _schedule(pkg, cfg, which):
    if which == "random":
        return pkg.Schedule.random(cfg, seed=23, steps=120,
                                   spec=pkg.ChaosSpec(p_crash=0.03))
    return pkg.Schedule.parse(DECLARED)


@pytest.mark.parametrize("which", ["random", "declared"])
@pytest.mark.parametrize("backend,depth", [("batched", 1), ("batched", 2),
                                           ("sharded", 1), ("sharded", 2)])
def test_torch_chaos_runner_log_identical_to_reference(backend, depth,
                                                       which):
    rc, cfg = _cfgs(pipeline_depth=depth)
    mesh = _mesh(rc.n_replicas) if backend == "sharded" else None
    ref = RefRuntime(rc, backend=backend, mesh=mesh, record=True)
    if depth > 1:
        _settle(ref)
    ref.attach_membership(RefService(rc, confirm_steps=3))
    rr = ref_chaos.ChaosRunner(ref, _schedule(ref_chaos, rc, which))
    want = rr.run(120, check=True)

    rt = FastRuntime(cfg, backend=backend, record=True, device="cpu")
    rt.attach_membership(MembershipService(cfg, confirm_steps=3))
    runner = chaos.ChaosRunner(rt, _schedule(chaos, cfg, which))
    got = runner.run(120, check=True)

    assert runner.log_json() == rr.log_json()
    kinds = {e["kind"] for e in got["events"]}
    assert {"freeze", "thaw", "crash_restart"} <= kinds
    if which == "declared":
        assert {"hb_skew", "partition", "heal", "remove", "join"} <= kinds
    assert _membership_rows(rt.membership) == _membership_rows(ref.membership)
    assert any(e.kind == "remove" for e in rt.membership.events)
    assert got["drained"] and got["checked_ok"], got["check_failures"]
    assert want["drained"] and want["checked_ok"]
    assert (got["lost_ops"], got["lost_client_futures"]) == \
        (want["lost_ops"], want["lost_client_futures"])
    np.testing.assert_array_equal(rt.live, ref.live)
    np.testing.assert_array_equal(rt.epoch, ref.epoch)
    assert int(rt.live[0]) == cfg.full_mask  # healed: everyone back
    _assert_state_equal(ref.fs, rt.fs, rt.n_copies)
    c = rt.counters()
    total = c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"]
    assert total == (cfg.n_replicas * cfg.n_sessions * cfg.ops_per_session
                     - got["lost_ops"])


def test_torch_chaos_runner_on_a_kvs_identical_to_reference():
    """The runner stepping the client layer: the executed log, the
    futures' kinds and the KVS's net_phase tag equal the reference's."""
    rc, cfg = _cfgs(value_words=6, n_sessions=4, ops_per_session=1,
                    pipeline_depth=1)
    sched = "@2 freeze 1\n@5 partition 3 until=18\n@12 crash_restart 0\n" \
            "@20 thaw 1\n"
    out = []
    for pkg, kvs, svc in ((ref_chaos, RefKVS(rc, record=True), RefService),
                          (chaos, KVS(cfg, record=True, device="cpu"),
                           MembershipService)):
        kvs.rt.attach_membership(svc(kvs.cfg, confirm_steps=2))
        futs = [kvs.put(r, s, (7 * r + s) % 96, [r, s])
                for r in range(5) for s in range(4)]
        runner = pkg.ChaosRunner(kvs, pkg.Schedule.parse(sched))
        phases = []
        runner.on_step = lambda s, k=kvs, p=phases: p.append(k.net_phase)
        res = runner.run(30, check=True)
        out.append((runner.log_json(), [f.result().kind for f in futs],
                    phases, res["checked_ok"], res["drained"]))
    assert out[0] == out[1]
    assert out[1][3] and out[1][4]
    assert {"windows": ["partition:3->-1@18"]} in out[1][2]


def test_torch_runner_quorum_floor_skips_illegal_events():
    """The runner never freezes below the healthy floor."""
    _, cfg = _cfgs(n_replicas=4)
    rt = FastRuntime(cfg, record=True, device="cpu")
    sched = chaos.Schedule.parse("\n".join(
        f"@{s} freeze" for s in range(1, 20)) + "\n")
    runner = chaos.ChaosRunner(rt, sched, spec=chaos.ChaosSpec(min_healthy=3))
    res = runner.run(30, check=True)
    assert len([e for e in res["events"] if e["kind"] == "freeze"]) == 1
    assert res["drained"] and res["checked_ok"]


def test_torch_runner_remove_floor_and_heal():
    """An all-remove schedule stops at the healthy floor (the rest logged
    'skipped'), and the heal rejoins everyone."""
    _, cfg = _cfgs()
    rt = FastRuntime(cfg, record=True, device="cpu")
    sched = chaos.Schedule.parse(
        "\n".join(f"@0 remove {r}" for r in range(5)) + "\n")
    runner = chaos.ChaosRunner(rt, sched, spec=chaos.ChaosSpec(min_healthy=3))
    res = runner.run(20, check=True)
    assert len([e for e in res["events"] if e["kind"] == "remove"]) == 2
    assert len([e for e in res["events"] if e["kind"] == "skipped"]) == 3
    assert res["drained"] and res["checked_ok"]
    assert int(rt.live[0]) == cfg.full_mask


def test_torch_runner_second_run_replays_the_schedule():
    _, cfg = _cfgs(n_replicas=4)
    rt = FastRuntime(cfg, device="cpu")
    runner = chaos.ChaosRunner(rt, chaos.Schedule.parse("@2 freeze 1\n"
                                                        "@6 thaw 1\n"))
    runner.run(10)
    runner.run(10)
    assert [e["kind"] for e in runner.log].count("freeze") == 2


def test_torch_hb_skew_exercises_hysteresis_without_faults():
    """A skewed view pushes a healthy replica into suspicion; the skew
    lapses inside the confirm window, so nobody is ejected."""
    _, cfg = _cfgs(n_replicas=4, pipeline_depth=2)
    rt = FastRuntime(cfg, record=True, device="cpu")
    obs = rt.attach_obs(Observability())
    rt.attach_membership(MembershipService(cfg, confirm_steps=20))
    runner = chaos.ChaosRunner(rt, chaos.Schedule.parse(
        "@5 hb_skew 1 skew=9 until=15\n"))
    res = runner.run(40, check=True)
    ev = [r["name"] for r in obs.records if r.get("kind") == "event"]
    assert "hb_skew" in ev and "suspect" in ev and "suspect_clear" in ev
    assert "remove" not in ev
    assert res["drained"] and res["checked_ok"]


def test_torch_partition_heals_through_the_detector():
    """On the fast engines a partition acts through the detector: the
    cut-off replica is removed and fenced, and the heal rejoins it."""
    _, cfg = _cfgs(n_replicas=4, pipeline_depth=2)
    rt = FastRuntime(cfg, record=True, device="cpu")
    rt.attach_membership(MembershipService(cfg, confirm_steps=2))
    runner = chaos.ChaosRunner(rt, chaos.Schedule.parse(
        "@4 partition 2 until=30\n@32 heal\n"))
    seen = {}
    runner.on_step = lambda s: seen.setdefault(s, (
        rt.membership.severed_edges(), bool(rt.frozen[2]),
        int(rt.live[0])))
    res = runner.run(40, check=True)
    assert seen[20] == ([(2, 0), (2, 1), (2, 3)], True, 0b1011)
    assert seen[31] == ([], True, 0b1011)  # the window lapsed at 30
    assert [(e.kind, e.replica) for e in rt.membership.events] == \
        [("remove", 2), ("join", 2)]
    assert int(rt.live[0]) == cfg.full_mask and not rt.frozen.any()
    assert res["drained"] and res["checked_ok"]


@pytest.mark.parametrize("line,msg", [
    ("@3 netdrop 0 dst=1 until=9", "no fault interposer"),
    ("@3 netcorrupt 1 until=9", "no fault interposer"),
    ("@3 net_drop 0 dst=2 until=9", "no fault hook"),
    ("@3 net_dup 1 until=9", "no fault hook"),
    ("@3 overload x=3.0 until=9", "no load shaper"),
    ("@3 powercut", "no kill carrier"),
    ("@3 partition 1 until=9", "no MembershipService"),
])
def test_torch_runner_refuses_verbs_without_a_carrier(line, msg):
    """No verb is dropped silently: a verb whose carrier is not attached
    (or not ported) raises when the runner is built, as in the
    reference."""
    rc, cfg = _cfgs(n_replicas=3)
    rt = FastRuntime(cfg, device="cpu")
    with pytest.raises(ValueError, match=msg) as got:
        chaos.ChaosRunner(rt, chaos.Schedule.parse(line + "\n"))
    with pytest.raises(ValueError) as want:
        ref_chaos.ChaosRunner(RefRuntime(rc), ref_chaos.Schedule.parse(
            line + "\n"))
    assert str(got.value) == str(want.value)


def test_torch_runner_takes_legacy_net_verbs_with_a_netchaos():
    """With a ``NetChaos`` the legacy verbs open its windows (the sim
    transport reads them: ``tests/test_torch_netchaos.py``)."""
    _, cfg = _cfgs(n_replicas=3)
    net = chaos.NetChaos()
    runner = chaos.ChaosRunner(FastRuntime(cfg, device="cpu"),
                               chaos.Schedule.parse(
                                   "@1 net_delay 0 dst=2 skew=3 until=5\n"),
                               net=net)
    runner.run(3, heal=False)
    assert net.windows == [("delay", 0, 2, 1, 5, 3)]
    assert net("delay", 0, 2, 2) == [5] and net("delay", 0, 1, 2) == [2]
    runner._heal_adversary(3)
    assert net.windows == []
