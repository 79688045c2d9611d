"""The port's failure detector (hermes_tpu_torch/membership.py and the
runtime's age ring) against the reference's (hermes_tpu/membership.py,
hermes_tpu/runtime.py).

The four drives of ``tests/test_membership.py`` (a stalled replica
removed, a removal then a rejoin, a partitioned replica fenced, a healthy
cluster never ejected) run on both packages' FastRuntime from the same
config: the membership events, the suspicions, the live mask, the epoch,
the frozen flags and every leaf of the final state must be equal, and
both checkers green.  The reference is settled at depth 2 (each
dispatched round completes before host code goes on): its ``_ctl`` may
alias the host's frozen/live rows on the CPU, so a removal the detector
makes inside a harvest could reach a round already dispatched (ROADMAP
C).  The port's own tests run at depth 2 unsettled: the ages ride the
ring one per round, a pipelined run makes no ``membership_fetch``, a run
that never harvests falls back to it, the confirm window cancels a
suspicion, and a rejoined replica is not re-ejected on pre-join ages."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.membership import MembershipService as RefService
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import chaos, convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.membership import MembershipService
from hermes_tpu_torch.obs import Observability
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _cfgs(seed=50, **over):
    kw = dict(n_replicas=4, n_keys=64, n_sessions=4, replay_slots=8,
              ops_per_session=20, replay_age=5, lease_steps=6,
              workload=RefWL(read_frac=0.4, rmw_frac=0.2, seed=seed))
    kw.update(over)
    rc = RefConfig(**kw)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def settle(ref):
    """Each round the reference dispatches completes before host code
    goes on (ROADMAP C); what it computes is unchanged."""
    dispatch = ref.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, ref.fs))
        return comp

    ref.dispatch_round = settled
    return ref


def pair(rc, cfg, backend="batched", record=True, **svc):
    """The reference and the port, each with a detector attached."""
    mesh = None
    if backend == "sharded":
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:rc.n_replicas]), ("replica",))
    ref = RefRuntime(rc, backend=backend, mesh=mesh, record=record)
    if rc.pipeline_depth > 1:
        settle(ref)
    rt = FastRuntime(cfg, backend=backend, record=record, device="cpu")
    ref.attach_membership(RefService(rc, **svc))
    rt.attach_membership(MembershipService(cfg, **svc))
    return ref, rt


def events(svc):
    return [(e.step, e.kind, e.replica, e.live_mask, e.group)
            for e in svc.events]


def assert_same(ref, rt, what=""):
    assert events(rt.membership) == events(ref.membership), what
    assert rt.membership.suspects == ref.membership.suspects, what
    assert rt.membership.severed_edges() == ref.membership.severed_edges()
    np.testing.assert_array_equal(rt.live, ref.live, err_msg=what)
    np.testing.assert_array_equal(rt.epoch, ref.epoch, err_msg=what)
    np.testing.assert_array_equal(rt.frozen, ref.frozen, err_msg=what)
    assert rt.step_idx == ref.step_idx, what
    got = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
    want = jax.device_get(ref.fs)
    for part in ("table", "sess", "replay", "meta"):
        a, b = getattr(want, part), getattr(got, part)
        for f in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{what} {part}.{f}")


# the four drives of tests/test_membership.py on the fast engines; each
# runs the same calls on either package's runtime

def drive_stalled_replica_removed(rt, cfg):
    rt.run(5)
    rt.freeze(3)
    rt.run(cfg.lease_steps + 3)
    evt = rt.membership.events[0]
    assert evt.kind == "remove" and evt.replica == 3
    assert not (int(rt.live[0]) >> 3) & 1
    assert rt.drain(500)


def drive_removed_then_rejoined(rt, cfg):
    rt.run(4)
    rt.freeze(2)
    rt.run(cfg.lease_steps + 3)
    assert any(e.kind == "remove" and e.replica == 2
               for e in rt.membership.events)
    rt.run(10)
    rt.join(2, from_replica=0)
    assert rt.membership.events[-1].kind == "join"
    assert rt.drain(500)


def drive_partitioned_replica_fenced(rt, cfg):
    # replica 2 stays unfrozen: every observer stops hearing it from
    # round 5 on (the detector-level partition of the fast engines)
    rt.run(5)
    rt.membership.sever(2, -1, at_step=rt.step_idx)
    rt.run(cfg.lease_steps + 3)
    assert any(e.kind == "remove" and e.replica == 2
               for e in rt.membership.events)
    assert rt.frozen[2], "a removed replica must be fenced"
    assert rt.drain(500)


def drive_healthy_never_ejects(rt, cfg):
    rt.run(3 * cfg.lease_steps)
    assert not rt.membership.events
    assert int(rt.live[0]) == cfg.full_mask
    assert rt.drain(500)


DRIVES = {"stalled": (drive_stalled_replica_removed, 50),
          "rejoined": (drive_removed_then_rejoined, 51),
          "partitioned": (drive_partitioned_replica_fenced, 53),
          "healthy": (drive_healthy_never_ejects, 52)}


@pytest.mark.parametrize("backend,depth", [("batched", 1), ("batched", 2),
                                           ("sharded", 2)])
@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_torch_membership_drive_identical_to_reference(drive, backend,
                                                       depth):
    fn, seed = DRIVES[drive]
    rc, cfg = _cfgs(seed=seed, pipeline_depth=depth)
    ref, rt = pair(rc, cfg, backend=backend)
    fn(ref, rc)
    fn(rt, cfg)
    assert_same(ref, rt, drive)
    v = rt.check()
    assert v.ok, (v.failures[:2], v.undecided[:2])
    assert ref.check().ok


def _events(obs):
    return [r["name"] for r in obs.records if r.get("kind") == "event"]


def _chaos_cfg(**over):
    kw = dict(n_replicas=4, n_keys=96, n_sessions=6, replay_slots=6,
              ops_per_session=24, replay_age=6, replay_scan_every=4,
              rebroadcast_every=2, lease_steps=6,
              workload=RefWL(read_frac=0.4, rmw_frac=0.25, seed=23))
    kw.update(over)
    return HermesConfig(**dataclasses.asdict(RefConfig(**kw)))


@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_torch_detector_pipelined_makes_no_membership_fetch(backend):
    """At depth 2 the detector reads only harvested ages: zero
    ``membership_fetch`` events, the frozen replica suspected, then
    removed, and the healed run checks."""
    cfg = _chaos_cfg(pipeline_depth=2)
    rt = FastRuntime(cfg, backend=backend, record=True, device="cpu")
    obs = rt.attach_obs(Observability())
    rt.attach_membership(MembershipService(cfg, confirm_steps=3))
    rt.run(4)
    rt.freeze(3)
    rt.run(25)
    ev = _events(obs)
    assert "membership_fetch" not in ev
    assert ev.index("suspect") < ev.index("remove")
    assert [(e.kind, e.replica) for e in rt.membership.events] == \
        [("remove", 3)]
    assert rt.drain(1500) and rt.check().ok


def test_torch_harvested_ages_ride_the_ring_one_per_round():
    """Each harvest reads the age columns of the round it harvests, never
    of a round still in flight: at depth 3 the harvested round lags the
    newest dispatched one by two, one entry a round."""
    cfg = _chaos_cfg(pipeline_depth=3)
    rt = FastRuntime(cfg, record=True, device="cpu")
    rt.attach_membership(MembershipService(cfg))
    seen = []
    for _ in range(10):
        rt.step_once()
        assert len(rt._age_ring) == len(rt._ring)
        if rt.harvested_ages is not None:
            age_round, ages = rt.harvested_ages
            seen.append(age_round)
            assert age_round == rt.step_idx - 3
            assert ages.shape == (cfg.n_replicas, cfg.n_replicas)
    assert seen == list(range(8))
    assert rt.drain(1500) and rt.check().ok


def test_torch_detector_falls_back_to_fetch_without_harvest():
    """``fetch_completions=False`` runs never harvest, so the detector
    polls synchronously, traced as ``membership_fetch``."""
    cfg = _chaos_cfg()
    rt = FastRuntime(cfg, device="cpu")
    rt.fetch_completions = False
    obs = rt.attach_obs(Observability())
    rt.attach_membership(MembershipService(cfg))
    rt.run(3)
    rt.freeze(3)
    rt.run(cfg.lease_steps + 3)
    assert "membership_fetch" in _events(obs)
    assert not rt._age_ring
    assert any(e.kind == "remove" and e.replica == 3
               for e in rt.membership.events)


def test_torch_confirm_window_cancels_a_suspicion():
    """A replica that recovers inside the confirm window is never
    removed: ``suspect_clear`` instead of an ejection."""
    cfg = _chaos_cfg(pipeline_depth=2)
    rt = FastRuntime(cfg, record=True, device="cpu")
    obs = rt.attach_obs(Observability())
    rt.attach_membership(MembershipService(cfg, confirm_steps=30))
    rt.run(3)
    rt.freeze(2)
    rt.run(cfg.lease_steps + 4)
    assert "suspect" in _events(obs)
    rt.thaw(2)
    rt.run(10)
    assert "suspect_clear" in _events(obs)
    assert not rt.membership.events
    assert int(rt.live[0]) == cfg.full_mask
    assert rt.drain(1500) and rt.check().ok


def test_torch_join_grace_keeps_a_rejoined_replica():
    """confirm_steps=0 at depth 2: a replica removed, then crash-restarted
    back in, is not removed again on the ages of rounds before its
    join."""
    cfg = _chaos_cfg(pipeline_depth=2)
    rt = FastRuntime(cfg, record=True, device="cpu")
    rt.attach_membership(MembershipService(cfg, confirm_steps=0))
    rt.run(6)
    rt.freeze(2)
    rt.run(cfg.lease_steps + 6)
    assert not (int(rt.live[0]) >> 2) & 1
    rt.thaw(2)
    chaos.restart_replica(rt, 2, donor=0)
    rt.run(cfg.lease_steps + 8)
    removes = [e for e in rt.membership.events
               if e.kind == "remove" and e.replica == 2]
    assert len(removes) == 1
    assert (int(rt.live[0]) >> 2) & 1
    assert rt.drain(2000) and rt.check().ok


def test_torch_detector_refuses_a_dist_group_rank():
    """A ``DistGroup`` rank holds some replicas' rows: the detector, which
    reads every replica's ages, is refused there loudly."""
    cfg = _chaos_cfg(n_replicas=2)
    rt = FastRuntime(cfg, backend="sharded", device="cpu")
    rt.group = SimpleNamespace(world=2)  # what a rank of two sees
    with pytest.raises(ValueError, match="single-process"):
        rt.attach_membership(MembershipService(cfg))
    assert rt.membership is None


def test_torch_membership_service_guards_and_oracle():
    cfg = _chaos_cfg()
    with pytest.raises(ValueError, match="confirm_steps"):
        MembershipService(cfg, confirm_steps=-1)
    svc = MembershipService(cfg)
    svc.sever(1, -1, at_step=4)
    svc.sever(1, 2, at_step=9)  # an edge already cut keeps its first round
    assert svc.severed_edges() == [(1, 0), (1, 2), (1, 3)]
    assert svc._severed[(1, 2)] == 4
    assert svc.restore(dst=0) == 1 and svc.heal_partitions() == 2
    assert svc.severed_edges() == []
