"""The port's phases engine on the ``sim`` backend (``runtime.Runtime``
over ``transport/sim.py``) against the JAX package's, bit for bit
(tolerance 0): every ``ReplicaState`` leaf and every ``Completions``
column after every round, the same drain round, equal histories, and the
checker green in both.

* Acceptance configs 1-5 at scale 0.01 on the lockstep ``SimTransport``.
* The drives of ``tests/test_sim_adversarial.py``: seeded drop / dup /
  delay schedules, a VAL blackout the replay scan recovers, one-way INV
  starvation, the delayed RMW conflict that must abort, and a stall ->
  remove -> rejoin.
* The failure detector (``MembershipService``) on the sim runtime, as in
  ``tests/test_membership.py``: a stall removed, a removal then a rejoin,
  a merely partitioned replica fenced, a healthy cluster never ejected.
"""

import hashlib

import numpy as np
import pytest

from torch_refpair import (acceptance_pair, assert_ops_equal,
                           assert_states_equal, drain_both, lockstep, pair,
                           port_state, ref_state, tap)


def h(*args) -> int:
    return int.from_bytes(hashlib.blake2b(repr(args).encode(),
                                          digest_size=4).digest(), "little")


def chaotic_schedule(seed, p_drop=0.15, p_dup=0.1, max_delay=3, until=300):
    """The reference test's seeded drop/dup/delay per (kind, src, dst,
    step); clean after ``until``."""

    def sched(kind, src, dst, step):
        if step >= until or src == dst:
            return [step]
        x = h(seed, kind, src, dst, step)
        if x % 1000 < p_drop * 1000:
            return []
        d = (x // 7) % (max_delay + 1)
        out = [step + d]
        if (x // 1000) % 1000 < p_dup * 1000:
            out.append(step + (x // 31) % (max_delay + 1))
        return out

    return sched


def small(seed, rmw_frac=0.5, **kw):
    base = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=8,
                ops_per_session=12, replay_age=6,
                workload=dict(read_frac=0.5, rmw_frac=rmw_frac, seed=seed))
    base.update(kw)
    return pair(**base)


def sim_pair(jc, pc, schedule=None, stream=None, record=True):
    """The reference and the port sim runtimes, each on its own
    SimTransport with the same schedule."""
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu.transport.sim import SimTransport as JS
    from hermes_tpu_torch.runtime import Runtime as PR
    from hermes_tpu_torch.transport.sim import SimTransport as PS

    kw = {} if schedule is None else dict(schedule=schedule)
    a = JR(jc, backend="sim", record=record,
           transport=JS(jc.n_replicas, **kw),
           stream=None if stream is None else stream[0])
    b = PR(pc, backend="sim", record=record,
           transport=PS(pc.n_replicas, **kw), device="cpu",
           stream=None if stream is None else stream[1])
    return a, b


def finish(a, b, comps):
    drain_both(a, b, comps)
    assert_states_equal(ref_state(a), port_state(b), "drained")
    assert_ops_equal(a.history_ops(), b.history_ops())
    va, vb = a.check(), b.check()
    assert va.ok and vb.ok, (vb.failures[:2], vb.undecided[:2])
    return b


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_torch_sim_acceptance_configs_round_by_round(n):
    from hermes_tpu.membership import MembershipService as JM
    from hermes_tpu_torch.membership import MembershipService as PM

    jc, pc = acceptance_pair(n, 0.01)
    a, b = sim_pair(jc, pc)
    comps = (tap(a), tap(b))
    if n == 4:
        a.attach_membership(JM(jc))
        b.attach_membership(PM(pc))
        lockstep(6, a, b, comps=comps)
        a.freeze(7)
        b.freeze(7)
    elif n == 5:
        lockstep(5, a, b, comps=comps)
        a.remove(6)
        b.remove(6)
        lockstep(10, a, b, comps=comps, where="removed")
        a.join(6, from_replica=0)
        b.join(6, from_replica=0)
    finish(a, b, comps)


@pytest.mark.parametrize("seed", range(4))
def test_torch_sim_chaos_drop_dup_delay(seed):
    jc, pc = small(30 + seed)
    a, b = sim_pair(jc, pc, chaotic_schedule(seed))
    comps = (tap(a), tap(b))
    rt = finish(a, b, comps)
    assert rt.counters()["n_write"] > 0


def test_torch_sim_val_blackout_replay_recovers():
    def sched(kind, src, dst, step):
        if kind == "val" and step < 30 and src != dst:
            return []
        return [step]

    jc, pc = small(40, replay_age=5)
    a, b = sim_pair(jc, pc, sched)
    comps = (tap(a), tap(b))
    finish(a, b, comps)


def test_torch_sim_inv_starvation_one_direction():
    def sched(kind, src, dst, step):
        if kind == "inv" and src == 0 and dst == 2 and step < 40:
            return [step + 5]
        return [step]

    jc, pc = small(41)
    a, b = sim_pair(jc, pc, sched)
    finish(a, b, (tap(a), tap(b)))


def test_torch_sim_rmw_delayed_conflict_aborts():
    """Two RMWs on key 0 from one base version, the higher-ts INV hidden
    from replica 0 past the lower RMW's would-be commit: exactly one
    commits and one aborts, in both packages."""
    from hermes_tpu.core import state as jst
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.core import types as t

    jc, pc = pair(n_replicas=3, n_keys=8, n_sessions=1, replay_slots=2,
                  ops_per_session=1, workload=dict(read_frac=0.5, seed=0))
    op = np.zeros((3, 1, 1), np.int32)
    op[0, 0, 0] = t.OP_RMW
    op[1, 0, 0] = t.OP_RMW
    key = np.zeros((3, 1, 1), np.int32)

    def sched(kind, src, dst, step):
        if kind == "inv" and src == 1 and dst == 0 and step < 3:
            return [step + 2]
        return [step]

    a, b = sim_pair(jc, pc, sched, stream=(jst.OpStream(op=op, key=key),
                                           st.OpStream(op=op, key=key)))
    comps = (tap(a), tap(b))
    rt = finish(a, b, comps)
    c = rt.counters()
    assert int(c["n_rmw"]) == 1 and int(c["n_abort"]) == 1, c


def test_torch_sim_stall_remove_rejoin():
    jc, pc = small(42, n_replicas=4, ops_per_session=20, replay_age=5)
    a, b = sim_pair(jc, pc)
    comps = (tap(a), tap(b))
    lockstep(5, a, b, comps=comps)
    a.freeze(2)
    b.freeze(2)
    lockstep(pc.lease_steps, a, b, comps=comps, where="frozen")
    a.remove(2)
    b.remove(2)
    lockstep(30, a, b, comps=comps, where="removed")
    a.join(2, from_replica=0)
    b.join(2, from_replica=0)
    finish(a, b, comps)
    got = port_state(b)
    assert (got.table.state == 0).all()
    for r in range(1, 4):
        np.testing.assert_array_equal(got.table.ver[0], got.table.ver[r])
        np.testing.assert_array_equal(got.table.val[0], got.table.val[r])


def _member_pair(seed, schedule=None, **kw):
    from hermes_tpu.membership import MembershipService as JM
    from hermes_tpu_torch.membership import MembershipService as PM

    base = dict(n_replicas=4, n_keys=64, n_sessions=4, replay_slots=8,
                ops_per_session=20, replay_age=5, lease_steps=6,
                workload=dict(read_frac=0.4, rmw_frac=0.2, seed=seed))
    base.update(kw)
    jc, pc = pair(**base)
    a, b = sim_pair(jc, pc, schedule)
    a.attach_membership(JM(jc))
    b.attach_membership(PM(pc))
    return pc, a, b


def _events(rt):
    return [(e.kind, e.replica, e.step) for e in rt.membership.events]


def test_torch_sim_detector_removes_stalled_replica():
    pc, a, b = _member_pair(50)
    comps = (tap(a), tap(b))
    lockstep(5, a, b, comps=comps)
    a.freeze(3)
    b.freeze(3)
    lockstep(pc.lease_steps + 3, a, b, comps=comps, where="stalled")
    assert _events(a) == _events(b)
    assert b.membership.events[0].kind == "remove"
    assert b.membership.events[0].replica == 3
    finish(a, b, comps)


def test_torch_sim_detector_then_rejoin_converges():
    pc, a, b = _member_pair(51)
    comps = (tap(a), tap(b))
    lockstep(4, a, b, comps=comps)
    a.freeze(2)
    b.freeze(2)
    lockstep(pc.lease_steps + 13, a, b, comps=comps, where="stalled")
    a.join(2, from_replica=0)
    b.join(2, from_replica=0)
    assert _events(a) == _events(b)
    assert ("join", 2) in [(k, r) for k, r, _s in _events(b)]
    finish(a, b, comps)
    got = port_state(b)
    assert (got.table.state == 0).all()


def test_torch_sim_detector_fences_partitioned_replica():
    """A replica merely partitioned by the SimTransport (messages dropped,
    the replica alive) is removed by the detector and fenced."""

    def partition_2(kind, src, dst, step):
        if (src == 2 or dst == 2) and src != dst and 5 <= step:
            return []
        return [step]

    pc, a, b = _member_pair(53, partition_2, n_replicas=3,
                            ops_per_session=30,
                            workload=dict(read_frac=0.6, rmw_frac=0.0,
                                          seed=53))
    comps = (tap(a), tap(b))
    lockstep(5 + pc.lease_steps + 3, a, b, comps=comps)
    assert _events(a) == _events(b)
    assert ("remove", 2) in [(k, r) for k, r, _s in _events(b)]
    assert b.frozen[2]
    finish(a, b, comps)


def test_torch_sim_healthy_cluster_never_ejects():
    pc, a, b = _member_pair(52)
    lockstep(3 * pc.lease_steps, a, b, comps=(tap(a), tap(b)))
    assert not b.membership.events and not a.membership.events
    assert int(b.live[0]) == pc.full_mask


def test_torch_sim_join_remints_inflight_timestamp(monkeypatch):
    """A fault of the reference protocol, held equal in the port: replica
    2's write of key 5 is in flight while its INVs are cut off; it is
    removed and re-joined from replica 0, whose copy of key 5 is still at
    version 0, so its second session issues version 1 again: two writes
    with one timestamp and two values reach the other replicas in one
    round.  Both packages keep the last lane's row (JAX's CPU scatter;
    the port on every device), round by round equal."""
    import torch

    from hermes_tpu.core import state as jst
    from hermes_tpu_torch.core import phases
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.core import types as t

    jc, pc = pair(n_replicas=3, n_keys=16, n_sessions=2, replay_slots=2,
                  ops_per_session=1, replay_age=50,
                  workload=dict(read_frac=0.5, seed=0))
    op = np.zeros((3, 2, 1), np.int32)
    op[2] = t.OP_WRITE
    key = np.full((3, 2, 1), 5, np.int32)

    def sched(kind, src, dst, step):
        if src == 2 and dst != 2 and step < 10:
            return []
        return [step]

    seen = []
    real = phases.inv_winners

    def inv_winners(*args):
        w = real(*args)
        for r in range(w.key.shape[0]):
            rows = {}
            for lane in torch.nonzero(w.beats_all[r]).flatten().tolist():
                rows.setdefault(int(w.key[r, lane]), []).append(
                    (lane, tuple(w.val[r, lane].tolist()),
                     int(w.ver[r, lane]), int(w.fc[r, lane])))
            for k, rs in rows.items():
                if len({v for _l, v, _ver, _fc in rs}) > 1:
                    kept = torch.nonzero(w.beats[r]).flatten().tolist()
                    seen.append((r, k, rs, [x for x in kept
                                            if int(w.key[r, x]) == k]))
        return w

    monkeypatch.setattr(phases, "inv_winners", inv_winners)
    a, b = sim_pair(jc, pc, sched, stream=(jst.OpStream(op=op, key=key),
                                           st.OpStream(op=op, key=key)))
    comps = (tap(a), tap(b))
    lockstep(3, a, b, comps=comps)
    a.remove(2)
    b.remove(2)
    lockstep(7, a, b, comps=comps, where="removed")
    a.join(2, from_replica=0)
    b.join(2, from_replica=0)
    lockstep(6, a, b, comps=comps, where="joined")
    assert seen, "no two writes met with one timestamp"
    for _r, _k, rows, kept in seen:
        assert len({(ver, fc) for _l, _v, ver, fc in rows}) == 1
        assert kept == [max(lane for lane, *_ in rows)]
