"""The port's phases engine (``hermes_tpu_torch/core/step.py`` and
``runtime.Runtime``) on its in-process backends, held bit for bit
against the JAX package's ``Runtime``.

* Acceptance configs 1-5 (``hermes_tpu/acceptance.py:_cfg`` at scale
  0.01, with config 4's stall under the failure detector and config 5's
  remove and re-join), on the ``batched`` backend and on the ``sharded``
  one (a ``LocalGroup`` on the CPU against the reference's sharded
  backend on a mesh of virtual CPU devices): every ``ReplicaState`` leaf
  and every ``Completions`` column after every round, then the drained
  histories equal and the checker green in both.
* ``build_step_scan`` equal to the step loop and to the reference's
  scanned chunk; the sharded scan equal to the batched scan; the
  wrapped stream.
* The sharded step over a gloo ``DistGroup`` of three ranks (one replica
  each), every rank's rows after every round equal to the reference's.
* Entry points on the card raise without one.

Tolerance: exact (the state is integer).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_refpair import (acceptance_pair, assert_ops_equal,
                           assert_states_equal, drain_both, lockstep, pair,
                           port_state, ref_state, tap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.01


def _runtimes(n, backend):
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu_torch.runtime import Runtime as PR

    jc, pc = acceptance_pair(n, SCALE)
    mesh = None
    if backend == "sharded":
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:jc.n_replicas]), ("replica",))
    a = JR(jc, backend=backend, mesh=mesh, record=True)
    b = PR(pc, backend=backend, record=True, device="cpu")
    return jc, pc, a, b


@pytest.mark.parametrize("backend", ["batched", "sharded"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_torch_step_acceptance_configs_round_by_round(n, backend):
    from hermes_tpu.membership import MembershipService as JM
    from hermes_tpu_torch.membership import MembershipService as PM

    jc, pc, a, b = _runtimes(n, backend)
    comps = (tap(a), tap(b))
    if n == 4:
        # the stall: replica 7 frozen at round 6, the detector removes it
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
    drain_both(a, b, comps)
    assert_states_equal(ref_state(a), port_state(b), "drained")
    if n == 4:
        assert [(e.kind, e.replica) for e in a.membership.events] == \
            [(e.kind, e.replica) for e in b.membership.events]
        assert ("remove", 7) in [(e.kind, e.replica)
                                 for e in b.membership.events]
    ca, cb = a.counters(), b.counters()
    for k in ("n_read", "n_write", "n_rmw", "n_abort", "lat_sum", "lat_cnt"):
        assert int(ca[k]) == int(cb[k]), k
    np.testing.assert_array_equal(np.asarray(ca["lat_hist"]), cb["lat_hist"])
    assert_ops_equal(a.history_ops(), b.history_ops())
    assert a.check().ok
    vb = b.check()
    assert vb.ok, (vb.failures[:2], vb.undecided[:2])


def _setup_ref(cfg):
    from hermes_tpu.core import state as jst
    from hermes_tpu.workload import ycsb

    r = cfg.n_replicas
    rs = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (r,) + x.shape),
                      jst.init_replica_state(cfg))
    return rs, jax.tree.map(jnp.asarray, ycsb.make_streams(cfg))


def _setup_port(cfg):
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.runtime import _prep_phases_stream
    from hermes_tpu_torch.workload import ycsb

    return (st.init_replica_state(cfg, "cpu"),
            _prep_phases_stream(ycsb.make_streams(cfg), "cpu"))


def _np_state(rs):
    from hermes_tpu_torch import convert

    return convert.replica_state_to_numpy(rs)


def test_torch_step_scan_equals_step_loop_and_reference():
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch.core import step as step_lib

    jc, pc = pair(n_replicas=3, n_keys=128, n_sessions=8, replay_slots=4,
                  ops_per_session=64,
                  workload=dict(read_frac=0.4, rmw_frac=0.5, seed=11))
    rs, stream = _setup_port(pc)
    step = step_lib.build_step_batched(pc)
    for s in range(12):
        rs, _ = step(rs, stream, step_lib.make_ctl(pc, s))
    loop = _np_state(rs)

    rs, stream = _setup_port(pc)
    chunk = step_lib.build_step_scan(pc, rounds=4)
    for c in range(3):
        rs = chunk(rs, stream, step_lib.make_ctl(pc, c * 4))
    assert_states_equal(loop, _np_state(rs), "scan")

    jrs, jstream = _setup_ref(jc)
    jchunk = jstep.build_step_scan(jc, rounds=4, donate=False)
    for c in range(3):
        jrs = jchunk(jrs, jstream, jstep.make_ctl(jc, c * 4))
    assert_states_equal(jax.device_get(jrs), loop, "reference scan")


def test_torch_sharded_scan_matches_batched_scan():
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.core.group import LocalGroup

    _jc, pc = pair(n_replicas=4, n_keys=64, n_sessions=4, replay_slots=2,
                   ops_per_session=32, workload=dict(read_frac=0.5, seed=13))
    rs, stream = _setup_port(pc)
    want = step_lib.build_step_scan(pc, rounds=6)(
        rs, stream, step_lib.make_ctl(pc, 0))
    group = LocalGroup("cpu")
    rs, stream = _setup_port(pc)
    rs, stream = step_lib.place_sharded(pc, group, rs, stream)
    got = step_lib.build_step_sharded_scan(pc, group, rounds=6)(
        rs, stream, step_lib.make_ctl(pc, 0))
    assert_states_equal(_np_state(want), _np_state(got), "sharded scan")


def test_torch_wrap_stream_runs_past_G_like_the_reference():
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.core import types as t

    jc, pc = pair(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=2,
                  ops_per_session=8, wrap_stream=True,
                  workload=dict(read_frac=0.0, seed=17))
    rs, stream = _setup_port(pc)
    rs = step_lib.build_step_scan(pc, rounds=40)(
        rs, stream, step_lib.make_ctl(pc, 0))
    got = _np_state(rs)
    assert (got.sess.status != t.S_DONE).all()
    assert got.sess.op_idx.min() > pc.ops_per_session
    written = got.table.val[..., 1] >= 0
    assert got.table.val[..., 0][written].max() > 8 * 4
    jrs, jstream = _setup_ref(jc)
    jrs = jstep.build_step_scan(jc, rounds=40, donate=False)(
        jrs, jstream, jstep.make_ctl(jc, 0))
    assert_states_equal(jax.device_get(jrs), got, "wrap")


DIST_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from hermes_tpu_torch import convert
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.core.group import DistGroup
    from hermes_tpu_torch.runtime import Runtime

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    spec = json.loads(sys.argv[5])
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    cfg = HermesConfig(workload=WorkloadConfig(**spec["workload"]),
                       **spec["cfg"])
    rt = Runtime(cfg, backend="sharded", group=DistGroup(device="cpu"),
                 device="cpu")
    events = {s: (act, args) for s, act, args in spec["events"]}
    rounds = {}
    for s in range(spec["rounds"]):
        if s in events:
            getattr(rt, events[s][0])(*events[s][1])
        rt.step_once()
        ns = convert.replica_state_to_numpy(rt.rs)
        for part in ("table", "sess", "replay", "meta"):
            for f in getattr(ns, part)._fields:
                rounds[f"{s}.{part}.{f}"] = getattr(getattr(ns, part), f)
    rounds["drained"] = np.array(rt.drain(400))
    rounds["steps"] = np.array(rt.step_idx)
    c = rt.counters()
    rounds["counters"] = np.array([int(c[k]) for k in (
        "n_read", "n_write", "n_rmw", "n_abort")])
    np.savez(out, **rounds)
    dist.destroy_process_group()
""")


def _dist_spec(case):
    """The drive of a 3-rank DistGroup case: config, rounds compared one
    by one, and (round, method, args) events."""
    import dataclasses

    if case == "config1":
        jc, _pc = acceptance_pair(1, SCALE)
        return dict(cfg={f.name: getattr(jc, f.name)
                         for f in dataclasses.fields(jc)
                         if f.name != "workload"},
                    workload=dataclasses.asdict(jc.workload), rounds=12,
                    events=[])
    return dict(cfg=dict(n_replicas=3, n_keys=48, n_sessions=4,
                         replay_slots=4, ops_per_session=10, replay_age=3),
                workload=dict(read_frac=0.4, rmw_frac=0.3, seed=61),
                rounds=24, events=[[4, "freeze", [2]], [9, "remove", [2]],
                                   [15, "join", [2, 0]]])


@pytest.mark.parametrize("case", ["faults", "config1"])
def test_torch_step_dist_group_three_ranks_round_by_round(tmp_path, case):
    """Three gloo processes of one replica each: the INV/VAL all-gather
    and the ACK all-to-all every round; acceptance config 1, and a drive
    with a freeze, a remove and a join whose donor row lives on another
    rank (``fetch_row``); every rank's rows equal the reference's after
    every round, then both drain alike."""
    import json

    from hermes_tpu.config import HermesConfig as JC
    from hermes_tpu.config import WorkloadConfig as JW
    from hermes_tpu.runtime import Runtime as JR

    spec = _dist_spec(case)
    script = tmp_path / "worker.py"
    script.write_text(DIST_WORKER)
    init = f"file://{tmp_path / 'rdv'}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "3", init,
         str(tmp_path / f"rank{r}.npz"), json.dumps(spec)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(3)]
    for p in procs:
        _out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-3000:]

    a = JR(JC(workload=JW(**spec["workload"]), **spec["cfg"]),
           backend="batched")
    events = {s: (act, args) for s, act, args in spec["events"]}
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(3)]
    for s in range(spec["rounds"]):
        if s in events:
            getattr(a, events[s][0])(*events[s][1])
        a.step_once()
        want = jax.device_get(a.rs)
        for r in range(3):
            for part in ("table", "sess", "replay", "meta"):
                for f in getattr(want, part)._fields:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(getattr(want, part), f))[r:r + 1],
                        got[r][f"{s}.{part}.{f}"],
                        err_msg=f"round {s} rank {r} {part}.{f}")
    assert a.drain(400)
    c = a.counters()
    want_c = [int(c[k]) for k in ("n_read", "n_write", "n_rmw", "n_abort")]
    for r in range(3):
        assert bool(got[r]["drained"])
        assert int(got[r]["steps"]) == a.step_idx
        assert got[r]["counters"].tolist() == want_c


def test_torch_runtime_raises_without_card():
    """``Runtime`` (every backend) and the TCP driver want the card by
    default and raise where there is none; with a card they take it."""
    from hermes_tpu_torch.runtime import Runtime

    _jc, pc = pair(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=2,
                   ops_per_session=4)
    for backend in ("batched", "sharded", "sim"):
        if torch.cuda.is_available():
            assert Runtime(pc, backend=backend).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="is_available"):
                Runtime(pc, backend=backend)
    if not torch.cuda.is_available():
        from hermes_tpu_torch import distributed

        with pytest.raises(RuntimeError, match="is_available"):
            distributed.run_replica(pc, 0, 3, 1, base_port=1)


@pytest.mark.parametrize("scale", [0.01, 0.25, 1.0])
def test_torch_chip_smoke_baseline_cfg_equals_acceptance(scale):
    """``chip_smoke.baseline_cfg`` (the smoke's phases cells) builds the
    configs of ``hermes_tpu/acceptance.py:_cfg`` field for field (no run:
    the configs only)."""
    import dataclasses

    import chip_smoke
    from hermes_tpu.acceptance import _cfg
    from hermes_tpu_torch import config

    for n in (1, 2, 3, 4, 5):
        want, got = _cfg(n, scale), chip_smoke.baseline_cfg(config, n, scale)
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if f.name == "workload":
                assert dataclasses.asdict(w) == dataclasses.asdict(g), n
            else:
                assert w == g, (n, f.name)
