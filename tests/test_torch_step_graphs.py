"""The compiled phases engine (``hermes_tpu_torch/core/step.py``'s
builders over ``core/graphs.py``, the counterpart of the reference's
``jax.jit``s) on the CPU.

On the CPU a compiled phases call keeps the card's bookkeeping — the
bound state, stream, membership rows and step, the completions ring, one
variant, a rebind on a new tree or shape — and calls the round function
where the card replays its graph.  So:

* ``Runtime(backend="batched")`` and ``"sharded"`` (a ``LocalGroup``)
  bit for bit against the JAX package's ``Runtime`` on BASELINE configs
  1 and 3 (``hermes_tpu/acceptance.py:_cfg`` at scale 0.01): every state
  leaf and completion column after every round, across a freeze, a thaw,
  a ``set_live``, a ``remove``, a ``join`` and a new op stream of another
  tree (a rebind), then both drained, the recorders' histories and the
  counters equal;
* the compiled chunks (``build_step_scan``, ``build_step_sharded_scan``)
  at ``rounds`` in (1, 4, 7) from step 5 against the reference's
  ``lax.scan`` chunks;
* a capturability lint of the compiled round and chunk at configs 1 and
  3, batched and sharded (no host sync, no tensor from host data, no
  data-dependent shape); the completions int32, carried by the ring as
  they are; a ``DistGroup``'s round eager; the runtime's tensors kept.

Tolerance: exact (the state is integer)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_graphs import CaptureLint
from torch_refpair import (acceptance_pair, assert_ops_equal,
                           assert_states_equal, drain_both, lockstep, pair,
                           port_state, tap)

torch.set_num_threads(1)

CPU = torch.device("cpu")
SCALE = 0.01
BACKENDS = ("batched", "sharded")
#: (round, method, args) of the scripted drive; "stream" swaps in a
#: stream with client payload words (another tree: a rebind)
EVENTS = {3: ("freeze", (1,)), 6: ("thaw", (1,)), 8: ("set_live", None),
          10: ("remove", (2,)), 14: ("join", (2, 0)), 17: ("stream", None)}
ROUNDS = 22


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("replica",))


def _runtimes(n, backend):
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu_torch.runtime import Runtime as PR

    jc, pc = acceptance_pair(n, SCALE)
    mesh = _mesh(jc.n_replicas) if backend == "sharded" else None
    a = JR(jc, backend=backend, mesh=mesh, record=True)
    b = PR(pc, backend=backend, record=True, device="cpu")
    return jc, pc, a, b, mesh


def _payload_stream(cfg, seed):
    """The config's op stream under another seed, with client payload
    words."""
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.workload import ycsb

    raw = ycsb.make_streams(dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, seed=seed)))
    rng = np.random.default_rng(seed)
    uval = rng.integers(-2**31, 2**31, size=raw.op.shape
                        + (cfg.value_words - 2,), dtype=np.int64)
    return st.OpStream(op=np.asarray(raw.op), key=np.asarray(raw.key),
                       uval=uval.astype(np.int32))


def _swap_stream(a, b, mesh, raw):
    """The same new stream into the reference and the port."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hermes_tpu.core import state as jst
    from hermes_tpu_torch.runtime import _prep_phases_stream

    ref = jst.OpStream(op=jnp.asarray(raw.op), key=jnp.asarray(raw.key),
                       uval=jnp.asarray(raw.uval))
    a.stream = (ref if mesh is None
                else jax.device_put(ref, NamedSharding(mesh, P("replica"))))
    b.stream = _prep_phases_stream(raw, "cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 3])
def test_torch_compiled_phases_runtime_equals_the_reference(n, backend):
    jc, pc, a, b, mesh = _runtimes(n, backend)
    comps = (tap(a), tap(b))
    for s in range(ROUNDS):
        if s in EVENTS:
            act, args = EVENTS[s]
            if act == "stream":
                _swap_stream(a, b, mesh, _payload_stream(pc, 7 + n))
            elif act == "set_live":
                a.set_live(int(a.live[0]))  # an epoch bump everywhere
                b.set_live(int(b.live[0]))
            else:
                getattr(a, act)(*args)
                getattr(b, act)(*args)
        lockstep(1, a, b, comps=comps, where=f"round {s}")
    drain_both(a, b, comps)
    assert_states_equal(jax.device_get(a.rs), port_state(b), "drained")
    ca, cb = a.counters(), b.counters()
    for k in ("n_read", "n_write", "n_rmw", "n_abort", "lat_sum", "lat_cnt"):
        assert int(ca[k]) == int(cb[k]), k
    assert_ops_equal(a.history_ops(), b.history_ops())
    assert b.check().ok
    step = b._step
    # one variant: run eagerly at its first call and captured at its
    # second, before and after the rebind; every later call a replay
    assert step.rebinds == 1
    assert step.warmups == step.captures == 2
    assert step.replays == b.step_idx - 2
    assert int(step.step) == b.step_idx


def _setup(cfg, backend):
    """A fresh (state, stream) of ``cfg`` in both packages, the
    reference's placed on a mesh on the sharded backend."""
    import jax.numpy as jnp

    from hermes_tpu.core import state as jst
    from hermes_tpu.core import step as jstep
    from hermes_tpu.workload import ycsb as jycsb
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.runtime import _prep_phases_stream
    from hermes_tpu_torch.workload import ycsb

    r = cfg[0].n_replicas
    jrs = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (r,) + x.shape),
                       jst.init_replica_state(cfg[0]))
    jstream = jax.tree.map(jnp.asarray, jycsb.make_streams(cfg[0]))
    if backend == "sharded":
        jrs, jstream = jstep.place_sharded(cfg[0], _mesh(r), jrs, jstream)
    return (jrs, jstream), (st.init_replica_state(cfg[1], CPU),
                            _prep_phases_stream(ycsb.make_streams(cfg[1]),
                                                "cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rounds", [1, 4, 7])
def test_torch_compiled_chunk_equals_the_reference_scan(rounds, backend):
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch import convert
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.core.group import LocalGroup

    cfgs = pair(n_replicas=4, n_keys=128, n_sessions=8, replay_slots=4,
                ops_per_session=24, replay_age=3,
                workload=dict(read_frac=0.4, rmw_frac=0.3, seed=31))
    jc, pc = cfgs
    (jrs, jstream), (rs, stream) = _setup(cfgs, backend)
    if backend == "batched":
        ref = jstep.build_step_scan(jc, rounds, donate=False)
        chunk = step_lib.build_step_scan(pc, rounds)
    else:
        ref = jstep.build_step_sharded_scan(jc, _mesh(jc.n_replicas), rounds,
                                            donate=False)
        group = LocalGroup("cpu")
        rs, stream = step_lib.place_sharded(pc, group, rs, stream)
        chunk = step_lib.build_step_sharded_scan(pc, group, rounds)
    first = 5  # not a multiple of 4 or 7
    ctl = step_lib.make_ctl(pc, first)
    calls = 4
    for c in range(calls):
        jrs = ref(jrs, jstream, jstep.make_ctl(jc, first + c * rounds))
        rs = chunk(rs, stream, ctl)  # the chunk advances the bound step
        assert int(chunk.step) == first + (c + 1) * rounds
        assert_states_equal(jax.device_get(jrs),
                            convert.replica_state_to_numpy(rs), f"chunk {c}")
    assert chunk.warmups == chunk.captures == 1
    assert chunk.replays == calls - chunk.warmups


def _mid_run(n, backend):
    """A port runtime of BASELINE config ``n`` eight rounds in, replica 1
    frozen for the last four."""
    from hermes_tpu_torch.runtime import Runtime

    _jc, pc = acceptance_pair(n, SCALE)
    rt = Runtime(pc, backend=backend, device="cpu")
    rt.run(4)
    rt.freeze(1)
    rt.run(4)
    return rt


@pytest.mark.parametrize("what", ["round", "chunk"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 3])
def test_torch_phases_round_is_capturable(n, backend, what):
    """The compiled call's whole body (the round or a 4-round chunk, the
    copy-back, the completions' buffer, the step's advance), run as the
    capture runs it, dispatches nothing a CUDA graph capture refuses."""
    from hermes_tpu_torch.core import step as step_lib

    rt = _mid_run(n, backend)
    call = rt._step
    if what == "chunk":
        call = (step_lib.build_step_scan(rt.cfg, 4) if backend == "batched"
                else step_lib.build_step_sharded_scan(rt.cfg, rt.group, 4))
        call(rt.rs, rt.stream, rt._ctl())  # bound: the next call copies nothing
    lint = CaptureLint()
    with call.eager(), lint:
        call(rt.rs, rt.stream, rt._ctl())
    assert lint.found == []


def test_torch_phases_completions_ride_the_ring_as_int32():
    """Every completion column of a phases round is int32, so the ring
    (int32) carries each one as it is, no cast; no extra column."""
    from hermes_tpu_torch.core import step as step_lib

    rt = _mid_run(1, "batched")
    _rs, raw = step_lib.step_round(rt.cfg)(rt.rs, rt.stream, rt._ctl())
    for f, x in zip(raw._fields, raw):
        assert x.dtype == torch.int32, f
    for slot, views, extra in rt._step._ring:
        assert slot.dtype == torch.int32 and extra is None
        assert [x.shape for x in views] == [x.shape for x in raw]


def test_torch_phases_ring_slot_tells_it_was_overwritten():
    """A phases round's completions are a tree over a ring slot: once
    ``ring_size`` later rounds have written that slot, ``stale`` says so;
    the newest round's are not stale."""
    rt = _mid_run(1, "batched")
    comps = [rt.step_once() for _ in range(rt._step.ring_size + 1)]
    assert rt._step.stale(comps[0])
    assert not any(rt._step.stale(c) for c in comps[1:])


def test_torch_dist_group_phases_round_stays_eager():
    """A ``DistGroup``'s compiled phases round and chunk take no graph
    (their collectives leave the device); a ``LocalGroup``'s do."""
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.core.group import LocalGroup

    _jc, pc = acceptance_pair(1, SCALE)
    group = LocalGroup("cpu")
    assert step_lib.build_step_sharded(pc, group).graph
    assert step_lib.build_step_sharded_scan(pc, group, 4).graph

    class Dist:
        world, device = 3, CPU

        def n_local(self, r):
            return r // 3

        def first(self, r):
            return 0

    assert not step_lib.build_step_sharded(pc, Dist()).graph
    assert not step_lib.build_step_sharded_scan(pc, Dist(), 4).graph


@pytest.mark.parametrize("backend", BACKENDS)
def test_torch_compiled_phases_runtime_keeps_its_tensors(backend):
    """The state, stream, membership rows and step the runtime hands its
    compiled round are the same tensors round after round: a freeze, a
    thaw, a set_live and a join write them in place, an assignment to
    ``step_idx`` re-seeds the bound step."""
    from hermes_tpu_torch.core import graphs
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.runtime import Runtime

    _jc, pc = acceptance_pair(1, SCALE)
    rt = Runtime(pc, backend=backend, device="cpu")
    rt.run(2)
    leaves = graphs.flatten(rt.rs)[0]
    ctl = rt._ctl()
    rt.freeze(2)
    rt.run(3)
    rt.thaw(2)
    rt.set_live(0b011)
    rt.join(2, from_replica=0)
    rt.step_idx = 40
    rt.run(3)
    assert all(x is y for x, y in zip(leaves, graphs.flatten(rt.rs)[0]))
    now = rt._ctl()
    for f in graphs.ctl_tensors(ctl):
        assert getattr(now, f) is getattr(ctl, f), f
    assert int(rt._step.step) == rt.step_idx == 43
    assert rt._step.rebinds == 0
    assert now.epoch.tolist() == [2] * 3
    assert now.live_mask.tolist() == [0b111] * 3
    assert now.frozen.tolist() == [False] * 3
