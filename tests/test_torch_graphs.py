"""The compiled round (hermes_tpu_torch/core/graphs.py), the counterpart of
``jax.jit`` for the fast round, on the CPU.

On the CPU a compiled round keeps the card's bookkeeping — bound inputs,
one variant a (scan, quiesce) pair, the completions ring, the step it
advances, rebinding on a new shape — and calls the round function where
the card replays its graph.  So:

* a capturability lint: one round of the fused, mega and sharded
  (``LocalGroup``) engines, in the scan, plain and quiesce variants,
  dispatches no host sync, no tensor made from host data and no op of a
  data-dependent shape (what a CUDA graph capture refuses);
* the compiled FastRuntime bit for bit against the JAX package's over 64
  rounds at depth 1 and 2, through a freeze, a thaw, a ``set_live`` and a
  new op stream of another shape (a rebind and recapture), and a
  ``build_fast_scan`` chunk against the reference's ``lax.scan``;
* the binding, ring and launch accounting themselves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.config import WorkloadConfig as RefWL
from hermes_tpu.core import faststep as ref_fst
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu.workload import ycsb as ref_ycsb
from hermes_tpu_torch import convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import graphs, kernels, megaround
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.runtime import FastRuntime
from hermes_tpu_torch.workload import ycsb
from torch_gatepair import assert_fast_state_equal, settled_reference  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")

CFG = dict(n_replicas=4, n_keys=64, n_sessions=16, replay_slots=4,
           ops_per_session=16, replay_age=3, replay_scan_every=4,
           arb_mode="sort", chain_writes=3, wrap_stream=True,
           workload=RefWL(read_frac=0.4, rmw_frac=0.2, seed=23))


def _cfgs(**over):
    rc = RefConfig(**dict(CFG, **over))
    return rc, HermesConfig(**dataclasses.asdict(rc))


# --------------------------------------------------------------------------
# the capturability lint
# --------------------------------------------------------------------------

#: ops that wait for the device on the host
HOST_SYNC = {"aten._local_scalar_dense.default", "aten.item.default",
             "aten.is_nonzero.default", "aten.equal.default",
             "aten.allclose.default"}
#: ops that make a tensor from host data
HOST_DATA = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default"}
#: ops whose output shape follows the data
DATA_SHAPE = {"aten.nonzero.default", "aten.masked_select.default",
              "aten._unique2.default", "aten.unique_dim.default",
              "aten.unique_consecutive.default",
              "aten.repeat_interleave.Tensor"}
#: factories that make a tensor where they are told to (none: the host)
FACTORIES = {"aten.scalar_tensor.default", "aten.full.default",
             "aten.zeros.default", "aten.ones.default", "aten.empty.memory_format",
             "aten.arange.default", "aten.arange.start"}


class CaptureLint(TorchDispatchMode):
    """Records every dispatched op a CUDA graph capture would refuse."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name in HOST_SYNC:
            self.found.append(("host-sync", name))
        if name in HOST_DATA:
            self.found.append(("host-data", name))
        if name in FACTORIES and kwargs.get("device") is None:
            self.found.append(("host-data", f"{name} on no device"))
        if name == "aten._to_copy.default" and "device" in kwargs:
            self.found.append(("host-data", f"{name} to {kwargs['device']}"))
        if name in DATA_SHAPE and not (
                name == "aten.repeat_interleave.Tensor"
                and kwargs.get("output_size") is not None):
            self.found.append(("data-shape", name))
        if name == "aten.index.Tensor" and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.found.append(("data-shape", "boolean-mask index"))
        return func(*args, **kwargs)


ENGINES = {
    "fused": dict(backend="batched", over=dict()),
    "mega": dict(backend="batched", over=dict(mega_round=True)),
    "sharded": dict(backend="sharded", over=dict()),
    "sharded-mega": dict(backend="sharded", over=dict(mega_round=True)),
}
#: (host_step, quiesce) of each variant; host_step 0 scans
VARIANTS = {"scan": (8, False), "plain": (9, False), "quiesce": (9, True)}


def _mid_run(engine):
    """A runtime of ``engine`` eight rounds in, on the CPU."""
    e = ENGINES[engine]
    _, cfg = _cfgs(**e["over"])
    rt = FastRuntime(cfg, backend=e["backend"], device="cpu")
    rt.freeze(3)
    rt.run(8)
    return rt


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_torch_round_is_capturable(engine, variant):
    rt = _mid_run(engine)
    host_step, quiesce = VARIANTS[variant]
    ctl = rt._ctl()._replace(host_step=host_step, quiesce=quiesce)
    lint = CaptureLint()
    launches = graphs.launch_counts()
    with lint:
        if rt.backend == "batched":
            fst.fast_round_batched(rt.cfg, ctl, rt.fs, rt.stream)
        else:
            fst.fast_round_sharded(rt.cfg, ctl, rt.fs, rt.stream, rt.group)
    assert lint.found == []
    assert graphs.launch_counts() == launches  # the CPU launches nothing


@pytest.mark.parametrize("bad,kind", [
    (lambda x: int(x.sum()), "host-sync"),
    (lambda x: x + torch.tensor([1, 2, 3, 4], dtype=x.dtype), "host-data"),
    (lambda x: x[x > 0], "data-shape"),
    (lambda x: torch.nonzero(x), "data-shape"),
])
def test_torch_capture_lint_flags_what_a_capture_refuses(bad, kind):
    lint = CaptureLint()
    with lint:
        bad(torch.arange(4, dtype=torch.int32))
    assert kind in {k for k, _ in lint.found}


# --------------------------------------------------------------------------
# the compiled runtime against the JAX package
# --------------------------------------------------------------------------


def _payload_stream(cfg, seed):
    """An op stream of ``cfg`` with client payload words: the tree and
    shape of the runtime's default stream changes (a rebind)."""
    raw = ycsb.make_streams(dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, seed=seed)))
    rng = np.random.default_rng(seed)
    uval = rng.integers(-2**31, 2**31, size=raw.op.shape
                        + (cfg.value_words - 2,), dtype=np.int64)
    return st.OpStream(op=np.asarray(raw.op), key=np.asarray(raw.key),
                       uval=uval.astype(np.int32))


def _drive(rt, steps, new_stream, place):
    """The same scripted run on either package: a freeze, a thaw, a
    membership change and a new op stream; every harvested completion."""
    out = []
    for s in range(steps):
        if s == 6:
            rt.freeze(1)
        if s == 19:
            rt.thaw(1)
        if s == 27:
            rt.set_live(int(rt.live[0]))  # an epoch bump everywhere
        if s == 40:
            rt.stream = place(new_stream)
        comp = rt.step_once()
        out.append(None if comp is None
                   else tuple(np.asarray(x) for x in comp))
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_compiled_runtime_equals_the_reference(depth,
                                                     settled_reference):
    rc, cfg = _cfgs(pipeline_depth=depth, value_words=4)
    ref = RefRuntime(rc, record=True)
    rt = FastRuntime(cfg, record=True, device="cpu")
    stream = _payload_stream(cfg, 5)
    want = _drive(ref, 64, stream, ref_fst.prep_stream)
    got = _drive(rt, 64, stream, lambda s: fst.prep_stream(s, CPU))
    for s, (a, b) in enumerate(zip(want, got)):
        assert (a is None) == (b is None), s
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"round {s}")
    assert_fast_state_equal(ref, rt)
    assert rt.check().ok
    comp = rt._step
    # one variant a (scan, quiesce) pair, before and after the rebind,
    # each run eagerly once and captured at its second call
    assert comp.rebinds == 1
    assert comp.captures == comp.warmups == 4
    assert comp.replays == 64 - comp.warmups
    assert comp.ring_size == depth + 1


def test_torch_compiled_runtime_keeps_its_tensors():
    """The state, stream and control rows a runtime hands its compiled
    round are the same tensors round after round: freeze, thaw and
    set_live write the bound control rows in place."""
    _, cfg = _cfgs()
    rt = FastRuntime(cfg, device="cpu")
    rt.run(2)
    leaves = graphs.flatten(rt.fs)[0]
    ctl = rt._ctl()
    rt.freeze(2)
    rt.run(3)
    rt.thaw(2)
    rt.set_live(0b0111)
    rt.step_idx = 40
    rt.run(3)
    assert all(a is b for a, b in zip(leaves, graphs.flatten(rt.fs)[0]))
    now = rt._ctl()
    for f in graphs.ctl_tensors(ctl):
        assert getattr(now, f) is getattr(ctl, f), f
    assert int(rt._step_dev) == rt.step_idx == 43
    assert rt._step.rebinds == 0
    assert now.epoch.tolist() == [1] * 4
    assert now.live_mask.tolist() == [0b0111] * 4


def test_torch_compiled_round_copies_in_and_rebinds():
    _, cfg = _cfgs()
    _, wide = _cfgs(n_sessions=32)
    by_width = {16: cfg, 32: wide}
    step = graphs.Compiled(
        lambda fs, stream, ctl: fst.fast_round_batched(
            by_width[fs.sess.status.shape[1]], ctl, fs, stream),
        graphs.fast_variant(cfg.replay_scan_every, 1), ring=2,
        extra=graphs.suspect_ages)
    fs = fst.init_fast_state(cfg, CPU)
    stream = fst.prep_stream(ycsb.make_streams(cfg), CPU)
    ctl = fst.make_fast_ctl(cfg, 1, CPU)
    out, _ = step(fs, stream, ctl)
    assert out is fs and int(ctl.step) == 2  # bound, stepped in place
    fresh = fst.init_fast_state(cfg, CPU)  # same shapes: copied in
    out2, _ = step(fresh, stream, ctl)
    assert out2 is fs and step.rebinds == 0
    assert step.warmups == step.captures == step.replays == 1
    ref, _ = fst.fast_round_batched(cfg, fst.make_fast_ctl(cfg, 2, CPU),
                                    fst.init_fast_state(cfg, CPU), stream)
    for a, b in zip(graphs.flatten(out2)[0], graphs.flatten(ref)[0]):
        assert torch.equal(a, b)
    big = fst.init_fast_state(wide, CPU)  # another shape: rebind, capture
    out3, comp = step(big, fst.prep_stream(ycsb.make_streams(wide), CPU),
                      fst.make_fast_ctl(wide, 1, CPU))
    assert out3 is big and step.rebinds == 1 and step.warmups == 2
    assert step.captures == 1  # called once: run eagerly, not captured
    assert comp.code.shape == (4, 32)


def test_torch_harvest_of_an_overwritten_slot_raises():
    _, cfg = _cfgs(pipeline_depth=2)
    rt = FastRuntime(cfg, device="cpu")
    comps = [rt.dispatch_round() for _ in range(rt._step.ring_size + 1)]
    with pytest.raises(RuntimeError, match="overwritten by a later round"):
        rt.harvest_comp(comps[0], round_idx=0)
    last = rt.harvest_comp(comps[-1], round_idx=rt.step_idx - 1)
    assert last.code.shape == (4, 16)


@pytest.mark.parametrize("rounds", [3, 8])
def test_torch_compiled_chunk_equals_the_reference_scan(rounds):
    rc, cfg = _cfgs(device_stream=True, read_unroll=2, mega_round=True,
                    phase_metrics=True)
    chunk = fst.build_fast_scan(cfg, rounds)
    ref_chunk = ref_fst.build_fast_scan(rc, rounds)
    fs = fst.init_fast_state(cfg, CPU)
    stream = fst.prep_stream(ycsb.stub_stream(cfg), CPU)
    ref_fs = ref_fst.init_fast_state(rc)
    ref_stream = ref_fst.prep_stream(ref_ycsb.stub_stream(rc))
    ctl = fst.make_fast_ctl(cfg, 0, CPU)
    for c in range(4):
        fs = chunk(fs, stream, ctl._replace(host_step=c * rounds))
        ref_fs = ref_chunk(ref_fs, ref_stream,
                           ref_fst.make_fast_ctl(rc, c * rounds))
        assert int(ctl.step) == (c + 1) * rounds  # the chunk stepped it
    want = jax.device_get(ref_fs)
    got = convert.fast_state_to_numpy(fs)
    for part in ("table", "sess", "replay", "meta"):
        for f in getattr(want, part)._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(want, part), f)),
                np.asarray(getattr(getattr(got, part), f)),
                err_msg=f"{part}.{f}")
    patterns = [tuple((c * rounds + o) % cfg.replay_scan_every == 0
                      for o in range(rounds)) for c in range(4)]
    assert chunk.warmups == len(set(patterns))
    assert chunk.captures == len({p for p in patterns
                                  if patterns.count(p) > 1})
    assert chunk.replays == 4 - chunk.warmups


def test_torch_compiled_runtime_launch_accounting(monkeypatch):
    """Each kernel wrapper counts the calls that reach it (on the CPU the
    plain versions, counted here as the card counts launches); the
    compiled mega runtime's counts equal an eager loop's: one
    ``stats_block`` a round, one ``mega_replay`` a scan round."""
    for mod, name in ((kernels, "stats_block"), (megaround, "mega_route"),
                      (megaround, "mega_apply"), (megaround, "mega_replay")):
        wrapper, plain = getattr(mod, name), getattr(mod, f"{name}_plain")

        def counted(*a, _w=wrapper, _p=plain, **k):
            _w.launches += 1
            return _p(*a, **k)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
    _, cfg = _cfgs(mega_round=True)

    def counts(run):
        before = graphs.launch_counts()
        run()
        after = graphs.launch_counts()
        return {k: after[k] - before[k] for k in
                ("stats_block", "mega_route", "mega_apply", "mega_replay")}

    rt = FastRuntime(cfg, device="cpu")
    got = counts(lambda: rt.run(64))
    fs = fst.init_fast_state(cfg, CPU)
    stream = fst.prep_stream(ycsb.make_streams(cfg), CPU)

    def eager():
        nonlocal fs
        for s in range(64):
            fs, _ = fst.fast_round_batched(cfg, fst.make_fast_ctl(cfg, s, CPU),
                                           fs, stream)

    want = counts(eager)
    assert got == want
    assert got["stats_block"] == 64 and got["mega_replay"] == 16
    assert rt._step.captures == 2 and rt._step.replays == 62


def test_torch_dist_group_round_stays_eager():
    """A ``DistGroup``'s round is compiled without a graph (its
    collectives leave the device); a ``LocalGroup``'s takes one."""
    _, cfg = _cfgs()
    assert fst.build_fast_sharded(cfg, LocalGroup("cpu")).graph

    class Dist:
        world = 1

    assert not fst.build_fast_sharded(cfg, Dist()).graph
