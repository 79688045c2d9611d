"""The port's FastRuntime (hermes_tpu_torch/runtime.py) against the
reference FastRuntime (hermes_tpu/runtime.py), batched backend.

Same config, same op stream, same scripted faults, at pipeline depths 1
and 2: every completion step_once hands back and the final Meta must be
equal (exact equality), the port's check() must be green, and the
reference's checker must agree on the port's recorded history.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hermes_tpu import stats as ref_stats
from hermes_tpu.checker import linearizability as ref_lin
from hermes_tpu.checker.fast import ArrayRecorder as RefArrayRecorder
from hermes_tpu.checker.fast import check_arrays as ref_check_arrays
from hermes_tpu.checker.history import Op as RefOp
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import stats
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)


def _host(comp):
    if comp is None:
        return None
    if isinstance(comp, tuple) and not hasattr(comp, "_fields"):
        return tuple(_host(c) for c in comp)
    return tuple(np.asarray(x) for x in comp)


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a[0], tuple):
        for x, y in zip(a, b):
            _assert_same(x, y, what)
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _script(rt, steps, settle=None):
    """The same scripted run: faults, a rebase, and the harvested
    completions of every step.  ``settle`` (the reference's) waits for
    the rounds in flight before a fault hook rewrites the host's frozen
    row: on the CPU backend ``jnp.asarray`` may alias that numpy array,
    so an in-flight round could read the new value (ROADMAP C)."""
    out = []
    for s in range(steps):
        if settle is not None and s in (5, 11):
            settle()
        if s == 5:
            rt.freeze(2)
        if s == 11:
            rt.thaw(2)
        if s == 16:
            rt.rebase_versions()
        out.append(_host(rt.step_once()))
    assert rt.drain(600)
    return out


CFG = dict(n_replicas=3, n_keys=32, n_sessions=8, replay_slots=4,
           ops_per_session=24, replay_age=3, replay_scan_every=2,
           arb_mode="sort", chain_writes=3,
           workload=RefWL(read_frac=0.4, rmw_frac=0.3, seed=17))


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_runtime_identical_to_reference(depth):
    rc = RefConfig(pipeline_depth=depth, **CFG)
    cfg = HermesConfig(**dataclasses.asdict(rc))
    ref = RefRuntime(rc, record=True)
    rt = FastRuntime(cfg, record=True, device="cpu")
    got = _script(rt, 24)
    want = _script(ref, 24, settle=lambda: jax.block_until_ready(ref.fs))
    assert len(got) == len(want)
    assert (got[0] is None) == (depth > 1)
    for s, (a, b) in enumerate(zip(want, got)):
        _assert_same(a, b, f"step {s}")
    assert rt.step_idx == ref.step_idx and rt.rebases == ref.rebases == 1
    np.testing.assert_array_equal(rt._ver_base, ref._ver_base)
    for f, x in zip(rt.fs.meta._fields, rt.fs.meta):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(getattr(ref.fs.meta, f))), x.numpy(),
            err_msg=f)
    assert stats.summarize(rt.fs.meta) == ref_stats.summarize(ref.fs.meta)

    v = rt.check()
    assert v.ok, (v.failures[:2], v.undecided[:2])
    ops = rt.history_ops()
    ref_ops = ref.history_ops()
    assert [dataclasses.astuple(o) for o in ops] == \
        [dataclasses.astuple(o) for o in ref_ops]
    # the reference checker agrees on the port's history
    rv = ref_lin.check_history([RefOp(**dataclasses.asdict(o)) for o in ops],
                               aborted_uids=rt.recorder.aborted_uids)
    assert rv.ok and rv.keys_checked == v.keys_checked


def test_torch_runtime_array_recorder_and_native_checker():
    """record='array': the port's columnar recorder and its own build of
    the native witness core give the reference's columns and verdict."""
    rc = RefConfig(n_replicas=3, n_keys=64, n_sessions=16, replay_slots=4,
                   ops_per_session=16, device_stream=True, read_unroll=2,
                   arb_mode="sort", chain_writes=4,
                   workload=RefWL(read_frac=0.5, rmw_frac=0.2, seed=9))
    cfg = HermesConfig(**dataclasses.asdict(rc))
    rt = FastRuntime(cfg, record="array", device="cpu")
    assert rt.drain(400)
    v = rt.check()
    assert v.ok and v.keys_checked > 0
    cols = rt.recorder.columns()
    ref_rec = RefArrayRecorder(rc)
    ref_rec._chunks = rt.recorder._chunks
    ref_rec.aborted_uids = rt.recorder.aborted_uids
    for k, x in ref_rec.columns().items():
        np.testing.assert_array_equal(x, cols[k], err_msg=k)
    rv = ref_check_arrays(ref_rec)
    assert rv.ok and rv.keys_checked == v.keys_checked
    c = rt.counters()
    total = c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"]
    assert total == 3 * 16 * 16


def test_torch_runtime_defaults_to_the_card():
    cfg = HermesConfig(n_replicas=2, n_keys=16, n_sessions=2, replay_slots=1,
                       ops_per_session=2)
    for backend in ("batched", "sharded"):
        if torch.cuda.is_available():
            assert FastRuntime(cfg, backend=backend).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                FastRuntime(cfg, backend=backend)
    rt = FastRuntime(cfg, backend="sharded", device="cpu")
    assert rt.device.type == "cpu" and rt.n_copies == 2
    with pytest.raises(ValueError, match="unknown backend"):
        FastRuntime(cfg, backend="phases", device="cpu")
