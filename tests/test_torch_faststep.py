"""The port's batched round (hermes_tpu_torch/core/faststep.py) against the
reference round (hermes_tpu/core/faststep.py), round by round.

Both packages start from the same state and op stream (the reference's
state carried across with hermes_tpu_torch.convert) and run N rounds
under the same control rows; after every round every leaf of FastState
(vpts, bank bytes, sessions, replay slots, Meta) and of the Completions
must be equal.  Tolerance: exact equality (all state is integer).  The
configurations follow tests/test_faststep.py: fused vs split sort, sort vs
race arbiter, write chaining, read_unroll, rmw_retries, lane-budget
overflow, the device stream, a frozen replica whose stuck keys the replay
scan picks up (started from a converted mid-run state), and a rebase.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.core import faststep as ref_fst
from hermes_tpu.workload import ycsb as ref_ycsb
from hermes_tpu_torch import convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import types as t

torch.set_num_threads(1)
CPU = torch.device("cpu")


def assert_tree_equal(ref, got, path="fs"):
    """Every leaf equal (shape and values) between two NamedTuple trees."""
    if hasattr(ref, "_fields"):
        assert ref._fields == got._fields, path
        for f in ref._fields:
            assert_tree_equal(getattr(ref, f), getattr(got, f), f"{path}.{f}")
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree_equal(a, b, f"{path}[{i}]")
    else:
        a = np.asarray(ref)
        b = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert a.shape == b.shape, f"{path}: shape {a.shape} != {b.shape}"
        if not np.array_equal(a, b):
            bad = np.argwhere(a != b)
            raise AssertionError(f"{path}: {len(bad)} elements differ, first "
                                 f"at {bad[0].tolist()}: {a[tuple(bad[0])]} vs "
                                 f"{b[tuple(bad[0])]}")


def port_cfg(ref_cfg):
    return HermesConfig(**dataclasses.asdict(ref_cfg))


def ref_ctl(cfg, s, frozen=(), removed=()):
    c = ref_fst.make_fast_ctl(cfg, s)
    live = cfg.full_mask
    for r in removed:
        live &= ~(1 << r)
    fz = np.zeros(cfg.n_replicas, bool)
    fz[list(frozen) + list(removed)] = True
    ep = 1 if removed else 0
    return c._replace(epoch=jnp.full((cfg.n_replicas,), ep, jnp.int32),
                      live_mask=jnp.full((cfg.n_replicas,), live, jnp.int32),
                      frozen=jnp.asarray(fz))


def port_ctl(cfg, s, frozen=(), removed=()):
    rc = ref_ctl(cfg, s, frozen, removed)
    return fst.make_fast_ctl(cfg, s, CPU)._replace(
        epoch=torch.tensor(np.asarray(rc.epoch)),
        live_mask=torch.tensor(np.asarray(rc.live_mask)),
        frozen=torch.tensor(np.asarray(rc.frozen)))


class Pair:
    """The same run in both packages."""

    def __init__(self, ref_cfg, ref_fs=None, stream=None):
        self.rc, self.pc = ref_cfg, port_cfg(ref_cfg)
        if stream is None:
            stream = (ref_ycsb.stub_stream(ref_cfg) if ref_cfg.device_stream
                      else ref_ycsb.make_streams(ref_cfg))
        self.ref_fs = ref_fs if ref_fs is not None else ref_fst.init_fast_state(ref_cfg)
        self.ref_stream = ref_fst.prep_stream(stream)
        self.ref_step = ref_fst.build_fast_batched(ref_cfg)
        self.fs = convert.fast_state_from_numpy(
            self.pc, jax.device_get(self.ref_fs), CPU)
        self.stream = fst.prep_stream(stream, CPU)
        assert_tree_equal(jax.device_get(self.ref_fs),
                          convert.fast_state_to_numpy(self.fs))

    def round(self, s, **faults):
        self.ref_fs, rcomp = self.ref_step(self.ref_fs, self.ref_stream,
                                           ref_ctl(self.rc, s, **faults))
        self.fs, comp = fst.fast_round_batched(
            self.pc, port_ctl(self.pc, s, **faults), self.fs, self.stream)
        assert_tree_equal(jax.device_get(self.ref_fs),
                          convert.fast_state_to_numpy(self.fs), f"r{s}.fs")
        assert_tree_equal(jax.device_get(rcomp), comp, f"r{s}.comp")
        return comp


def run_pair(ref_cfg, rounds):
    p = Pair(ref_cfg)
    for s in range(rounds):
        p.round(s)
    return p


BASE = dict(n_replicas=3, n_keys=64, n_sessions=8, replay_slots=4,
            ops_per_session=16)

CONFIGS = {
    "race": dict(BASE, workload=RefWL(read_frac=0.4, rmw_frac=0.3, seed=41)),
    "sort_fused": dict(BASE, arb_mode="sort",
                       workload=RefWL(read_frac=0.4, rmw_frac=0.3, seed=41)),
    "sort_split": dict(BASE, arb_mode="sort", fused_sort=False,
                       workload=RefWL(read_frac=0.4, rmw_frac=0.3, seed=41)),
    "chain_fused": dict(BASE, arb_mode="sort", chain_writes=3,
                        workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=42)),
    "chain_split": dict(BASE, arb_mode="sort", chain_writes=3,
                        fused_sort=False,
                        workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=42)),
    "overflow_fused": dict(BASE, n_keys=8, arb_mode="sort", chain_writes=2,
                           lane_budget_cfg=5, rebroadcast_every=2,
                           workload=RefWL(read_frac=0.2, rmw_frac=0.2, seed=47)),
    "overflow_split": dict(BASE, n_keys=8, arb_mode="sort", fused_sort=False,
                           lane_budget_cfg=5, rebroadcast_every=2,
                           workload=RefWL(read_frac=0.2, rmw_frac=0.2, seed=47)),
    "read_unroll": dict(BASE, read_unroll=2,
                        workload=RefWL(read_frac=0.6, rmw_frac=0.2, seed=45)),
    "rmw_retries": dict(BASE, n_replicas=5, n_keys=8, rmw_retries=3,
                        workload=RefWL(read_frac=0.0, rmw_frac=1.0, seed=71)),
    "device_stream": dict(BASE, n_keys=256, device_stream=True,
                          workload=RefWL(read_frac=0.5, rmw_frac=0.2, seed=5)),
    "bench_shaped": dict(n_replicas=4, n_keys=256, n_sessions=32,
                         replay_slots=8, ops_per_session=16, arb_mode="sort",
                         chain_writes=4, wrap_stream=True, device_stream=True,
                         lane_budget_cfg=24, read_unroll=2,
                         replay_scan_every=4,
                         workload=RefWL(read_frac=0.5, seed=0)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_round_identical_to_reference(name):
    p = run_pair(RefConfig(**CONFIGS[name]), rounds=24)
    # the drive did real work: updates committed in both packages
    assert int(p.fs.meta.n_write.sum() + p.fs.meta.n_rmw.sum()) > 0


@pytest.mark.parametrize("arb_mode", ["race", "sort"])
def test_torch_frozen_replica_replay_scan_from_converted_state(arb_mode):
    """A replica freezes mid-run: writes stall on its missing acks, their
    keys stick INVALID, and the replay scan snapshots them into replay
    slots; after membership removes it, everything commits.  The reference
    runs the first rounds alone; its mid-run state is carried into the
    port, and from there both run round by round."""
    rc = RefConfig(n_replicas=4, n_keys=128, n_sessions=8, replay_slots=16,
                   ops_per_session=24, replay_age=2, replay_scan_every=2,
                   arb_mode=arb_mode,
                   workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=35))
    stream = ref_ycsb.make_streams(rc)
    ref_fs = ref_fst.init_fast_state(rc)
    step = ref_fst.build_fast_batched(rc)
    sp = ref_fst.prep_stream(stream)
    for s in range(6):
        ref_fs, _ = step(ref_fs, sp, ref_ctl(rc, s))
    for s in range(6, 9):
        ref_fs, _ = step(ref_fs, sp, ref_ctl(rc, s, frozen=(3,)))
    p = Pair(rc, ref_fs=ref_fs, stream=stream)
    replayed = 0
    for s in range(9, 17):
        p.round(s, frozen=(3,))
        replayed = max(replayed, int(p.fs.replay.active.sum()))
    assert replayed > 0, "the replay scan never took a stuck key"
    for s in range(17, 45):
        p.round(s, removed=(3,))
    status = p.fs.sess.status.numpy()
    assert (status[:3] == t.S_DONE).all()


def test_torch_rebase_identical_to_reference():
    """build_rebase on the same converted mid-run state: identical state
    and per-key version deltas."""
    rc = RefConfig(n_replicas=3, n_keys=16, n_sessions=16, replay_slots=4,
                   ops_per_session=32, wrap_stream=True, arb_mode="sort",
                   chain_writes=4, workload=RefWL(read_frac=0.2, seed=28))
    p = run_pair(rc, rounds=12)
    # quiesce so most keys settle, then rebase both
    for s in range(12, 16):
        p.ref_fs, _ = p.ref_step(p.ref_fs, p.ref_stream,
                                 ref_ctl(rc, s)._replace(quiesce=jnp.bool_(True)))
        p.fs, _ = fst.fast_round_batched(
            p.pc, port_ctl(p.pc, s)._replace(quiesce=True), p.fs, p.stream)
    ref_fs, ref_delta = ref_fst.build_rebase(rc)(p.ref_fs)
    fs, delta = fst.build_rebase(p.pc)(p.fs)
    assert_tree_equal(jax.device_get(ref_fs), convert.fast_state_to_numpy(fs))
    np.testing.assert_array_equal(np.asarray(ref_delta), delta.numpy())
    assert int((delta > 0).sum()) > 0


def test_torch_apply_inv_arb_identical_to_reference():
    """The source-shaped apply_inv (the sharded engine's scatter-max plus
    heartbeat fold) on a random INV block."""
    rc = RefConfig(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=2,
                   ops_per_session=4)
    rng = np.random.default_rng(3)
    R, C, V = 3, 6, rc.value_words
    key = rng.integers(0, 32, (R, C), dtype=np.int32)
    pts = rng.integers(0, 1 << 20, (R, C), dtype=np.int32)
    valid = rng.random((R, C)) < 0.7
    pkf = key | np.where(valid, fst.INV_VALID, 0).astype(np.int32)
    val = rng.integers(-128, 128, (R, C, 4 * V), dtype=np.int8)
    head = np.stack([pkf, pts], axis=-1).astype(np.int32)
    meta = np.array([0 << 1 | 1, 0 << 1 | 0, 1 << 1 | 1], np.int32)
    rows8 = np.asarray(ref_fst._i32_to_bank(jnp.asarray(head)))
    rows8 = np.concatenate([rows8, val], axis=-1)
    ref_inv = ref_fst.FastInv(rows8=jnp.asarray(rows8), meta=jnp.asarray(meta))
    inv = fst.FastInv(rows8=torch.from_numpy(rows8), meta=torch.from_numpy(meta))
    assert_tree_equal(jax.device_get(ref_inv.key), inv.key)
    ref_fs0 = ref_fst.init_fast_state(rc)
    fs0 = convert.fast_state_from_numpy(port_cfg(rc), jax.device_get(ref_fs0),
                                        CPU)
    ref_out = ref_fst._apply_inv_arb(rc, ref_ctl(rc, 5, frozen=(1,)),
                                     ref_fs0, ref_inv)
    out = fst._apply_inv_arb(port_cfg(rc), port_ctl(port_cfg(rc), 5,
                                                    frozen=(1,)), fs0, inv)
    assert_tree_equal(jax.device_get(ref_out), convert.fast_state_to_numpy(out))


def test_torch_table_views_and_drop_row():
    cfg = HermesConfig(n_replicas=2, n_keys=8, n_sessions=2, replay_slots=1,
                       ops_per_session=2, value_words=3)
    fs = fst.init_fast_state(cfg, CPU)
    assert fs.table.vpts.shape == (9,) and fs.table.bank.shape == (9, 20)
    np.testing.assert_array_equal(fs.table.val[:, 0].numpy(), np.arange(8))
    assert (fs.table.val[:, 1] == -1).all()
    assert (fs.table.sst == 0).all() and (fs.table.row_pts == 0).all()
