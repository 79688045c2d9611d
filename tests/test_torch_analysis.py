"""The port's kernel matrix and sanitizer (hermes_tpu_torch/analysis) against
the reference's (hermes_tpu/analysis/diffcheck.py, seeds.py), on the CPU.

* The port's kernel cells have the reference's names, shapes, dtypes and
  input bounds, and ``_draw`` gives the reference's arrays byte for byte.
* For every cell the drawn arguments go through the reference cell's
  function (its Pallas kernel in interpret mode) and the port's plain
  version: equal outputs, inside the port's declared output bounds.
* ``scan_acc_plain`` and every ``fx_*_plain`` against its Pallas original.
  The fixtures are defined inside test functions of
  tests/test_pallas_analysis.py, so they are stated again here and run with
  ``interpret=True``; every one of them runs in interpret mode on this JAX,
  the DMA one included.  Arguments that leave the tensor (an index, keys, a
  block offset) are held too: the plain versions place them where interpret
  mode does.
* Red: a bound declared too tight, an overlapping pack and a dropped
  initialisation escape; the guard's arithmetic through a host build of
  ``csrc/guard.cuh``.
* The command line, the probe's analysis fields, the layouts tables and
  seeds the bounds are made from.

Tolerance: exact equality, every value is an integer.  The CUDA kernels and
their bound-checked build are held on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from hermes_tpu.analysis import diffcheck as ref_dc
from hermes_tpu.analysis import seeds as ref_seeds
from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.core import layouts as ref_layouts
from hermes_tpu_torch import analysis as ana
from hermes_tpu_torch import build
from hermes_tpu_torch import table_probe as tp
from hermes_tpu_torch.analysis import __main__ as cli
from hermes_tpu_torch.analysis import diffcheck as dc
from hermes_tpu_torch.analysis import domain as D
from hermes_tpu_torch.analysis import fixture_kernels as fk
from hermes_tpu_torch.analysis import seeds
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import dispatch, layouts

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_NAMES = ["stats_block/r4s512", "stats_block/r1024s600",
             "stats_block/r512s2000", "synthetic/scan-accumulate",
             "mega_route/r2l6", "mega_apply/k16n16", "mega_replay/k16b1",
             "mega_replay/k22b3"]


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a))


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.fixture(scope="module")
def ref_cells():
    return {c.name: c for c in ref_dc.kernel_cells()}


def _ref_cell(ref_cells, name):
    """The reference's cell of that name; for the port's own ninth cell,
    the reference's mega_replay cell built at its key count."""
    if name in ref_cells:
        return ref_cells[name]
    assert name == "mega_replay/k2500b3"
    return ref_dc._mega_replay_cell(name, 2500, 1 << 20, "")


# --------------------------------------------------------------------------
# cells, bounds and draws
# --------------------------------------------------------------------------


def test_torch_kernel_cells_have_reference_names():
    names = [c.name for c in dc.kernel_cells()]
    assert names[:8] == REF_NAMES
    assert names[:8] == [c.name for c in ref_dc.kernel_cells()]
    assert names[8:] == ["mega_replay/k2500b3"]
    assert dc.cell_by_name("mega_apply/k16n16").name == "mega_apply/k16n16"
    with pytest.raises(KeyError):
        dc.cell_by_name("nope")


@pytest.mark.parametrize("name", REF_NAMES + ["mega_replay/k2500b3"])
def test_torch_kernel_cell_matches_reference_cell(ref_cells, name):
    """Shapes, dtypes and input bounds (lo, hi, ones), argument by
    argument."""
    cell, ref = dc.cell_by_name(name), _ref_cell(ref_cells, name)
    assert [(tuple(s), np.dtype(dt)) for s, dt in cell.shapes] == [
        (tuple(s.shape), np.dtype(s.dtype)) for s in ref.shapes]
    assert [(a.lo, a.hi, a.ones) for a in cell.in_avs] == [
        (a.lo, a.hi, a.ones) for a in ref.in_avs]
    assert len(cell.out_avs) == len(jax.tree.leaves(
        jax.eval_shape(ref.fn, *ref.shapes)))


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_draws_are_the_reference_draws(ref_cells, seed):
    """The same generator calls in the same order: byte-identical
    arguments for every cell, drawn one cell after the other from one
    generator as ``diff_check`` draws them."""
    for name in REF_NAMES:
        cell, ref = dc.cell_by_name(name), ref_cells[name]
        rng, ref_rng = (np.random.default_rng(seed) for _ in range(2))
        for _ in range(2):
            got = dc.draw_args(cell, rng)
            want = [ref_dc._draw(ref_rng, s, av)
                    for s, av in zip(ref.shapes, ref.in_avs)]
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", REF_NAMES + ["mega_replay/k2500b3"])
def test_torch_cell_plain_matches_reference_kernel(ref_cells, name):
    """Three draws through the reference cell's function (interpret mode)
    and the port's plain version: equal, and inside the declared output
    bounds; the wrapper on CPU tensors is the plain version."""
    cell, ref = dc.cell_by_name(name), _ref_cell(ref_cells, name)
    rng = np.random.default_rng(0)
    for _ in range(3):
        args = dc.draw_args(cell, rng)
        want = [_np(x) for x in jax.tree.leaves(
            ref.fn(*[jnp.asarray(a) for a in args]))]
        got = [o.numpy() for o in cell.plain(*[_t(a) for a in args])]
        via_wrapper = [o.numpy() for o in cell.fn(*[_t(a) for a in args])]
        assert len(want) == len(got) == len(cell.out_avs)
        for w, g, v, av in zip(want, got, via_wrapper, cell.out_avs):
            assert w.dtype == g.dtype and w.shape == g.shape
            np.testing.assert_array_equal(w, g)
            np.testing.assert_array_equal(w, v)
            assert D.contains(av, w) == [] and D.contains(av, g) == []


def test_torch_declared_bounds_hold_the_reference_tests_bounds():
    """What tests/test_pallas_analysis.py states of the derived bounds:
    ``code`` in [0, 4] and ``hist`` in [0, 512] at the r4s512 cell, the
    +1 loop reaching 10; and the sums that can wrap are dtype-TOP."""
    code, ctr, hist = seeds.out_stats_block(512)
    assert (code.lo, code.hi) == (0, 4) and not D.is_top(code, np.int32)
    assert (hist.lo, hist.hi) == (0, 512)
    assert D.is_top(ctr, np.int32)  # lat_sum wraps for S >= 9
    small = seeds.out_stats_block(8)[1]
    assert not D.is_top(small, np.int32)
    assert small.hi == 8 * (layouts.MAX_STEPS - 1) == -small.lo
    (acc,) = seeds.out_scan_acc(16)
    assert (acc.lo, acc.hi) == (0, 1600)
    assert D.is_top(seeds.out_scan_acc(1 << 30)[0], np.int32)
    assert int(fk.fx_loop_inc_plain(torch.zeros((8, 128), dtype=torch.int32),
                                    10).max()) == 10


def test_torch_lat_sum_wraps_under_the_declared_inputs():
    """The reason ``ctr`` is TOP: step and invoke_step drawn independently
    over the step field make a 512-session ``lat_sum`` leave any interval
    tighter than int32 could state."""
    cell = dc.cell_by_name("stats_block/r4s512")
    args = dc.draw_args(cell, np.random.default_rng(0))
    args[0] = np.asarray(layouts.MAX_STEPS - 1, np.int32)
    args[2][:] = 0
    args[3][:] = True
    _code, ctr, _hist = cell.plain(*[_t(a) for a in args])
    true_sum = 512 * (layouts.MAX_STEPS - 1)
    assert true_sum > (1 << 31) - 1
    row = layouts.STATS_CTR.row("lat_sum")
    assert int(ctr[0, row]) == ((true_sum + (1 << 31)) % (1 << 32)) - (1 << 31)


# --------------------------------------------------------------------------
# the sentinel and the fixtures against their Pallas originals
# --------------------------------------------------------------------------


def test_torch_scan_acc_plain_matches_reference():
    ref = ref_dc._scan_acc_cell()
    rng = np.random.default_rng(3)
    x = rng.integers(0, 101, (16, 8), dtype=np.int32)
    want = _np(ref.fn(jnp.asarray(x)))
    before = fk.scan_acc.launches
    np.testing.assert_array_equal(want, fk.scan_acc(_t(x)).numpy())
    assert fk.scan_acc.launches == before  # a CPU tensor: the plain version
    # general in (M, W), wrapping as int32
    big = rng.integers(-(1 << 31), 1 << 31, (37, 5), dtype=np.int64).astype(
        np.int32)
    np.testing.assert_array_equal(
        big.astype(np.int64).sum(0, keepdims=True).astype(np.int32),
        fk.scan_acc_plain(_t(big)).numpy())


def _scan_shares(plan, M):
    """The CTAs' row shares of a column tile."""
    r = plan.rows_per_cta
    return [(q * r, min(M, (q + 1) * r)) for q in range(plan.cluster)]


def _scan_by_plan(plan, x):
    """scan_acc.cu's algorithm over the plan, in numpy: each tile's CTAs
    sum their row shares (wrapping as uint32), rank 0 adds the partials.
    A column no tile covers keeps the poison -7."""
    M, W = x.shape
    out = np.full((1, W), -7, np.int64)
    u = x.astype(np.int64) & 0xFFFFFFFF
    tile = plan.tpr * plan.vec
    for t in range(plan.tiles):
        lo, hi = t * tile, min(W, (t + 1) * tile)
        parts = [u[a:b, lo:hi].sum(0) for a, b in _scan_shares(plan, M)]
        total = np.sum(parts, axis=0) & 0xFFFFFFFF
        out[0, lo:hi] = np.where(total >= 1 << 31, total - (1 << 32), total)
    return out


SCAN_PLAN_SHAPES = [(M, W, True) for M, W in chip_smoke.SCAN_ACC_SHAPES] + [
    (4096, 256, False), (1, 1, True), (33, 12, True)]


@pytest.mark.parametrize("M,W,aligned", SCAN_PLAN_SHAPES)
def test_torch_scan_acc_plan_covers_rows_and_columns_once(M, W, aligned):
    """At the sentinel's shape, (4096, 256), the ragged (4097, 257), the
    tall (65536, 8) and small ones: the CTAs' row shares cover [0, M)
    exactly once, the tiles cover [0, W), a cluster of at most 16 CTAs
    within the card's shared memory, 16-byte loads exactly where W and the
    pointer allow them, and the plan's sums are the plain version's."""
    plan = fk.scan_acc_plan(M, W, aligned)
    assert 1 <= plan.cluster <= 16 and fk.SCAN_SMEM_BYTES <= 232448
    assert plan.vec == (4 if W % 4 == 0 and aligned else 1)
    assert plan.tpr in (1, 2, 4, 8)
    tile = plan.tpr * plan.vec
    assert (plan.tiles - 1) * tile < W <= plan.tiles * tile
    shares = _scan_shares(plan, M)
    assert all(a < b for a, b in shares)  # no CTA without rows
    seen = np.zeros(M, np.int64)
    for a, b in shares:
        seen[a:b] += 1
    assert (seen == 1).all()
    if (M, W) == (16, 8):
        assert plan.cluster == 1  # a cluster of one, as before
    if (M, W, aligned) == (4096, 256, True):
        assert plan.cluster * plan.tiles == 128  # of the card's 132 SMs
    rng = np.random.default_rng(M + W)
    x = rng.integers(-(1 << 31), 1 << 31, (M, W), dtype=np.int64).astype(
        np.int32)
    np.testing.assert_array_equal(_scan_by_plan(plan, x),
                                  fk.scan_acc_plain(_t(x)).numpy())


def _ref_pack(a, b):
    def _pack_kernel(a_ref, b_ref, o_ref):
        o_ref[:] = (a_ref[:] << 29) | b_ref[:]

    return pl.pallas_call(_pack_kernel, out_shape=_sds(a.shape, jnp.int32),
                          interpret=True)(a, b)


def _ref_store_at(i, v):
    blk = v.shape[0]

    def _kern(i_ref, v_ref, o_ref):
        o_ref[:] = jnp.zeros_like(o_ref)
        i = i_ref[0, 0]
        o_ref[pl.dslice(i, 1), :] = v_ref[pl.dslice(0, 1), :]

    return pl.pallas_call(
        _kern,
        in_specs=[pl.BlockSpec((1, 1), lambda: (0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((blk, 128), lambda: (0, 0))],
        out_specs=pl.BlockSpec((blk, 128), lambda: (0, 0)),
        out_shape=_sds((blk, 128), jnp.int32), interpret=True)(i, v)


def _ref_acc(x, with_init):
    def _kern(x_ref, o_ref):
        if with_init:
            @pl.when(pl.program_id(0) == 0)
            def _init():
                o_ref[:] = jnp.zeros_like(o_ref)

        o_ref[:] += jnp.sum(x_ref[:], axis=1, keepdims=True)

    return pl.pallas_call(
        _kern, grid=(2,),
        in_specs=[pl.BlockSpec((8, 128), lambda j: (0, j))],
        out_specs=pl.BlockSpec((8, 1), lambda j: (0, 0)),
        out_shape=_sds((8, 1), jnp.int32), interpret=True)(x)


def _ref_block_copy(x, offset):
    def _kern(x_ref, o_ref):
        o_ref[:] = x_ref[:]

    return pl.pallas_call(
        _kern, grid=(2,),
        in_specs=[pl.BlockSpec((8, 128), lambda j: (0, j))],
        out_specs=pl.BlockSpec((8, 128), lambda j: (0, j + offset)),
        out_shape=_sds((8, 256), jnp.int32), interpret=True)(x)


def _ref_serial_scan(table, keys, rows):
    K, W = table.shape
    M = keys.shape[0]

    def _kern(keys_ref, rows_ref, tin_ref, tout_ref):
        del tin_ref

        def body(i, _):
            k = keys_ref[i]
            tout_ref[pl.dslice(k, 1), :] = rows_ref[pl.dslice(i, 1), :]
            return 0

        jax.lax.fori_loop(0, keys_ref.shape[0], body, 0)

    return pl.pallas_call(
        _kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((M, W), lambda: (0, 0)),
                  pl.BlockSpec((K, W), lambda: (0, 0))],
        out_specs=pl.BlockSpec((K, W), lambda: (0, 0)),
        out_shape=_sds((K, W), jnp.int32), input_output_aliases={2: 0},
        interpret=True)(keys, rows, table)


def _ref_async_copy(x):
    def _kern(x_ref, o_ref, sem):
        cp = pltpu.make_async_copy(x_ref, o_ref, sem)
        cp.start()
        cp.wait()

    return pl.pallas_call(_kern, out_shape=_sds(x.shape, jnp.int32),
                          scratch_shapes=[pltpu.SemaphoreType.DMA],
                          interpret=True)(x)


def _ref_loop_inc(x):
    def _kern(x_ref, o_ref):
        o_ref[:] = jnp.zeros_like(o_ref)

        def body(i, _):
            o_ref[:] = o_ref[:] + 1
            return 0

        jax.lax.fori_loop(0, 10, body, 0)

    return pl.pallas_call(_kern, out_shape=_sds(x.shape, jnp.int32),
                          interpret=True)(x)


def _i32(rng, shape, lo=-(1 << 31), hi=1 << 31):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("b_hi", [(1 << 29) - 1, 1 << 31])
def test_torch_fx_pack_matches_fixture(b_hi):
    """Disjoint fields, and any int32 operands (the shift wraps)."""
    rng = np.random.default_rng(b_hi % 97)
    a = _i32(rng, (8, 128), 0, 3) if b_hi < (1 << 31) else _i32(rng, (8, 128))
    b = _i32(rng, (8, 128), 0 if b_hi < (1 << 31) else -(1 << 31), b_hi)
    want = _np(_ref_pack(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(want, fk.fx_pack(_t(a), _t(b)).numpy())


@pytest.mark.parametrize("idx", [0, 3, 7, 8, 100, -1, -3, -8, -9, -100,
                                 (1 << 31) - 1, -(1 << 31)])
def test_torch_fx_store_at_matches_fixture(idx):
    """In bounds and, index by index, out of bounds: interpret mode counts
    a negative index from the end and clamps; the plain version copies
    it."""
    v = _i32(np.random.default_rng(4), (8, 128), 0, 101)
    i = np.array([[idx]], np.int32)
    want = _np(_ref_store_at(jnp.asarray(i), jnp.asarray(v)))
    np.testing.assert_array_equal(want, fk.fx_store_at(_t(i), _t(v)).numpy())


def test_torch_fx_acc_revisit_matches_fixture():
    """With its initialisation: the row sums.  Without: interpret mode
    fills an uninitialised output with the type's least value, the port's
    poison (``dispatch.poison``), and the sums land on it."""
    x = _i32(np.random.default_rng(5), (8, 256), 0, 4)
    want = _np(_ref_acc(jnp.asarray(x), True))
    np.testing.assert_array_equal(want, fk.fx_acc_revisit(_t(x)).numpy())
    np.testing.assert_array_equal(want, x.sum(1, keepdims=True))
    poisoned = torch.full((8, 1), dispatch.poison(torch.int32),
                          dtype=torch.int32)
    np.testing.assert_array_equal(
        _np(_ref_acc(jnp.asarray(x), False)),
        fk.fx_acc_revisit_plain(_t(x), init=False, acc=poisoned).numpy())


def _acc_by_plan(plan, x, before):
    """``acc_revisit_kernel`` over the plan, in numpy: CTA q of the cluster
    sums columns [q * cols, min(C, (q + 1) * cols)) of every row, lane l
    the vectors l, l + 32, ... of its share (``plan.vec`` columns each),
    wrapping as uint32; rank 0 adds the partials to ``before`` (None: the
    zero of ``init``).  Returns the sums and how often each column was
    read."""
    R, C = x.shape
    u = x.astype(np.int64) & 0xFFFFFFFF
    reads = np.zeros(C, np.int64)
    total = np.zeros(R, np.int64)
    for q in range(plan.cluster):
        c0, c1 = q * plan.cols, min(C, (q + 1) * plan.cols)
        assert c0 < c1  # no CTA without columns
        for lane in range(32):
            for c in range(c0 + plan.vec * lane, c1, 32 * plan.vec):
                total += u[:, c:c + plan.vec].sum(1)
                reads[c:c + plan.vec] += 1
    if before is not None:
        total += before.astype(np.int64)
    total &= 0xFFFFFFFF
    return np.where(total >= 1 << 31, total - (1 << 32), total), reads


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("R,C", [(1, 1), (8, 256), (20, 1000), (7, 1001),
                                 (32, 32768)])
def test_torch_acc_revisit_plan_replays_in_numpy(R, C, aligned):
    """The fixture's (8, 256), chip_smoke.py's larger shapes and one
    element, from an aligned ``x`` and not: int4 loads exactly where C and
    the pointer allow them, a cluster within what the entry takes, every
    column summed by exactly one lane of one CTA, one CTA at the fixture's
    shape; the plan's sums, onto zero and onto an old output, are the
    plain version's."""
    plan = fk.acc_revisit_plan(R, C, aligned)
    assert plan.vec == (4 if aligned and C % 4 == 0 else 1)
    assert 1 <= plan.cluster <= fk.ACC_CLUSTER_MAX
    assert fk.ACC_CLUSTER_MAX <= _fixture_constant("kAccClusterMax")
    assert plan.cols % plan.vec == 0
    assert (plan.cluster - 1) * plan.cols < C <= plan.cluster * plan.cols
    if (R, C) == (8, 256):
        assert plan.cluster == 1
    if (R, C) == (32, 32768):
        assert plan.cluster == fk.ACC_CLUSTER_MAX
    rng = np.random.default_rng(R * 31 + C)
    x = _i32(rng, (R, C))
    old = _i32(rng, (R,))
    want = fk.fx_acc_revisit_plain(_t(x)).numpy()[:, 0]
    got, reads = _acc_by_plan(plan, x, None)
    assert (reads == 1).all()
    np.testing.assert_array_equal(got, want)
    acc = _t(old).reshape(R, 1).clone()
    np.testing.assert_array_equal(
        _acc_by_plan(plan, x, old)[0],
        fk.fx_acc_revisit_plain(_t(x), init=False, acc=acc).numpy()[:, 0])


def test_torch_fx_acc_revisit_path_and_row_limit():
    """``acc_revisit_access`` gives int4s only for an aligned ``x`` whose
    C is a multiple of 4; more than 32 rows raise on any device."""
    buf = torch.zeros(8 * 256 + 1, dtype=torch.int32)
    assert fk.acc_revisit_access(buf[:-1].view(8, 256)) == 1
    assert fk.acc_revisit_access(buf[1:].view(8, 256)) == 0
    assert fk.acc_revisit_access(buf[:7 * 291].view(7, 291)) == 0
    with pytest.raises(ValueError, match="at most 32 rows"):
        fk.fx_acc_revisit(torch.zeros((33, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="no plan"):
        fk.acc_revisit_plan(33, 4)


@pytest.mark.parametrize("offset", [0, 1, -1])
def test_torch_fx_block_copy_matches_fixture(offset):
    """Offset 0 in bounds; off by a block, interpret mode clamps the block
    index and leaves the unwritten block at its fill value."""
    x = _i32(np.random.default_rng(6), (8, 256), 0, 4)
    want = _np(_ref_block_copy(jnp.asarray(x), offset))
    fill = torch.full((8, 256), dispatch.poison(torch.int32),
                      dtype=torch.int32)
    got = fk.fx_block_copy_plain(_t(x), offset, fill).numpy()
    np.testing.assert_array_equal(want, got)
    if offset == 0:
        np.testing.assert_array_equal(x, fk.fx_block_copy(_t(x)).numpy())


def _fixture_constant(name):
    """A ``constexpr int`` of ``csrc/analysis_fixtures.cu``."""
    text = (build.CSRC / "analysis_fixtures.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def _block_copy_replay(x, copied, offset):
    """``block_copy_kernel`` replayed in numpy: the entry's grid of CTAs
    of kThreads threads (``analysis_fixtures.cu``), a CTA a (row tile,
    column block), with the path ``block_copy_access`` picks, each
    thread's row, unit and destination as the kernel computes them.
    Returns the output (0 where nothing landed), the stores each output
    word took, the path, and the stores the per-row guard skips."""
    R, C = x.shape
    vec = fk.block_copy_access(x, copied)
    if vec:
        assert C % 4 == 0 and x.data_ptr() % 16 == 0
        assert copied.data_ptr() % 16 == 0
    threads = _fixture_constant("kThreads")
    unit = 4 if vec else 1  # words a thread moves
    units = fk.BLOCK_COLS // unit  # a block row's
    rows = threads // units  # a CTA's
    cu = C // unit  # units a row
    xs = x.numpy().reshape(R, cu, unit)
    got = np.zeros((R, cu, unit), np.int64)
    writes = np.zeros((R, cu), np.int64)
    t = np.arange(threads)
    skipped = 0
    for bx in range(-(-R // rows)):
        for by in range(-(-C // fk.BLOCK_COLS)):
            r = bx * rows + t // units
            u = t % units
            src = by * units + u
            live = (r < R) & (src < cu)
            dst = (by + offset) * units + u
            inrow = live & (dst >= 0) & (dst < cu)
            skipped += int((live & ~inrow).sum())
            got[r[inrow], dst[inrow]] = xs[r[inrow], src[inrow]]
            writes[r[inrow], dst[inrow]] += 1
    return got.reshape(R, C), writes, vec, skipped


@pytest.mark.parametrize("R,C", [(8, 256), (5, 1000), (3, 1001), (7, 130),
                                 (1, 1)])
def test_torch_fx_block_copy_grid_replays_in_numpy(R, C):
    """The one-unit-a-thread grid replayed in numpy: from aligned tensors
    (int4s where C is a multiple of 4) and from an input view 4 bytes off
    its allocation (words), every element is copied by exactly one thread
    at offset 0; at offset 1 the stores past a row's end are exactly those
    the per-row guard skips (a flat index over the tensor would have let
    all but the last row's land in the next row)."""
    rng = np.random.default_rng(R * 7 + C)
    buf = _t(_i32(rng, (R * C + 1,)))
    copied = torch.empty((R, C), dtype=torch.int32)
    for x in (buf[:-1].view(R, C), buf[1:].view(R, C)):
        got, writes, vec, skipped = _block_copy_replay(x, copied, 0)
        assert vec == int(C % 4 == 0 and x.data_ptr() == buf.data_ptr())
        assert (writes == 1).all() and skipped == 0
        np.testing.assert_array_equal(got, x.numpy())
    for x in (buf[:-1].view(R, C), buf[1:].view(R, C)):
        got, writes, vec, skipped = _block_copy_replay(x, copied, 1)
        # a row's last BLOCK_COLS columns (all of them if fewer) land past
        # its end: a row-local store index at or past the row's extent
        per_row = min(C, fk.BLOCK_COLS) // (4 if vec else 1)
        assert skipped == R * per_row
        assert (writes <= 1).all() and writes.sum() == R * C // (
            4 if vec else 1) - skipped


@pytest.mark.parametrize("bad_key", [None, 64, 69, -1, -64, -65, -70,
                                     (1 << 31) - 1, -(1 << 31)])
def test_torch_fx_serial_scan_matches_fixture(bad_key):
    """Duplicate keys (the last message wins), untouched rows kept; one key
    out of [0, K), key by key, lands where interpret mode puts it."""
    rng = np.random.default_rng(7)
    table = _i32(rng, (64, 10), 0, 101)
    keys = _i32(rng, (32,), 0, 64)
    rows = _i32(rng, (32, 10), 0, 1 << 20)
    keys[3] = keys[20]
    if bad_key is not None:
        keys[11] = bad_key
    want = _np(_ref_serial_scan(jnp.asarray(table), jnp.asarray(keys),
                                jnp.asarray(rows)))
    t = _t(table)
    assert fk.fx_serial_scan(t, _t(keys), _t(rows)) is t  # in place
    np.testing.assert_array_equal(want, t.numpy())


def _serial_scan_by_slices(table, keys, rows, S, order, guard=None):
    """``serial_scan_kernel`` in numpy with S rows a CTA: CTA b fills its
    winner column with -1, takes ``np.maximum.at`` (the shared-memory
    atomicMax) of the message indices on the keys of its slice, in the
    threads' ``order``, then walks its slots 32 at a time, lists the
    slots that won in lane order and copies their rows a word a lane.
    With
    ``guard`` (the host build of csrc/guard.cuh) CTA 0 checks each
    message's row as a store range and returns the report too.  Returns
    the table and the words stored into each table row."""
    K, W = table.shape
    out = table.copy()
    stored = np.zeros(K, np.int64)
    rep = (ctypes.c_longlong * dispatch.REPORT_WORDS)()
    for b in range(-(-K // S)):
        base, slots = b * S, min(S, K - b * S)
        win = np.full(slots, -1, np.int64)
        k = keys[order].astype(np.int64)
        if b == 0 and guard is not None:
            for key in k:
                guard.hermes_guard_check_range(ctypes.addressof(rep),
                                               int(key) * W, W, K * W, 1, 1)
        inside = (k >= base) & (k - base < slots)
        np.maximum.at(win, k[inside] - base, order[inside])
        for s0 in range(0, slots, 32):
            lanes = win[s0:s0 + 32]
            listed = [(s0 + lane, lanes[lane])
                      for lane in np.flatnonzero(lanes >= 0)]
            for t in range(len(listed) * W):
                j, c = divmod(t, W)
                slot, i = listed[j]
                out[base + slot, c] = rows[i, c]
                stored[base + slot] += 1
    return out, stored, rep


SCAN_CASES = ["duplicates", "one_key", "descending", "ragged", "outside"]


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("S", [1, 7, 64, 4096])
def test_torch_fx_serial_scan_slices_equal_the_serial_loop(S, case):
    """The shared-column design replayed in numpy equals the ordered
    Python loop ``for i: table[keys[i]] = rows[i]``, whatever order the
    atomics run in: heavy duplicates, every message on one key, keys in
    descending order, K not a multiple of S (and past 4,096), and keys
    outside [0, K), which the release design never stores and the checked
    build's range check counts once each.  Every row is written by its
    winner alone (W words), untouched rows keep their values."""
    # the column and the warps' (slot, message) lists fit the 48 KB a CTA
    # has without asking for more
    assert _fixture_constant("kScanSlots") * 4 + 8 * _fixture_constant(
        "kScanThreads") <= 48 * 1024
    rng = np.random.default_rng(S * 11 + SCAN_CASES.index(case))
    K, M = {"duplicates": (100, 500), "one_key": (64, 200),
            "descending": (300, 300), "ragged": (5000, 2000),
            "outside": (130, 400)}[case]
    if case == "duplicates":
        keys = _i32(rng, (M,), 0, 9) * 11
    elif case == "one_key":
        keys = np.full(M, 17, np.int32)
    elif case == "descending":
        keys = (K - 1 - np.arange(M)).astype(np.int32)
    else:
        keys = _i32(rng, (M,), 0, K)
    if case == "outside":
        keys[::37] = K
        keys[5::41] = -1
    table = _i32(rng, (K, 10))
    rows = _i32(rng, (M, 10))
    want = table.copy()
    for i in range(M):  # the fixture's loop, on the keys inside the table
        if 0 <= keys[i] < K:
            want[keys[i]] = rows[i]
    order = rng.permutation(M)
    got, stored, rep = _serial_scan_by_slices(table, keys, rows, S, order,
                                              _guard())
    np.testing.assert_array_equal(got, want)
    inside = keys[(keys >= 0) & (keys < K)]
    assert (stored[np.unique(inside)] == 10).all()
    assert stored.sum() == 10 * len(np.unique(inside))
    bad = int(((keys < 0) | (keys >= K)).sum())
    assert rep[dispatch.R_COUNT] == bad and (bad > 0) == (case == "outside")
    if case != "outside":  # the plain version clamps keys outside
        t = _t(table)
        np.testing.assert_array_equal(
            fk.fx_serial_scan(t, _t(keys), _t(rows)).numpy(), want)


def test_torch_fx_async_copy_and_loop_inc_match_fixtures():
    """The DMA fixture does run in interpret mode on this JAX."""
    v = _i32(np.random.default_rng(8), (8, 128), 0, 8)
    np.testing.assert_array_equal(_np(_ref_async_copy(jnp.asarray(v))),
                                  fk.fx_async_copy(_t(v)).numpy())
    np.testing.assert_array_equal(_np(_ref_loop_inc(jnp.asarray(v))),
                                  fk.fx_loop_inc(_t(v)).numpy())


@pytest.mark.parametrize("n", [4, 1024, 4092, 65536, 1028000])
def test_torch_fx_async_copy_tiles_replay_in_numpy(n):
    """``async_copy_kernel``'s launch replayed in numpy: the entry's grid
    of one ``kTileBytes`` tile a CTA, each tile's words as the kernel
    computes them, the last one what remains.  Every tile is a whole
    number of 16-byte units (what a bulk copy moves), passes the checked
    build's range check (``check_range`` through the host build of
    ``csrc/guard.cuh``) and every word is moved exactly once; an output 4
    words short fails the check on the last tile alone, at its first word
    past the extent."""
    tile_bytes = _fixture_constant("kTileBytes")
    assert tile_bytes % 16 == 0 and tile_bytes <= 48 * 1024  # static smem
    tile = tile_bytes // 4
    x = _i32(np.random.default_rng(n), (n,))
    got = np.zeros(n, np.int64)
    moved = np.zeros(n, np.int64)
    lib = _guard()
    rep = (ctypes.c_longlong * dispatch.REPORT_WORDS)()
    short = (ctypes.c_longlong * dispatch.REPORT_WORDS)()
    tiles = -(-n // tile)  # the entry's grid
    sizes = []
    for b in range(tiles):
        start = b * tile
        words = n - start if n - start < tile else tile
        assert (4 * words) % 16 == 0
        assert lib.hermes_guard_check_range(ctypes.addressof(rep), start,
                                            words, n, 1, 1) == 1
        lib.hermes_guard_check_range(ctypes.addressof(short), start, words,
                                     n - 4, 2, 1)
        got[start:start + words] = x[start:start + words]
        moved[start:start + words] += 1
        sizes.append(4 * words)
    assert (moved == 1).all() and list(rep) == [0] * dispatch.REPORT_WORDS
    np.testing.assert_array_equal(got, x)
    assert sizes[:-1] == [tile_bytes] * (tiles - 1)
    assert sizes[-1] == 4 * n - tile_bytes * (tiles - 1)
    assert (short[dispatch.R_COUNT], short[dispatch.R_INDEX],
            short[dispatch.R_EXTENT]) == (1, n - 4, n - 4)
    np.testing.assert_array_equal(fk.fx_async_copy(_t(x)).numpy(), x)


@pytest.mark.parametrize("bad", ["n_not_a_multiple_of_4", "x_misaligned"])
def test_torch_fx_async_copy_refuses_what_a_bulk_copy_cannot_take(bad):
    """A bulk copy moves 16-byte units between 16-byte aligned addresses:
    the wrapper raises, on any device, for a count not a multiple of 4 and
    for an ``x`` 4 bytes off its allocation."""
    buf = torch.arange(1029, dtype=torch.int32)
    x = buf[:1026] if bad == "n_not_a_multiple_of_4" else buf[1:1025]
    assert (x.data_ptr() - buf.data_ptr()) == (0 if x.numel() == 1026 else 4)
    with pytest.raises(ValueError, match="multiple of 4" if x.numel() == 1026
                       else "16-byte aligned"):
        fk.fx_async_copy(x)


def test_torch_launch_floor_needs_the_card():
    """Without a card ``python -m hermes_tpu_torch.launch_floor`` exits 2
    and prints no result."""
    r = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.launch_floor"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2 and r.stdout == "" and "card" in r.stderr


@pytest.mark.parametrize("n", [1, 3, 91, 1024, 77000])
def test_torch_fx_loop_inc_replays_in_numpy(n):
    """``loop_inc_kernel``'s launch replayed in numpy into an output from
    its allocation and one 4 bytes off it: the path ``loop_inc_access``
    picks (int4s only where n is a multiple of 4 and the pointer is
    16-byte aligned), the entry's grid of ``kThreads`` threads, each
    thread's unit; every word is written exactly once, and the fixture's
    1,024 words take one CTA of int4s."""
    threads = _fixture_constant("kThreads")
    buf = torch.empty(n + 1, dtype=torch.int32)
    for acc in (buf[:-1], buf[1:]):
        vec = fk.loop_inc_access(acc)
        assert vec == int(n % 4 == 0 and acc.data_ptr() == buf.data_ptr())
        unit = 4 if vec else 1  # words a thread stores
        units = n // unit
        ctas = -(-units // threads)  # the entry's grid
        writes = np.zeros(n, np.int64)
        for b in range(ctas):
            i = b * threads + np.arange(threads)
            i = i[i < units]
            for k in range(unit):
                writes[i * unit + k] += 1
        assert (writes == 1).all()
        if n == 1024 and vec:
            assert ctas == 1
    np.testing.assert_array_equal(
        fk.fx_loop_inc(torch.zeros(n, dtype=torch.int32), 7).numpy(),
        np.full(n, 7))


#: fx_pack's and fx_store_at's chip_smoke.py shapes but the large one,
#: and (1000, 77)
PACK_STORE_SHAPES = [(8, 128), (64, 10), (7, 13), (1000, 77)]


def _unit_grid(n, out):
    """The entry's grid of ``kThreads`` threads over ``n`` words, one unit
    a thread: the unit (4 words where ``vec``, else 1), the live threads'
    unit indices and the CTAs launched."""
    vec = n % 4 == 0 and out.data_ptr() % 16 == 0
    unit = 4 if vec else 1
    threads = _fixture_constant("kThreads")
    ctas = -(-(n // unit) // threads)
    i = np.arange(ctas * threads)
    return unit, i[i < n // unit], ctas


def _store_at_replay(idx, v, stored):
    """``store_at_kernel`` replayed in numpy: thread i's unit, the column
    ``j % W`` it loads from row 0 of ``v`` beside ``idx`` (the first by
    division, the next by a wrapping increment), and the flat range test
    against ``lo = idx * W`` that keeps the loaded word or stores 0.
    Returns the output (-1 where nothing landed), the stores each word
    took, the unit and the CTAs."""
    rows, W = v.shape
    n = rows * W
    unit, i, ctas = _unit_grid(n, stored)
    assert fk.store_at_access(stored) == int(unit == 4)
    lo = idx * W
    row0 = v[0].numpy()
    got = np.full(n, -1, np.int64)
    writes = np.zeros(n, np.int64)
    c = (i * unit) % W
    for k in range(unit):
        j = i * unit + k
        inrow = (j >= lo) & (j < lo + W)
        assert (c[inrow] == j[inrow] - lo).all()  # j % W is j - lo there
        got[j] = np.where(inrow, row0[c], 0)
        np.add.at(writes, j, 1)
        c = np.where(c + 1 < W, c + 1, 0)
    return got.reshape(rows, W), writes, unit, ctas


@pytest.mark.parametrize("rows,W", PACK_STORE_SHAPES)
def test_torch_fx_store_at_replays_in_numpy(rows, W):
    """``store_at_kernel``'s one launch replayed in numpy into an output at
    its allocation and one 4 bytes off it, with ``idx`` at the first, a
    middle and the last row: every word is written exactly once, the
    words equal the plain version (row 0 of ``v`` at row ``idx``, zeros
    elsewhere, bit-exact), and the fixture's (8, 128) takes one CTA of
    int4s.  An ``idx`` one past the end writes zeros alone, all inside
    the output."""
    v = _t(_i32(np.random.default_rng(rows * 31 + W), (rows, W)))
    buf = torch.empty(rows * W + 1, dtype=torch.int32)
    for stored in (buf[:-1], buf[1:]):
        for idx in (0, rows // 2, rows - 1, rows):
            got, writes, unit, ctas = _store_at_replay(idx, v, stored)
            assert (writes == 1).all()
            if idx < rows:
                i = torch.tensor([[idx]], dtype=torch.int32)
                np.testing.assert_array_equal(
                    got, fk.fx_store_at_plain(i, v).numpy())
            else:
                assert (got == 0).all()
        assert unit == (4 if rows * W % 4 == 0
                        and stored.data_ptr() == buf.data_ptr() else 1)
        if (rows, W) == (8, 128) and unit == 4:
            assert ctas == 1


@pytest.mark.parametrize("rows,C", PACK_STORE_SHAPES)
def test_torch_fx_pack_replays_in_numpy(rows, C):
    """``pack_kernel``'s one launch replayed in numpy into an output at its
    allocation and one 4 bytes off it: the path ``pack_access`` picks, one
    unit a thread; every word is written exactly once and equals the
    plain version's shift-or (bit-exact, the shift wrapping), and the
    fixture's (8, 128) takes one CTA of int4s."""
    rng = np.random.default_rng(rows * 37 + C)
    a, b = _i32(rng, (rows * C,)), _i32(rng, (rows * C,))
    want = fk.fx_pack_plain(_t(a), _t(b)).numpy()
    buf = torch.empty(rows * C + 1, dtype=torch.int32)
    for packed in (buf[:-1], buf[1:]):
        n = rows * C
        unit, i, ctas = _unit_grid(n, packed)
        assert fk.pack_access(_t(a), _t(b), packed) == int(unit == 4)
        got = np.zeros(n, np.int64)
        writes = np.zeros(n, np.int64)
        for k in range(unit):
            j = i * unit + k
            got[j] = ((a[j].astype(np.uint32) << np.uint32(29))
                      | b[j].astype(np.uint32)).astype(np.int32)
            np.add.at(writes, j, 1)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        if (rows, C) == (8, 128) and unit == 4:
            assert ctas == 1


@pytest.mark.parametrize("n", [1, 3, 91, 1024, 1028])
def test_torch_store_at_and_pack_access_take_int4s_only_when_aligned(n):
    """Both choosers give int4s (1) only where n is a multiple of 4 and
    every pointer they are given is 16-byte aligned; a tensor 4 bytes off
    its allocation, in any place, gives words (0)."""
    buf = torch.empty(n + 1, dtype=torch.int32)
    on, off = buf[:-1], buf[1:]
    assert fk.store_at_access(on) == int(n % 4 == 0)
    assert fk.store_at_access(off) == 0
    assert fk.pack_access(on, on, on) == int(n % 4 == 0)
    for a, b, packed in ((off, on, on), (on, off, on), (on, on, off)):
        assert fk.pack_access(a, b, packed) == 0


@pytest.mark.parametrize("shape", [(8, 128), (7, 13), (1000, 77)])
def test_torch_fx_pack_plain_matches_fixture_at_every_shape(shape):
    """``_ref_pack`` takes any shape: the plain version equals it, bit for
    bit, at the word path's (7, 13) and (1000, 77) as at the fixture's."""
    rng = np.random.default_rng(shape[0] + shape[1])
    a, b = _i32(rng, shape), _i32(rng, shape)
    np.testing.assert_array_equal(
        _np(_ref_pack(jnp.asarray(a), jnp.asarray(b))),
        fk.fx_pack_plain(_t(a), _t(b)).numpy())


@pytest.mark.parametrize("blk", [8, 64])
def test_torch_fx_store_at_plain_matches_fixture_at_both_blocks(blk):
    """``_ref_store_at`` is fixed at 128 columns and takes any row count:
    at 8 and 64 rows, ``idx`` at the first, a middle and the last row and
    one past the end (interpret mode clamps it), bit for bit."""
    v = _i32(np.random.default_rng(blk), (blk, 128))
    for idx in (0, blk // 2, blk - 1, blk):
        i = np.array([[idx]], np.int32)
        np.testing.assert_array_equal(
            _np(_ref_store_at(jnp.asarray(i), jnp.asarray(v))),
            fk.fx_store_at_plain(_t(i), _t(v)).numpy())


def test_torch_one_operation_names_every_timed_kernel():
    """``chip_smoke.ONE_OPERATION`` names every kernel the kernels phase
    times (``kernel_specs``: the six production and probe kernels and
    ``fk.KERNELS``), so none can slip out of the one-operation check."""
    from types import SimpleNamespace

    from hermes_tpu_torch.core import kernels
    from hermes_tpu_torch.core import megaround as mega
    from hermes_tpu_torch.core import probe_kernels as pk

    port = SimpleNamespace(kernels=kernels, mega=mega, pk=pk, fk=fk)
    names = [spec[0] for spec in chip_smoke.kernel_specs(port)]
    assert len(names) == len(set(names)) == 14
    assert set(names) == set(fk.KERNELS) | {
        "stats_block", "mega_route", "mega_apply", "mega_replay",
        "probe_serial", "probe_vgather"}
    assert sorted(chip_smoke.ONE_OPERATION) == sorted(names)


@pytest.mark.parametrize("name", sorted(fk.KERNELS))
def test_torch_analysis_kernels_dispatch(name):
    """A CPU tensor takes the plain version (no launch counted); a wrong
    type raises; every kernel names its source and what it replaces."""
    wrapper, plain, lib, replaces = fk.KERNELS[name]
    x = torch.ones((8, 256), dtype=torch.int32)
    args = {"fx_pack": (x, x), "fx_serial_scan": (x.clone(), x[0, :4], x[:4]),
            "fx_store_at": (torch.tensor([1], dtype=torch.int32), x)}.get(
                name, (x,))
    before = wrapper.launches
    wrapper(*args)
    assert wrapper.launches == before
    with pytest.raises(TypeError):
        wrapper(*[a.long() for a in args])
    assert (build.CSRC / f"{lib}.cu").exists() and callable(plain)
    path, line = replaces.split(":")
    assert "pallas_call" in "".join(
        (ROOT / path).read_text().splitlines()[int(line) - 1:int(line) + 12])


# --------------------------------------------------------------------------
# red: what must escape does
# --------------------------------------------------------------------------


def test_torch_too_tight_bound_is_an_interval_violation():
    """The counterpart of the reference's unsound-rule mutation: ``hist``
    declared [0, 0] and the concrete counts escape."""
    cell = dc.cell_by_name("stats_block/r4s512")
    assert dc.diff_check(cell, n_draws=2, device="cpu")["ok"]
    cell.out_avs[2] = D.iv(0, 0)
    r = dc.diff_check(cell, n_draws=2, device="cpu")
    assert not r["ok"] and r["n_draws"] == 2
    assert any(v["kind"] == "interval" and v["out"] == 2
               for v in r["violations"])
    assert {"draw", "out", "concrete", "abstract", "kind"} <= set(
        r["violations"][0])


def test_torch_miscomputing_kernel_inside_its_bound_is_a_plain_violation():
    """A kernel that stays inside its declared bounds and computes
    something else: the sanitizer holds it against the plain version on
    the same draw and reports where they part."""
    cell = dc.cell_by_name("synthetic/scan-accumulate")
    assert dc.diff_check(cell, n_draws=2, device="cpu")["ok"]
    sums = cell.fn

    def off_by_one(x):  # column 3 one too high, still within [0, 1600]
        (out,) = sums(x)
        out[0, 3] += 1
        return (out,)

    cell.fn = off_by_one
    r = dc.diff_check(cell, n_draws=2, device="cpu")
    assert not r["ok"]
    assert [(v["draw"], v["kind"], v["out"], v["index"], v["n_differ"],
             v["concrete"] - v["abstract"]) for v in r["violations"]] == [
        (0, "plain", 0, 3, 1, 1), (1, "plain", 0, 3, 1, 1)]


def test_torch_route_cell_leaves_repeated_targets_open_and_nothing_else():
    """The matrix's draws repeat ``mega_route``'s targets, where a kernel
    whose threads run in no order may keep any writer's value: a
    first-writer-wins stand-in passes, one wrong word does not."""
    cell = dc.cell_by_name("mega_route/r2l6")
    plain = cell.plain
    args = dc.draw_args(cell, np.random.default_rng(0))
    assert len(np.unique(args[0][0])) < args[0].shape[1]  # a repeated lane
    cell.fn = lambda si, w, sr: plain(si.flip(1), w.flip(1), sr.flip(1))
    assert any(not torch.equal(a, b) for a, b in zip(
        cell.fn(*map(torch.from_numpy, args)),
        plain(*map(torch.from_numpy, args))))
    assert dc.diff_check(cell, n_draws=3, device="cpu")["ok"]
    first_wins = cell.fn

    def one_wrong_word(si, w, sr):
        lane_word, slot_lane = first_wins(si, w, sr)
        lane_word[0, 0] += 1
        return lane_word, slot_lane

    cell.fn = one_wrong_word
    r = dc.diff_check(cell, n_draws=3, device="cpu")
    assert [(v["kind"], v["out"], v["index"], v["n_differ"])
            for v in r["violations"]] == [("plain", 0, 0, 1)] * 3


def test_torch_overlapping_pack_escapes_the_disjoint_bound():
    """``a`` in [0, 2] and ``b`` below 2^29 pack into [0, 3 * 2^29 - 1];
    ``b`` at 2^29 overlaps ``a``'s field and leaves it."""
    av = D.iv(0, (2 << 29) | ((1 << 29) - 1))
    a = torch.full((8, 128), 2, dtype=torch.int32)
    ok = fk.fx_pack_plain(a, torch.full_like(a, (1 << 29) - 1))
    assert D.contains(av, ok.numpy()) == []
    bad = fk.fx_pack_plain(a, torch.full_like(a, 1 << 29))
    assert [v["kind"] for v in D.contains(av, bad.numpy())] == ["interval"]


def test_torch_dropped_init_escapes_on_a_poisoned_output():
    """In a checked block every output is poisoned first; without its
    zero-fill fx_acc_revisit keeps the poison and the analysis reports
    ``ref-read-before-init`` at the kernel's entry point."""
    x = torch.randint(0, 4, (8, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(1))
    bound = [D.iv(0, 3 * 256)]
    _outs, found = dc.analyze_call(lambda: (fk.fx_acc_revisit(x, True),),
                                   bound, "fx_acc_revisit", fk.LIB)
    assert found == []
    outs, found = dc.analyze_call(lambda: (fk.fx_acc_revisit(x, False),),
                                  bound, "fx_acc_revisit", fk.LIB)
    assert int(outs[0].max()) < 0
    assert [f.code for f in found] == ["ref-read-before-init"]
    f = found[0]
    assert f.severity == ana.ERROR and f.fn == "fx_acc_revisit"
    assert f.file == "hermes_tpu_torch/csrc/analysis_fixtures.cu"
    src = (ROOT / f.file).read_text().splitlines()
    assert "hermes_fx_acc_revisit(" in src[f.line - 1]
    # outside a checked block nothing is poisoned
    assert dispatch.out((2,), torch.int32, "cpu").shape == (2,)


def test_torch_checked_build_block_poisons_and_does_not_nest():
    with dispatch.checked_build() as chk:
        assert int(dispatch.out((3,), torch.int32, "cpu")[0]) == -(1 << 31)
        assert int(dispatch.out((3,), torch.int8, "cpu")[0]) == -128
        assert bool(dispatch.out((2,), torch.bool, "cpu")[0])
        with pytest.raises(RuntimeError):
            with dispatch.checked_build():
                pass
    assert chk.violations == [] and chk.launched == []
    with dispatch.checked_build():  # the failed nesting left no block open
        pass


def _guard():
    lib = build.load_cxx(build.PKG / "native" / "guard_host.cpp")
    lib.hermes_guard_check.restype = ctypes.c_int
    lib.hermes_guard_check.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int]
    lib.hermes_guard_check_range.restype = ctypes.c_int
    lib.hermes_guard_check_range.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.hermes_guard_words.restype = ctypes.c_int
    return lib


def test_torch_guard_arithmetic_host_build():
    """``csrc/guard.cuh``'s check through g++: an access in [0, extent)
    passes and records nothing; the first violation wins the report (site,
    index, extent, load or store); every violation is counted."""
    lib = _guard()
    assert lib.hermes_guard_words() == dispatch.REPORT_WORDS
    rep = (ctypes.c_longlong * dispatch.REPORT_WORDS)()
    check = lambda *a: lib.hermes_guard_check(ctypes.addressof(rep), *a)
    assert check(0, 8, 10, 1) == 1 and check(7, 8, 11, 0) == 1
    assert list(rep) == [0] * dispatch.REPORT_WORDS
    assert check(8, 8, 12, 0) == 0       # the extent itself is outside
    assert check(-1, 8, 13, 1) == 0      # so is a negative index
    assert check(1 << 40, 1 << 33, 14, 1) == 0  # 64-bit indices
    assert check(0, 0, 15, 1) == 0       # an empty extent holds nothing
    assert rep[dispatch.R_COUNT] == 4
    assert (rep[dispatch.R_LINE], rep[dispatch.R_INDEX],
            rep[dispatch.R_EXTENT], rep[dispatch.R_STORE]) == (12, 8, 8, 0)
    assert rep[dispatch.R_UNGUARDED] == 0


@pytest.mark.parametrize("start,count,extent,first_out", [
    (0, 1024, 1024, None), (1020, 4, 1024, None), (1024, 0, 1024, None),
    (1 << 40, 4096, 1 << 41, None), (0, 1024, 1020, 1020),
    (4096, 4, 1020, 4096), (-4, 8, 1020, -4), (1020, 4, 1020, 1020)])
def test_torch_guard_range_check_host_build(start, count, extent, first_out):
    """``check_range`` through g++: a range inside [0, extent) (an empty
    one at the extent too, 64-bit indices) passes and records nothing; a
    range that leaves the extent is refused whole and recorded at its
    first index outside it (the extent itself, or its start when that lies
    outside), as a store, once."""
    lib = _guard()
    rep = (ctypes.c_longlong * dispatch.REPORT_WORDS)()
    ok = lib.hermes_guard_check_range(ctypes.addressof(rep), start, count,
                                      extent, 77, 1)
    if first_out is None:
        assert ok == 1 and list(rep) == [0] * dispatch.REPORT_WORDS
    else:
        assert ok == 0
        assert (rep[dispatch.R_COUNT], rep[dispatch.R_LINE],
                rep[dispatch.R_INDEX], rep[dispatch.R_EXTENT],
                rep[dispatch.R_STORE]) == (1, 77, first_out, extent, 1)


def test_torch_every_kernel_source_is_guarded():
    """Every ``csrc/*.cu`` includes the guard, takes the report in its
    entry points and indexes no global pointer outside a guard site:
    ``kernel_at`` names the function of every site."""
    sources = build.cuda_sources()
    assert len(sources) == 8
    for src in sources:
        text = src.read_text()
        assert '#include "guard.cuh"' in text
        assert text.count("HG_ENTRY_ARG") == text.count("int hermes_") - (
            1 if src.stem == "stats_block" else 0)  # its _abi export
        assert text.count("HG_BEGIN(") == text.count("HG_ENTRY_ARG")
        assert dispatch.guard_sites(src.stem) >= 2
        for i, line in enumerate(text.splitlines(), 1):
            if dispatch._GUARD_SITE.search(line):
                assert dispatch.kernel_at(src.stem, i) != "<unknown>"
    apply_src = (build.CSRC / "mega_apply.cu").read_text().splitlines()
    atomic = next(i for i, line in enumerate(apply_src, 1)
                  if "HG_ATOMIC_MAX(" in line)
    assert dispatch.kernel_at("mega_apply", atomic) == "apply_kernel"
    flags = build.cuda_flags("mega_apply", checked=True, broken=True)
    assert "-DHERMES_CHECKED" in flags and "-DHERMES_BROKEN_NO_CLAMP" in flags
    assert "-DHERMES_CHECKED" not in build.cuda_flags("mega_apply")
    assert "-cudart" in build.cuda_flags("mega_apply", checked=True)
    with pytest.raises(ValueError):
        build.cuda_flags("mega_apply", checked=False, broken=True)


# --------------------------------------------------------------------------
# the reports and the command line
# --------------------------------------------------------------------------


def test_torch_analyze_kernel_report_shape_on_cpu():
    rep = dc.analyze_kernel(dc.cell_by_name("mega_apply/k16n16"), "cpu")
    assert rep["engine"] == "kernel/mega_apply/k16n16"
    assert rep["build"] == "plain" and rep["n_sites"] > 0
    assert rep["proved"] == {"refhazard": 0}  # nothing was bound-checked
    (f,) = rep["findings"]
    assert (f.code, f.severity, f.engine) == ("guard-skipped", ana.INFO,
                                              rep["engine"])
    assert f.record()["key"] == f.key and f.site == "<unknown>:0"


def test_torch_kernels_flag_runs_matrix(capsys, tmp_path):
    """The reference's keys (``test_kernels_flag_runs_matrix`` there)."""
    out = tmp_path / "findings.jsonl"
    rc = cli.main(["--kernels", "--json", "--draws", "2", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["ok"] and doc["config"] == "kernels"
    assert doc["errors"] == 0 and doc["warnings"] == 0
    assert list(doc["cells"])[:8] == [f"kernel/{n}" for n in REF_NAMES]
    for info in doc["cells"].values():
        assert info["sanitizer_ok"] and info["draws"] == 2
        assert info["seconds"] >= 0 and info["errors"] == 0
        assert info["build"] == "plain"
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert all(r["kind"] == "analysis" and r["config"] == "kernels"
               and "t" in r for r in recs)
    assert sum(r["record"] == "program" for r in recs) == len(doc["cells"])
    assert sum(r["record"] == "finding" for r in recs) == doc["infos"]


def test_torch_kernels_cli_red_and_refusals(capsys, monkeypatch):
    """A violated cell fails the run; a config the command does not know
    is refused."""
    cell = dc.cell_by_name("synthetic/scan-accumulate")
    cell.out_avs[0] = D.iv(0, 100)  # one pass of the loop body, unwidened
    monkeypatch.setattr(dc, "kernel_cells", lambda: [cell])
    assert cli.main(["--kernels", "--draws", "2", "--device", "cpu"]) == 1
    io = capsys.readouterr()
    assert json.loads(io.out.strip().splitlines()[-1])["ok"] is False
    assert "ESCAPE" in io.err and "ref-read-before-init" in io.err
    with pytest.raises(SystemExit):
        cli.main(["--config", "nope", "--device", "cpu"])


def test_torch_kernels_cli_needs_card():
    """Without ``--device`` the matrix asks for the card and, on a machine
    without one, exits non-zero naming it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the matrix would run on it")
    r = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.analysis",
                        "--kernels", "--json"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("cand", ["torch", "serial", "onehot", "vgather"])
def test_torch_probe_cells_carry_analysis_fields(cand):
    """The analysis fields of scripts/pallas_probe.py's cells; on the CPU
    they come from the plain versions and say so."""
    c = tp.cell(cand, 64, 256, "cpu")
    assert c["analysis_clean"] is True and c["analysis_findings"] == []
    assert c["analysis_build"] == "plain" and c["analysis_calls"] == 1
    assert c["calls"] == 4  # the timed calls, as before


def test_torch_probe_analysis_flags_an_escape(monkeypatch):
    """A step whose output leaves its declared bound is not clean."""
    monkeypatch.setattr(tp, "_declared_out",
                        lambda cand, K, args: [D.iv(0, 0)])
    c = tp.analyze_step("vgather", 64, 256, "cpu")
    assert c["analysis_clean"] is False
    assert c["analysis_findings"][0].startswith(
        "error:refhazard/ref-read-before-init@hermes_tpu_torch/csrc/"
        "probe_vgather.cu:")


# --------------------------------------------------------------------------
# the tables and seeds the bounds are made from
# --------------------------------------------------------------------------


@pytest.mark.parametrize("table", ["LANE_WORD", "INV_PKF", "SST", "PTS"])
def test_torch_layout_fields_read_by_the_seeds_equal_reference(table):
    mine, ref = getattr(layouts, table), getattr(ref_layouts, table)
    assert mine.word_bits == ref.word_bits
    assert [tuple(f) for f in mine.fields] == [tuple(f) for f in ref.fields]
    for f in ref.fields:
        assert mine.field(f.name).mask == f.mask
        assert mine.field(f.name).cap == f.cap


def test_torch_stats_ctr_and_step_budget_equal_reference():
    assert layouts.STATS_CTR.rows == ref_layouts.STATS_CTR.rows
    assert layouts.STATS_CTR.width == ref_layouts.STATS_CTR.width
    for row in ref_layouts.STATS_CTR.rows:
        assert layouts.STATS_CTR.row(row) == ref_layouts.STATS_CTR.row(row)
    assert layouts.MAX_STEPS == ref_layouts.MAX_STEPS
    assert layouts.MAX_KEY_VERSIONS == ref_layouts.MAX_KEY_VERSIONS


def test_torch_seeds_equal_reference_seeds():
    kw = dict(n_replicas=3, n_keys=40, n_sessions=6, replay_slots=3,
              ops_per_session=4, arb_mode="sort", mega_round=True)
    cfg, ref_cfg = HermesConfig(**kw), RefConfig(**kw)
    same = lambda a, b: [(x.lo, x.hi, x.ones) for x in a] == [
        (x.lo, x.hi, x.ones) for x in b]
    assert same([seeds.pts_seed(cfg), seeds.step_seed(cfg)],
                [ref_seeds.pts_seed(ref_cfg), ref_seeds.step_seed(ref_cfg)])
    assert same(seeds.seed_stats_block(), ref_seeds.seed_stats_block())
    assert same(seeds.seed_mega_route(cfg), ref_seeds.seed_mega_route(ref_cfg))
    assert same(seeds.seed_mega_apply(cfg), ref_seeds.seed_mega_apply(ref_cfg))
    assert same(seeds.seed_mega_replay(cfg),
                ref_seeds.seed_mega_replay(ref_cfg))
    assert same(seeds.seed_scan_acc(), ref_dc._scan_acc_cell().in_avs)


def test_torch_domain_matches_reference_domain():
    from hermes_tpu.analysis import domain as ref_D

    for lo, hi, ones in [(0, 5, -1), (3, 3, -1), (-4, 9, 0xF), (0, 100, 0x55),
                         (0, (1 << 31) - 1, -1)]:
        a, b = D.AbsVal(lo, hi, ones), ref_D.AbsVal(lo, hi, ones)
        assert (a.lo, a.hi, a.ones, repr(a)) == (b.lo, b.hi, b.ones, repr(b))
    for dt in (np.int32, np.int8, np.bool_):
        a, b = D.top(dt), ref_D.top(dt)
        assert (a.lo, a.hi, a.ones) == (b.lo, b.hi, b.ones)
        assert D.is_top(a, dt) and not D.is_top(D.iv(0, 1), np.int8)
    arr = np.array([[3, -7], [12, 0]], np.int32)
    a, b = D.from_concrete(arr), ref_D.from_concrete(arr)
    assert (a.lo, a.hi, a.ones) == (b.lo, b.hi, b.ones)
    with pytest.raises(ValueError):
        D.AbsVal(2, 1)
    # contains: the interval test and the possible-ones test
    assert D.contains(D.iv(0, 12), np.array([0, 12])) == []
    assert [v["kind"] for v in D.contains(D.iv(0, 11), np.array([12]))] == [
        "interval"]
    masked = D.AbsVal(0, 12, 0b1100)
    assert D.contains(masked, np.array([4, 8, 12])) == []
    assert [v["kind"] for v in D.contains(masked, np.array([5]))] == [
        "ones-mask"]
    assert D.contains(D.iv(0, 0), np.zeros((0,), np.int32)) == []
