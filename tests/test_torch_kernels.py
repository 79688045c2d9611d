"""The port's stats_block (hermes_tpu_torch/core/kernels.py) against the
reference Pallas kernel (hermes_tpu/core/kernels.py, interpret mode on the
CPU, as tests/test_kernels.py runs it).

The plain version is held bit-exact (integer outputs, tolerance: exact
equality) at the three stats_block cells of the reference's kernel matrix
(analysis/diffcheck.py kernel_cells: r4s512, r1024s600, r512s2000) and at
two edges of the CUDA kernel's geometry; the CUDA kernel is held against
the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.  Its launch geometry (``stats_plan``) and its arithmetic
over that geometry are replayed here in numpy.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hermes_tpu.analysis import diffcheck
from hermes_tpu.core import kernels as ref_kernels
from hermes_tpu_torch.core import kernels, layouts, types as t

torch.set_num_threads(1)


def _stats_cells():
    """(R, S) of every stats_block cell in the reference's kernel matrix."""
    out = []
    for cell in diffcheck.kernel_cells():
        m = re.fullmatch(r"stats_block/r(\d+)s(\d+)", cell.name)
        if m:
            out.append((int(m.group(1)), int(m.group(2))))
    return out


STATS_CELLS = [(4, 512), (1024, 600), (512, 2000)]


def _inputs(R, S, seed):
    rng = np.random.default_rng(seed)
    op = rng.choice([t.OP_NOP, t.OP_READ, t.OP_WRITE, t.OP_RMW],
                    (R, S)).astype(np.int32)
    invoke = rng.integers(0, 90, (R, S)).astype(np.int32)
    commit = rng.random((R, S)) < 0.3
    abort = (rng.random((R, S)) < 0.05) & ~commit
    read = (rng.random((R, S)) < 0.3) & ~commit & ~abort
    return 77, op, invoke, commit, abort, read


def test_stats_cells_match_reference_matrix():
    assert _stats_cells() == STATS_CELLS


# shapes of the CUDA kernel's edges beside the matrix's cells: a row
# shorter than two 4-lane units, one that takes two CTAs of a cluster
STATS_EDGES = [(3, 5), (1, 33000)]


@pytest.mark.parametrize("R,S", STATS_CELLS + STATS_EDGES)
def test_stats_block_plain_matches_pallas(R, S):
    step, op, invoke, commit, abort, read = _inputs(R, S, seed=R + S)
    ref = ref_kernels.stats_block(step, *(jnp.asarray(a) for a in
                                          (op, invoke, commit, abort, read)))
    got = kernels.stats_block_plain(
        torch.tensor(step, dtype=torch.int32),
        *(torch.from_numpy(a) for a in (op, invoke, commit, abort, read)))
    for name, r, g in zip(("code", "ctr", "hist"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


def test_stats_block_layout_rows_match_reference():
    assert (kernels.CTR_READ, kernels.CTR_WRITE, kernels.CTR_RMW,
            kernels.CTR_ABORT, kernels.CTR_LATSUM, kernels.CTR_LATCNT,
            kernels.CTR_WIDTH) == (
        ref_kernels.CTR_READ, ref_kernels.CTR_WRITE, ref_kernels.CTR_RMW,
        ref_kernels.CTR_ABORT, ref_kernels.CTR_LATSUM, ref_kernels.CTR_LATCNT,
        ref_kernels.CTR_WIDTH)
    assert layouts.STATS_CTR.width == kernels.CTR_WIDTH


def test_stats_block_wrapper_takes_plain_path_on_cpu():
    step, op, invoke, commit, abort, read = _inputs(3, 100, seed=1)
    args = [torch.from_numpy(a) for a in (op, invoke, commit, abort, read)]
    before = kernels.stats_block.launches
    got = kernels.stats_block(step, *args)
    plain = kernels.stats_block_plain(torch.tensor(step, dtype=torch.int32),
                                      *args)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert kernels.stats_block.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["op_dtype", "mask_dtype", "shape", "step"])
def test_stats_block_wrapper_rejects_bad_inputs(bad):
    step, op, invoke, commit, abort, read = _inputs(2, 16, seed=2)
    args = [torch.tensor(step, dtype=torch.int32)] + [
        torch.from_numpy(a) for a in (op, invoke, commit, abort, read)]
    if bad == "op_dtype":
        args[1] = args[1].to(torch.int64)
    elif bad == "mask_dtype":
        args[3] = args[3].to(torch.int32)
    elif bad == "shape":
        args[5] = args[5][:, :8]
    else:
        args[0] = torch.tensor(step, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        kernels.stats_block(*args)


# --------------------------------------------------------------------------
# stats_block's launch geometry (csrc/stats_block.cu runs only on the card)
# --------------------------------------------------------------------------

import chip_smoke  # noqa: E402  (after the reference's imports, as above)

UNIT = kernels.STATS_UNIT


def _cta_spans(plan, R, S, vec=True):
    """stats_block.cu's spans: for each (replica r, CTA q) of the grid,
    the head, the body of 4-lane units and the tail of its lanes, as
    global [lo, hi) ranges; without vector access the whole span is the
    head."""
    out = []
    for r in range(R):
        for q in range(plan.cluster):
            s0, s1 = min(S, q * plan.ps), min(S, (q + 1) * plan.ps)
            g0, g1 = r * S + s0, r * S + s1
            a = b = g1
            if vec:
                a = min(g1, -(-g0 // UNIT) * UNIT)
                b = max(a, g1 // UNIT * UNIT)
            out.append((r, q, (g0, a), (a, b), (b, g1)))
    return out


def _stats_by_plan(plan, R, S, step, op, invoke, commit, abort, read):
    """stats_block.cu's arithmetic over the plan, in numpy: each CTA sums
    its spans' lanes in uint32 (bin 0 in a register, the other bins in its
    histogram), then rank 0 of each cluster adds the CTAs' partials and
    writes the row whole; every element starts poisoned."""
    flat = lambda x: np.asarray(x).reshape(-1)
    op, inv, c, a, rd = map(flat, (op, invoke, commit, abort, read))
    code = np.full(R * S, -7, np.int64)
    part = {}
    for r, q, *spans in _cta_spans(plan, R, S):
        sums = np.zeros(7, np.uint32)
        hist = np.zeros(64, np.uint32)
        for lo, hi in spans:
            i = np.arange(lo, hi)
            rmw = op[i] == t.OP_RMW
            code[i] = np.where(a[i], t.C_RMW_ABORT, np.where(
                c[i], np.where(rmw, t.C_RMW, t.C_WRITE),
                np.where(rd[i], t.C_READ, t.C_NONE)))
            lat = (np.uint32(step) - inv[i].astype(np.uint32))[c[i]]
            sums += np.array([rd[i].sum(), (c[i] & ~rmw).sum(),
                              (c[i] & rmw).sum(), a[i].sum(),
                              lat.sum(dtype=np.uint32), c[i].sum(), 0],
                             np.uint32)
            b = np.clip(lat.view(np.int32), 0, 63)
            sums[6] += np.uint32((b == 0).sum())
            np.add.at(hist, b[b > 0], 1)
        hist[0] = sums[6]
        part[r, q] = (sums, hist)
    ctr = np.full((R, 8), -7, np.int64)
    hist = np.full((R, 64), -7, np.int64)
    for r in range(R):
        s = sum(part[r, q][0] for q in range(plan.cluster)).astype(np.uint32)
        h = sum(part[r, q][1] for q in range(plan.cluster)).astype(np.uint32)
        ctr[r] = np.concatenate([s[:6], np.zeros(2, np.uint32)]).view(
            np.int32)
        hist[r] = h.view(np.int32)
    return code.reshape(R, S), ctr, hist


@pytest.mark.parametrize("R,S", list(chip_smoke.STATS_SHAPES) + STATS_EDGES)
def test_torch_stats_plan_spans_partition_each_row(R, S):
    """At every chip_smoke.py shape, a row shorter than two 4-lane units
    and one that takes two CTAs: the plan is a cluster of 1 to 16 CTAs
    (R clusters within the card's SMs, at least STATS_MIN_LANES lanes a
    CTA), the CTAs' head, body and tail spans partition each replica's
    row with bodies in whole 4-lane units (16 bytes of op, invoke and
    code), and the kernel's sums over those spans give the plain
    version's outputs, every element written."""
    plan = kernels.stats_plan(R, S)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.ps % UNIT == 0
    assert plan.cluster * plan.ps >= S
    assert plan.cluster == 1 or (R * plan.cluster <= 132 and
                                 S >= plan.cluster * kernels.STATS_MIN_LANES)
    if (R, S) == chip_smoke.STATS_SHAPES[0]:  # the bench shape
        assert plan == (16, 4096)
    for vec in (True, False):
        seen = np.zeros(R * S, np.int64)
        for r, _q, *spans in _cta_spans(plan, R, S, vec):
            (h0, h1), (b0, b1), (t0, t1) = spans
            assert h0 <= h1 == b0 <= b1 == t0 <= t1
            assert r * S <= h0 and t1 <= (r + 1) * S
            assert h1 - h0 < UNIT and t1 - t0 < UNIT or not vec
            assert b0 == b1 or b0 % UNIT == 0 and b1 % UNIT == 0 or (
                not vec)
            for lo, hi in spans:
                seen[lo:hi] += 1
        assert (seen == 1).all()
    step, op, invoke, commit, abort, read = _inputs(R, S, seed=R * S)
    got = _stats_by_plan(plan, R, S, step, op, invoke, commit, abort, read)
    want = kernels.stats_block_plain(
        torch.tensor(step, dtype=torch.int32),
        *(torch.from_numpy(a) for a in (op, invoke, commit, abort, read)))
    for name, g, w in zip(("code", "ctr", "hist"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


def test_torch_stats_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError):
        kernels.stats_plan(65536, 16)
    with pytest.raises(ValueError):
        kernels.stats_plan(4, 0)
