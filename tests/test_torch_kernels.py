"""The port's stats_block (hermes_tpu_torch/core/kernels.py) against the
reference Pallas kernel (hermes_tpu/core/kernels.py, interpret mode on the
CPU, as tests/test_kernels.py runs it).

The plain version is held bit-exact (integer outputs, tolerance: exact
equality) at the three stats_block cells of the reference's kernel matrix
(analysis/diffcheck.py kernel_cells: r4s512, r1024s600, r512s2000); the
CUDA kernel is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
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


@pytest.mark.parametrize("R,S", STATS_CELLS)
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
