"""The round's completion-statistics kernel: ``stats_block``.

Replaces the Pallas kernel ``hermes_tpu/core/kernels.py:_stats_kernel``
(wrapper ``stats_block``, which reaches ``pl.pallas_call``) with a CUDA
kernel written for Hopper, ``hermes_tpu_torch/csrc/stats_block.cu``.  For
each (replica, session) it forms the completion code; per replica it sums
the op counters ``read, write, rmw, abort, lat_sum, lat_cnt`` into an
(R, STATS_CTR.width) int32 block and a LAT_BINS-bin commit-latency
histogram over ``clip(step - invoke_step, 0, LAT_BINS - 1)``.

What bounds it on the card: memory, ~15 bytes per lane and no real
arithmetic — at the bench shape (8 x 65536 lanes) about 2.4 us at
3.35 TB/s, about what a launch takes.  The kernel is therefore one launch
that touches device memory once per input and output: one thread-block
cluster a replica (``stats_plan``), four lanes a thread a step with
16-byte loads of the int32 arrays, every reduction on chip (registers,
warp reductions, a shared-memory histogram, the cluster's distributed
shared memory), and each output written whole, so nothing needs zeroing
first; see the source note in the .cu file.

Dispatch has no fallback: a CPU tensor goes to ``stats_block_plain`` (the
same function in plain torch, which the CPU tests use and ``chip_smoke.py``
holds the kernel against); a CUDA tensor launches the kernel or raises.
``stats_block.launches`` counts kernel launches and nothing else, one a
call: a call is one device operation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hermes_tpu_torch import build
from hermes_tpu_torch.core import layouts
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.core.dispatch import CLUSTER_MAX, SMS, cdiv, launch, out

CTR_READ = layouts.STATS_CTR.row("read")
CTR_WRITE = layouts.STATS_CTR.row("write")
CTR_RMW = layouts.STATS_CTR.row("rmw")
CTR_ABORT = layouts.STATS_CTR.row("abort")
CTR_LATSUM = layouts.STATS_CTR.row("lat_sum")
CTR_LATCNT = layouts.STATS_CTR.row("lat_cnt")
CTR_WIDTH = layouts.STATS_CTR.width

I32 = torch.int32

# the constants stats_block.cu must have been compiled with (its
# hermes_stats_block_abi export), in that function's order
_ABI = (st.LAT_BINS, CTR_WIDTH, len(layouts.STATS_CTR.rows), t.OP_RMW,
        t.C_NONE, t.C_READ, t.C_WRITE, t.C_RMW, t.C_RMW_ABORT)
assert layouts.STATS_CTR.rows == ("read", "write", "rmw", "abort",
                                  "lat_sum", "lat_cnt")


def stats_block_plain(step, sess_op, invoke_step, commit, abort, read_done):
    """The kernel's function in plain torch: (code (R, S) int32,
    ctr (R, CTR_WIDTH) int32, hist (R, LAT_BINS) int32)."""
    R, S = sess_op.shape
    is_rmw = sess_op == t.OP_RMW
    code = torch.full((R, S), t.C_NONE, dtype=I32, device=sess_op.device)
    code = torch.where(read_done, t.C_READ, code)
    code = torch.where(commit & ~is_rmw, t.C_WRITE, code)
    code = torch.where(commit & is_rmw, t.C_RMW, code)
    code = torch.where(abort, t.C_RMW_ABORT, code)
    lat = torch.where(commit, step - invoke_step, 0)
    cnt = lambda m: m.sum(dim=1, dtype=I32)
    zero = torch.zeros(R, dtype=I32, device=sess_op.device)
    cols = [cnt(read_done), cnt(commit & ~is_rmw), cnt(commit & is_rmw),
            cnt(abort), lat.sum(dim=1, dtype=I32), cnt(commit)]
    ctr = torch.stack(cols + [zero] * (CTR_WIDTH - len(cols)), dim=1)
    clat = lat.clamp(0, st.LAT_BINS - 1).long()
    hist = torch.zeros((R, st.LAT_BINS), dtype=I32, device=sess_op.device)
    hist.scatter_add_(1, clat, commit.to(I32))
    return code, ctr, hist


_abi_checked = False


def _check_abi() -> None:
    """Raise unless the built kernel library's compiled-in constants are
    ``_ABI``; checked once."""
    global _abi_checked
    if not _abi_checked:
        lib = build.load_cuda("stats_block")
        n = len(_ABI)
        buf = (ctypes.c_int32 * n)()
        lib.hermes_stats_block_abi.restype = ctypes.c_int
        lib.hermes_stats_block_abi.argtypes = [ctypes.c_void_p, ctypes.c_int]
        got = lib.hermes_stats_block_abi(ctypes.addressof(buf), n)
        if got != n or tuple(buf) != _ABI:
            raise RuntimeError(
                f"stats_block.cu was built with constants {tuple(buf)[:got]}"
                f", but core/types.py and core/layouts.py say {_ABI}")
        _abi_checked = True


def _check_args(step, sess_op, invoke_step, commit, abort, read_done):
    if sess_op.dim() != 2:
        raise ValueError(f"sess_op must be (R, S), got {tuple(sess_op.shape)}")
    dev = sess_op.device
    for name, x, dt in (("sess_op", sess_op, I32),
                        ("invoke_step", invoke_step, I32),
                        ("commit", commit, torch.bool),
                        ("abort", abort, torch.bool),
                        ("read_done", read_done, torch.bool)):
        if x.dtype != dt:
            raise TypeError(f"stats_block: {name} must be {dt}, got {x.dtype}")
        if x.shape != sess_op.shape:
            raise ValueError(f"stats_block: {name} has shape "
                             f"{tuple(x.shape)}, want {tuple(sess_op.shape)}")
        if x.device != dev:
            raise ValueError(f"stats_block: {name} is on {x.device}, "
                             f"sess_op on {dev}")
    if step.dtype != I32 or step.numel() != 1 or step.device != dev:
        raise TypeError("stats_block: step must be a one-element int32 "
                        f"tensor on {dev}, got {step.dtype} "
                        f"{tuple(step.shape)} on {step.device}")


#: lanes a thread of stats_block.cu takes a step, one int4 (its kUnit)
STATS_UNIT = 4
#: the least lanes a CTA walks before a replica takes more CTAs
STATS_MIN_LANES = 2048


class StatsPlan(NamedTuple):
    """``stats_block.cu``'s launch geometry: a cluster of ``cluster`` CTAs a
    replica row (grid ``(cluster, R)``); CTA ``q`` walks the row's lanes
    ``[q * ps, (q + 1) * ps)``, ``ps`` a multiple of ``STATS_UNIT``, with
    a thread for every ``STATS_UNIT`` lanes of it, up to 512."""
    cluster: int
    ps: int


@functools.lru_cache(maxsize=64)
def stats_plan(R: int, S: int) -> StatsPlan:
    """The cluster of an (R, S) call: the largest power of two up to
    ``CLUSTER_MAX`` that keeps R clusters within the card's ``SMS`` and
    gives every CTA at least ``STATS_MIN_LANES`` lanes, else one CTA a
    replica.  At the bench shape (8, 65536): 8 clusters of 16."""
    if not (1 <= R <= 65535 and S >= 1):
        raise ValueError(f"stats_plan: no plan for R={R} S={S}")
    q = 1
    while (2 * q <= CLUSTER_MAX and R * 2 * q <= SMS
           and S >= 2 * q * STATS_MIN_LANES):
        q *= 2
    return StatsPlan(q, cdiv(cdiv(S, q), STATS_UNIT) * STATS_UNIT)


def _stats_block_cuda(step, sess_op, invoke_step, commit, abort, read_done):
    args = (step, sess_op, invoke_step, commit, abort, read_done)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("stats_block: the CUDA kernel takes contiguous "
                         "tensors only")
    R, S = sess_op.shape
    dev = sess_op.device
    code = out((R, S), I32, dev)
    if R == 0 or S == 0:  # no lane: nothing to launch, the sums are 0
        return (code, torch.zeros((R, CTR_WIDTH), dtype=I32, device=dev),
                torch.zeros((R, st.LAT_BINS), dtype=I32, device=dev))
    # the kernel writes ctr and hist whole: no zero-fill
    ctr = out((R, CTR_WIDTH), I32, dev)
    hist = out((R, st.LAT_BINS), I32, dev)
    _check_abi()
    plan = stats_plan(R, S)
    launch("stats_block", dev, *args, code, ctr, hist, R, S, plan.cluster,
           plan.ps)
    stats_block.launches += 1
    return code, ctr, hist


def stats_block(step, sess_op, invoke_step, commit, abort, read_done):
    """Fused completion codes + counters + latency histogram.

    ``step`` is the round index as a one-element int32 tensor on the
    sessions' device (or a Python int); the rest are (R, S) session
    arrays, ``commit``/``abort``/``read_done`` bool.  Returns
    (code (R, S), ctr (R, CTR_WIDTH), hist_add (R, LAT_BINS)), all int32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=I32, device=sess_op.device)
    _check_args(step, sess_op, invoke_step, commit, abort, read_done)
    if sess_op.device.type == "cpu":
        return stats_block_plain(step, sess_op, invoke_step, commit, abort,
                                 read_done)
    if sess_op.device.type != "cuda":
        raise ValueError(f"stats_block runs on cuda or cpu tensors, got "
                         f"{sess_op.device}")
    return _stats_block_cuda(step, sess_op, invoke_step, commit, abort,
                             read_done)


stats_block.launches = 0
