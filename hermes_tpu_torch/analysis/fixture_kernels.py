"""The kernel analysis's own kernels: the scan-accumulate sentinel
``scan_acc`` and the seven fixtures ``fx_*`` that its red tests are built
on.

Each replaces a Pallas kernel with a CUDA kernel written for Hopper
(``csrc/scan_acc.cu`` and ``csrc/analysis_fixtures.cu``, built by
``build.py`` and loaded with ctypes; the source notes there say what each
computes and what its design does):

* ``scan_acc`` — ``hermes_tpu/analysis/diffcheck.py:_scan_acc_cell._kern``
  (pallas_call at :99): the column sums of an (M, W) int32 array;
* the fixtures of ``tests/test_pallas_analysis.py``: ``fx_pack`` (:128,
  :146), ``fx_store_at`` (:174), ``fx_acc_revisit`` (:215),
  ``fx_block_copy`` (:249), ``fx_serial_scan`` (:279, :315),
  ``fx_async_copy`` (:350), ``fx_loop_inc`` (:405).

Dispatch, as for ``core/megaround.py``: a CPU tensor goes to the plain
version (``*_plain``), a CUDA tensor launches the kernel or raises.
``.launches`` on each wrapper counts the calls that launched its kernel,
one per call.

Three fixtures take an argument that can leave the tensor
(``fx_store_at``'s index, ``fx_serial_scan``'s keys, ``fx_block_copy``'s
offset).  The CUDA kernels do not clamp it: launch such an argument only
inside ``dispatch.checked_build()``, where the guard records and skips the
access; the release build may write outside the tensor
(``fx_block_copy``) or store nothing there (``fx_serial_scan``,
``fx_store_at``), where the plain version clamps.  The plain
versions place such an argument where the reference's interpret mode
does (an index counted from the end when negative, then clamped), so the
CPU tests can hold them against the Pallas fixtures there too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hermes_tpu_torch.core.dispatch import (CLUSTER_MAX, SMS, cdiv, launch,
                                            need, on_card, out)
from hermes_tpu_torch.core.probe_kernels import (probe_serial_plain,
                                                 row_index)

I32 = torch.int32
LIB = "analysis_fixtures"
BLOCK_COLS = 128  # analysis_fixtures.cu's kBlockCols


def _need2(name, what, x):
    need(name, what, x, I32)
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{name}: {what} must be a non-empty 2-d tensor, got "
                         f"{tuple(x.shape)}")
    return x.shape


# --------------------------------------------------------------------------
# scan_acc: the scan-accumulate sentinel
# --------------------------------------------------------------------------


def scan_acc_plain(x):
    """The (1, W) column sums of ``x`` (M, W) int32, wrapping as int32."""
    return x.sum(dim=0, keepdim=True, dtype=torch.int64).to(I32)


#: threads of a scan_acc CTA (scan_acc.cu's kThreads) and the most
#: threads that read one row of a column tile
SCAN_THREADS = 512
SCAN_TPR_MAX = 8
#: scan_acc.cu's shared memory a CTA: a partial row a warp, then the CTA's
SCAN_SMEM_BYTES = 4 * (SCAN_THREADS // 32 + 1) * 32


class ScanPlan(NamedTuple):
    """``scan_acc.cu``'s launch geometry: ``vec`` columns a thread (4: one
    16-byte load), ``tpr`` threads a row of a tile of ``tpr * vec``
    columns, ``tiles`` tiles, one cluster of ``cluster`` CTAs a tile, each
    CTA summing ``rows_per_cta`` rows."""
    vec: int
    tpr: int
    cluster: int
    tiles: int
    rows_per_cta: int


@functools.lru_cache(maxsize=64)
def scan_acc_plan(M: int, W: int, aligned: bool = True) -> ScanPlan:
    """The cluster plan of the (M, W) column sums: 16-byte loads when W is
    a multiple of 4 and ``x`` is ``aligned``; as many threads a row as the
    row's vectors need, at most ``SCAN_TPR_MAX``; as many CTAs a tile as
    fill the card's SMs, at most ``CLUSTER_MAX``, each with at least two
    passes of its threads over its rows (so a short array takes one CTA)."""
    if M < 1 or W < 1:
        raise ValueError(f"scan_acc_plan: no plan for ({M}, {W})")
    vec = 4 if W % 4 == 0 and aligned else 1
    tpr = min(SCAN_TPR_MAX, 1 << (cdiv(W, vec) - 1).bit_length())
    tiles = cdiv(W, tpr * vec)
    rows_in_flight = SCAN_THREADS // tpr
    q = max(1, min(CLUSTER_MAX, cdiv(SMS, tiles), M // (2 * rows_in_flight)))
    rows = cdiv(M, q)
    return ScanPlan(vec, tpr, cdiv(M, rows), tiles, rows)


def scan_acc(x):
    """``out[0, w] = sum_i x[i, w]`` for ``x`` (M, W) int32; returns the
    (1, W) int32 sums.

    Replaces ``_scan_acc_cell._kern``, a zero-fill and a 16-step loop that
    adds row i into the output block.  Bound by memory (each element read
    once, each column written once; at the sentinel's (16, 8) the launch is
    all of its time).  A thread-block cluster a column tile
    (``scan_acc_plan``): its CTAs sum contiguous row shares in registers,
    reduce across warps in shared memory and across the cluster through
    distributed shared memory, and one CTA stores each column once."""
    name = "scan_acc"
    M, W = _need2(name, "x", x)
    if not on_card(name, x):
        return scan_acc_plain(x)
    sums = out((1, W), I32, x.device)
    plan = scan_acc_plan(M, W, x.data_ptr() % 16 == 0)
    launch(name, x.device, x, sums, M, W, plan.vec, plan.tpr, plan.cluster,
           plan.tiles, plan.rows_per_cta)
    scan_acc.launches += 1
    return sums


scan_acc.launches = 0


# --------------------------------------------------------------------------
# fx_pack: a shift-or pack
# --------------------------------------------------------------------------


def fx_pack_plain(a, b):
    """``(a << 29) | b`` on int32, the shift wrapping."""
    return (a << 29) | b


def pack_access(a, b, packed) -> int:
    """1 where ``fx_pack`` moves 16-byte int4s (a multiple of 4 elements,
    all three pointers 16-byte aligned), else 0 (4-byte words)."""
    return int(a.numel() % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b, packed)))


def fx_pack(a, b):
    """``(a << 29) | b`` elementwise on two int32 tensors of one shape:
    the pack whose fields overlap when ``b`` reaches 2^29.  Replaces
    ``_pack_kernel``.  One unit a thread and no thread loops: a 16-byte
    int4 of each tensor where ``pack_access`` allows it, else a word."""
    name = "fx_pack"
    need(name, "a", a, I32)
    need(name, "b", b, I32, a.shape)
    if not on_card(name, a, b):
        return fx_pack_plain(a, b)
    packed = out(a.shape, I32, a.device)
    if a.numel():
        launch(name, a.device, a, b, packed, a.numel(),
               pack_access(a, b, packed), lib=LIB)
        fx_pack.launches += 1
    return packed


fx_pack.launches = 0


# --------------------------------------------------------------------------
# fx_store_at: one row stored at an index read from device memory
# --------------------------------------------------------------------------


def fx_store_at_plain(idx, v):
    """Zeros shaped as ``v`` with ``v[0]`` stored at row
    ``row_index(idx)``: where interpret mode puts any index."""
    stored = torch.zeros_like(v)
    stored[row_index(idx.reshape(()), v.shape[0]).long()] = v[0]
    return stored


def fx_store_at(idx, v):
    """``out = 0; out[idx] = v[0]`` for ``v`` (rows, W) int32 and ``idx``
    a one-element int32 tensor on ``v``'s device (the counterpart of the
    Pallas kernel's scalar in SMEM).  Replaces ``_store_at_idx._kern``.
    One launch and no memset: each thread stores one unit of the flat
    output (a 16-byte int4 where ``store_at_access`` allows it, else a
    word), row 0 of ``v`` on the words of row ``idx`` and 0 on the others.
    An ``idx`` outside [0, rows) only inside ``dispatch.checked_build()``
    (the release build then writes zeros alone, where the plain version
    clamps the row)."""
    name = "fx_store_at"
    rows, W = _need2(name, "v", v)
    need(name, "idx", idx, I32)
    if idx.numel() != 1:
        raise ValueError(f"{name}: idx must hold one index, got "
                         f"{tuple(idx.shape)}")
    if not on_card(name, idx, v):
        return fx_store_at_plain(idx, v)
    stored = out((rows, W), I32, v.device)
    launch(name, v.device, idx, v, stored, rows, W, store_at_access(stored),
           lib=LIB)
    fx_store_at.launches += 1
    return stored


fx_store_at.launches = 0


# --------------------------------------------------------------------------
# fx_acc_revisit: partial sums accumulated into one revisited output
# --------------------------------------------------------------------------


def fx_acc_revisit_plain(x, init=True, acc=None):
    """``acc`` (R, 1) plus the row sums of ``x`` (R, C), block of 128
    columns by block; ``init`` zeroes ``acc`` first.  Without ``init`` the
    result keeps what ``acc`` held (an uninitialised output's content)."""
    if acc is None:
        acc = out((x.shape[0], 1), I32, x.device)
    if init:
        acc.zero_()
    for c in range(0, x.shape[1], BLOCK_COLS):
        acc += x[:, c:c + BLOCK_COLS].sum(dim=1, keepdim=True,
                                          dtype=torch.int64).to(I32)
    return acc


#: the least columns a CTA of fx_acc_revisit's cluster sums, and the
#: largest cluster its plan takes (analysis_fixtures.cu takes up to 16)
ACC_COLS_MIN = 2048
ACC_CLUSTER_MAX = 8


class AccPlan(NamedTuple):
    """``acc_revisit_kernel``'s launch: ``vec`` columns a lane a load (4:
    one 16-byte int4), a cluster of ``cluster`` CTAs, each summing ``cols``
    columns of every row."""
    vec: int
    cluster: int
    cols: int


def acc_revisit_access(x) -> int:
    """1 where ``fx_acc_revisit`` loads 16-byte int4s from ``x`` (C a
    multiple of 4, ``x`` 16-byte aligned), else 0 (4-byte words)."""
    return int(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=64)
def acc_revisit_plan(R: int, C: int, aligned: bool = True) -> AccPlan:
    """The cluster plan of the (R, C) row sums: int4 loads where C is a
    multiple of 4 and ``x`` is ``aligned``; a CTA (a warp a row) for every
    ``ACC_COLS_MIN`` columns, at most ``ACC_CLUSTER_MAX``, each summing an
    equal share of whole vectors (so a short row takes one CTA)."""
    if not (1 <= R <= 32 and C >= 1):
        raise ValueError(f"acc_revisit_plan: no plan for ({R}, {C})")
    vec = 4 if aligned and C % 4 == 0 else 1
    q = max(1, min(ACC_CLUSTER_MAX, C // ACC_COLS_MIN))
    cols = cdiv(cdiv(C, q), vec) * vec
    return AccPlan(vec, cdiv(C, cols), cols)


def fx_acc_revisit(x, init=True):
    """The (R, 1) int32 row sums of ``x`` (R, C) int32, R <= 32, added to
    a zero output (``init``) or to whatever the output held
    (``init=False``: the fixture of a dropped initialisation).  Replaces
    ``TestRefHazards._acc._kern`` (a grid of 2 revisiting one output
    block, with or without its first-visit zero-fill).  One launch and one
    device operation, no memset and no global atomic: a warp a row, a
    shuffle reduction, and one store a row that adds onto zero or onto the
    old value; wide rows a thread-block cluster along the columns
    (``acc_revisit_plan``), whose partials meet in distributed shared
    memory."""
    name = "fx_acc_revisit"
    R, C = _need2(name, "x", x)
    if R > 32:
        raise ValueError(f"{name}: at most 32 rows (one warp a row), got {R}")
    acc = out((R, 1), I32, x.device)
    if not on_card(name, x):
        return fx_acc_revisit_plain(x, init, acc)
    plan = acc_revisit_plan(R, C, bool(acc_revisit_access(x)))
    launch(name, x.device, x, acc, R, C, int(bool(init)), plan.vec,
           plan.cluster, plan.cols, lib=LIB)
    fx_acc_revisit.launches += 1
    return acc


fx_acc_revisit.launches = 0


# --------------------------------------------------------------------------
# fx_block_copy: a blocked copy whose output block can be off
# --------------------------------------------------------------------------


def fx_block_copy_plain(x, offset=0, copied=None):
    """Column block j of ``x`` (R, C) copied to column block j + offset of
    ``copied``, for j in order; a block index outside the output lands
    where interpret mode puts it (counted from the end when negative, then
    clamped, as ``row_index`` places a row).  Blocks nobody writes keep
    what ``copied`` held."""
    if copied is None:
        copied = out(x.shape, I32, x.device)
    last = (x.shape[1] - 1) // BLOCK_COLS
    for j in range(last + 1):
        d = j + offset + (last + 1 if j + offset < 0 else 0)
        d = min(max(d, 0), last) * BLOCK_COLS
        src = x[:, j * BLOCK_COLS:(j + 1) * BLOCK_COLS]
        copied[:, d:d + src.shape[1]] = src
    return copied


#: the most column blocks fx_block_copy's grid takes (its y extent)
COPY_BLOCKS_MAX = 65535


def block_copy_access(x, copied) -> int:
    """1 where ``fx_block_copy`` moves 16-byte int4s (C a multiple of 4,
    both pointers 16-byte aligned), else 0 (4-byte words)."""
    return int(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
               and copied.data_ptr() % 16 == 0)


def fx_block_copy(x, offset=0):
    """``out[:, (j + offset) block] = x[:, j block]`` for every 128-column
    block j of ``x`` (R, C) int32.  Replaces the blocked copy ``_kern``
    whose output index map is off by one block.  One launch in which every
    thread moves one unit and none loops, a CTA per (row tile, column
    block): a 16-byte int4 where ``block_copy_access`` allows it, else a
    word.  A non-zero
    ``offset`` only inside ``dispatch.checked_build()``."""
    name = "fx_block_copy"
    R, C = _need2(name, "x", x)
    if cdiv(C, BLOCK_COLS) > COPY_BLOCKS_MAX:
        raise ValueError(f"{name}: at most {COPY_BLOCKS_MAX} column blocks, "
                         f"got {cdiv(C, BLOCK_COLS)}")
    copied = out((R, C), I32, x.device)
    if not on_card(name, x):
        return fx_block_copy_plain(x, offset, copied)
    launch(name, x.device, x, copied, R, C, int(offset),
           block_copy_access(x, copied), lib=LIB)
    fx_block_copy.launches += 1
    return copied


fx_block_copy.launches = 0


# --------------------------------------------------------------------------
# fx_serial_scan: the ordered row scatter
# --------------------------------------------------------------------------

#: ``table[row_index(keys[i])] = rows[i]`` in message order, in place (the
#: fixture's kernel body is the table-step probe's)
fx_serial_scan_plain = probe_serial_plain


def fx_serial_scan(table, keys, rows):
    """``for i: table[keys[i]] = rows[i]`` on ``table`` (K, W), ``keys``
    (M,) and ``rows`` (M, W), all int32, in place; returns ``table``.
    Replaces the serial scan ``_kern`` (a loop of dynamic single-row
    stores).  One plain launch and one device operation: CTA b owns table
    rows [b * S, (b + 1) * S) (S = ``kScanSlots`` of
    ``csrc/analysis_fixtures.cu``) and their winner column in shared
    memory, takes a shared-memory ``atomicMax`` of the message index on
    each key in its slice (the last message wins), then copies each
    winner's row.  No allocation, no memset, no state between calls.  It
    does not clamp: a key outside [0, K) only inside
    ``dispatch.checked_build()`` (the release build stores no such
    key)."""
    name = "fx_serial_scan"
    K, W = _need2(name, "table", table)
    need(name, "keys", keys, I32)
    if keys.dim() != 1:
        raise ValueError(f"{name}: keys must be (M,), got {tuple(keys.shape)}")
    M = keys.shape[0]
    need(name, "rows", rows, I32, (M, W))
    if not on_card(name, table, keys, rows):
        return fx_serial_scan_plain(table, keys, rows)
    if M:
        launch(name, table.device, table, keys, rows, K, M, W, lib=LIB)
        fx_serial_scan.launches += 1
    return table


fx_serial_scan.launches = 0


# --------------------------------------------------------------------------
# fx_async_copy: a copy through the asynchronous copy unit
# --------------------------------------------------------------------------


def fx_async_copy_plain(x):
    """A copy of ``x``."""
    return x.clone()


def fx_async_copy(x):
    """A copy of ``x`` (int32, a multiple of 4 elements, 16-byte aligned)
    made with the card's Tensor Memory Accelerator: a CTA a 4 KB tile, one
    thread asks for the tile's bulk copy into shared memory, waits on an
    mbarrier, then asks for its bulk store.  Replaces the DMA ``_kern``
    (``pltpu.make_async_copy`` and its semaphore).  The bulk copies are the
    accesses of the port no guard wraps; the source declares them, the
    checked build reports them and checks each tile's store as a range."""
    name = "fx_async_copy"
    need(name, "x", x, I32)
    if x.numel() < 4 or x.numel() % 4:
        raise ValueError(f"{name}: x must hold a multiple of 4 elements, got "
                         f"{x.numel()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if not on_card(name, x):
        return fx_async_copy_plain(x)
    copied = out(x.shape, I32, x.device)
    launch(name, x.device, x, copied, x.numel(), x.numel(), lib=LIB)
    fx_async_copy.launches += 1
    return copied


fx_async_copy.launches = 0


# --------------------------------------------------------------------------
# fx_loop_inc: a loop-carried increment
# --------------------------------------------------------------------------


def fx_loop_inc_plain(x, times=10):
    """Zeros shaped as ``x`` with 1 added ``times`` times."""
    acc = torch.zeros_like(x)
    for _ in range(times):
        acc = acc + 1
    return acc


def loop_inc_access(acc) -> int:
    """1 where ``fx_loop_inc`` stores 16-byte int4s into ``acc`` (a
    multiple of 4 elements, 16-byte aligned), else 0 (4-byte words)."""
    return int(acc.numel() % 4 == 0 and acc.data_ptr() % 16 == 0)


#: 1 where ``fx_store_at`` stores 16-byte int4s: ``loop_inc_access``'s
#: rule, for the output it fills
store_at_access = loop_inc_access


def fx_loop_inc(x, times=10):
    """``out = 0``, then ``out += 1`` ``times`` times, shaped as the int32
    tensor ``x`` (whose values the function, as the Pallas ``_kern`` it
    replaces, does not read).  The loop in a register, then one store a
    thread: a 16-byte int4 where ``loop_inc_access`` allows it, else a
    word."""
    name = "fx_loop_inc"
    need(name, "x", x, I32)
    if times < 0:
        raise ValueError(f"{name}: times must be >= 0, got {times}")
    if not on_card(name, x):
        return fx_loop_inc_plain(x, times)
    acc = out(x.shape, I32, x.device)
    if x.numel():
        launch(name, x.device, acc, x.numel(), int(times),
               loop_inc_access(acc), lib=LIB)
        fx_loop_inc.launches += 1
    return acc


fx_loop_inc.launches = 0

#: every kernel of this module: name -> (wrapper, plain version, library,
#: the ``file:line`` of the Pallas kernel it replaces)
KERNELS = {
    "scan_acc": (scan_acc, scan_acc_plain, "scan_acc",
                 "hermes_tpu/analysis/diffcheck.py:89"),
    "fx_pack": (fx_pack, fx_pack_plain, LIB,
                "tests/test_pallas_analysis.py:124"),
    "fx_store_at": (fx_store_at, fx_store_at_plain, LIB,
                    "tests/test_pallas_analysis.py:168"),
    "fx_acc_revisit": (fx_acc_revisit, fx_acc_revisit_plain, LIB,
                       "tests/test_pallas_analysis.py:203"),
    "fx_block_copy": (fx_block_copy, fx_block_copy_plain, LIB,
                      "tests/test_pallas_analysis.py:245"),
    "fx_serial_scan": (fx_serial_scan, fx_serial_scan_plain, LIB,
                       "tests/test_pallas_analysis.py:268"),
    "fx_async_copy": (fx_async_copy, fx_async_copy_plain, LIB,
                      "tests/test_pallas_analysis.py:344"),
    "fx_loop_inc": (fx_loop_inc, fx_loop_inc_plain, LIB,
                    "tests/test_pallas_analysis.py:395"),
}
