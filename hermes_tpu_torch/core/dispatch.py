"""What every kernel wrapper of the port shares: argument checks, the
device rule (a CPU tensor goes to the plain version, a CUDA tensor to the
kernel), the allocation of outputs, and the launch of a ``csrc/*.cu`` entry
point through ctypes.  Used by ``core/kernels.py``, ``core/megaround.py``,
``core/probe_kernels.py`` and ``analysis/fixture_kernels.py``.

The bound-checked build (``csrc/guard.cuh``) is chosen by the caller and
by nothing else::

    with dispatch.checked_build() as chk:
        wrapper(...)                 # any of the port's kernel wrappers
    chk.violations                   # what the guards recorded

Inside the block ``launch`` calls the ``-DHERMES_CHECKED`` library of the
source, with one row of the block's report, and ``out`` fills
every output and scratch tensor with a poison value (the type's least
value, as the reference's interpret mode fills uninitialised outputs), so a
kernel that reads or accumulates into memory it never initialised shows in
its result.  Outside the block a CUDA tensor launches the release kernel or
raises: no failure selects the checked build, and the checked build never
stands in for the release one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
from typing import List, Optional

import torch

from hermes_tpu_torch import build
from hermes_tpu_torch.core import layouts

# The card the launch plans are made for (an H100 SXM): its streaming
# multiprocessors, the shared memory one CTA may take (227 KB, above 48 KB
# only as dynamic shared memory) and the largest thread-block cluster
# (16, non-portable above 8).
SMS = 132
SMEM_BYTES_MAX = 232448
CLUSTER_MAX = 16


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def on_card(name: str, *xs) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix of
    devices or any other device."""
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors "
                         "only")
    return dev.type == "cuda"


def need(name: str, what: str, x, dtype, shape=None) -> None:
    """Raise unless ``x`` is a ``dtype`` tensor (of ``shape``, if given)."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype:
        got = x.dtype if isinstance(x, torch.Tensor) else type(x).__name__
        raise TypeError(f"{name}: {what} must be a {dtype} tensor, got {got}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")


# --------------------------------------------------------------------------
# the bound-checked build
# --------------------------------------------------------------------------

#: words of one report row and their meaning (csrc/guard.cuh)
REPORT_WORDS = 8
R_COUNT, R_LINE, R_INDEX, R_EXTENT, R_STORE, R_UNGUARDED = range(6)
_GUARD_SITE = re.compile(
    r"\bHG_(LD|LD_CG|ST|SMEM_ST|ATOMIC_MAX|ATOMIC_ADD)\(")


def poison(dtype):
    """The value a checked block fills outputs with: the type's least."""
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


def kernel_at(lib: str, line: int) -> str:
    """The ``__global__`` or ``__device__`` function of ``csrc/<lib>.cu``
    that holds source line ``line`` (1-based): the nearest one defined at
    or above it."""
    src = (build.CSRC / f"{lib}.cu").read_text().splitlines()
    for i in range(min(line, len(src)) - 1, -1, -1):
        if "__global__" in src[i] or "__device__" in src[i]:
            head = re.sub(r"__launch_bounds__\s*\([^)]*\)", "",
                          " ".join(src[i:i + 3]))
            m = re.search(r"(\w+)\s*\(", head)
            if m:
                return m.group(1)
    return "<unknown>"


def guard_sites(lib: str) -> int:
    """How many guarded accesses ``csrc/<lib>.cu`` has."""
    return len(_GUARD_SITE.findall((build.CSRC / f"{lib}.cu").read_text()))


class CheckedBuild:
    """One use of the bound-checked build: the device report its launches
    fill (a row a launch) and what was read back from it.

    ``violations`` holds one dict per launch whose guards fired: ``lib``,
    ``entry``, ``kernel``, ``line``, ``index``, ``extent``, ``store``
    (bool), ``count``.  ``unguarded`` holds one per launch that reached a
    declared unguarded access: ``lib``, ``entry``, ``kernel``, ``line``,
    ``what``.  ``launched`` lists the ``(lib, entry)`` of every launch.
    Both fill at ``collect()``, which the block's end calls.
    ``broken=True`` takes the test-only library that lacks the kernel's own
    clamp (``build.BROKEN``)."""

    ROWS = 64

    def __init__(self, broken: bool = False):
        self.broken = broken
        self.violations: List[dict] = []
        self.unguarded: List[dict] = []
        self.launched: List[tuple] = []
        self._report = None
        self._pending: List[tuple] = []

    def _row(self, dev, lib: str, entry: str) -> int:
        """The device address of a fresh report row for one launch."""
        if self._report is not None and (self._report.device != dev
                                         or len(self._pending) == self.ROWS):
            self.collect()
        if self._report is None:
            self._report = torch.zeros((self.ROWS, REPORT_WORDS),
                                       dtype=torch.int64, device=dev)
        self._pending.append((lib, entry))
        self.launched.append((lib, entry))
        return self._report[len(self._pending) - 1].data_ptr()

    def collect(self) -> None:
        """Wait for the launches so far and read their report rows."""
        if not self._pending:
            return
        torch.cuda.synchronize(self._report.device)
        rows = self._report[:len(self._pending)].cpu().tolist()
        self._report.zero_()
        for (lib, entry), row in zip(self._pending, rows):
            if row[R_COUNT]:
                self.violations.append(dict(
                    lib=lib, entry=entry, kernel=kernel_at(lib, row[R_LINE]),
                    line=row[R_LINE], index=row[R_INDEX],
                    extent=row[R_EXTENT], store=bool(row[R_STORE]),
                    count=row[R_COUNT]))
            if row[R_UNGUARDED]:
                line = row[R_UNGUARDED]
                text = (build.CSRC / f"{lib}.cu").read_text().splitlines()
                m = re.search(r'HG_UNGUARDED\("([^"]*)"\)', text[line - 1])
                self.unguarded.append(dict(
                    lib=lib, entry=entry, kernel=kernel_at(lib, line),
                    line=line, what=m.group(1) if m else "undeclared"))
        self._pending = []


_checked: Optional[CheckedBuild] = None


@contextlib.contextmanager
def checked_build(broken: bool = False):
    """Run the block's kernel launches in the bound-checked build; yields
    the ``CheckedBuild`` that gathers what the guards record.  Blocks do
    not nest."""
    global _checked
    if _checked is not None:
        raise RuntimeError("checked_build blocks do not nest")
    _checked = chk = CheckedBuild(broken)
    try:
        yield chk
        chk.collect()
    finally:
        _checked = None


def out(shape, dtype, device):
    """A new output or scratch tensor for a kernel to write: uninitialised,
    or poison-filled inside a ``checked_build`` block."""
    if _checked is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.full(shape, poison(dtype), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# hand-kernel calls, as the op census (obs/profile.py) counts them
# --------------------------------------------------------------------------

#: every wrapper marked with ``hand_kernel``, by name
HAND_KERNELS: dict = {}
_depth = 0  # wrapper calls in progress on this process
_calls: Optional[dict] = None  # name -> outermost calls, while counted
#: set by ``analysis/graph.py`` while it traces a round: called as
#: ``_trace(name, args, kwargs)`` in place of an outermost wrapper call
_trace = None


def hand_kernel(fn=None, *, audit: Optional[str] = None):
    """Mark ``fn`` as a hand-kernel wrapper: a call counts as ONE op of
    the census, named after the kernel, on both devices.  While it runs,
    ``in_hand_kernel()`` is True, so the census skips the torch ops it
    makes (the plain version's on the CPU, the outputs' allocation on the
    card).  A wrapper called from inside another counts nothing.

    Inside an analysis trace (``analysis/graph.py``) an outermost call
    runs neither the plain version nor the kernel: it becomes one opaque
    node of the graph, named after the kernel, in a
    ``layouts.audited(audit)`` scope when ``audit`` names the reviewed
    invariant the kernel relies on (the reference audits its
    ``pallas_call`` sites)."""
    if fn is None:
        return functools.partial(hand_kernel, audit=audit)
    name = fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        global _depth
        if _trace is not None and _depth == 0:
            if audit is None:
                return _trace(name, args, kwargs)
            with layouts.audited(audit):
                return _trace(name, args, kwargs)
        if _depth == 0 and _calls is not None:
            _calls[name] = _calls.get(name, 0) + 1
        _depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _depth -= 1

    HAND_KERNELS[name] = call
    return call


def in_hand_kernel() -> bool:
    return _depth > 0


@contextlib.contextmanager
def count_hand_kernels():
    """Yield a dict that counts, by name, the hand-kernel calls made
    inside the block (outermost calls only).  Blocks do not nest."""
    global _calls
    if _calls is not None:
        raise RuntimeError("count_hand_kernels blocks do not nest")
    _calls = got = {}
    try:
        yield got
    finally:
        _calls = None


_entry: dict = {}  # release: entry name -> its typed C entry point
_checked_entry: dict = {}  # (entry name, broken) -> the checked library's


def _bind(table: dict, key, name: str, lib_handle, args, pointers: int):
    """The typed ``hermes_<name>`` of ``lib_handle``, cached in ``table``:
    ints as they are, tensors as pointers, then ``pointers`` more (the
    report's row in the checked build, the stream)."""
    fn = getattr(lib_handle, f"hermes_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                    for a in args] + [ctypes.c_void_p] * pointers)
    table[key] = fn
    return fn


def launch(name: str, dev, *args, lib: Optional[str] = None) -> None:
    """Call ``hermes_<name>`` of ``csrc/<lib>.cu`` (``lib`` defaults to
    ``name``; built at first use) with the tensors' pointers and the ints
    as they are, on the current stream; raise on a CUDA error.  Inside a
    ``checked_build`` block: the checked library, with a report row before
    the stream."""
    lib = lib or name
    chk = _checked
    if chk is None:
        fn = _entry.get(name) or _bind(_entry, name, name,
                                       build.load_cuda(lib), args, 1)
    else:
        broken = chk.broken and lib in build.BROKEN
        fn = _checked_entry.get((name, broken)) or _bind(
            _checked_entry, (name, broken), name,
            build.load_cuda(lib, True, broken), args, 2)
    with torch.cuda.device(dev):
        report = () if chk is None else (chk._row(dev, lib, name),)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a if isinstance(a, int) else a.data_ptr() for a in args),
                 *report, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
