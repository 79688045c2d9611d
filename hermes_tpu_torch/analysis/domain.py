"""The abstract values of the kernel analysis: an interval and a
possible-ones mask per tensor.

The port's copy of what the kernel matrix needs from
``hermes_tpu/analysis/domain.py``: ``AbsVal`` and its constructors, and
``contains``, the test the differential sanitizer applies to a concrete
array.  The reference's transfer rules walk jaxprs and have no counterpart
here: the port's output bounds are declared beside each kernel's input
seeds (``analysis/seeds.py``), not derived.

One ``AbsVal`` summarizes every element of a tensor: an inclusive integer
interval ``[lo, hi]`` and a ``ones`` mask of the bits that may be 1
(``ones == -1``: any bit; the mask only means something for a value that
cannot be negative).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def mask_for(lo: int, hi: int) -> int:
    """Bits that may be 1 for a value in [lo, hi]: everything below the top
    bit of hi for non-negative ranges, "all bits" (-1) otherwise."""
    if lo < 0:
        return -1
    return (1 << int(hi).bit_length()) - 1


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Interval + possible-ones mask.  ``ones == -1`` = unconstrained."""

    lo: int
    hi: int
    ones: int = -1

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")
        if self.lo < 0:
            object.__setattr__(self, "ones", -1)
            return
        # non-negative: tighten the mask against the interval (a constant's
        # mask is the constant)
        m = self.lo if self.lo == self.hi else mask_for(self.lo, self.hi)
        object.__setattr__(self, "ones",
                           m if self.ones == -1 else (self.ones & m))

    def __repr__(self):
        m = "" if self.ones == -1 else f" ones=0x{self.ones:x}"
        return f"[{self.lo}, {self.hi}]{m}"


def iv(lo, hi=None, ones: int = -1) -> AbsVal:
    """Interval constructor (``iv(3)`` = the constant 3)."""
    return AbsVal(int(lo), int(lo if hi is None else hi), ones)


def top(dtype) -> AbsVal:
    """The full range of a bool or integer dtype ("know nothing")."""
    d = np.dtype(dtype)
    if d == np.bool_:
        return iv(0, 1)
    info = np.iinfo(d)  # raises on a float: the port's kernels have none
    lo, hi = int(info.min), int(info.max)
    return AbsVal(lo, hi, -1 if lo < 0 else hi)


def is_top(av: AbsVal, dtype) -> bool:
    t = top(dtype)
    return av.lo <= t.lo and av.hi >= t.hi


def from_concrete(arr) -> AbsVal:
    """The tightest interval around a concrete bool or integer array."""
    a = np.asarray(arr)
    if a.size == 0:
        return iv(0)
    return iv(int(a.min()), int(a.max()))


def contains(av: AbsVal, arr) -> List[dict]:
    """The sanitizer's test of one concrete array against ``av``: [] when
    every element lies in the interval and (for a non-negative integer
    array under a constrained mask) sets no bit outside ``av.ones``; else
    one dict per failed test, ``kind`` "interval" or "ones-mask" with the
    ``concrete`` and ``abstract`` sides, as the reference reports them."""
    a = np.asarray(arr)
    if a.size == 0:
        return []
    out = []
    lo, hi = int(a.min()), int(a.max())
    if lo < av.lo or hi > av.hi:
        out.append(dict(kind="interval", concrete=[lo, hi],
                        abstract=[int(av.lo), int(av.hi)]))
    if av.ones != -1 and lo >= 0 and np.issubdtype(a.dtype, np.integer):
        bits = int(np.bitwise_or.reduce(a.ravel().astype(np.int64)))
        if bits & ~av.ones:
            out.append(dict(kind="ones-mask", concrete=hex(bits),
                            abstract=hex(av.ones)))
    return out
