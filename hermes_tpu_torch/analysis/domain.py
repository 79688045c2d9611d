"""The abstract domain of the analysis: an interval and a possible-ones
mask per tensor, and the transfer functions over it.

The port's copy of ``hermes_tpu/analysis/domain.py`` (which imports only
numpy; the tests hold every definition here equal to the reference's on
drawn inputs).  One ``AbsVal`` summarizes EVERY element of a tensor (the
engines are data-parallel: per-element precision buys nothing for the
invariants proved, which are all "no element of this tensor can reach
bit N"):

  * an inclusive integer interval ``[lo, hi]`` (unbounded Python ints
    while an op computes; clamped to the result dtype afterwards, with a
    ``wrapped`` flag when the raw range escapes the dtype: that flag IS
    the overflow theorem's negation);
  * a ``ones`` bitmask of bits that MAY be 1 (``ones == -1``: any bit,
    including the sign; the mask only means something for a value that
    cannot be negative).  Intervals alone cannot prove ``(ver << 10) |
    fc`` overlap-free, but the mask knows a shifted value keeps its low
    bits clear.

Floats get the interval only; bools are the interval [0, 1].  Dtypes are
numpy dtypes here (the interpreter maps torch's onto them).

Beside the copy stand the rules where torch's integer semantics part from
``lax``'s (ROADMAP C5), each named after the torch op it models and held
against that op on concrete tensors by the tests:

  * ``fmod``: ``torch.fmod`` is ``lax.rem`` (sign of the dividend);
  * ``remainder``: ``torch.remainder`` and ``%`` take the sign of the
    divisor (``jnp.remainder``);
  * ``floor_div`` / ``trunc_div``: ``//`` and ``rounding_mode="trunc"``;
  * ``shl_torch`` / ``shr_torch``: a shift count outside ``[0, bits)``
    gives 0 (left) or the sign fill (right), where the copy's ``shl``
    keeps shifting up to ``MAX_SHIFT``;
  * ``wrap_neg_index``: torch's indexing wraps an index in ``[-n, 0)`` by
    ``n`` and refuses anything outside ``[-n, n)``.

``contains`` is the differential sanitizer's test of a concrete array
against an abstract value (``analysis/diffcheck.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

_INT_INFO = {}


def _int_range(dtype) -> tuple:
    key = np.dtype(dtype).name
    if key not in _INT_INFO:
        ii = np.iinfo(np.dtype(dtype))
        _INT_INFO[key] = (int(ii.min), int(ii.max))
    return _INT_INFO[key]


def is_int(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.integer)


def is_bool(dtype) -> bool:
    return np.dtype(dtype) == np.bool_


def is_float(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.floating)


def dtype_bits(dtype) -> int:
    return np.dtype(dtype).itemsize * 8


def mask_for(lo: int, hi: int) -> int:
    """Bits that may be 1 for a value in [lo, hi]: everything below the
    top bit of hi for non-negative ranges, "all bits" (-1) otherwise."""
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
        # mask IS the constant — `1 << 20` has exactly one possible bit,
        # which is what makes `WIN_BIT | rank` provably disjoint)
        m = self.lo if self.lo == self.hi else mask_for(self.lo, self.hi)
        object.__setattr__(self, "ones",
                           m if self.ones == -1 else (self.ones & m))

    @property
    def nonneg(self) -> bool:
        return self.lo >= 0

    @property
    def is_const(self) -> bool:
        return self.lo == self.hi

    def __repr__(self):
        m = "" if self.ones == -1 else f" ones=0x{self.ones:x}"
        return f"[{self.lo}, {self.hi}]{m}"


def iv(lo, hi=None, ones: int = -1) -> AbsVal:
    """Interval constructor (``iv(3)`` = the constant 3)."""
    return AbsVal(int(lo), int(lo if hi is None else hi), ones)


def const(v) -> AbsVal:
    if isinstance(v, (bool, np.bool_)):
        v = int(v)
    if isinstance(v, (float, np.floating)):
        return AbsVal(int(np.floor(v)), int(np.ceil(v))) if np.isfinite(v) \
            else top(np.float32)
    return iv(int(v))


def top(dtype) -> AbsVal:
    """The dtype's full range (the "know nothing" element)."""
    d = np.dtype(dtype)
    if is_bool(d):
        return iv(0, 1)
    if is_int(d):
        lo, hi = _int_range(d)
        return AbsVal(lo, hi, -1 if lo < 0 else hi)
    # floats (and anything exotic): a huge sentinel interval
    return AbsVal(-(1 << 127), 1 << 127)


def is_top(av: AbsVal, dtype) -> bool:
    t = top(dtype)
    return av.lo <= t.lo and av.hi >= t.hi


def join(a: AbsVal, b: AbsVal) -> AbsVal:
    ones = -1 if (a.ones == -1 or b.ones == -1) else (a.ones | b.ones)
    return AbsVal(min(a.lo, b.lo), max(a.hi, b.hi), ones)


def join_all(avs) -> AbsVal:
    avs = list(avs)
    out = avs[0]
    for a in avs[1:]:
        out = join(out, a)
    return out


def clamp(av: AbsVal, dtype) -> tuple:
    """Fit a raw result into its dtype: returns ``(clamped, wrapped)``.
    A range escaping the dtype wraps (two's complement) — the clamped
    value is the dtype TOP and ``wrapped`` is True: the analyzer's passes
    decide whether that wrap is a finding (a pack site) or intended
    modular arithmetic (hash mixing)."""
    d = np.dtype(dtype)
    if is_bool(d):
        # widen, never narrow: an out-of-range abstract bool (e.g. the
        # raw int result of `not`) must become the unknown [0, 1], not a
        # false constant — narrowing here made every `~mask` proof vacuous
        if 0 <= av.lo and av.hi <= 1:
            return av, False
        return AbsVal(0, 1), False
    if not is_int(d):
        return av, False
    lo, hi = _int_range(d)
    if av.lo >= lo and av.hi <= hi:
        return av, False
    return top(d), True


def from_concrete(arr) -> AbsVal:
    """Abstract a concrete constant (a graph's constants and literals)."""
    a = np.asarray(arr)
    if a.size == 0:
        return iv(0)
    if a.dtype == np.bool_:
        return iv(int(a.min()), int(a.max()))
    if np.issubdtype(a.dtype, np.floating):
        lo, hi = float(a.min()), float(a.max())
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return top(a.dtype)
        return AbsVal(int(np.floor(lo)), int(np.ceil(hi)))
    return iv(int(a.min()), int(a.max()))


# --------------------------------------------------------------------------
# Transfer functions (raw — the interpreter clamps to the result dtype)
# --------------------------------------------------------------------------

MAX_SHIFT = 64  # abstract shift amounts are capped (real shifts are < 32)


def add(a: AbsVal, b: AbsVal) -> AbsVal:
    lo, hi = a.lo + b.lo, a.hi + b.hi
    if a.ones != -1 and b.ones != -1 and (a.ones & b.ones) == 0:
        # disjoint possible-ones: no carry anywhere, add == or
        return AbsVal(lo, hi, a.ones | b.ones)
    return AbsVal(lo, hi)


def sub(a: AbsVal, b: AbsVal) -> AbsVal:
    return AbsVal(a.lo - b.hi, a.hi - b.lo)


def neg(a: AbsVal) -> AbsVal:
    return AbsVal(-a.hi, -a.lo)


def mul(a: AbsVal, b: AbsVal) -> AbsVal:
    cs = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return AbsVal(min(cs), max(cs))


def max_(a: AbsVal, b: AbsVal) -> AbsVal:
    ones = -1 if (a.ones == -1 or b.ones == -1) else (a.ones | b.ones)
    return AbsVal(max(a.lo, b.lo), max(a.hi, b.hi), ones)


def min_(a: AbsVal, b: AbsVal) -> AbsVal:
    ones = -1 if (a.ones == -1 or b.ones == -1) else (a.ones | b.ones)
    return AbsVal(min(a.lo, b.lo), min(a.hi, b.hi), ones)


def and_(a: AbsVal, b: AbsVal) -> AbsVal:
    if a.nonneg or b.nonneg:
        # AND against a non-negative mask bounds the result by that mask
        # (this is how `pkf & KEY_MASK` restores a proven bound from an
        # unknown wire word); sound because x & m is in [0, m] whenever
        # m >= 0, regardless of x's sign
        masks = [x.ones for x in (a, b) if x.nonneg]
        m = masks[0] if len(masks) == 1 else (a.ones & b.ones)
        return AbsVal(0, m, m)
    # both may be negative: AND can go BELOW both (-5 & -3 == -7) — know
    # nothing (the dtype clamp bounds it)
    return AbsVal(-(1 << 63), 1 << 63)


def or_(a: AbsVal, b: AbsVal) -> AbsVal:
    if a.nonneg and b.nonneg:
        m = a.ones | b.ones
        return AbsVal(max(a.lo, b.lo), m, m)
    # a negative-capable operand: OR can exceed both positive his
    # (-1 | x == -1; 10 | 5 == 15) — know nothing (dtype clamp bounds it)
    return AbsVal(-(1 << 63), 1 << 63)


def xor(a: AbsVal, b: AbsVal) -> AbsVal:
    if a.nonneg and b.nonneg:
        m = a.ones | b.ones
        return AbsVal(0, m, m)
    return AbsVal(min(a.lo, b.lo, -(1 << 63)), max(a.hi, b.hi, 1 << 63))


def not_(a: AbsVal) -> AbsVal:
    return AbsVal(-a.hi - 1, -a.lo - 1)


def _shift_range(s: AbsVal) -> range:
    lo = max(0, min(s.lo, MAX_SHIFT))
    hi = max(0, min(s.hi, MAX_SHIFT))
    return range(lo, hi + 1)


def shl(a: AbsVal, s: AbsVal) -> AbsVal:
    rng = _shift_range(s)
    lo = min(a.lo << k for k in rng)
    hi = max(a.hi << k for k in rng)
    if a.ones != -1:
        ones = 0
        for k in rng:
            ones |= a.ones << k
        return AbsVal(lo, hi, ones)
    return AbsVal(lo, hi)


def shr_arith(a: AbsVal, s: AbsVal) -> AbsVal:
    rng = _shift_range(s)
    lo = min(a.lo >> k for k in rng)
    hi = max(a.hi >> k for k in rng)
    if a.ones != -1:
        ones = 0
        for k in rng:
            ones |= a.ones >> k
        return AbsVal(lo, hi, ones)
    return AbsVal(lo, hi)


def shr_logical(a: AbsVal, s: AbsVal, nbits: int) -> AbsVal:
    rng = _shift_range(s)
    if a.nonneg:
        return AbsVal(min(a.lo >> k for k in rng),
                      max(a.hi >> k for k in rng))
    # negative inputs reinterpret as large unsigned values
    umax = (1 << nbits) - 1
    return AbsVal(0, max(umax >> k for k in rng))


def rem(a: AbsVal, b: AbsVal) -> AbsVal:
    """XLA/jax ``rem``: sign follows the DIVIDEND."""
    if b.lo <= 0 <= b.hi:
        # divisor may be 0 (result undefined) — know nothing useful
        return AbsVal(min(a.lo, -abs(a.lo)), max(a.hi, abs(a.hi)))
    m = max(abs(b.lo), abs(b.hi)) - 1
    lo = 0 if a.nonneg else -m
    hi = 0 if a.hi <= 0 else m
    # a tighter bound when the dividend already fits
    if a.nonneg:
        hi = min(hi, a.hi)
    return AbsVal(lo, hi)


def div(a: AbsVal, b: AbsVal) -> AbsVal:
    """Integer division toward zero."""
    if b.lo <= 0 <= b.hi:
        return AbsVal(-max(abs(a.lo), abs(a.hi)), max(abs(a.lo), abs(a.hi)))

    def q(x, y):
        return int(abs(x) // abs(y)) * (1 if (x >= 0) == (y > 0) else -1)

    cs = [q(a.lo, b.lo), q(a.lo, b.hi), q(a.hi, b.lo), q(a.hi, b.hi)]
    return AbsVal(min(cs), max(cs))


def abs_(a: AbsVal) -> AbsVal:
    if a.nonneg:
        return a
    if a.hi <= 0:
        return AbsVal(-a.hi, -a.lo)
    return AbsVal(0, max(-a.lo, a.hi))


def clamp3(lo_av: AbsVal, x: AbsVal, hi_av: AbsVal) -> AbsVal:
    lo = max(lo_av.lo, min(x.lo, hi_av.hi))
    hi = min(hi_av.hi, max(x.hi, lo_av.lo))
    if lo > hi:  # contradictory clamp operands — stay sound
        lo, hi = min(lo, hi), max(lo, hi)
    return AbsVal(lo, hi)


def sum_n(a: AbsVal, n: int) -> AbsVal:
    """Sum of n independent elements each in ``a``."""
    if n <= 0:
        return iv(0)
    return AbsVal(min(a.lo * n, a.lo), max(a.hi * n, a.hi))


def prefix_sums(a: AbsVal, n: int) -> AbsVal:
    """Any prefix sum of up to n elements of ``a`` (cumsum)."""
    if n <= 0:
        return iv(0)
    return AbsVal(min(a.lo, a.lo * n), max(a.hi, a.hi * n))


# --------------------------------------------------------------------------
# Torch's own rules (where torch's semantics part from lax's)
# --------------------------------------------------------------------------


def fmod(a: AbsVal, b: AbsVal) -> AbsVal:
    """``torch.fmod``: the remainder of truncated division, the sign of the
    dividend: ``lax.rem`` exactly."""
    return rem(a, b)


def remainder(a: AbsVal, b: AbsVal) -> AbsVal:
    """``torch.remainder`` and ``%`` on tensors: the remainder of floor
    division, the sign of the DIVISOR.  A positive divisor gives [0,
    b.hi - 1] (the dividend itself when it already lies below the
    divisor); a negative one [b.lo + 1, 0]; a divisor that may be 0 knows
    nothing but the join of both signs and the dividend."""
    if b.lo > 0:
        if a.nonneg and a.hi < b.lo:
            return a
        hi = b.hi - 1
        if a.nonneg:
            hi = min(hi, a.hi)
        return AbsVal(0, hi)
    if b.hi < 0:
        if a.hi <= 0 and a.lo > b.hi:
            return AbsVal(a.lo, a.hi)
        return AbsVal(b.lo + 1, 0)
    m = max(abs(b.lo), abs(b.hi))
    return AbsVal(min(a.lo, -m, 0), max(a.hi, m, 0))


def floor_div(a: AbsVal, b: AbsVal) -> AbsVal:
    """``//`` (``torch.div(rounding_mode="floor")``) on integers: monotone
    in each operand on either side of a zero divisor, so the corners
    bound it; a divisor that may be 0 knows nothing but the magnitude."""
    if b.lo <= 0 <= b.hi:
        m = max(abs(a.lo), abs(a.hi))
        return AbsVal(-m, m)
    cs = [x // y for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return AbsVal(min(cs), max(cs))


def trunc_div(a: AbsVal, b: AbsVal) -> AbsVal:
    """``torch.div(rounding_mode="trunc")``: division toward zero, the
    copy's ``div``."""
    return div(a, b)


def _count_split(s: AbsVal, nbits: int):
    """The shift counts of ``s`` inside [0, nbits) as an AbsVal (None if
    none), and whether any count lies outside."""
    lo, hi = max(s.lo, 0), min(s.hi, nbits - 1)
    inside = AbsVal(lo, hi) if lo <= hi else None
    return inside, s.lo < 0 or s.hi >= nbits


def shl_torch(a: AbsVal, s: AbsVal, nbits: int) -> AbsVal:
    """``<<`` on an nbits-wide integer: a count in [0, nbits) shifts as
    ``shl`` does (raw: the dtype clamp decides the wrap), any other count
    gives 0."""
    inside, outside = _count_split(s, nbits)
    parts = ([shl(a, inside)] if inside is not None else []) + (
        [iv(0)] if outside else [])
    return join_all(parts)


def shr_torch(a: AbsVal, s: AbsVal, nbits: int) -> AbsVal:
    """``>>`` (arithmetic) on an nbits-wide integer: a count in [0, nbits)
    shifts as ``shr_arith`` does, any other count fills with the sign
    (``a >> (nbits - 1)``)."""
    inside, outside = _count_split(s, nbits)
    parts = ([shr_arith(a, inside)] if inside is not None else []) + (
        [shr_arith(a, iv(nbits - 1))] if outside else [])
    return join_all(parts)


def wrap_neg_index(idx: AbsVal, n: int) -> AbsVal:
    """The row an index in [-n, n) selects in torch's indexing (``x[i]``,
    ``index_put``): a negative index counts from the end.  Only the part
    of ``idx`` inside [-n, n) is mapped (the caller flags the rest)."""
    spans = [(max(0, idx.lo), min(idx.hi, n - 1)),
             (max(idx.lo, -n) + n, min(idx.hi, -1) + n)]
    cases = [AbsVal(lo, hi) for lo, hi in spans if lo <= hi]
    return join_all(cases) if cases else iv(0)


# --------------------------------------------------------------------------
# The sanitizer's test
# --------------------------------------------------------------------------


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
