"""The port's abstract domain (hermes_tpu_torch/analysis/domain.py) against
the reference's (hermes_tpu/analysis/domain.py, numpy only), on the CPU.

* Every definition the port copies gives the reference's result on
  hypothesis-drawn intervals and masks: the AbsVal's (lo, hi, ones),
  exactly.
* Every torch-named rule (``fmod``, ``remainder``, ``floor_div``,
  ``trunc_div``, ``shl_torch``, ``shr_torch``, ``wrap_neg_index``) is held
  against the torch op it models: concrete int32 / int64 values drawn
  inside the operands' intervals, the op's results inside the rule's.

Tolerance: exact, every value is an integer.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hermes_tpu.analysis import domain as R
from hermes_tpu_torch.analysis import domain as D

SET = settings(max_examples=60, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])
BOUND = 1 << 34


@st.composite
def absvals(draw, lo_min=-BOUND, hi_max=BOUND):
    lo = draw(st.integers(lo_min, hi_max))
    hi = draw(st.integers(lo, hi_max))
    ones = draw(st.one_of(st.just(-1), st.integers(0, (1 << 36) - 1)))
    return lo, hi, ones


def _pair(t):
    return D.AbsVal(*t), R.AbsVal(*t)


def _same(a, b):
    assert (a.lo, a.hi, a.ones) == (b.lo, b.hi, b.ones), (a, b)


BINARY = ("add", "sub", "mul", "max_", "min_", "and_", "or_", "xor", "rem",
          "div", "join")
UNARY = ("neg", "not_", "abs_")


@SET
@given(a=absvals(), b=absvals(), name=st.sampled_from(BINARY))
def test_torch_domain_binary_rules_equal_reference(a, b, name):
    (pa, ra), (pb, rb) = _pair(a), _pair(b)
    _same(getattr(D, name)(pa, pb), getattr(R, name)(ra, rb))


@SET
@given(a=absvals(), name=st.sampled_from(UNARY))
def test_torch_domain_unary_rules_equal_reference(a, name):
    pa, ra = _pair(a)
    _same(getattr(D, name)(pa), getattr(R, name)(ra))


@SET
@given(a=absvals(-(1 << 20), 1 << 20), s=absvals(-4, 70),
       name=st.sampled_from(("shl", "shr_arith")))
def test_torch_domain_shift_rules_equal_reference(a, s, name):
    (pa, ra), (ps, rs) = _pair(a), _pair(s)
    _same(getattr(D, name)(pa, ps), getattr(R, name)(ra, rs))


@SET
@given(a=absvals(), s=absvals(-4, 70), nbits=st.sampled_from((8, 32, 64)))
def test_torch_domain_logical_shift_equal_reference(a, s, nbits):
    (pa, ra), (ps, rs) = _pair(a), _pair(s)
    _same(D.shr_logical(pa, ps, nbits), R.shr_logical(ra, rs, nbits))


@SET
@given(lo=absvals(), x=absvals(), hi=absvals())
def test_torch_domain_clamp3_equal_reference(lo, x, hi):
    p, r = zip(*(_pair(t) for t in (lo, x, hi)))
    _same(D.clamp3(*p), R.clamp3(*r))


@SET
@given(a=absvals(), n=st.integers(-2, 5000))
def test_torch_domain_sums_equal_reference(a, n):
    pa, ra = _pair(a)
    _same(D.sum_n(pa, n), R.sum_n(ra, n))
    _same(D.prefix_sums(pa, n), R.prefix_sums(ra, n))


DTYPES = (np.int8, np.uint8, np.int16, np.int32, np.int64, np.uint32,
          np.bool_, np.float32, np.float64)


@SET
@given(a=absvals(), dt=st.sampled_from(DTYPES))
def test_torch_domain_dtype_helpers_equal_reference(a, dt):
    pa, ra = _pair(a)
    (pc, pw), (rc, rw) = D.clamp(pa, dt), R.clamp(ra, dt)
    _same(pc, rc)
    assert pw == rw
    _same(D.top(dt), R.top(dt))
    assert D.is_top(pa, dt) == R.is_top(ra, dt)
    for f in ("is_int", "is_bool", "is_float", "dtype_bits"):
        assert getattr(D, f)(dt) == getattr(R, f)(dt)


@SET
@given(a=absvals(), b=absvals(), c=absvals())
def test_torch_domain_join_all_and_mask_equal_reference(a, b, c):
    p, r = zip(*(_pair(t) for t in (a, b, c)))
    _same(D.join_all(p), R.join_all(r))
    assert D.mask_for(a[0], a[1]) == R.mask_for(a[0], a[1])
    pa, ra = p[0], r[0]
    assert (pa.nonneg, pa.is_const, repr(pa)) == (ra.nonneg, ra.is_const,
                                                  repr(ra))


@pytest.mark.parametrize("v", [0, 7, -3, True, False, 2.5, -0.5, np.int32(9),
                               np.float32(1.25), float("inf")])
def test_torch_domain_const_equals_reference(v):
    _same(D.const(v), R.const(v))


@pytest.mark.parametrize("arr", [
    np.array([3, -7, 12], np.int32), np.array([True, False]),
    np.array([0.5, 2.25], np.float32), np.array([np.inf], np.float32),
    np.zeros((0,), np.int64), np.array([[1 << 40]], np.int64)])
def test_torch_domain_from_concrete_equals_reference(arr):
    _same(D.from_concrete(arr), R.from_concrete(arr))


# --------------------------------------------------------------------------
# the torch-named rules against the torch ops they model
# --------------------------------------------------------------------------

TDT = {32: torch.int32, 64: torch.int64}


@st.composite
def operand(draw, bits, lo_min=None, hi_max=None):
    lim = 1 << (bits - 1)
    lo_min = -lim if lo_min is None else lo_min
    hi_max = lim - 1 if hi_max is None else hi_max
    lo = draw(st.integers(lo_min, hi_max))
    hi = draw(st.integers(lo, min(hi_max, lo + (1 << 40))))
    vals = draw(st.lists(st.integers(lo, hi), min_size=1, max_size=24))
    return D.iv(lo, hi), vals


def _inside(av, t):
    x = t.tolist()
    return all(av.lo <= v <= av.hi for v in x)


@SET
@given(bits=st.sampled_from((32, 64)), data=st.data(),
       name=st.sampled_from(("fmod", "remainder", "floor_div", "trunc_div")))
def test_torch_division_rules_hold_concrete_torch(bits, data, name):
    a, av = data.draw(operand(bits, -(1 << 30), 1 << 30))
    b, bv = data.draw(operand(bits, -(1 << 20), 1 << 20))
    bv = [v for v in bv if v != 0]
    if not bv:
        return
    n = min(len(av), len(bv))
    x = torch.tensor(av[:n], dtype=TDT[bits])
    y = torch.tensor(bv[:n], dtype=TDT[bits])
    got = {"fmod": lambda: torch.fmod(x, y),
           "remainder": lambda: torch.remainder(x, y),
           "floor_div": lambda: torch.div(x, y, rounding_mode="floor"),
           "trunc_div": lambda: torch.div(x, y, rounding_mode="trunc")}[
        name]()
    assert _inside(getattr(D, name)(a, b), got), (name, a, b, x, y, got)


@SET
@given(bits=st.sampled_from((32, 64)), data=st.data(),
       left=st.booleans())
def test_torch_shift_rules_hold_concrete_torch(bits, data, left):
    a, av = data.draw(operand(bits, -(1 << 24), 1 << 24))
    s, sv = data.draw(operand(bits, -3, bits + 8))
    n = min(len(av), len(sv))
    x = torch.tensor(av[:n], dtype=TDT[bits])
    k = torch.tensor(sv[:n], dtype=TDT[bits])
    if left:
        got = x << k
        raw = D.shl_torch(a, s, bits)
        # the rule is raw: the dtype clamp decides the wrap
        rule, wrapped = D.clamp(raw, np.dtype(f"int{bits}"))
    else:
        got = x >> k
        rule, wrapped = D.clamp(D.shr_torch(a, s, bits),
                                np.dtype(f"int{bits}"))
        assert not wrapped
    assert _inside(rule, got), (left, a, s, x, k, got)


def test_torch_shift_past_the_width_is_zero_or_the_sign():
    x = torch.tensor([5, -5], dtype=torch.int32)
    assert (x << 40).tolist() == [0, 0]
    assert (x >> 40).tolist() == [0, -1]
    assert (D.shl_torch(D.iv(5), D.iv(40), 32).lo,
            D.shl_torch(D.iv(5), D.iv(40), 32).hi) == (0, 0)
    r = D.shr_torch(D.iv(-5, 5), D.iv(40), 32)
    assert (r.lo, r.hi) == (-1, 0)
    # the copy of the reference's rule keeps shifting instead
    assert D.shl(D.iv(5), D.iv(40)).lo == 5 << 40


@SET
@given(n=st.integers(1, 64), data=st.data())
def test_torch_wrap_neg_index_holds_torch_indexing(n, data):
    idx, vals = data.draw(operand(64, -n, n - 1))
    t = torch.arange(n)
    got = t[torch.tensor(vals)]  # the row each index selects
    assert _inside(D.wrap_neg_index(idx, n), got)


def test_torch_remainder_and_fmod_part_on_sign():
    assert (torch.fmod(torch.tensor([-7]), 3).item(),
            torch.remainder(torch.tensor([-7]), 3).item()) == (-1, 2)
    assert (D.remainder(D.iv(-7), D.iv(3)).lo,
            D.remainder(D.iv(-7), D.iv(3)).hi) == (0, 2)
    assert D.fmod(D.iv(-7), D.iv(3)).lo < 0
    r = D.remainder(D.top(np.int32), D.iv(64))
    assert (r.lo, r.hi) == (0, 63)
