"""Abstract interpreter over the FX graph of a round (the analysis's engine).

The port's counterpart of ``hermes_tpu/analysis/interp.py``.  It walks a
functionalized graph (``analysis/graph.py``) node by node, propagating one
``domain.AbsVal`` per tensor through transfer rules keyed by aten overload
(``"aten.add.Tensor"``) or by overload packet (``"aten.add"``), and calls
the passes (``analysis/passes.py``) on every node with its computed
results and a ``wrapped`` flag (a raw result escaped its dtype).

What the reference needs and this does not:

* ``pjit``/``closed_call`` inlining, ``cond``, ``scan`` and ``while``: a
  torch round has no higher-order ops.  Python control flow unrolls in the
  trace (the replay-scan gate on the host step, ``read_unroll``, a loop
  over local copies), so the graph is one straight line.
* ``shard_map`` and ``axis_index``: the sharded round runs over a leading
  axis of local replicas, and its collectives are ``hermes.*`` nodes that
  name their axis and size themselves.
* ``pallas_call`` bodies: a hand-kernel call is one ``hermes.<kernel>``
  node whose outputs take the kernel's declared bounds
  (``analysis/seeds.py``, ``KERNELS``); ``passes.HandKernelPass`` holds its
  inputs to the declared seeds.

Path sensitivity: ``where(cond, a, b)`` evaluates ``a`` with ``cond``
assumed true and ``b`` with it assumed false.  A comparison against a
constant in ``cond`` (or in a conjunction of them, for the true branch)
narrows the compared value, so ``where(x < 0, x + n, x)`` (the negative
index wrap, the reference's ``_refine_neg_index_select``) and ``where(r <
C, L + r, L + C)`` keep exact bounds; an inclusive ``cumsum`` of the
condition itself is at least 1 where the condition holds, and the lane
index minus that count is non-negative where it does not (the slot-rank
idiom of the fused sort).  The branch is re-evaluated from those facts
through the nodes between them and it.

An op without a rule is sound by construction: its results are the
dtype's full range, and ``unmodeled`` records it for an ``info`` finding
(``passes.interp_findings``), never a silent pass and never a crash.  A
value leaving an audited scope whose audit states a bound
(``seeds.AUDIT_BOUNDS``) takes that bound, recorded in ``assumed`` for an
``info`` finding that names the audit.
"""

from __future__ import annotations

import operator
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hermes_tpu_torch.analysis import domain as D
from hermes_tpu_torch.analysis import graph as G
from hermes_tpu_torch.analysis import seeds
from hermes_tpu_torch.analysis.domain import AbsVal

_NP = {
    torch.bool: np.bool_, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.uint16: np.uint16, torch.uint32: np.uint32,
    torch.uint64: np.uint64, torch.float16: np.float16,
    torch.bfloat16: np.float32, torch.float32: np.float32,
    torch.float64: np.float64,
}


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype the domain computes a torch dtype with."""
    return np.dtype(_NP.get(dtype, np.float32))


def op_name(target) -> str:
    """``"aten.add.Tensor"`` for an overload, the callable's name else."""
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    return getattr(target, "__name__", str(target))


def packet_name(target) -> str:
    """``"aten.add"``: the overload packet with its namespace."""
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target._opname}"
    return op_name(target)


def _vals(node) -> list:
    """The fake results of a node, always a list (None for a non-tensor)."""
    v = node.meta.get("val")
    if isinstance(v, (tuple, list)):
        return [x if isinstance(x, torch.Tensor) else None for x in v]
    return [v if isinstance(v, torch.Tensor) else None]


class Ctx:
    """Interpreter context shared with the passes."""

    def __init__(self, cfg=None, mesh_axes=None, passes=()):
        self.cfg = cfg
        #: declared mesh axes {name: size}; {} = batched (no collectives
        #: allowed); None = don't check
        self.mesh_axes = mesh_axes
        self.passes = list(passes)
        self.env: Dict = {}  # Node -> AbsVal (or a list, multi-output)
        self.order: Dict = {}  # Node -> position in the graph
        #: assumed truth of bool nodes while a where branch re-evaluates
        self.assume: Dict = {}
        self.unmodeled: Dict[str, list] = {}  # op name -> nodes
        #: (node, derived, bound) where an audit's bound was assumed
        self.assumed: list = []
        self.n_eqns = 0

    # -- values -------------------------------------------------------------
    def av(self, a) -> Optional[AbsVal]:
        """The abstract value of a node or a Python scalar (None: None)."""
        if isinstance(a, torch.fx.Node):
            v = self.env.get(a)
            if isinstance(v, AbsVal):
                return v
            return D.top(self.dtype(a))
        if a is None:
            return None
        if isinstance(a, (bool, int, float, np.integer, np.floating)):
            return D.const(a)
        raise TypeError(f"no abstract value for {a!r}")

    def dtype(self, a) -> np.dtype:
        if isinstance(a, torch.fx.Node):
            v = _vals(a)[0]
            return np_dtype(v.dtype) if v is not None else np.dtype(np.int64)
        if isinstance(a, bool):
            return np.dtype(np.bool_)
        if isinstance(a, int):
            return np.dtype(np.int64)
        return np.dtype(np.float32)

    def shape(self, a) -> tuple:
        if isinstance(a, torch.fx.Node):
            v = _vals(a)[0]
            return tuple(int(s) for s in v.shape) if v is not None else ()
        return ()

    # -- dataflow helpers for passes ----------------------------------------
    def def_of(self, a):
        """The call node that defines ``a`` (None for inputs, constants
        and scalars)."""
        if isinstance(a, torch.fx.Node) and a.op == "call_function":
            return a
        return None

    def resolve(self, a):
        """Skip through shape/dtype-transparent defs to the value-defining
        node (None for inputs, constants and scalars)."""
        return self.def_of(self.base(a))

    def base(self, a):
        """``a`` with transparent defs skipped: the identity of a value."""
        for _ in range(64):
            e = self.def_of(a)
            if e is None or packet_name(e.target) not in TRANSPARENT:
                return a
            a = e.args[0]
        return a

    def is_const_like(self, a) -> bool:
        """A scalar, a constant abstract value, or a where over const-like
        cases (the ``where(flag, CONST, 0)`` pack idiom)."""
        if not isinstance(a, torch.fx.Node):
            return a is not None
        if self.av(a).is_const:
            return True
        e = self.resolve(a)
        if e is not None and packet_name(e.target) == "aten.where":
            return all(self.is_const_like(x) for x in e.args[1:3])
        return False


#: value-preserving, element-set-preserving ops (the reference's
#: broadcast/reshape/squeeze/transpose/copy/rev/convert)
TRANSPARENT = frozenset({
    "aten.view_copy", "aten.view", "aten._unsafe_view", "aten.reshape",
    "aten.expand_copy", "aten.expand", "aten.unsqueeze_copy",
    "aten.unsqueeze", "aten.squeeze_copy", "aten.squeeze",
    "aten.permute_copy", "aten.permute", "aten.transpose_copy",
    "aten.transpose", "aten.t_copy", "aten.t", "aten.clone",
    "aten.alias_copy", "aten.alias", "aten.detach_copy", "aten.detach",
    "aten._to_copy", "aten.lift_fresh_copy", "aten.contiguous",
    "aten.flip"})


# --------------------------------------------------------------------------
# Transfer rules: fn(node, ctx) -> raw AbsVals, one per output
# --------------------------------------------------------------------------

RULES: Dict[str, Callable] = {}
_HUGE = AbsVal(-(1 << 127), 1 << 127)


def rule(*names):
    def deco(fn):
        for n in names:
            RULES[n] = fn
        return fn

    return deco


def _arg(node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _ins(node, ctx, n: int = 2):
    return [ctx.av(a) for a in node.args[:n]]


def _dim(d, rank: int) -> int:
    return d + rank if d < 0 else d


def _dims_count(shape, dims) -> int:
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return int(np.prod(shape or (1,)))
    if isinstance(dims, int):
        dims = [dims]
    n = 1
    for d in dims:
        n *= shape[_dim(d, len(shape))] if shape else 1
    return n


def _bits(node) -> int:
    return D.dtype_bits(np_dtype(_vals(node)[0].dtype))


def _out_is_bool(node) -> bool:
    return _vals(node)[0].dtype == torch.bool


def _cmp_rule(decide):
    """Comparisons refine to a constant when the intervals decide them."""

    def fn(node, ctx):
        a, b = _ins(node, ctx)
        r = decide(a, b)
        return [D.iv(r) if r is not None else D.iv(0, 1)]

    return fn


RULES["aten.eq"] = _cmp_rule(
    lambda a, b: 1 if (a.is_const and b.is_const and a.lo == b.lo)
    else (0 if (a.hi < b.lo or b.hi < a.lo) else None))
RULES["aten.ne"] = _cmp_rule(
    lambda a, b: 0 if (a.is_const and b.is_const and a.lo == b.lo)
    else (1 if (a.hi < b.lo or b.hi < a.lo) else None))
RULES["aten.lt"] = _cmp_rule(
    lambda a, b: 1 if a.hi < b.lo else (0 if a.lo >= b.hi else None))
RULES["aten.le"] = _cmp_rule(
    lambda a, b: 1 if a.hi <= b.lo else (0 if a.lo > b.hi else None))
RULES["aten.gt"] = _cmp_rule(
    lambda a, b: 1 if a.lo > b.hi else (0 if a.hi <= b.lo else None))
RULES["aten.ge"] = _cmp_rule(
    lambda a, b: 1 if a.lo >= b.hi else (0 if a.hi < b.lo else None))


def _alpha(node, ctx, b: AbsVal) -> AbsVal:
    alpha = node.kwargs.get("alpha", 1)
    return b if alpha == 1 else D.mul(b, D.const(alpha))


@rule("aten.add")
def _(node, ctx):
    a, b = _ins(node, ctx)
    return [D.add(a, _alpha(node, ctx, b))]


@rule("aten.sub")
def _(node, ctx):
    count = _index_minus_count(node, ctx)
    if count is not None:
        return [count]
    a, b = _ins(node, ctx)
    return [D.sub(a, _alpha(node, ctx, b))]


@rule("aten.rsub")
def _(node, ctx):
    a, b = _ins(node, ctx)
    return [D.sub(_alpha(node, ctx, b), a)]


@rule("aten.mul")
def _(node, ctx):
    return [D.mul(*_ins(node, ctx))]


@rule("aten.neg")
def _(node, ctx):
    return [D.neg(ctx.av(node.args[0]))]


@rule("aten.abs")
def _(node, ctx):
    return [D.abs_(ctx.av(node.args[0]))]


@rule("aten.sign", "aten.sgn")
def _(node, ctx):
    return [D.iv(-1, 1)]


@rule("aten.maximum", "aten.max.other", "aten.fmax")
def _(node, ctx):
    return [D.max_(*_ins(node, ctx))]


@rule("aten.minimum", "aten.min.other", "aten.fmin")
def _(node, ctx):
    return [D.min_(*_ins(node, ctx))]


@rule("aten.bitwise_and", "aten.__and__", "aten.logical_and")
def _(node, ctx):
    return [D.and_(*_ins(node, ctx))]


@rule("aten.bitwise_or", "aten.__or__", "aten.logical_or")
def _(node, ctx):
    return [D.or_(*_ins(node, ctx))]


@rule("aten.bitwise_xor", "aten.__xor__", "aten.logical_xor")
def _(node, ctx):
    return [D.xor(*_ins(node, ctx))]


def _not_bool(a: AbsVal) -> AbsVal:
    return D.AbsVal(1 - min(a.hi, 1), 1 - max(a.lo, 0))


@rule("aten.bitwise_not")
def _(node, ctx):
    a = ctx.av(node.args[0])
    return [_not_bool(a) if _out_is_bool(node) else D.not_(a)]


@rule("aten.logical_not")
def _(node, ctx):
    a = ctx.av(node.args[0])
    if a.is_const:
        return [D.iv(int(a.lo == 0))]
    return [D.iv(0) if (a.lo > 0 or a.hi < 0) else D.iv(0, 1)]


@rule("aten.__lshift__", "aten.bitwise_left_shift")
def _(node, ctx):
    a, s = _ins(node, ctx)
    return [D.shl_torch(a, s, _bits(node))]


@rule("aten.__rshift__", "aten.bitwise_right_shift")
def _(node, ctx):
    a, s = _ins(node, ctx)
    return [D.shr_torch(a, s, _bits(node))]


@rule("aten.remainder")
def _(node, ctx):
    return [D.remainder(*_ins(node, ctx))]


@rule("aten.fmod")
def _(node, ctx):
    return [D.fmod(*_ins(node, ctx))]


@rule("aten.floor_divide")
def _(node, ctx):
    return [D.floor_div(*_ins(node, ctx))]


@rule("aten.div")
def _(node, ctx):
    mode = node.kwargs.get("rounding_mode")
    a, b = _ins(node, ctx)
    if mode == "floor":
        return [D.floor_div(a, b)]
    if mode == "trunc":
        return [D.trunc_div(a, b)]
    return [_HUGE]  # true division: a float


@rule("aten.clamp", "aten.clamp_min", "aten.clamp_max")
def _(node, ctx):
    x = ctx.av(node.args[0])
    name = packet_name(node.target)
    lo = hi = None
    if name == "aten.clamp":
        lo, hi = _arg(node, 1, "min"), _arg(node, 2, "max")
    elif name == "aten.clamp_min":
        lo = _arg(node, 1, "min")
    else:
        hi = _arg(node, 1, "max")
    lo_av = ctx.av(lo) if lo is not None else D.iv(x.lo)
    hi_av = ctx.av(hi) if hi is not None else D.iv(x.hi)
    return [D.clamp3(lo_av, x, hi_av)]


def _passthrough(node, ctx):
    return [ctx.av(node.args[0]) for _ in _vals(node)]


for _n in TRANSPARENT | {
        "aten.slice_copy", "aten.slice", "aten.select_copy", "aten.select",
        "aten.narrow_copy", "aten.narrow", "aten.repeat", "aten.tile",
        "aten.roll", "aten.diagonal_copy", "aten.as_strided_copy",
        "aten.unfold_copy", "aten.index", "aten.gather",
        "aten.index_select", "aten.take", "aten.amax", "aten.amin",
        "aten.max.default", "aten.min.default", "aten.contiguous",
        "aten.unbind_copy", "aten.split_copy", "aten.split_with_sizes_copy",
        "hermes.gather_src", "hermes.route_back", "hermes.pmax",
        "hermes.pmin"}:
    RULES[_n] = _passthrough


@rule("aten.view_copy.dtype", "aten.view.dtype")
def _(node, ctx):
    # an explicit reinterpret: value-preserving when it happens to fit,
    # dtype-TOP otherwise, never reported as an implicit wrap
    out = np_dtype(_vals(node)[0].dtype)
    av, wrapped = D.clamp(ctx.av(node.args[0]), out)
    return [D.top(out) if wrapped else av]


@rule("aten.cat", "aten.stack", "aten.hstack", "aten.vstack")
def _(node, ctx):
    return [D.join_all(ctx.av(a) for a in node.args[0])]


@rule("aten.constant_pad_nd")
def _(node, ctx):
    return [D.join(ctx.av(node.args[0]),
                   ctx.av(_arg(node, 2, "value", 0)))]


@rule("aten.where")
def _(node, ctx):
    return [_where(node, ctx)]


@rule("aten.masked_fill")
def _(node, ctx):
    m = ctx.av(node.args[1])
    x, v = ctx.av(node.args[0]), ctx.av(node.args[2])
    if m.is_const:
        return [v if m.lo else x]
    return [D.join(x, v)]


@rule("aten.index_put")
def _(node, ctx):
    self_, values = ctx.av(node.args[0]), ctx.av(node.args[2])
    if _arg(node, 3, "accumulate", False):
        n = _numel(ctx.shape(node.args[2]))
        return [D.join(self_, D.add(self_, D.sum_n(values, n)))]
    return [D.join(self_, values)]


def _numel(shape) -> int:
    return max(1, int(np.prod(shape or (1,))))


@rule("aten.scatter", "aten.index_copy", "aten.slice_scatter",
      "aten.select_scatter", "aten.diagonal_scatter",
      "aten.as_strided_scatter", "aten.index_fill")
def _(node, ctx):
    name = packet_name(node.target)
    if name in ("aten.scatter", "aten.index_copy", "aten.index_fill"):
        src = node.args[3]
        reduce = node.kwargs.get("reduce")
        if reduce in ("add", "multiply"):
            return [_accumulated(node, ctx, src, reduce == "add")]
    else:
        src = node.args[1]
    return [D.join(ctx.av(node.args[0]), ctx.av(src))]


def _accumulated(node, ctx, src, add: bool) -> AbsVal:
    self_ = ctx.av(node.args[0])
    if not add:
        return _HUGE
    n = _numel(ctx.shape(src))
    return D.join(self_, D.add(self_, D.sum_n(ctx.av(src), n)))


@rule("aten.scatter_add", "aten.index_add")
def _(node, ctx):
    return [_accumulated(node, ctx, node.args[3], True)]


@rule("aten.scatter_reduce")
def _(node, ctx):
    reduce = _arg(node, 4, "reduce")
    if reduce == "sum":
        return [_accumulated(node, ctx, node.args[3], True)]
    if reduce in ("amax", "amin", "mean"):
        return [D.join(ctx.av(node.args[0]), ctx.av(node.args[3]))]
    return [_HUGE]


@rule("aten.copy", "aten.copy_")
def _(node, ctx):
    return [ctx.av(node.args[1])]


@rule("aten.fill")
def _(node, ctx):
    return [ctx.av(node.args[1])]


@rule("aten.sum")
def _(node, ctx):
    shape = ctx.shape(node.args[0])
    dims = _arg(node, 1, "dim") if str(node.target) != "aten.sum.default" \
        else None
    return [D.sum_n(ctx.av(node.args[0]), _dims_count(shape, dims))]


@rule("aten.any", "aten.all")
def _(node, ctx):
    a = ctx.av(node.args[0])
    if a.lo > 0 or a.hi < 0:
        return [D.iv(1)]
    if a.is_const:
        return [D.iv(0)]
    return [D.iv(0, 1)]


@rule("aten.count_nonzero")
def _(node, ctx):
    shape = ctx.shape(node.args[0])
    return [D.iv(0, _dims_count(shape, _arg(node, 1, "dim")))]


def _axis_len(node, ctx, dim) -> int:
    shape = ctx.shape(node.args[0])
    if not shape:
        return 1
    return shape[_dim(dim, len(shape))]


def _index_range(n: int) -> AbsVal:
    return D.iv(0, max(0, n - 1))


@rule("aten.cumsum")
def _(node, ctx):
    n = _axis_len(node, ctx, _arg(node, 1, "dim"))
    return [D.prefix_sums(ctx.av(node.args[0]), n)]


@rule("aten.cummax", "aten.cummin")
def _(node, ctx):
    n = _axis_len(node, ctx, _arg(node, 1, "dim"))
    return [ctx.av(node.args[0]), _index_range(n)]


@rule("aten.max.dim", "aten.min.dim")
def _(node, ctx):
    n = _axis_len(node, ctx, _arg(node, 1, "dim"))
    return [ctx.av(node.args[0]), _index_range(n)]


@rule("aten.argmax", "aten.argmin")
def _(node, ctx):
    dim = _arg(node, 1, "dim")
    n = (_numel(ctx.shape(node.args[0])) if dim is None
         else _axis_len(node, ctx, dim))
    return [_index_range(n)]


@rule("aten.sort", "aten.topk", "aten.argsort", "aten.msort")
def _(node, ctx):
    name = packet_name(node.target)
    if name == "aten.topk":
        dim = _arg(node, 2, "dim", -1)
    elif str(node.target) == "aten.sort.stable":
        dim = node.kwargs.get("dim", -1)
    elif name == "aten.msort":
        dim = 0
    else:
        dim = _arg(node, 1, "dim", -1)
    idx = _index_range(_axis_len(node, ctx, dim))
    if name == "aten.argsort":
        return [idx]
    return [ctx.av(node.args[0]), idx]


@rule("aten.searchsorted")
def _(node, ctx):
    shape = ctx.shape(node.args[0])
    return [D.iv(0, shape[-1] if shape else 0)]


@rule("aten.arange")
def _(node, ctx):
    name = str(node.target)
    if name == "aten.arange.default":
        start, end, step = 0, node.args[0], 1
    else:
        start, end = node.args[0], node.args[1]
        step = node.args[2] if len(node.args) > 2 else 1
    if (end - start) * step <= 0:
        return [D.iv(int(start))]
    last = start + step * ((abs(end - start) - 1) // abs(step))
    return [D.iv(int(min(start, last)), int(max(start, last)))]


@rule("aten.full", "aten.full_like", "aten.new_full")
def _(node, ctx):
    i = 2 if packet_name(node.target) == "aten.new_full" else 1
    return [ctx.av(node.args[i])]


@rule("aten.zeros", "aten.zeros_like", "aten.new_zeros")
def _(node, ctx):
    return [D.iv(0)]


@rule("aten.ones", "aten.ones_like", "aten.new_ones")
def _(node, ctx):
    return [D.iv(1)]


@rule("aten.scalar_tensor")
def _(node, ctx):
    return [ctx.av(node.args[0])]


@rule("aten.empty", "aten.empty_like", "aten.new_empty",
      "aten.empty_strided", "aten.new_empty_strided")
def _(node, ctx):
    return [D.top(np_dtype(_vals(node)[0].dtype))]  # uninitialized


@rule("hermes.psum")
def _(node, ctx):
    return [D.sum_n(ctx.av(node.args[0]), int(node.args[2]))]


def _hand_kernel(node, ctx):
    decl = seeds.KERNELS.get(node.target._opname)
    outs = _vals(node)
    if decl is not None:
        shapes = [ctx.shape(a) for a in node.args
                  if isinstance(a, torch.fx.Node)]
        try:
            return list(decl.outs(ctx.cfg, shapes))
        except AttributeError:  # no config to size the bounds
            pass
    return [D.top(np_dtype(v.dtype)) for v in outs]


for _n in G.KERNELS:
    RULES[f"{G.NS}.{_n}"] = _hand_kernel


# --------------------------------------------------------------------------
# Path sensitivity
# --------------------------------------------------------------------------

_FLIP = {"aten.lt": "aten.ge", "aten.le": "aten.gt", "aten.gt": "aten.le",
         "aten.ge": "aten.lt", "aten.eq": "aten.ne", "aten.ne": "aten.eq"}
_MIRROR = {"aten.lt": "aten.gt", "aten.le": "aten.ge", "aten.gt": "aten.lt",
           "aten.ge": "aten.le", "aten.eq": "aten.eq", "aten.ne": "aten.ne"}


def _narrow(av: AbsVal, op: str, k: AbsVal) -> Optional[AbsVal]:
    """``av`` restricted to the values where ``x <op> k`` can hold (None if
    none can)."""
    lo, hi = av.lo, av.hi
    if op == "aten.lt":
        hi = min(hi, k.hi - 1)
    elif op == "aten.le":
        hi = min(hi, k.hi)
    elif op == "aten.gt":
        lo = max(lo, k.lo + 1)
    elif op == "aten.ge":
        lo = max(lo, k.lo)
    elif op == "aten.eq":
        lo, hi = max(lo, k.lo), min(hi, k.hi)
    if lo > hi:
        return None
    if (lo, hi) == (av.lo, av.hi):
        return av
    return AbsVal(lo, hi, av.ones)


def _facts(ctx, cond, truth: bool, out: dict) -> None:
    """Interval facts ``{node: AbsVal}`` that ``cond == truth`` implies:
    a comparison of a node with a constant narrows the node; a
    conjunction, assumed true, gives each conjunct's."""
    e = ctx.def_of(cond)
    if e is None:
        return
    name = packet_name(e.target)
    if name in ("aten.bitwise_and", "aten.logical_and", "aten.__and__") \
            and truth and _out_is_bool(e):
        for a in e.args[:2]:
            _facts(ctx, a, True, out)
        return
    if name in ("aten.bitwise_not", "aten.logical_not") and _out_is_bool(e):
        _facts(ctx, e.args[0], not truth, out)
        return
    if name not in _FLIP or len(e.args) < 2:
        return
    a, b = e.args[0], e.args[1]
    op = name if truth else _FLIP[name]
    if op == "aten.ne":
        return
    if isinstance(a, torch.fx.Node) and ctx.av(b).is_const:
        x, k = a, ctx.av(b)
    elif isinstance(b, torch.fx.Node) and ctx.av(a).is_const:
        x, k, op = b, ctx.av(a), _MIRROR[op]
    else:
        return
    narrowed = _narrow(out.get(x, ctx.av(x)), op, k)
    if narrowed is not None:
        out[x] = narrowed


def _ancestors(ctx, node, depth: int = 24) -> set:
    seen, stack = set(), [(node, 0)]
    while stack:
        n, d = stack.pop()
        if n in seen or d > depth:
            continue
        seen.add(n)
        for a in n.all_input_nodes:
            stack.append((a, d + 1))
    return seen


def _under(ctx, atom, facts: dict, assume: dict) -> AbsVal:
    """The value of ``atom`` re-evaluated from ``facts`` (node -> narrowed
    AbsVal) and ``assume`` (bool node -> truth) through the nodes between
    them and it (no pass sees these re-evaluations)."""
    if not isinstance(atom, torch.fx.Node):
        return ctx.av(atom)
    if atom in facts:
        return facts[atom]
    roots = set(facts) | set(assume)
    anc = _ancestors(ctx, atom)
    if not roots & anc:
        return ctx.av(atom)
    # the ancestors that depend on a root, in graph order
    dep = set()
    for n in sorted(anc, key=ctx.order.get):
        if n in roots or any(a in dep for a in n.all_input_nodes):
            dep.add(n)
    saved_env = {n: ctx.env.get(n) for n in dep}
    saved_assume = ctx.assume
    ctx.assume = {**saved_assume, **assume}
    try:
        for n, v in facts.items():
            ctx.env[n] = v
        for n in sorted(dep - set(facts), key=ctx.order.get):
            if n.op != "call_function":
                continue
            ctx.env[n] = _eval_quiet(n, ctx)
        return ctx.av(atom)
    finally:
        ctx.assume = saved_assume
        for n, v in saved_env.items():
            if v is None:
                ctx.env.pop(n, None)
            else:
                ctx.env[n] = v


def _where(node, ctx) -> AbsVal:
    cond, a, b = node.args[0], node.args[1], node.args[2]
    c = ctx.av(cond)
    if c.is_const:
        return ctx.av(a) if c.lo else ctx.av(b)
    if not isinstance(cond, torch.fx.Node):
        return D.join(ctx.av(a), ctx.av(b))
    cases = []
    for truth, branch in ((True, a), (False, b)):
        facts: dict = {}
        _facts(ctx, cond, truth, facts)
        cases.append(_under(ctx, branch, facts, {ctx.base(cond): truth}))
    return D.join(*cases)


def _count_of(ctx, a):
    """``(cumsum node, flag node)`` when ``a`` is the inclusive cumsum of a
    0/1 flag along the last axis, read element for element (through dtype
    conversions only), else None."""
    for _ in range(8):
        e = ctx.def_of(a)
        if e is None:
            return None
        name = packet_name(e.target)
        if name == "aten.cumsum":
            flag = ctx.av(e.args[0])
            rank = len(ctx.shape(e))
            if (flag.lo < 0 or flag.hi > 1 or not rank
                    or _dim(_arg(e, 1, "dim"), rank) != rank - 1):
                return None
            return e, ctx.base(e.args[0])
        if name not in ("aten._to_copy", "aten.clone"):
            return None
        a = e.args[0]
    return None


def _is_lane_index(ctx, a, n: int) -> bool:
    """``a`` is a 1-D ``arange(n)`` broadcast along the last axis (only
    leading unsqueezes, expands and dtype conversions between)."""
    for _ in range(8):
        e = ctx.def_of(a)
        if e is None:
            return False
        name = packet_name(e.target)
        if name == "aten.arange":
            av = ctx.av(a)
            return ctx.shape(a) == (n,) and (av.lo, av.hi) == (0, n - 1)
        if name in ("aten.unsqueeze_copy", "aten.unsqueeze"):
            if e.args[1] != 0:
                return False
        elif name not in ("aten.expand_copy", "aten.expand",
                          "aten._to_copy", "aten.clone"):
            return False
        a = e.args[0]
    return False


def _index_minus_count(node, ctx) -> Optional[AbsVal]:
    """The slot-rank idioms of an inclusive count ``c = cumsum(p)`` along
    the last axis, read element for element:

    * ``c - 1`` where ``p`` is assumed true: the count at a counted
      position is at least 1, so [max(c.lo, 1) - 1, c.hi - 1];
    * ``(X + pos) - c``, ``pos`` the lane index of that axis: ``pos - c``
      lies in [-1, n-1], and in [0, n-1] where ``p`` is assumed false (the
      position does not count itself).

    None if the node is neither."""
    y, c = node.args[0], node.args[1]
    if node.kwargs.get("alpha", 1) != 1:
        return None
    got = _count_of(ctx, y)
    if got is not None and ctx.av(c).is_const and ctx.av(c).lo == 1:
        cnt = ctx.av(y)
        if ctx.assume.get(got[1]) is True and cnt.hi >= 1:
            return AbsVal(max(cnt.lo, 1) - 1, cnt.hi - 1)
        return None
    got = _count_of(ctx, c)
    ye = ctx.resolve(y)
    if got is None or ye is None or packet_name(ye.target) != "aten.add" \
            or ye.kwargs.get("alpha", 1) != 1:
        return None
    ce, flag = got
    n = ctx.shape(ce)[-1]
    for x, pos in (ye.args[:2], tuple(reversed(ye.args[:2]))):
        if _is_lane_index(ctx, pos, n):
            lo = 0 if ctx.assume.get(flag) is False else -1
            return D.add(ctx.av(x), AbsVal(lo, n - 1))
    return None


# --------------------------------------------------------------------------
# The walk
# --------------------------------------------------------------------------


def _rule_of(node):
    fn = RULES.get(op_name(node.target))
    if fn is None:
        fn = RULES.get(packet_name(node.target))
    return fn


def _eval_quiet(node, ctx):
    """A node's clamped results (a list for a multi-output node), for a
    re-evaluation."""
    outs, _ = _eval_node(node, ctx, record=False)
    outs = _audited_bound(node, ctx, outs)
    return outs if isinstance(node.meta.get("val"), (tuple, list)) \
        else outs[0]


def _eval_node(node, ctx, record: bool = True):
    if node.target is operator.getitem:
        return [ctx.env[node.args[0]][node.args[1]]], False
    vals = _vals(node)
    fn = _rule_of(node)
    if fn is None:
        if record:
            ctx.unmodeled.setdefault(op_name(node.target), []).append(node)
        return [D.top(np_dtype(v.dtype)) if v is not None else D.iv(0)
                for v in vals], False
    raw = fn(node, ctx)
    outs, wrapped = [], False
    for v, av in zip(vals, raw):
        if v is None:
            outs.append(av)
            continue
        c, w = D.clamp(av, np_dtype(v.dtype))
        outs.append(c)
        wrapped = wrapped or w
    return outs, wrapped


def _meet(a: AbsVal, b: AbsVal) -> AbsVal:
    lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
    if lo > hi:
        return b
    ones = b.ones if a.ones == -1 else (a.ones if b.ones == -1
                                         else a.ones & b.ones)
    return AbsVal(lo, hi, ones)


def _audited_bound(node, ctx, results, record: bool = False):
    """A node of an audited scope whose value leaves the scope takes the
    bound its audit states (``seeds.AUDIT_BOUNDS``), met with what it
    derived."""
    tag = G.audit_of(node)
    bound = seeds.AUDIT_BOUNDS.get(tag) if tag is not None else None
    if bound is None or all(G.audit_of(u) == tag for u in node.users):
        return results
    b = bound(ctx.cfg)
    if record:
        ctx.assumed.append((node, results, b))
    return [_meet(r, b) if isinstance(r, AbsVal) else r for r in results]


def _const_attr(gm, node) -> AbsVal:
    t = getattr(gm, node.target)
    if not isinstance(t, torch.Tensor):
        return D.const(t)
    try:
        return D.from_concrete(t.detach().cpu().numpy())
    except (RuntimeError, TypeError, NotImplementedError):
        return D.top(np_dtype(t.dtype))  # a fake constant: no data


def eval_graph(gm, in_avs: List[AbsVal], ctx: Ctx) -> List[AbsVal]:
    """Walk ``gm`` with ``in_avs`` for its inputs (graph order); run the
    passes on every call node; return the outputs' abstract values."""
    env = ctx.env
    ins = iter(in_avs)
    outs: List[AbsVal] = []
    for i, node in enumerate(gm.graph.nodes):
        ctx.order[node] = i
        if node.op == "placeholder":
            env[node] = next(ins)
        elif node.op == "get_attr":
            env[node] = _const_attr(gm, node)
        elif node.op == "call_function":
            if node.target is operator.getitem:
                env[node] = env[node.args[0]][node.args[1]]
                continue
            ctx.n_eqns += 1
            results, wrapped = _eval_node(node, ctx)
            results = _audited_bound(node, ctx, results, record=True)
            for p in ctx.passes:
                p.on_node(ctx, node, results, wrapped)
            env[node] = (results if isinstance(node.meta.get("val"),
                                               (tuple, list))
                         else results[0])
        elif node.op == "output":
            outs = [ctx.av(a) for a in node.args[0]
                    if isinstance(a, torch.fx.Node)]
    return outs
