"""The round as an FX graph: the port's counterpart of ``jax.make_jaxpr``.

``trace(fn, args)`` records ``fn(*args)`` with
``make_fx(functionalize(fn), tracing_mode="fake")``: every tensor leaf of
``args`` becomes a graph input (in pytree order), every other leaf (a host
step, a Python flag) is fixed by the trace, and nothing is computed.
Functionalization leaves pure ops only (an in-place update becomes its
functional form plus, at the end, a ``copy_`` back into the mutated
input), so the interpreter (``analysis/interp.py``) walks SSA values and
needs no alias model.  Build the inputs under ``fake_mode()`` and nothing
is materialized either: a bench-shape round traces on the CPU in seconds.

Three things the plain ``make_fx`` does not give, added while a trace
records:

* **Hand-kernel calls** (``core/dispatch.hand_kernel``) each become ONE
  opaque node, ``hermes.<kernel>``, whose fake implementation gives the
  kernel's output shapes, on either device: the wrapper runs neither its
  plain version (which the CPU would otherwise trace op by op) nor its
  CUDA kernel (whose launch needs ``data_ptr()``, which a fake tensor
  cannot give).  A kernel that updates an input in place (``mega_apply``'s
  ``vpts``, ``mega_replay``'s bank) returns the new tensor from the node
  and copies it back, so functionalization sees an ordinary update.  The
  eager path never meets these ops.
* **Collectives**: ``TracedGroup`` wraps a replica group so that each of
  ``gather_src``, ``route_back``, ``psum``, ``pmax`` and ``pmin`` becomes
  one node, ``hermes.<collective>``, carrying the group's axis name and
  size; a ``LocalGroup``'s identity and transposes would otherwise leave
  nothing or a plain transpose in the graph.
* **Sites and audits**: every node carries ``node.meta["hermes_site"]``,
  the ``(file, line, function)`` of the innermost ``hermes_tpu_torch`` (or
  ``tests``) frame that made it, outside this tracing machinery (the
  frames ``make_fx`` records itself come out empty after
  functionalization), and ``node.meta["hermes_audit"]``, the innermost
  open ``layouts.audited`` tag.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from hermes_tpu_torch.core import dispatch, layouts

NS = "hermes"
SITE = "hermes_site"
AUDIT = "hermes_audit"
UNKNOWN_SITE = ("<unknown>", 0, "<unknown>")
#: the replica group's collectives (``core/group.py``)
COLLECTIVES = ("gather_src", "route_back", "psum", "pmax", "pmin")

_ROOTS = ("hermes_tpu_torch/", "tests/")
_MACHINERY = frozenset({"hermes_tpu_torch/analysis/graph.py",
                        "hermes_tpu_torch/core/dispatch.py",
                        "hermes_tpu_torch/core/layouts.py"})


def _never_run(*_args):
    raise RuntimeError("a node of an analysis graph: traced, never run")


# --------------------------------------------------------------------------
# The hand kernels as trace-only ops.  Argument order is that of the
# kernel's input seeds in analysis/seeds.py, output order that of its
# declared output bounds.
# --------------------------------------------------------------------------


@torch.library.custom_op(f"{NS}::stats_block", mutates_args=())
def _stats_block(step: Tensor, sess_op: Tensor, invoke_step: Tensor,
                 commit: Tensor, abort: Tensor, read_done: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    _never_run()


@_stats_block.register_fake
def _(step, sess_op, invoke_step, commit, abort, read_done):
    from hermes_tpu_torch.core import kernels
    from hermes_tpu_torch.core import state as st

    R, S = sess_op.shape
    return (sess_op.new_empty((R, S)),
            sess_op.new_empty((R, kernels.CTR_WIDTH)),
            sess_op.new_empty((R, st.LAT_BINS)))


@torch.library.custom_op(f"{NS}::mega_route", mutates_args=())
def _mega_route(si: Tensor, word: Tensor, srank: Tensor, C: int
                ) -> Tuple[Tensor, Tensor]:
    _never_run()


@_mega_route.register_fake
def _(si, word, srank, C):
    return si.new_empty(si.shape), si.new_empty((si.shape[0], C))


@torch.library.custom_op(f"{NS}::mega_apply", mutates_args=())
def _mega_apply(vpts: Tensor, keys: Tensor, pts: Tensor, mask: Tensor
                ) -> Tuple[Tensor, Tensor]:
    _never_run()


@_mega_apply.register_fake
def _(vpts, keys, pts, mask):
    return vpts.new_empty(vpts.shape), vpts.new_empty((keys.numel(),))


@torch.library.custom_op(f"{NS}::mega_replay", mutates_args=())
def _mega_replay(step: Tensor, active: Tensor, frozen: Tensor, bank: Tensor,
                 vpts: Tensor, key: Tensor, pts: Tensor, acks: Tensor,
                 val: Tensor, n_keys: int, replay_age: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    _never_run()


@_mega_replay.register_fake
def _(step, active, frozen, bank, vpts, key, pts, acks, val, n_keys,
      replay_age):
    return tuple(x.new_empty(x.shape) for x in (bank, active, key, pts,
                                                 acks, val))


def _step(step, like):
    if isinstance(step, Tensor):
        return step
    return torch.tensor(step, dtype=torch.int32, device=like.device)


def _stats_block_node(step, sess_op, invoke_step, commit, abort, read_done):
    return torch.ops.hermes.stats_block(_step(step, sess_op), sess_op,
                                        invoke_step, commit, abort,
                                        read_done)


def _mega_route_node(cfg, si, word, srank):
    return torch.ops.hermes.mega_route(si, word, srank, cfg.lane_budget)


def _mega_apply_node(cfg, vpts, keys, pts, mask):
    new, post = torch.ops.hermes.mega_apply(vpts, keys, pts, mask)
    vpts.copy_(new)  # the kernel's in-place update
    return vpts, post


def _mega_replay_node(cfg, step, frozen, table_vpts, table_bank, replay):
    outs = torch.ops.hermes.mega_replay(
        _step(step, table_bank), replay.active, frozen, table_bank,
        table_vpts, replay.key, replay.pts, replay.acks, replay.val,
        cfg.n_keys, cfg.replay_age)
    table_bank.copy_(outs[0])  # the REPLAY marks, in place
    return table_bank, tuple(outs[1:])


_NODES = {"stats_block": _stats_block_node, "mega_route": _mega_route_node,
          "mega_apply": _mega_apply_node, "mega_replay": _mega_replay_node}
#: the hand kernels a trace turns into nodes (the round's four)
KERNELS = tuple(_NODES)


def _kernel_node(name: str, args, kwargs):
    """``dispatch._trace``: a hand-kernel call as its one node."""
    form = _NODES.get(name)
    if form is None:
        raise NotImplementedError(
            f"hand kernel {name!r} has no trace form in analysis/graph.py "
            f"(the round's kernels are {KERNELS})")
    return form(*args, **kwargs)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------


@torch.library.custom_op(f"{NS}::gather_src", mutates_args=())
def _gather_src(x: Tensor, axis: str, size: int, world: int) -> Tensor:
    _never_run()


@_gather_src.register_fake
def _(x, axis, size, world):
    return x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))


@torch.library.custom_op(f"{NS}::route_back", mutates_args=())
def _route_back(block: Tensor, axis: str, size: int, world: int) -> Tensor:
    _never_run()


@_route_back.register_fake
def _(block, axis, size, world):
    r = block.shape[1]
    return block.new_empty((r // world, r) + tuple(block.shape[2:]))


def _reduce_op(name):
    op = torch.library.custom_op(f"{NS}::{name}", mutates_args=())(
        _typed_reduce)
    op.register_fake(lambda x, axis, size, world: x.new_empty(x.shape))
    return op


def _typed_reduce(x: Tensor, axis: str, size: int, world: int) -> Tensor:
    _never_run()


for _name in ("psum", "pmax", "pmin"):
    _reduce_op(_name)


class TracedGroup:
    """A replica group whose collectives each trace as one
    ``hermes.<collective>`` node carrying ``axis`` and ``size`` (the
    replicas the axis spans); everything else is the group's own.  Only
    for a trace: the nodes never run."""

    def __init__(self, group, size: int, axis: str = "replica"):
        self._group = group
        self.axis = axis
        self.size = int(size)

    def __getattr__(self, name):
        return getattr(self._group, name)

    def _call(self, name, x):
        op = getattr(torch.ops.hermes, name)
        return op(x, self.axis, self.size, self._group.world)

    def gather_src(self, x):
        return self._call("gather_src", x)

    def route_back(self, block):
        return self._call("route_back", block)

    def psum(self, x):
        return self._call("psum", x)

    def pmax(self, x):
        return self._call("pmax", x)

    def pmin(self, x):
        return self._call("pmin", x)


# --------------------------------------------------------------------------
# Sites, audits and the trace
# --------------------------------------------------------------------------


def _site():
    """(file, line, function) of the innermost frame of the port or its
    tests that is not this tracing machinery."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename.replace(os.sep, "/")
        for root in _ROOTS:
            i = fname.rfind(root)
            if i >= 0:
                rel = fname[i:]
                if rel not in _MACHINERY:
                    return (rel, f.f_lineno, f.f_code.co_name)
                break
        f = f.f_back
    return UNKNOWN_SITE


def site_of(node) -> tuple:
    return node.meta.get(SITE, UNKNOWN_SITE)


def audit_of(node):
    return node.meta.get(AUDIT)


@contextlib.contextmanager
def recording():
    """The trace-only state: hand kernels become nodes, audit scopes are
    open, and every new graph node gets its site and audit.  Traces do not
    nest; everything is put back on the way out."""
    if layouts._AUDITS is not None or dispatch._trace is not None:
        raise RuntimeError("analysis traces do not nest")
    create = torch.fx.Graph.create_node

    def create_node(self, *args, **kwargs):
        node = create(self, *args, **kwargs)
        node.meta[SITE] = _site()
        node.meta[AUDIT] = layouts.current_audit()
        return node

    layouts._AUDITS = []
    dispatch._trace = _kernel_node
    torch.fx.Graph.create_node = create_node
    try:
        yield
    finally:
        torch.fx.Graph.create_node = create
        dispatch._trace = None
        layouts._AUDITS = None


def fake_mode():
    """A fake-tensor mode to build a trace's inputs in: shapes and dtypes
    on the chosen device, no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def trace(fn, args: tuple):
    """The functionalized FX graph of ``fn(*args)``: one input per tensor
    leaf of ``args`` (pytree order), one output per tensor leaf of the
    result.  Returns ``(graph_module, seconds)``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat, spec = pytree.tree_flatten(args)
    pos = [i for i, x in enumerate(flat) if isinstance(x, Tensor)]

    def flat_fn(*tensors):
        leaves = list(flat)
        for i, x in zip(pos, tensors):
            leaves[i] = x
        out = fn(*pytree.tree_unflatten(leaves, spec))
        return [x for x in pytree.tree_leaves(out) if isinstance(x, Tensor)]

    t0 = time.perf_counter()
    with recording():
        gm = make_fx(torch.func.functionalize(
            flat_fn, remove="mutations_and_views"),
            tracing_mode="fake")(*[flat[i] for i in pos])
    return gm, time.perf_counter() - t0


def kernel_nodes(gm) -> dict:
    """The hand-kernel nodes of a graph, counted by kernel name."""
    out: dict = {}
    for n in gm.graph.nodes:
        if n.op == "call_function" and _ns(n.target) == NS:
            name = n.target._opname
            if name in KERNELS:
                out[name] = out.get(name, 0) + 1
    return out


def _ns(target) -> str:
    return getattr(target, "namespace", "")
