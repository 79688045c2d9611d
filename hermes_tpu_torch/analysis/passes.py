"""The round analysis's passes: the port's counterpart of
``hermes_tpu/analysis/passes.py``.

Five passes ship, over the FX graph of a round (``analysis/graph.py``),
walked by the interpreter (``analysis/interp.py``):

  * ``BitPackPass`` — every left shift must fit its dtype, and every
    ``bitwise_or`` pack overlap-free and sign-safe under the config-seeded
    bounds.  A pack site is an ``or`` whose operand is a shift result, a
    previous pack, or a constant-like mask (the ``key | where(flag, BIT,
    0)`` idiom); a plain bitmap union (ack aggregation) is not one.
  * ``DtypePromotionPass`` — torch's rule (below).
  * ``ScatterHazardPass`` — every index is inside its dimension (torch
    has no drop or clip mode: an index out of range raises on the CPU and
    faults on the card), and every set-scatter (``index_put`` without
    ``accumulate``, ``scatter`` without a reduction, ``index_copy``) has
    injectivity evidence.  Commutative scatters (``scatter_add``,
    ``scatter_reduce``, ``index_add``, ``index_put`` with ``accumulate``)
    need none.  There is no donation check: the port updates its table in
    place.
  * ``HandKernelPass`` — the counterpart of ``RefHazardPass``: the port's
    kernels are CUDA, so no body is interpreted; each ``hermes.<kernel>``
    node is held to its declaration (``analysis/seeds.py``, ``KERNELS``).
  * ``ShardingConsistencyPass`` — every collective node names a declared
    axis with the declared size; a batched program holds none.

**The dtype rule for torch.**  The reference forbids every 64-bit value
("x64 should be off").  In torch int64 is the index dtype, and the port's
stream hash computes uint32 words in int64, so a literal copy would flag
hundreds of sound nodes.  The rule is restated:

  * an int64 value must never wrap: a raw int64 result outside int64 is an
    ``int64-wrap`` error (its 32-bit counterpart is what the reference's
    passes catch at a pack or a convert);
  * a narrowing or sign-changing ``_to_copy`` between integer (or bool)
    dtypes must keep every value (``implicit-wrap-convert``, warn): that is
    where an int64 value reaches a packed int32 word or a table store
    (torch's stores take their own dtype, so every store of a wider value
    goes through one);
  * a float is allowed only where ``cfg.device_stream`` allows it (the
    reference's ``allow_float``): an op producing a float warns
    ``float-in-round``, a float-to-int ``_to_copy`` ``float-to-int``;
  * a 64-bit float is a ``silent-64bit`` error, as in the reference;
  * ``view(dtype)`` is the explicit reinterpret (the reference's
    ``bitcast_convert_type``) and is never a finding.

**Injectivity evidence.**  Torch has no ``unique_indices=True``.  Its
counterpart is an index that is injective by construction: the index
output of ``sort``/``argsort``/``topk`` scattered along the dimension it
permutes, or an ``arange``: such a scatter is proved.  Otherwise the site
must be audited (``layouts.audited``), which downgrades the warning to
info and names the invariant.

Severity contract (the gate, ``gates.py``'s ``analysis``):

  * ``error``  — a violation provable from config-seeded facts;
  * ``warn``   — a structural hazard the analysis cannot discharge;
  * ``info``   — a discharged assumption (an audited site, an unmodeled
    op): never gates, always listed.

Findings made inside a ``layouts.audited(tag)`` scope are downgraded to
info and carry the tag.  ``Finding`` and the severities live in
``analysis/findings.py``.
"""

from __future__ import annotations

import operator
from typing import Dict, List

import numpy as np
import torch

from hermes_tpu_torch.analysis import domain as D
from hermes_tpu_torch.analysis import graph as G
from hermes_tpu_torch.analysis import interp as I
from hermes_tpu_torch.analysis import seeds
from hermes_tpu_torch.analysis.findings import (ERROR, INFO, WARN, Finding,
                                                SEV_RANK)
from hermes_tpu_torch.analysis.interp import Ctx, op_name, packet_name


class Pass:
    """Base: dedups findings by (code, site, op, audit) and counts proof
    sites."""

    name = "pass"

    def __init__(self):
        self.findings: Dict[tuple, Finding] = {}
        self.n_proved = 0

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        pass

    def emit(self, node, code: str, severity: str, message: str,
             audited: bool = True) -> None:
        emit(self.findings, self.name, node, code, severity, message,
             audited)

    def results(self) -> List[Finding]:
        return sorted(self.findings.values(),
                      key=lambda f: (-SEV_RANK[f.severity], f.file, f.line))


def emit(table: dict, pass_name: str, node, code: str, severity: str,
         message: str, audited: bool = True) -> None:
    """Record one finding at ``node``'s site, downgraded to info with the
    tag inside an audited scope (unless ``audited`` is False: a finding no
    audit can discharge); a repeat at the same key counts up."""
    file, line, fn = G.site_of(node)
    audit = G.audit_of(node) if audited else None
    if audit is not None and severity != INFO:
        message = f"audited[{audit}]: {message}"
        severity = INFO
    op = op_name(node.target)
    k = (code, file, line, fn, op, audit)
    f = table.get(k)
    if f is None:
        table[k] = Finding(pass_name=pass_name, code=code, severity=severity,
                           message=message, file=file, line=line, fn=fn,
                           op=op, audit=audit)
    else:
        f.count += 1


def _out_dtypes(node) -> list:
    v = node.meta.get("val")
    vs = v if isinstance(v, (tuple, list)) else [v]
    return [x.dtype for x in vs if isinstance(x, torch.Tensor)]


def _is_int(dt) -> bool:
    return dt != torch.bool and not dt.is_floating_point \
        and not dt.is_complex


# --------------------------------------------------------------------------
# 1. bit-pack interval analysis
# --------------------------------------------------------------------------

_SHL = ("aten.__lshift__", "aten.bitwise_left_shift")
_OR = ("aten.bitwise_or", "aten.__or__")


class BitPackPass(Pass):
    name = "bitpack"

    def _is_pack_operand(self, ctx: Ctx, atom) -> bool:
        e = ctx.resolve(atom)
        # a shift result, a previous pack (chained `a | b | c`), or a
        # constant-like mask makes the `or` a field pack
        if e is not None and packet_name(e.target) in _SHL + _OR:
            return True
        return ctx.is_const_like(atom)

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        name = packet_name(node.target)
        dts = _out_dtypes(node)
        if name in _SHL:
            if not dts or not _is_int(dts[0]):
                return
            if wrapped:
                a, s = ctx.av(node.args[0]), ctx.av(node.args[1])
                self.emit(
                    node, "pack-shift-overflow", ERROR,
                    f"left shift can escape {dts[0]}: operand {a} << {s} — "
                    f"the shifted field can reach the sign bit / wrap; "
                    f"widen the layout or bound the field")
            else:
                self.n_proved += 1
            return
        if name not in _OR or not dts or dts[0] == torch.bool:
            return
        a_pack = self._is_pack_operand(ctx, node.args[0])
        b_pack = self._is_pack_operand(ctx, node.args[1])
        if not (a_pack or b_pack):
            return  # a bitmap union, not a field pack
        a, b = ctx.av(node.args[0]), ctx.av(node.args[1])
        if a.lo < 0 or b.lo < 0:
            self.emit(
                node, "pack-negative-operand", ERROR,
                f"pack operand may be negative ({a} | {b}): a sign-extended "
                f"value sets every high bit and aliases all fields above it")
            return
        overlap = a.ones & b.ones
        if overlap:
            self.emit(
                node, "pack-overlap", ERROR,
                f"packed fields may overlap on mask 0x{overlap:x} "
                f"({a} | {b}): a field value can alias its neighbor's bits")
            return
        self.n_proved += 1


# --------------------------------------------------------------------------
# 2. dtype promotion lint (torch's rule: see the module docstring)
# --------------------------------------------------------------------------

_CONVERTS = ("aten._to_copy", "aten.copy")


class DtypePromotionPass(Pass):
    name = "dtype"

    def __init__(self, allow_float: bool = False):
        super().__init__()
        self.allow_float = allow_float

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        name = packet_name(node.target)
        dts = _out_dtypes(node)
        for dt in dts:
            if dt == torch.float64:
                self.emit(node, "silent-64bit", ERROR,
                          f"{op_name(node.target)} produces {dt}: a 64-bit "
                          f"float on the round doubles its bytes silently")
            elif (not self.allow_float and dt.is_floating_point
                  and name not in _CONVERTS):
                self.emit(node, "float-in-round", WARN,
                          f"{op_name(node.target)} produces {dt} in an "
                          f"integer protocol round (only device_stream "
                          f"zipfian sampling may use floats)")
        if wrapped and torch.int64 in dts and name not in _CONVERTS:
            self.emit(node, "int64-wrap", ERROR,
                      f"{op_name(node.target)} can leave int64: an index or "
                      f"hash word that wraps silently")
        if name not in _CONVERTS:
            return
        src_node = node.args[1] if name == "aten.copy" else node.args[0]
        if not isinstance(src_node, torch.fx.Node):
            return
        src = _out_dtypes(src_node)[0]
        dst = dts[0]
        if src.is_floating_point and _is_int(dst) and not self.allow_float:
            self.emit(node, "float-to-int", WARN,
                      f"float->int convert ({src}->{dst}) in an integer "
                      f"round")
            return
        if src.is_floating_point or dst.is_floating_point:
            return
        if wrapped:
            self.emit(
                node, "implicit-wrap-convert", WARN,
                f"convert {src}->{dst} can change the value (operand "
                f"{ctx.av(src_node)} escapes {dst}): a silent two's-"
                f"complement wrap — make the reinterpretation explicit with "
                f"a same-width view(dtype), or mask first (see "
                f"faststep._bank_to_i32)")
        else:
            self.n_proved += 1


# --------------------------------------------------------------------------
# 3. scatter/gather hazard detector
# --------------------------------------------------------------------------

#: gathers: (index argument, dimension argument or None for index's own
#: position list, whether a negative index wraps)
_GATHERS = {"aten.gather": (2, 1, False), "aten.index_select": (2, 1, False),
            "aten.take": (1, None, False), "aten.index": (1, None, True)}
#: scatters: (index argument, dimension argument, negative wraps, set)
_SCATTERS = {"aten.index_put": (1, None, True, None),
             "aten.scatter": (2, 1, False, True),
             "aten.index_copy": (2, 1, False, True),
             "aten.scatter_add": (2, 1, False, False),
             "aten.scatter_reduce": (2, 1, False, False),
             "aten.index_add": (2, 1, False, False),
             "aten.index_fill": (2, 1, False, False)}
_PERMUTERS = ("aten.sort", "aten.argsort", "aten.topk")


class ScatterHazardPass(Pass):
    name = "scatter"

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        name = packet_name(node.target)
        if name in _GATHERS:
            i, d, neg = _GATHERS[name]
            self._check_bounds(ctx, node, i, d, neg)
            return
        if name not in _SCATTERS:
            return
        i, d, neg, is_set = _SCATTERS[name]
        self._check_bounds(ctx, node, i, d, neg)
        if name == "aten.index_put":
            is_set = not (node.args[3] if len(node.args) > 3
                          else node.kwargs.get("accumulate", False))
        elif name == "aten.scatter" and node.kwargs.get("reduce"):
            is_set = False
        if not is_set:
            self.n_proved += 1  # add/max/min: duplicate indices commute
            return
        if self._injective(ctx, node, i, d):
            self.n_proved += 1
            return
        self.emit(
            node, "scatter-set-not-injective", WARN,
            "set-scatter without injectivity evidence: duplicate indices "
            "make the written row unspecified (index_put_ and scatter_ "
            "order them arbitrarily).  Prove it (an index that is a "
            "permutation by construction), or audit the protocol invariant "
            "that makes duplicates deterministic (layouts.audited)")

    def _injective(self, ctx: Ctx, node, i: int, d) -> bool:
        """The scatter's index is a permutation by construction along the
        scattered dimension: the index output of a sort (or argsort, topk)
        along it, or an arange."""
        if d is None:
            return False
        idx = node.args[i]
        e = ctx.resolve(idx)
        rank = len(ctx.shape(idx))
        dim = node.args[d] + rank if node.args[d] < 0 else node.args[d]
        if I._is_lane_index(ctx, idx, ctx.shape(idx)[-1] if rank else 0):
            return dim == rank - 1
        if e is None or e.target is not operator.getitem:
            return False
        src = e.args[0]
        if packet_name(src.target) not in _PERMUTERS:
            return False
        if packet_name(src.target) == "aten.topk":
            sdim = src.args[2] if len(src.args) > 2 else \
                src.kwargs.get("dim", -1)
        elif str(src.target) == "aten.sort.stable":
            sdim = src.kwargs.get("dim", -1)
        else:
            sdim = src.args[1] if len(src.args) > 1 else \
                src.kwargs.get("dim", -1)
        srank = len(ctx.shape(src.args[0]))
        sdim = sdim + srank if sdim < 0 else sdim
        return e.args[1] == (0 if packet_name(src.target) == "aten.argsort"
                             else 1) and sdim == dim and srank == rank

    def _check_bounds(self, ctx: Ctx, node, i: int, d, neg: bool) -> None:
        shape = ctx.shape(node.args[0])
        if d is None and packet_name(node.target) == "aten.take":
            pairs = [(node.args[i], int(np.prod(shape or (1,))))]
        elif d is None:  # a list of per-dimension indices (None: a slice)
            pairs = [(a, shape[k]) for k, a in enumerate(node.args[i])
                     if isinstance(a, torch.fx.Node)]
        else:
            dim = node.args[d]
            dim = dim + len(shape) if dim < 0 else dim
            pairs = [(node.args[i], shape[dim] if shape else 1)]
        for idx_node, cap in pairs:
            if _out_dtypes(idx_node)[0] == torch.bool:
                continue  # a mask, not positions
            idx = ctx.av(idx_node)
            lo = -cap if neg else 0
            if idx.lo < lo or idx.hi >= cap:
                self.emit(
                    node, "oob-promised-index", ERROR,
                    f"indices {idx} can leave [{lo}, {cap}): torch has no "
                    f"drop or clip mode, an index out of range raises on "
                    f"the CPU and faults on the card")
            else:
                self.n_proved += 1


# --------------------------------------------------------------------------
# 4. hand-kernel bound check (the counterpart of RefHazardPass)
# --------------------------------------------------------------------------


def _inside(av: D.AbsVal, seed: D.AbsVal) -> bool:
    if av.lo < seed.lo or av.hi > seed.hi:
        return False
    return seed.ones == -1 or (av.ones != -1 and not av.ones & ~seed.ones)


class HandKernelPass(Pass):
    """At each ``hermes.<kernel>`` node (``analysis/graph.py``), the
    kernel's declaration (``analysis/seeds.py``, ``KERNELS``):

      * ``kernel-undeclared`` (error) — a hand-kernel node with no
        declared bounds: its outputs are dtype-TOP, never silently;
      * ``kernel-input-escapes-seed`` (error) — an argument's abstract
        value leaves the kernel's declared input seed (interval, or the
        ones mask), so the declared output bounds do not apply;

    (no audit discharges these two: the kernel's audit declares its
    access pattern, not its inputs);
      * the kernel's declared hazard (warn) — the access pattern its call
        site must declare with ``layouts.audited`` (with the audit: info,
        tag carried), e.g. ``grid-revisit-accumulator`` for outputs
        accumulated across CTAs.

    The interpreter gives the node's outputs their declared bounds."""

    name = "refhazard"

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        if G._ns(node.target) != G.NS or \
                node.target._opname not in G.KERNELS:
            return
        kname = node.target._opname
        decl = seeds.KERNELS.get(kname)
        if decl is None:
            self.emit(node, "kernel-undeclared", ERROR,
                      f"hand kernel {kname} has no declared bounds in "
                      f"analysis/seeds.py KERNELS: its outputs are "
                      f"dtype-TOP and its inputs unchecked", audited=False)
            return
        args = [a for a in node.args if isinstance(a, torch.fx.Node)]
        ok = True
        for k, (a, seed) in enumerate(zip(args, decl.seeds(ctx.cfg))):
            av = ctx.av(a)
            if not _inside(av, seed):
                ok = False
                self.emit(
                    node, "kernel-input-escapes-seed", ERROR,
                    f"{kname} argument {k} is {av}, outside its declared "
                    f"seed {seed}: the kernel's declared output bounds do "
                    f"not cover this call", audited=False)
        if ok:
            self.n_proved += 1
        code, what = decl.hazard
        self.emit(node, code, WARN,
                  f"{kname}: {what}; declare it with layouts.audited(tag) "
                  f"on the kernel (hand_kernel(audit=...))")


# --------------------------------------------------------------------------
# 5. sharding consistency
# --------------------------------------------------------------------------


class ShardingConsistencyPass(Pass):
    name = "sharding"

    def on_node(self, ctx: Ctx, node, outs, wrapped) -> None:
        declared = ctx.mesh_axes
        if declared is None or G._ns(node.target) != G.NS:
            return
        name = node.target._opname
        if name not in G.COLLECTIVES:
            return
        if not declared:
            self.emit(node, "collective-in-batched-engine", ERROR,
                      f"{name} in the batched (single-device) engine: the "
                      f"lockstep emulation must not contain wire ops")
            return
        _x, axis, size, world = node.args
        if axis not in declared:
            self.emit(node, "unknown-mesh-axis", ERROR,
                      f"{name} names mesh axis {axis!r}; declared axes "
                      f"are {sorted(declared)}")
            return
        if declared[axis] != int(size):
            self.emit(node, "axis-size-mismatch", ERROR,
                      f"{name} over axis {axis!r} of size {size}, the "
                      f"engine declares {declared[axis]} (per-replica "
                      f"shapes will disagree)")
            return
        if name == "route_back":
            shape = ctx.shape(node.args[0])
            if len(shape) < 2 or shape[1] % int(world):
                self.emit(node, "uneven-all-to-all", ERROR,
                          f"route_back splits dim 1 of {shape} over "
                          f"{world} ranks: not divisible — per-replica "
                          f"shapes disagree")
                return
        self.n_proved += 1


def default_passes(allow_float: bool = False) -> list:
    return [BitPackPass(), DtypePromotionPass(allow_float=allow_float),
            ScatterHazardPass(), HandKernelPass(),
            ShardingConsistencyPass()]


def interp_findings(ctx: Ctx) -> List[Finding]:
    """The interpreter's own info findings: ``unmodeled-op`` for an op
    without a transfer rule (its results were dtype-TOP), one a site with
    its count, and ``audited-bound`` where a value leaving an audited
    scope took the bound its audit states (``seeds.AUDIT_BOUNDS``)."""
    table: dict = {}
    for name, nodes in sorted(ctx.unmodeled.items()):
        for node in nodes:
            emit(table, "interp", node, "unmodeled-op", INFO,
                 f"{name} has no transfer rule: its results are "
                 f"dtype-TOP (sound, but nothing is proved through it)")
    for node, derived, bound in ctx.assumed:
        emit(table, "interp", node, "audited-bound", INFO,
             f"{op_name(node.target)} is assumed inside {bound} by its "
             f"audit (derived: {', '.join(map(str, derived))})")
    return list(table.values())
