"""The kernel matrix and its differential sanitizer.

Port of ``hermes_tpu/analysis/diffcheck.py``.  ``kernel_cells()`` registers
every production kernel of the port at the shapes that reach its distinct
code paths, with the declared abstract bound of each argument and of each
output (``analysis/seeds.py``).  Two checks run over a cell:

* ``analyze_kernel(cell)`` runs the kernel once in the bound-checked build
  (``core/dispatch.checked_build``: every global access guarded, every
  output poisoned before the launch) on a seeded draw and returns a report
  in the reference's shape, its findings under the reference's codes
  (``analysis/findings.py``).  The reference proves the same hazards from
  the kernel's jaxpr; the port observes them on a run, so a clean report
  says that this draw, spanning the declared bounds, raised none.
* ``diff_check(cell)`` is the differential sanitizer: seeded inputs drawn
  uniformly inside the declared bounds go through the kernel, and every
  output element must lie inside its declared interval and possible-ones
  mask, and equal what the plain version gives on the CPU for the same
  draw.  An escape means a bound that is too tight, or a kernel that
  computes something else.  The draws are the reference's byte for byte
  (``_draw``: the same numpy generator calls in the same order).

On a CPU device the wrappers take their plain versions, so both checks
hold the plain versions to the declared bounds (and to themselves) and no
access is bound-checked; the report says so with an info finding.

    python -m hermes_tpu_torch.analysis --kernels [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from hermes_tpu_torch.analysis import findings as F
from hermes_tpu_torch.analysis import fixture_kernels as fk
from hermes_tpu_torch.analysis import seeds as seeds_lib
from hermes_tpu_torch.analysis.domain import AbsVal, contains
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import dispatch, kernels, megaround
from hermes_tpu_torch.device import resolve


@dataclasses.dataclass
class KernelCell:
    """One kernel x shape.  ``fn`` calls the kernel's wrapper and ``plain``
    its plain version, both on the cell's positional tensors (``shapes``:
    a ``(shape, numpy dtype)`` each, the reference cell's) and both
    returning the outputs as a flat tuple; ``in_avs`` and ``out_avs`` are
    the declared bounds, one ``AbsVal`` per argument and per output;
    ``lib`` is the ``csrc/<lib>.cu`` that holds the kernel.  ``either``,
    where the kernel leaves an element open on inputs outside its
    contract, maps ``(numpy args, output index, flat element index)`` to
    the values that element may take besides the plain version's."""

    name: str
    fn: Callable
    plain: Callable
    shapes: Tuple
    in_avs: List[AbsVal]
    out_avs: List[AbsVal]
    lib: str
    note: str = ""
    either: Optional[Callable] = None


I32, I8, BOOL = np.dtype(np.int32), np.dtype(np.int8), np.dtype(np.bool_)


def _stats_cell(name: str, R: int, S: int, note: str = "") -> KernelCell:
    shapes = (((), I32),) + tuple(((R, S), dt)
                                  for dt in (I32, I32, BOOL, BOOL, BOOL))
    return KernelCell(name=name, fn=kernels.stats_block,
                      plain=kernels.stats_block_plain, shapes=shapes,
                      in_avs=seeds_lib.seed_stats_block(),
                      out_avs=seeds_lib.out_stats_block(S),
                      lib="stats_block", note=note)


def _scan_acc_cell() -> KernelCell:
    """The sentinel: a loop-carried accumulation into the output, the
    pattern whose bound a loop analysis must widen (one pass of the body
    gives [0, 100]; 16 rows reach 1600)."""
    M, W = 16, 8
    return KernelCell(name="synthetic/scan-accumulate",
                      fn=lambda x: (fk.scan_acc(x),),
                      plain=lambda x: (fk.scan_acc_plain(x),),
                      shapes=(((M, W), I32),),
                      in_avs=seeds_lib.seed_scan_acc(),
                      out_avs=seeds_lib.out_scan_acc(M), lib="scan_acc",
                      note="loop-carried ref accumulation sentinel")


def _mega_cfg(n_keys: int = 16) -> HermesConfig:
    return HermesConfig(n_replicas=2, n_keys=n_keys, n_sessions=4,
                        replay_slots=2, ops_per_session=4,
                        arb_mode="sort", mega_round=True)


def _mega_route_cell() -> KernelCell:
    """The draws take ``si`` and ``srank`` uniformly, so they repeat
    targets, which the round never does (``si`` is the sort's permutation,
    ``srank`` a bijection).  There the reference's serial loop and the
    plain version on the CPU let the last position win, while the CUDA
    kernel's threads run in no order (``csrc/mega_route.cu``): an element
    several positions write may hold any of their values."""
    cfg = _mega_cfg()
    R, L, C = cfg.n_replicas, cfg.n_lanes, cfg.lane_budget

    def either(args, i, index):
        si, word, srank = args
        r, target = divmod(index, C if i else L)
        lane = si[r].clip(0, L - 1)
        return lane[srank[r] == target] if i else word[r][lane == target]

    return KernelCell(
        name="mega_route/r2l6",
        fn=lambda si, w, sr: megaround.mega_route(cfg, si, w, sr),
        plain=lambda si, w, sr: megaround.mega_route_plain(cfg, si, w, sr),
        shapes=tuple(((R, L), I32) for _ in range(3)),
        in_avs=seeds_lib.seed_mega_route(cfg),
        out_avs=seeds_lib.out_mega_route(cfg), lib="mega_route",
        note="permutation route-back + slot region", either=either)


def _mega_apply_cell() -> KernelCell:
    cfg = _mega_cfg()
    N = 2 * cfg.n_lanes + 4  # slots + replay rows shape
    # the reference's cell hands the mask over as int32
    return KernelCell(
        name="mega_apply/k16n16",
        fn=lambda v, k, p, m: megaround.mega_apply(cfg, v, k, p, m != 0),
        plain=lambda v, k, p, m: megaround.mega_apply_plain(cfg, v, k, p,
                                                            m != 0),
        shapes=(((cfg.n_keys,), I32), ((N,), I32), ((N,), I32), ((N,), I32)),
        in_avs=seeds_lib.seed_mega_apply(cfg),
        out_avs=seeds_lib.out_mega_apply(cfg), lib="mega_apply",
        note="two-phase scatter-max + verdict read-back; keys span the "
             "untrusted 29-bit wire field (drop/clamp exercised)")


def _mega_replay_cell(name: str, n_keys: int, note: str) -> KernelCell:
    from hermes_tpu_torch.core import faststep as fst

    cfg = _mega_cfg(n_keys=n_keys)
    R, RS, V4 = cfg.n_replicas, cfg.replay_slots, 4 * cfg.value_words
    W4 = 4 * (2 + cfg.value_words)
    K = cfg.n_keys

    def call(replay_fn):
        def fn(step, act, frozen, bank, vpts, key, pts, acks, val):
            rep = fst.FastReplay(active=act, key=key, pts=pts, val=val,
                                 acks=acks)
            bank, new = replay_fn(cfg, step, frozen, vpts, bank, rep)
            return (bank, *new)
        return fn

    shapes = (((), I32), ((R, RS), BOOL), ((R,), BOOL), ((K, W4), I8),
              ((K,), I32), ((R, RS), I32), ((R, RS), I32), ((R, RS), I32),
              ((R, RS, V4), I8))
    return KernelCell(name=name, fn=call(megaround.mega_replay),
                      plain=call(megaround.mega_replay_plain), shapes=shapes,
                      in_avs=seeds_lib.seed_mega_replay(cfg),
                      out_avs=seeds_lib.out_mega_replay(cfg),
                      lib="mega_replay", note=note)


def kernel_cells() -> List[KernelCell]:
    """The kernel matrix: the reference's eight cells, name for name and
    shape for shape, and one more.  The reference's ``mega_replay/k22b3``
    forces a ragged 3-block grid over 22 rows through a block-bytes
    override; the port's ``mega_replay`` gives each CTA of its one
    cooperative launch a span of whole ``megaround.REPLAY_UNIT_ROWS``-row
    units (``megaround.replay_plan``), where 22 rows are one CTA, so
    ``mega_replay/k2500b3`` adds what reaches that code path here: three
    CTAs, the last span ragged, the candidate ranks crossing CTAs."""
    return [
        _stats_cell("stats_block/r4s512", 4, 512,
                    note="single block, no padding"),
        _stats_cell("stats_block/r1024s600", 1024, 600,
                    note="many replicas, a ragged last block of sessions"),
        _stats_cell("stats_block/r512s2000", 512, 2000,
                    note="several blocks a replica, ragged"),
        _scan_acc_cell(),
        _mega_route_cell(),
        _mega_apply_cell(),
        _mega_replay_cell("mega_replay/k16b1", 16,
                          note="single table block"),
        _mega_replay_cell("mega_replay/k22b3", 22,
                          note="the reference's ragged 3-block shape; one "
                               "block here"),
        _mega_replay_cell("mega_replay/k2500b3", 2500,
                          note="3 CTAs of 1024 rows, the last ragged: "
                               "the candidate ranks cross CTAs"),
    ]


def cell_by_name(name: str) -> KernelCell:
    for c in kernel_cells():
        if c.name == name:
            return c
    raise KeyError(name)


def _draw(rng, shape_dtype, av: AbsVal):
    """One concrete argument uniformly inside the declared bound."""
    shape, dt = shape_dtype
    if dt == np.bool_:
        lo, hi = max(0, av.lo), min(1, av.hi)
        return rng.integers(lo, hi + 1, size=shape).astype(np.bool_)
    info = np.iinfo(dt)
    lo = max(av.lo, int(info.min))
    hi = min(av.hi, int(info.max))
    return rng.integers(lo, hi + 1, size=shape, dtype=np.int64).astype(dt)


def draw_args(cell: KernelCell, rng) -> list:
    """The cell's arguments for one draw, as numpy arrays."""
    return [_draw(rng, s, av) for s, av in zip(cell.shapes, cell.in_avs)]


def _run(fn, args, dev) -> list:
    """The outputs of ``fn`` (a cell's ``fn`` or ``plain``), as numpy
    arrays, on copies of the numpy ``args`` on ``dev``."""
    outs = fn(*(torch.from_numpy(np.array(a)).to(dev) for a in args))
    return [o.cpu().numpy() for o in outs]


def _differs(cell: KernelCell, args, outs) -> List[dict]:
    """Every output that is not, element for element, what the cell's
    plain version gives on the CPU for the same ``args``, nor one of the
    values ``cell.either`` leaves open there: one record each
    (``kind="plain"``, the number of differing elements and the first
    one's flat index, the kernel's value and the plain version's)."""
    found = []
    for i, (got, want) in enumerate(zip(outs, _run(cell.plain, args, "cpu"))):
        if got.shape != want.shape or got.dtype != want.dtype:
            found.append(dict(out=i, kind="plain",
                              concrete=[str(got.dtype), list(got.shape)],
                              abstract=[str(want.dtype), list(want.shape)]))
            continue
        bad = np.flatnonzero(got.ravel() != want.ravel())
        if cell.either is not None:
            bad = np.array([k for k in bad if got.ravel()[k]
                            not in cell.either(args, i, int(k))], dtype=int)
        if bad.size:
            at = int(bad[0])
            found.append(dict(out=i, kind="plain", n_differ=int(bad.size),
                              index=at, concrete=int(got.ravel()[at]),
                              abstract=int(want.ravel()[at])))
    return found


def _escapes(cell: KernelCell, outs) -> List[dict]:
    """Every output that leaves its declared bound: the ``contains``
    records with the output's index."""
    return [dict(out=i, **v)
            for i, (arr, av) in enumerate(zip(outs, cell.out_avs))
            for v in contains(av, arr)]


def analyze_call(call, out_avs, name: str, lib: str, engine: str = "",
                 broken: bool = False):
    """Run ``call()`` (which returns a tuple of tensors) in the
    bound-checked build, ``broken`` in the test-only one without the
    kernel's clamp; returns ``(outputs as numpy arrays, findings)``: what
    the guards recorded, and ``ref-read-before-init`` for every output,
    poisoned before the launch, that left its declared bound
    ``out_avs[i]``.  ``name`` and ``lib`` name the kernel (its entry point
    is ``hermes_<name>``) and its ``csrc/<lib>.cu`` in those findings."""
    with dispatch.checked_build(broken) as chk:
        outs = [o.cpu().numpy() for o in call()]
    found = F.guard_findings(chk, engine)
    for i, (arr, av) in enumerate(zip(outs, out_avs)):
        found += [F.uninit_finding(engine, name, lib, i, v)
                  for v in contains(av, arr)]
    return outs, found


def analyze_kernel(cell: KernelCell, device="cuda", seed: int = 0) -> dict:
    """Run one kernel cell in the bound-checked build on a seeded draw;
    returns a report shaped like the reference's ``analyze_kernel``
    (``engine="kernel/<name>"``, ``proved``, ``findings``), with
    ``n_sites``, the guarded accesses of the kernel's source, where the
    reference has ``n_eqns``.  ``proved["refhazard"]`` counts those sites
    when the run raised no error.  On a CPU device the plain version runs
    and an info finding says that nothing was bound-checked."""
    dev = resolve(device)
    engine = f"kernel/{cell.name}"
    args = [torch.from_numpy(a).to(dev)
            for a in draw_args(cell, np.random.default_rng(seed))]
    _outs, found = analyze_call(lambda: cell.fn(*args), cell.out_avs,
                                cell.lib, cell.lib, engine)
    on_card = dev.type == "cuda"
    if not on_card:
        found.append(F.plain_finding(engine, cell.name))
    n_sites = dispatch.guard_sites(cell.lib)
    clean = on_card and not any(f.severity == F.ERROR for f in found)
    return dict(engine=engine, n_sites=n_sites,
                build="checked" if on_card else "plain",
                proved={F.PASS_NAME: n_sites if clean else 0},
                findings=found)


def diff_check(cell: KernelCell, n_draws: int = 3, seed: int = 0,
               device="cuda", checked: bool = False) -> dict:
    """Run the kernel on ``n_draws`` seeded concrete inputs drawn from the
    declared bounds; every concrete output element must lie inside its
    declared interval and possible-ones mask, and equal the plain version's
    on the CPU on the same draw (``kind="plain"``; the bounds alone would
    pass a kernel that miscomputes inside them, and several are the whole
    type).  ``checked`` runs the draws in the bound-checked build, where a
    guard that fires is a violation too (``kind="guard"``).  Returns
    ``dict(cell, ok, n_draws, violations, seconds)``, the violations in the
    reference's form."""
    dev = resolve(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    violations = []
    for d in range(n_draws):
        args = draw_args(cell, rng)
        if checked:
            with dispatch.checked_build() as chk:
                outs = _run(cell.fn, args, dev)
            violations += [dict(draw=d, out=None, kind="guard",
                                concrete=v["index"], abstract=v["extent"])
                           for v in chk.violations]
        else:
            outs = _run(cell.fn, args, dev)
        violations += [dict(draw=d, **v) for v in _escapes(cell, outs)
                       + _differs(cell, args, outs)]
    return dict(cell=cell.name, ok=not violations, n_draws=n_draws,
                violations=violations,
                seconds=round(time.perf_counter() - t0, 3))


def run_kernel_matrix(n_draws: int = 3, seed: int = 0, device="cuda",
                      checked: bool = False) -> List[dict]:
    """Analyze and sanitize every registered kernel cell (what
    ``--kernels`` runs).  Each entry: the ``analyze_kernel`` report plus a
    ``sanitizer`` dict (its draws in the release build, or with
    ``checked`` in the bound-checked one), the cell's wall time and its
    note."""
    out = []
    for cell in kernel_cells():
        t0 = time.perf_counter()
        rep = analyze_kernel(cell, device, seed)
        rep["sanitizer"] = diff_check(cell, n_draws=n_draws, seed=seed,
                                      device=device, checked=checked)
        rep["seconds"] = round(time.perf_counter() - t0, 3)
        rep["note"] = cell.note
        out.append(rep)
    return out
