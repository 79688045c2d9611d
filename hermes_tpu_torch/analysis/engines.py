"""Trace the engine programs and run the analysis over them: the port's
counterpart of ``hermes_tpu/analysis/engines.py``.

``trace_program`` records one protocol round, batched or sharded, fused or
split sort, of a config as an FX graph (``analysis/graph.py``) on the
caller's device: the state, the stream and the control are built as fake
tensors, so nothing is materialized and a bench-shape round traces in
seconds.  The sharded round runs over a ``LocalGroup`` of the device,
wrapped so that its collectives are nodes.  The round traced is round 0
with ``host_step`` 0, the round that runs the gated replay scan (as the
reference's program holds the scan).  The program pairs the graph with
the config-seeded input bounds (``analysis/seeds.py``) and the engine's
declared axes; ``analyze_program`` walks it with the passes.

``analyze_config`` is what the CLI, ``--analyze`` and the gate
share: the engines x (as configured + the split-sort variant when the
config resolves the fused sort).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch
from torch.utils import _pytree as pytree

from hermes_tpu_torch.analysis import graph as G
from hermes_tpu_torch.analysis import seeds as seeds_lib
from hermes_tpu_torch.analysis.interp import Ctx, eval_graph
from hermes_tpu_torch.analysis.passes import default_passes, \
    interp_findings
from hermes_tpu_torch.config import HermesConfig

#: the sharded engine's one axis: the replicas
AXIS = "replica"


@dataclasses.dataclass
class Program:
    """One traced engine program and the facts the passes need."""

    engine: str  # "batched" | "sharded"
    variant: str  # "fused" | "split" | "race"
    graph: object  # the torch.fx.GraphModule
    in_avs: list
    mesh_axes: Optional[dict]  # {} for batched (no collectives allowed)
    cfg: HermesConfig
    seconds: float = 0.0  # the trace's

    @property
    def name(self) -> str:
        return f"{self.engine}/{self.variant}"


def flat_seeds(args, seed_tree) -> list:
    """The seeds of the tensor leaves of ``args``, in pytree order; raises
    when the seed tree no longer mirrors the arguments (a state field was
    added or renamed without declaring its bound in analysis/seeds.py)."""
    leaves, spec = pytree.tree_flatten(args)
    sleaves, sspec = pytree.tree_flatten(seed_tree)
    if spec != sspec:
        raise ValueError(
            "seed tree no longer matches the engine's arguments: a state "
            "field was added or renamed without declaring its bound in "
            f"analysis/seeds.py (engine {spec}, seeds {sspec})")
    out = []
    for leaf, seed in zip(leaves, sleaves):
        if isinstance(leaf, torch.Tensor):
            if seed == seeds_lib.HOST:
                raise ValueError("a tensor argument is seeded as a host "
                                 "value in analysis/seeds.py")
            out.append(seed)
        elif seed != seeds_lib.HOST and not (leaf is None and seed is None):
            raise ValueError(f"a host argument ({leaf!r}) has a tensor "
                             f"seed {seed} in analysis/seeds.py")
    return out


def variant_of(cfg: HermesConfig) -> str:
    if cfg.use_fused_sort:
        return "fused"
    return "split" if cfg.arb_mode == "sort" else "race"


def trace_program(cfg: HermesConfig, engine: str = "batched",
                  device="cuda") -> Program:
    """The round of ``cfg`` on ``engine`` traced on ``device`` (raises when
    the card is asked for and absent)."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.workload import ycsb

    dev = device_lib.resolve(device)
    if engine not in ("batched", "sharded"):
        raise ValueError(f"unknown engine {engine!r}")
    raw = ycsb.stub_stream(cfg) if cfg.device_stream \
        else ycsb.make_streams(cfg)
    with G.fake_mode():
        ctl = fst.make_fast_ctl(cfg, 0, dev)
        if engine == "batched":
            args = (fst.init_fast_state(cfg, dev), fst.prep_stream(raw, dev),
                    ctl)

            def fn(fs, stream, ctl):
                return fst.fast_round_batched(cfg, ctl, fs, stream)

            mesh_axes: dict = {}
        else:
            group = G.TracedGroup(LocalGroup(dev), cfg.n_replicas, AXIS)
            fs, stream = fst.place_fast_sharded(cfg, group, raw)
            args = (fs, stream, ctl)

            def fn(fs, stream, ctl):
                return fst.fast_round_sharded(cfg, ctl, fs, stream, group)

            mesh_axes = {AXIS: cfg.n_replicas}
    gm, seconds = G.trace(fn, args)
    in_avs = flat_seeds(args, seeds_lib.seed_round_args(
        cfg, has_uval=args[1].uval is not None))
    return Program(engine=engine, variant=variant_of(cfg), graph=gm,
                   in_avs=in_avs, mesh_axes=mesh_axes, cfg=cfg,
                   seconds=seconds)


def analyze_program(prog: Program, passes=None) -> dict:
    """Run the passes over one traced program.  Returns the report dict:
    findings (engine-stamped), proof counts, node count, seconds."""
    ps = passes if passes is not None else default_passes(
        allow_float=prog.cfg.device_stream)
    ctx = Ctx(cfg=prog.cfg, mesh_axes=prog.mesh_axes, passes=ps)
    t0 = time.perf_counter()
    eval_graph(prog.graph, list(prog.in_avs), ctx)
    findings = []
    proved = {}
    for p in ps:
        findings.extend(p.results())
        proved[p.name] = p.n_proved
    findings.extend(interp_findings(ctx))
    for f in findings:
        f.engine = prog.name
    return dict(engine=prog.name, n_eqns=ctx.n_eqns, proved=proved,
                findings=findings, kernels=G.kernel_nodes(prog.graph),
                trace_seconds=round(prog.seconds, 3),
                seconds=round(prog.seconds + time.perf_counter() - t0, 3))


def analyze_config(cfg: HermesConfig, engines=("batched", "sharded"),
                   variants: str = "both", device="cuda") -> List[dict]:
    """The shared entry: each engine x (as configured + the split-sort
    program when the config resolves the fused sort).  ``variants``:
    "both" | "as-is"."""
    cfgs = [cfg]
    if variants == "both" and cfg.use_fused_sort:
        # the split program is the A/B baseline for both the fused sort
        # and the mega path, so the variant drops mega_round too (a split
        # mega config is not constructible: the mega route consumes the
        # fused sort's verdicts)
        cfgs.append(dataclasses.replace(cfg, fused_sort=False,
                                        mega_round=False))
    reports = []
    for engine in engines:
        for c in cfgs:
            reports.append(analyze_program(trace_program(c, engine, device)))
    return reports
