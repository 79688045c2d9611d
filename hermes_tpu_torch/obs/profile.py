"""The round's op census, its per-fusion ledger and the census gate: the
port's counterpart of ``hermes_tpu/obs/profile.py``.

The reference counts the StableHLO ops of an abstractly lowered round.
PyTorch has no abstract lowering, so the census here runs ONE real round
(a fresh state, round 0: a replay-scan round, as the reference's lowered
program holds the scan) and counts what it dispatches:

* every aten op, seen by a ``TorchDispatchMode``.  Gather-like ops
  (``index.Tensor``, ``index_select``, ``gather``, ``take``),
  scatter-like ops (``index_put(_)``, ``scatter*``, ``index_add(_)``,
  ``index_copy(_)``) and ``sort``/``topk``/``argsort`` are **sparse**;
* every call through the replica group's ``gather_src``, ``route_back``,
  ``psum``, ``pmax`` and ``pmin`` is a **collective**; the ops inside a
  collective are not counted, so a ``LocalGroup`` and a ``DistGroup``
  give one census;
* a hand-kernel call (``core/dispatch.hand_kernel``) is ONE op,
  ``kernel:<name>``, whatever runs inside it: the plain version on the
  CPU, the CUDA kernel on the card.  So the aten census is the same on
  both devices (the counterpart of the reference's
  ``pallas_ledger_of_jaxpr``);
* on the card also ``kernel_total``: the CUDA kernels one round
  launches, from ``torch.profiler`` (two agreeing traces,
  ``profiling.device_launches``).

The census leaves no trace: it builds its own state and puts back the
wrappers' ``launches`` counters.  The reference's kernel-interior fields
(``pallas_interior_sparse``, ``pallas_serial_iter_bound``,
``pallas_while_loops``) and its ``COST_LO``/``COST_HI`` pricing are a TPU
cost model with no CUDA meaning: the records keep the ``modeled_*`` keys
as None.

    python -m hermes_tpu_torch.obs.profile [S] [C] [--rounds N] [--reps N]
        [--census-only] [--out PROFILE_JSONL] [--device cpu]
    python -m hermes_tpu_torch.obs.profile --check [--update] [--device cpu]

``--check`` is the port's census gate: the eight sections of
``op_budget.json`` measured at the gate shape (``gate_cfg``: the bench
shape on the card, a cut of it on the CPU; the census does not depend on
the shape) against their ceilings, and on the card the ``card``
section's ``kernel_total`` counts too, held to equality
(``check_card``).  ``--update`` rewrites the
measured fields of ``op_budget.json`` and nothing else.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hermes_tpu_torch.core import dispatch

#: aten ops (overload packets) of each sparse class
GATHER_OPS = frozenset({"index", "index_select", "gather", "take"})
SCATTER_OPS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_copy", "index_copy_"})
SORT_OPS = frozenset({"sort", "topk", "argsort"})
SPARSE = ("gather", "scatter", "sort")
#: the replica group's collectives (core/group.py)
COLLECTIVE = ("gather_src", "route_back", "psum", "pmax", "pmin")

BUDGET_PATH = pathlib.Path(__file__).with_name("op_budget.json")
#: the budget file's section of card-only counts (kernel_total)
CARD = "card"
ENGINES = ("batched", "sharded", "batched_mega", "sharded_mega")


class _Census(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active, but none made
    inside a hand-kernel wrapper or a collective."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.coll: collections.Counter = collections.Counter()
        self.quiet = 0  # collectives in progress

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.quiet and not dispatch.in_hand_kernel():
            self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


class _CountedGroup:
    """A replica group whose collectives the census counts as one op
    each; everything else is the group's own."""

    def __init__(self, group, census: _Census):
        self._group = group
        self._census = census

    def __getattr__(self, name):
        return getattr(self._group, name)

    def _call(self, name, x):
        self._census.coll[name] += 1
        self._census.quiet += 1
        try:
            return getattr(self._group, name)(x)
        finally:
            self._census.quiet -= 1

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


def _census_dict(mode: _Census, kernels: dict) -> dict:
    ops = mode.ops
    out = {"gather": sum(ops[n] for n in GATHER_OPS),
           "scatter": sum(ops[n] for n in SCATTER_OPS),
           "sort": sum(ops[n] for n in SORT_OPS)}
    out["sparse_total"] = sum(out[k] for k in SPARSE)
    for c in COLLECTIVE:
        out[c] = mode.coll[c]
    out["collective_total"] = sum(mode.coll[c] for c in COLLECTIVE)
    out["hand_kernel_calls"] = sum(kernels.values())
    for name in sorted(kernels):
        out[f"kernel:{name}"] = kernels[name]
    out["aten_total"] = sum(ops.values())
    out["aten_ops"] = dict(sorted(ops.items()))
    return out


@contextlib.contextmanager
def _launches_kept():
    """Put every hand-kernel wrapper's ``launches`` back as it was."""
    saved = {n: w.launches for n, w in dispatch.HAND_KERNELS.items()}
    try:
        yield
    finally:
        for n, w in dispatch.HAND_KERNELS.items():
            w.launches = saved[n]


def count_ops(run, keep_launches: bool = False) -> dict:
    """The census of what ``run(mode)`` dispatches (``mode`` wraps a
    replica group: ``_CountedGroup(group, mode)``), with the launch
    counters put back unless ``keep_launches``."""
    mode = _Census()
    kept = contextlib.nullcontext() if keep_launches else _launches_kept()
    with kept, dispatch.count_hand_kernels() as kernels:
        with mode:
            run(mode)
    return _census_dict(mode, kernels)


# --------------------------------------------------------------------------
# The round census
# --------------------------------------------------------------------------


def census_shape(cfg) -> dict:
    """The config knobs that identify a census cell (the reference's)."""
    return dict(n_replicas=cfg.n_replicas, n_keys=cfg.n_keys,
                n_sessions=cfg.n_sessions, lane_budget=cfg.lane_budget,
                value_words=cfg.value_words, chain_writes=cfg.chain_writes,
                arb_mode=cfg.arb_mode, fused_sort=cfg.use_fused_sort)


def _round_args(cfg, backend: str, dev, group=None):
    """A fresh (fs, stream, ctl) of round 0 and the group (sharded)."""
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.workload import ycsb

    raw = ycsb.stub_stream(cfg) if cfg.device_stream \
        else ycsb.make_streams(cfg)
    ctl = fst.make_fast_ctl(cfg, 0, dev)
    if backend == "batched":
        return (fst.init_fast_state(cfg, dev), fst.prep_stream(raw, dev),
                ctl, None)
    if backend != "sharded":
        raise ValueError(f"unknown backend {backend!r}")
    group = group if group is not None else LocalGroup(dev)
    lo = group.first(cfg.n_replicas)
    rows = slice(lo, lo + group.n_local(cfg.n_replicas))
    ctl = ctl._replace(my_cid=ctl.my_cid[rows], epoch=ctl.epoch[rows],
                       live_mask=ctl.live_mask[rows],
                       frozen=ctl.frozen[rows])
    fs, stream = fst.place_fast_sharded(cfg, group, raw)
    return fs, stream, ctl, group


def _run_round(cfg, backend, fs, stream, ctl, group):
    from hermes_tpu_torch.core import faststep as fst

    if backend == "batched":
        return fst.fast_round_batched(cfg, ctl, fs, stream)
    return fst.fast_round_sharded(cfg, ctl, fs, stream, group)


def op_census(cfg, backend: str = "batched", device="cuda",
              group=None, count_kernels: bool = True,
              keep_launches: bool = False) -> dict:
    """The census of ONE round of ``cfg`` on ``backend`` (``"batched"``
    or ``"sharded"``; ``group`` defaults to a ``LocalGroup``), run on a
    fresh state on ``device``; on the card with ``kernel_total`` unless
    not ``count_kernels``.  ``keep_launches`` leaves the round's kernel
    launches on the wrappers' counters."""
    from hermes_tpu_torch import device as device_lib

    dev = device_lib.resolve(device)
    fs, stream, ctl, grp = _round_args(cfg, backend, dev, group)
    cen = count_ops(lambda mode: _run_round(
        cfg, backend, fs, stream, ctl,
        grp and _CountedGroup(grp, mode)), keep_launches)
    if dev.type == "cuda" and count_kernels:
        cen["kernel_total"] = kernel_total(cfg, backend, dev, group)
    return cen


def kernel_total(cfg, backend: str, dev, group=None) -> int:
    """The CUDA kernels one round launches on the card (a fresh state a
    trace, built outside it), the launch counters put back."""
    from hermes_tpu_torch.profiling import device_launches

    with _launches_kept():
        return device_launches(
            lambda: _round_args(cfg, backend, dev, group),
            lambda a: _run_round(cfg, backend, *a))


# --------------------------------------------------------------------------
# Per-fusion ledger
# --------------------------------------------------------------------------


def _stage_fns(cfg):
    """Ordered prefixes of the batched round, each up to a protocol
    fusion boundary (the reference's): consecutive deltas attribute ops
    and time to the fusion added between them.  Each takes and returns
    ``fs``."""
    from hermes_tpu_torch.core import faststep as fst

    def coordinate(ctl, fs, stream):
        return fst._coordinate(cfg, ctl, fs, stream)[0]

    def apply_inv(ctl, fs, stream):
        fs2, lanes, _slot_lane, taken_lane, *_ = fst._coordinate(
            cfg, ctl, fs, stream)
        return fst._apply_inv_lanes(cfg, ctl, fs2, lanes, taken_lane)[0]

    def full(ctl, fs, stream):
        return fst.fast_round_batched(cfg, ctl, fs, stream)[0]

    return [("coordinate", coordinate), ("apply_inv", apply_inv),
            ("acks_commit_val", full)]


def _timed_stage(cfg, fn, dev, rounds: int, reps: int) -> float:
    """Median ms a round of ``rounds`` chained calls of ``fn``, after one
    untimed chunk; each chunk ends in a device sync on the card."""
    fs, stream, ctl, _ = _round_args(cfg, "batched", dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def chunk(fs, first):
        for off in range(rounds):
            c = first + off
            fs = fn(ctl._replace(step=ctl.step + c, host_step=c), fs, stream)
        return fs

    fs = chunk(fs, 0)
    sync()
    ts = []
    for rep in range(1, reps + 1):
        t0 = time.perf_counter()
        fs = chunk(fs, rep * rounds)
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] / rounds * 1e3


def round_ledger(cfg, rounds: int = 30, reps: int = 3,
                 time_stages: bool = True, device="cuda") -> dict:
    """The per-fusion ledger of the batched round at cfg's shape:
    ``stages`` rows carry each fusion's sparse-op delta and, with
    ``time_stages``, its ms-a-round delta on the host clock (ending in a
    device sync on the card); ``census`` is the full round's.  The
    reference's ``modeled_ms`` is a TPU cost model: None here."""
    from hermes_tpu_torch import device as device_lib

    dev = device_lib.resolve(device)
    rows = []
    prev: Optional[dict] = None
    prev_ms: Optional[float] = None
    full = None
    for name, fn in _stage_fns(cfg):
        fs, stream, ctl, _ = _round_args(cfg, "batched", dev)
        cen = count_ops(lambda mode: fn(ctl, fs, stream))
        ms = _timed_stage(cfg, fn, dev, rounds, reps) if time_stages \
            else None
        ops = {k: cen[k] - (prev[k] if prev else 0)
               for k in SPARSE + COLLECTIVE
               if cen[k] - (prev[k] if prev else 0)}
        rows.append({
            "fusion": name, "ops": ops,
            "sparse_delta": cen["sparse_total"] - (
                prev["sparse_total"] if prev else 0),
            "modeled_ms": None,
            "ms": None if ms is None else round(ms - (prev_ms or 0.0), 3),
        })
        prev, prev_ms, full = cen, ms, cen
    return {"shape": census_shape(cfg),
            "rounds": rounds if time_stages else 0,
            "census": full, "stages": rows,
            "round_ms": None if prev_ms is None else round(prev_ms, 3)}


# --------------------------------------------------------------------------
# Budget gate + JSONL export
# --------------------------------------------------------------------------


def check_budget(census_by_engine: dict, budget: dict) -> list:
    """The gate predicate, the reference's: for every engine in
    ``budget``, every budgeted count in the measured census must not
    exceed its ceiling.  Returns the failures (empty: the gate passes).
    A budgeted engine with no census, or a budgeted metric the census
    lacks, is a failure."""
    failures = []
    for engine, limits in sorted(budget.items()):
        cen = census_by_engine.get(engine)
        if cen is None:
            failures.append(f"{engine}: no census measured for budgeted engine")
            continue
        for metric, ceiling in sorted(limits.items()):
            got = cen.get(metric)
            if got is None:
                failures.append(f"{engine}: census lacks budgeted metric "
                                f"{metric!r}")
            elif got > ceiling:
                failures.append(
                    f"{engine}: {metric} = {got} exceeds budget {ceiling} — "
                    f"an op or a launch crept back onto the round; take it "
                    f"off again or raise hermes_tpu_torch/obs/op_budget.json "
                    f"with the measurement that justifies it")
    return failures


def check_card(census_by_engine: dict, card: dict) -> list:
    """The card section's rule: each engine's ``kernel_total`` must EQUAL
    the recorded count, since one round on a fresh state launches the same
    kernels every time; a count above it is a launch that crept onto the
    round, one below it a lost profiler record or a state left behind by
    earlier work that changes what a round launches.  Returns the
    failures (``check_budget``'s, and every count below its record)."""
    failures = check_budget(census_by_engine, card)
    for engine, limits in sorted(card.items()):
        for metric, want in sorted(limits.items()):
            got = census_by_engine.get(engine, {}).get(metric)
            if got is not None and got < want:
                failures.append(
                    f"{engine}: {metric} = {got} is below the recorded "
                    f"{want} — a round launches the same kernels every "
                    f"time; find what dropped them")
    return failures


def export_profile(path_or_fp, records, extra: Optional[dict] = None) -> None:
    """Write profile records as obs run-log JSONL (``kind="profile"``,
    the exporter's monotonic ``t`` stamp)."""
    from hermes_tpu_torch.obs.metrics import JsonlExporter

    own = isinstance(path_or_fp, (str, pathlib.Path))
    fp = open(path_or_fp, "w") if own else path_or_fp
    try:
        exp = JsonlExporter(fp, stamp=True)
        for rec in records:
            exp.write({**extra, **rec} if extra else rec, kind="profile")
    finally:
        if own:
            fp.close()


def round_record(census: dict, **extra) -> dict:
    """One ``"round"`` profile record: the census (the reference's
    schema; its cost-model pricing is None here)."""
    return dict(record="round", census=census, modeled_sparse_ms=None,
                **extra)


def ledger_records(ledger: dict) -> list:
    """A ``round_ledger()`` result as JSONL records: one summary record,
    then one a fusion stage."""
    head = {k: ledger[k] for k in ("shape", "rounds", "census", "round_ms")}
    head["record"] = "round"
    return [head] + [{"record": "fusion", **row} for row in ledger["stages"]]


# --------------------------------------------------------------------------
# The census gate
# --------------------------------------------------------------------------


def gate_cfg(small: bool):
    """The gate's round config: ``config.bench_cfg("a")``; ``small`` cuts
    it to 2^12 keys and 256 sessions a replica (the lane budget stays 3/4
    of them), which the CPU can run."""
    from hermes_tpu_torch.config import bench_cfg

    return bench_cfg("a", over=dict(n_keys=1 << 12, n_sessions=256,
                                    replay_slots=16) if small else None)


def heap_cfg(cfg):
    """The heap sections' config (the reference gate's)."""
    return dataclasses.replace(cfg, value_words=max(3, cfg.value_words),
                               max_value_bytes=1024, heap_bytes=1 << 22)


def measure(device="cuda") -> dict:
    """The eight census sections at the gate shape on ``device``: the
    bench shape on the card, its cut on the CPU."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.core import readpath
    from hermes_tpu_torch.heap import core as heap

    dev = device_lib.resolve(device)
    cfg = gate_cfg(small=dev.type == "cpu")
    mega = dataclasses.replace(cfg, mega_round=True)
    hcfg = heap_cfg(cfg)
    return {
        "batched": op_census(cfg, "batched", dev),
        "sharded": op_census(cfg, "sharded", dev),
        "batched_mega": op_census(mega, "batched", dev),
        "sharded_mega": op_census(mega, "sharded", dev),
        "read_path": readpath.read_census(cfg, "batched", device=dev),
        "read_scan": readpath.scan_census(cfg, "batched", device=dev),
        "heap_path": heap.gather_census(hcfg, batch=1024, device=dev),
        "heap_append": heap.append_census(hcfg, chunk=4096, device=dev),
    }


def load_budget(path=BUDGET_PATH):
    """(budget, card budget) of ``op_budget.json``: the sections the CPU
    measures, and the ``card`` section's counts."""
    doc = json.loads(pathlib.Path(path).read_text())
    return ({k: v for k, v in doc.items()
             if not k.startswith("_") and k != CARD}, doc.get(CARD, {}))


def gate(device="cuda", path=BUDGET_PATH, update: bool = False) -> dict:
    """Measure, then hold the census to ``op_budget.json`` (on the card
    also the ``card`` section); ``update`` rewrites the measured fields
    instead of failing.  Returns the report (``ok``, ``census``,
    ``budget_failures``)."""
    measured = measure(device)
    budget, card = load_budget(path)
    on_card = "kernel_total" in measured["batched"]
    if update:
        doc = json.loads(pathlib.Path(path).read_text())
        for sec, lim in budget.items():
            doc[sec] = {k: measured[sec][k] for k in lim
                        if k in measured[sec]}
        if on_card:
            doc[CARD] = {e: {"kernel_total": measured[e]["kernel_total"]}
                         for e in ENGINES}
        pathlib.Path(path).write_text(json.dumps(doc, indent=1) + "\n")
        budget, card = load_budget(path)
    failures = check_budget(measured, budget)
    if on_card:
        failures += check_card(measured, card)
    return dict(ok=not failures, census=measured, budget_failures=failures)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _cli_cfg(S: int, C: int, arb_mode: str = "race", chain_writes: int = 0,
             fused_sort: bool = True):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=8, n_keys=1 << 20, value_words=8, n_sessions=S,
        replay_slots=256, ops_per_session=128, wrap_stream=True,
        lane_budget_cfg=C, rebroadcast_every=4, replay_scan_every=32,
        arb_mode=arb_mode, chain_writes=chain_writes, fused_sort=fused_sort,
        workload=WorkloadConfig(read_frac=0.5, seed=0),
    )


def _slim(cen: dict) -> dict:
    return {k: v for k, v in cen.items() if k != "aten_ops"}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m hermes_tpu_torch.obs.profile",
        description="Per-fusion ledger and op census of the fast round; "
        "--check: the census gate against op_budget.json.")
    ap.add_argument("sessions", nargs="?", type=int, default=16384)
    ap.add_argument("lane_budget", nargs="?", type=int, default=None,
                    help="default: sessions // 2")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--arb-mode", choices=["race", "sort"], default="race")
    ap.add_argument("--chain-writes", type=int, default=0)
    ap.add_argument("--split-sort", action="store_true",
                    help="the split two-sort program (sort arbiter only)")
    ap.add_argument("--census-only", action="store_true",
                    help="skip timing")
    ap.add_argument("--out", default=None, metavar="PROFILE_JSONL",
                    help="also export the ledger as obs-schema JSONL "
                    "records (kind=profile)")
    ap.add_argument("--check", action="store_true",
                    help="the census gate: the eight sections at the gate "
                    "shape against op_budget.json")
    ap.add_argument("--update", action="store_true",
                    help="with --check: rewrite op_budget.json's measured "
                    "fields instead of failing")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.update and not args.check:
        ap.error("--update needs --check")

    if args.check:
        rep = gate(args.device, update=args.update)
        for f in rep["budget_failures"]:
            print(f"BUDGET: {f}", file=sys.stderr)
        print(json.dumps(dict(
            ok=rep["ok"], device=str(args.device),
            census={k: _slim(v) for k, v in rep["census"].items()},
            budget_failures=rep["budget_failures"])))
        return 0 if rep["ok"] else 1

    cfg = _cli_cfg(args.sessions, args.lane_budget or args.sessions // 2,
                   arb_mode=args.arb_mode, chain_writes=args.chain_writes,
                   fused_sort=not args.split_sort)
    led = round_ledger(cfg, rounds=args.rounds, reps=args.reps,
                       time_stages=not args.census_only, device=args.device)
    print(f"S={cfg.n_sessions} C={cfg.lane_budget} "
          f"fused_sort={cfg.use_fused_sort} device={args.device}",
          file=sys.stderr)
    for row in led["stages"]:
        ms = "      -" if row["ms"] is None else f"{row['ms']:7.2f}"
        print(f"  {row['fusion']:<16}: {ms} ms  +{row['sparse_delta']} sparse "
              f"{row['ops']}", file=sys.stderr)
    print(f"  census: sparse_total={led['census']['sparse_total']} "
          f"collective_total={led['census']['collective_total']} "
          f"round_ms={led['round_ms']}", file=sys.stderr)
    if args.out:
        export_profile(args.out, ledger_records(led),
                       extra=dict(device=str(args.device)))
    print(json.dumps(dict(sparse_total=led["census"]["sparse_total"],
                          collective_total=led["census"]["collective_total"],
                          round_ms=led["round_ms"], device=str(args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
