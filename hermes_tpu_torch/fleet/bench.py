"""Fleet bench cells: per-group and concurrent committed writes/s.  The
port of ``hermes_tpu/fleet/bench.py``.

Each group runs its raw throughput loop (``faststep.build_fast_scan``
over a device-generated op stream), ``rounds`` rounds a dispatch:

  * ``per_group`` — each group timed ALONE, and
    ``aggregate_writes_per_sec`` their sum, the figure the reference
    reports as the fleet's scale-out capacity: it assumes one device a
    group, whose groups then overlap perfectly;
  * ``concurrent`` — every group's chunks dispatched together, one wall
    for all of them.

On ONE card the groups time-share the card and its stream (no stream a
group), so the concurrent cell is the fleet's number there and the summed
"alone" rate ``aggregate_writes_per_sec`` (the reference's name) is NOT a
capacity; ``one_card`` says so.  Rates are on the host clock, each window
ending in a device sync.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch



def _fleet_cfg(fcfg, g: int):
    cfg = fcfg.group_cfg(g)
    if not cfg.device_stream:
        raise ValueError(
            "fleet bench cells drive the raw scan round: the group config "
            "needs device_stream=True (counter-hash op streams)")
    return cfg


def _chunks(cfg, rounds: int, dev):
    """(state, stream, chunk_fn) for one group on one device."""
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.workload import ycsb

    fs = fst.init_fast_state(cfg, dev)
    stream = fst.prep_stream(ycsb.stub_stream(cfg), dev)
    return fs, stream, fst.build_fast_scan(cfg, rounds)


def _commits(fs) -> int:
    m = fs.meta
    return int((m.n_write.sum() + m.n_rmw.sum()).item())


def _sync(devs) -> None:
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def run_fleet_cells(fcfg, rounds: int = 20, chunks: int = 2,
                    warmup_chunks: int = 1, devices: Optional[list] = None,
                    device="cuda") -> dict:
    """Measure the fleet (module docstring): per-group cells alone, group
    0's as the single-group baseline, and the concurrent cell.  Groups go
    round-robin over ``devices`` (default: every visible card for
    ``device="cuda"``, else ``device``)."""
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.fleet.core import _placement

    devs = _placement(device, devices)
    G = fcfg.groups
    states = []
    for g in range(G):
        cfg = _fleet_cfg(fcfg, g)
        dev = devs[g % len(devs)]
        fs, stream, chunk = _chunks(cfg, rounds, dev)
        states.append(dict(g=g, cfg=cfg, dev=dev, fs=fs, stream=stream,
                           chunk=chunk, ctl=fst.make_fast_ctl(cfg, 0, dev)))

    def dispatch(st, c):
        # one ctl a group: its compiled chunk bound the step and advances
        # it, so the step is only re-seeded in place
        st["ctl"].step.fill_(c * rounds)
        st["fs"] = st["chunk"](st["fs"], st["stream"],
                               st["ctl"]._replace(host_step=c * rounds))

    for st in states:  # warm every group (first build, first chunk)
        for c in range(warmup_chunks):
            dispatch(st, c)
    _sync(devs)
    base = [_commits(st["fs"]) for st in states]

    # -- per-group cells: each group timed ALONE ----------------------------
    per_group = []
    for st in states:
        t0 = time.perf_counter()
        for c in range(warmup_chunks, warmup_chunks + chunks):
            dispatch(st, c)
        _sync([st["dev"]])
        wall = time.perf_counter() - t0
        commits = _commits(st["fs"]) - base[st["g"]]
        per_group.append(dict(
            group=st["g"], writes_per_sec=commits / wall,
            commits=commits, rounds=chunks * rounds, wall_s=wall,
            device=str(st["dev"])))
    aggregate = sum(c["writes_per_sec"] for c in per_group)

    # -- concurrent cell: every group's chunks in flight together -----------
    base = [_commits(st["fs"]) for st in states]
    t0 = time.perf_counter()
    for c in range(warmup_chunks + chunks, warmup_chunks + 2 * chunks):
        for st in states:
            dispatch(st, c)
    _sync(devs)
    conc_wall = time.perf_counter() - t0
    conc_commits = sum(_commits(st["fs"]) - b for st, b in zip(states, base))

    # group 0's own cell is a single group timed alone at the same shape
    # (vary_seed adds 0 to its seed): the scale-out denominator
    cfg0 = _fleet_cfg(fcfg, 0)
    single = {k: per_group[0][k]
              for k in ("writes_per_sec", "commits", "rounds", "wall_s")}
    cards = len({str(d) for d in devs if d.type == "cuda"})
    one_card = cards == 1 and G > 1
    return dict(
        groups=G,
        per_group=per_group,
        aggregate_writes_per_sec=aggregate,
        single_group=single,
        scaleout_x=aggregate / max(1e-9, single["writes_per_sec"]),
        concurrent=dict(
            writes_per_sec=conc_commits / conc_wall,
            commits=conc_commits, wall_s=conc_wall,
            rounds=chunks * rounds * G,
            note="every group's chunks in flight at once: the fleet's "
                 "number when groups share a device and its stream"),
        one_card=one_card,
        host_cores=os.cpu_count(),
        devices=len(devs),
        shape=dict(
            n_replicas=cfg0.n_replicas, n_keys=cfg0.n_keys,
            n_sessions=cfg0.n_sessions, value_words=cfg0.value_words,
            rounds_per_dispatch=rounds),
        platform=devs[0].type,
    )
