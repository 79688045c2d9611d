"""Process bootstrap for the sharded engine: the port of
``hermes_tpu/launch.py``'s ``init_distributed``, ``replica_mesh``,
``run``, ``fleet_meshes``, ``group_of_process`` and ``run_fleet``.

The reference boots one JAX process a host with ``jax.distributed`` and
runs the sharded round under ``shard_map`` over the global mesh.  Here a
run is one process holding every replica (a ``LocalGroup``, the card's
path), or W processes of one ``torch.distributed`` group holding R/W
replicas each (a ``DistGroup``): gloo on the CPU; NCCL on CUDA, with one
card a rank.  Nothing on a machine tells a process of its peers, so the
caller gives the rendezvous address (``tcp://host:port`` or a
``file://`` path), the world size and the rank.

    # one process, every replica on the card:
    python -m hermes_tpu_torch.launch --replicas 8 --steps 200
    # two processes on the CPU, four replicas each:
    python -m hermes_tpu_torch.launch --init file:///tmp/rdv --world-size 2 \\
        --rank $RANK --device cpu --replicas 8 --steps 200
    # a sharded fleet of four groups of eight replicas, one process:
    python -m hermes_tpu_torch.launch --fleet-groups 4 --replicas 8

A fleet's layout is a partition of replica groups: ``fleet_replica_groups``
gives one ``LocalGroup`` a fleet group (round-robin over the visible
cards; on one card they all share it), and ``group_of_rank`` names the
fleet groups a rank serves when a multi-process run lays the (groups,
replicas) grid row-major over its ranks.  ``run_fleet`` runs one process
holding every group, or W ranks: then each fleet group is a
``torch.distributed`` subgroup over the ranks its replicas sit on
(``fleet_rank_layout``), each rank holding an equal contiguous block of
the group's replicas as a ``DistGroup`` over that subgroup.

    # two fleet groups of four replicas over four ranks on the CPU:
    python -m hermes_tpu_torch.launch --fleet-groups 2 --replicas 4 \\
        --world-size 4 --rank $RANK --init file:///tmp/rdv --device cpu

The serving topologies (``hermes_tpu_torch.serving``):
``start_serve_workers`` starts N columnar serving worker processes that
shard TCP accepts on one SO_REUSEPORT port, each with a PRIVATE store
(on the card: a CUDA context each); ``start_one_store`` keeps ONE store
in this process and starts N torch-free shm front-end processes feeding
it over shared-memory column rings.  Both use ``spawn``: a forked child
of a process with a CUDA context cannot use CUDA.

    # four shm front ends feeding one store on the card, for 30 s:
    python -m hermes_tpu_torch.launch --serve-workers 4 --one-store \
        --serve-seconds 30
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from hermes_tpu_torch.core.group import (DistGroup, LocalGroup, local_card,
                                         replica_devices)

__all__ = ["init_distributed", "replica_devices", "make_group", "run",
           "fleet_replica_groups", "group_of_rank", "fleet_rank_layout",
           "run_fleet",
           "ServeWorkers", "start_serve_workers", "start_one_store"]


def init_distributed(init_method: Optional[str] = None, world_size: int = 1,
                     rank: int = 0, device="cuda") -> None:
    """``torch.distributed.init_process_group`` for a multi-process run
    (a no-op for one process): gloo on the CPU, NCCL on the card."""
    if world_size <= 1:
        return
    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_method is None:
        raise ValueError("a multi-process run needs init_method "
                         "(tcp://host:port or file://path)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_group(world_size: int = 1, rank: int = 0, device="cuda"):
    """The replica group of this process: a ``LocalGroup`` for one
    process, else a ``DistGroup`` over the default process group (on the
    card, this rank's card on its own host: ``group.local_card``)."""
    if world_size <= 1:
        return LocalGroup(device)
    import torch

    if torch.device(device).type == "cuda":
        device = torch.device("cuda", local_card(rank))
    return DistGroup(None, device)


def run(cfg, steps: int, init_method: Optional[str] = None,
        world_size: int = 1, rank: int = 0, device="cuda"):
    """Boot (multi-process if asked), build the group and run the sharded
    fast round for ``steps`` rounds.  Returns the runtime."""
    from hermes_tpu_torch.runtime import FastRuntime

    init_distributed(init_method, world_size, rank, device)
    rt = FastRuntime(cfg, backend="sharded",
                     group=make_group(world_size, rank, device))
    rt.run(steps)
    return rt


def fleet_replica_groups(n_groups: int, device="cuda",
                         devices=None) -> list:
    """The replica groups of a one-process sharded fleet: one
    ``LocalGroup`` a fleet group, placed round-robin over ``devices``
    (default: every visible card for ``device="cuda"``, else ``device``),
    the counterpart of the reference's ``fleet_meshes`` (one disjoint
    submesh a group)."""
    from hermes_tpu_torch.fleet.core import _placement

    devs = _placement(device, devices)
    return [LocalGroup(devs[g % len(devs)]) for g in range(n_groups)]


def group_of_rank(n_groups: int, n_replicas: int, world_size: int = 1,
                  rank: int = 0) -> list:
    """The fleet groups rank ``rank`` serves in a ``world_size``-process
    run: the (groups, replicas) grid laid out row-major, each rank holding
    an equal contiguous block of its ``n_groups * n_replicas`` replicas,
    and serving every group with at least one replica in its block (the
    counterpart of the reference's ``group_of_process``)."""
    total = n_groups * n_replicas
    if world_size < 1 or total % world_size:
        raise ValueError(f"{total} replicas ({n_groups} groups of "
                         f"{n_replicas}) do not split over {world_size} "
                         "rank(s)")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    per = total // world_size
    lo, hi = rank * per, (rank + 1) * per
    return [g for g in range(n_groups)
            if g * n_replicas < hi and (g + 1) * n_replicas > lo]


def fleet_rank_layout(n_groups: int, n_replicas: int,
                      world_size: int) -> list:
    """The ranks of each fleet group in a ``world_size``-process run (the
    grid of ``group_of_rank``): ``layout[g]`` lists, in rank order, the
    ranks holding group g's replicas.  Raises on a layout in which a
    group's replicas split unevenly over its ranks: a ``DistGroup`` holds
    an equal contiguous block of its group on each of its ranks."""
    layout = [[] for _ in range(n_groups)]
    for r in range(world_size):
        for g in group_of_rank(n_groups, n_replicas, world_size, r):
            layout[g].append(r)
    per = n_groups * n_replicas // world_size
    for g, ranks in enumerate(layout):
        shares = [min((r + 1) * per, (g + 1) * n_replicas)
                  - max(r * per, g * n_replicas) for r in ranks]
        if len(set(shares)) != 1:
            raise ValueError(
                f"{n_groups} groups of {n_replicas} replicas over "
                f"{world_size} ranks: group {g}'s replicas split "
                f"{shares} over ranks {ranks}; each rank of a group must "
                "hold an equal share of it")
    return layout


def _fleet_subgroups(layout, device):
    """One ``torch.distributed`` subgroup a fleet group, made by EVERY
    rank in group order (torch requires each rank to enter each
    ``new_group``, member or not); on the card also the gloo side group
    a ``DistGroup`` compares its ranks' cards over.  A rank gets
    ``GroupMember.NON_GROUP_MEMBER`` for a group it is not in."""
    import torch
    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    out = []
    for ranks in layout:
        pg = dist.new_group(ranks=ranks)
        side = dist.new_group(ranks=ranks, backend="gloo") if cuda else None
        out.append((pg, side))
    return out


def run_fleet(fcfg, steps: int, init_method: Optional[str] = None,
              world_size: int = 1, rank: int = 0, device="cuda"):
    """Run a sharded FLEET: G independent group runtimes stepped in
    lockstep, each labeled with its group (``rt.fleet_group``).  One
    process: every group on a ``LocalGroup`` (``fleet_replica_groups``),
    group g = rts[g].  ``world_size`` > 1: boot the process group, make
    one subgroup a fleet group (``fleet_rank_layout``) and step, in group
    order, a ``DistGroup`` runtime for each group this rank serves
    (``group_of_rank``); the runtimes of those groups, in group order,
    after a barrier of every rank."""
    from hermes_tpu_torch.runtime import FastRuntime

    if world_size <= 1:
        local = fleet_replica_groups(fcfg.groups, device)
        served = list(range(fcfg.groups))
    else:
        R = fcfg.base.n_replicas
        odd = [g for g in range(fcfg.groups)
               if fcfg.group_cfg(g).n_replicas != R]
        if odd:
            raise ValueError(f"groups {odd} override n_replicas: a fleet "
                             "over ranks lays out groups of one size")
        layout = fleet_rank_layout(fcfg.groups, R, world_size)
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        init_distributed(init_method, world_size, rank, device)
        import torch

        if torch.device(device).type == "cuda":
            device = torch.device("cuda", local_card(rank))
        subgroups = _fleet_subgroups(layout, device)
        served = group_of_rank(fcfg.groups, R, world_size, rank)
    rts = []
    for g in served:
        group = (local[g] if world_size <= 1 else
                 DistGroup(subgroups[g][0], device,
                           side_group=subgroups[g][1]))
        rt = FastRuntime(fcfg.group_cfg(g), backend="sharded", group=group)
        rt.fleet_group = g
        rts.append(rt)
    for _ in range(steps):
        for rt in rts:
            rt.step_once()
    if world_size > 1:
        import torch.distributed as dist

        dist.barrier()
    return rts


class ServeWorkers:
    """Handle over an accept-sharded serving fleet: N worker processes,
    one SO_REUSEPORT listener each on ``addr``, started by
    ``start_serve_workers`` and joined by ``stop()``."""

    def __init__(self, procs, stop_ev, addr):
        self.procs = procs
        self.addr = addr
        self._stop_ev = stop_ev

    def alive(self) -> int:
        return sum(p.is_alive() for p in self.procs)

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop_ev.set()
        for p in self.procs:
            p.join(timeout=timeout_s)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def start_serve_workers(n_workers: int, cfg=None, scfg=None,
                        host: str = "127.0.0.1", port: int = 0,
                        ready_timeout_s: float = 120.0,
                        device="cuda") -> ServeWorkers:
    """Start ``n_workers`` columnar serving worker PROCESSES sharing one
    port via SO_REUSEPORT accept sharding (``serving.rpc.
    serve_worker_main``): each worker owns its own KVS on ``device``,
    ColumnarFrontend and GIL; the kernel balances client connections
    across them.  Blocks until every worker is accepting (or raises if
    one dies during boot)."""
    import multiprocessing as mp

    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.device import resolve
    from hermes_tpu_torch.serving.ipc import claim_port, spawn_workers
    from hermes_tpu_torch.serving.rpc import serve_worker_main
    from hermes_tpu_torch.serving.server import ServingConfig

    if n_workers < 1:
        raise ValueError("need at least one serve worker")
    resolve(device)  # refuse a missing card here, not in every worker
    cfg = cfg or HermesConfig(n_replicas=4, n_keys=1 << 10, n_sessions=64,
                              value_words=6)
    scfg = scfg or ServingConfig()
    port = port or claim_port(host)
    stop_ev = mp.get_context("spawn").Event()
    procs = spawn_workers(
        serve_worker_main,
        lambda w, ready_q: (w, host, port, cfg, scfg, ready_q, stop_ev,
                            str(device)),
        n_workers, ready_timeout_s, "serve worker",
        lambda procs: ServeWorkers(procs, stop_ev, (host, port)).stop())
    fleet = ServeWorkers(procs, stop_ev, (host, port))
    return fleet


def start_one_store(n_workers: int, cfg=None, scfg=None,
                    host: str = "127.0.0.1", port: int = 0,
                    nslots: int = 8, slot_rows: int = 512,
                    ready_timeout_s: float = 120.0, device="cuda"):
    """Start the ONE-STORE topology (``serving.ipc``): THIS process owns
    the single KVS on ``device``, its ColumnarFrontend and the owner pump
    thread; ``n_workers`` torch-free shm front-end processes shard TCP
    accepts on one SO_REUSEPORT port and feed it over zero-copy column
    rings.  Returns the ``OneStoreServer`` handle (``.addr``,
    ``.alive()``, ``.close()``, context manager)."""
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving.ipc import OneStoreServer
    from hermes_tpu_torch.serving.server import ServingConfig

    if n_workers < 1:
        raise ValueError("need at least one shm worker")
    cfg = cfg or HermesConfig(n_replicas=4, n_keys=1 << 10,
                              n_sessions=64, value_words=6)
    scfg = scfg or ServingConfig()
    store = KVS(cfg, device=device)
    return OneStoreServer(store, scfg, host=host, port=port,
                          n_workers=n_workers, nslots=nslots,
                          slot_rows=slot_rows,
                          ready_timeout_s=ready_timeout_s)


def _serve(a) -> int:
    """``--serve-workers N`` [``--one-store``]: serve until
    ``--serve-seconds`` pass (or ^C, or the fleet dies)."""
    import time as _time

    from hermes_tpu_torch.config import HermesConfig

    cfg = HermesConfig(n_replicas=a.replicas, n_keys=a.keys,
                       n_sessions=a.sessions, value_words=6)
    if a.one_store:
        srv = start_one_store(a.serve_workers, cfg=cfg, port=a.serve_port,
                              device=a.device)
        up = lambda: srv.alive() and srv.pump_error is None
        stop = srv.close
    else:
        srv = start_serve_workers(a.serve_workers, cfg=cfg,
                                  port=a.serve_port, device=a.device)
        up = srv.alive
        stop = srv.stop
    print(json.dumps({"serving": list(srv.addr),
                      "workers": a.serve_workers,
                      "one_store": bool(a.one_store)}), flush=True)
    try:
        if a.serve_seconds > 0:
            _time.sleep(a.serve_seconds)
        else:
            while up():
                _time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        stop()
    return 0


def main(argv=None) -> int:
    from hermes_tpu_torch.config import HermesConfig

    ap = argparse.ArgumentParser(prog="hermes_tpu_torch.launch",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--init", default=None,
                    help="rendezvous: tcp://host:port or file://path")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--keys", type=int, default=1 << 16)
    ap.add_argument("--sessions", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--fleet-groups", type=int, default=1,
                    help="run a key-sharded fleet: N groups of --replicas "
                    "each, one replica group a fleet group (with "
                    "--world-size: a subgroup of ranks a fleet group); "
                    "prints one JSON line a group this rank serves")
    ap.add_argument("--serve-workers", type=int, default=0,
                    help="instead of a protocol run: start N columnar "
                    "serving worker processes sharding accepts on one "
                    "port (SO_REUSEPORT) and serve until interrupted")
    ap.add_argument("--serve-port", type=int, default=0,
                    help="shared serving port (0 = pick a free one)")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="serve for this long then exit (0 = until ^C)")
    ap.add_argument("--one-store", action="store_true",
                    help="with --serve-workers: the workers are thin shm "
                    "front ends (serving/ipc.py) feeding ONE store owned "
                    "by this process over zero-copy column rings, "
                    "instead of each worker owning a private store")
    a = ap.parse_args(argv)
    if a.one_store and a.serve_workers < 1:
        ap.error("--one-store needs --serve-workers N")
    if a.serve_workers > 0:
        if a.world_size > 1 or a.fleet_groups > 1:
            ap.error("--serve-workers is its own run; drop --world-size/"
                     "--fleet-groups")
        return _serve(a)
    cfg = HermesConfig(n_replicas=a.replicas, n_keys=a.keys,
                       n_sessions=a.sessions, wrap_stream=True)
    if a.fleet_groups > 1:
        from hermes_tpu_torch.config import FleetConfig

        rts = run_fleet(FleetConfig(groups=a.fleet_groups, base=cfg),
                        a.steps, a.init, a.world_size, a.rank, a.device)
        layout = (fleet_rank_layout(a.fleet_groups, cfg.n_replicas,
                                    a.world_size) if a.world_size > 1
                  else [[0]] * a.fleet_groups)
        for rt in rts:  # counters gather over the group: in group order
            g = rt.fleet_group
            c = rt.counters()
            print(json.dumps(dict(
                group=g, rank=a.rank, world_size=a.world_size,
                ranks=layout[g], rounds=rt.step_idx,
                replicas=cfg.n_replicas, local_copies=rt.n_copies,
                **{k: int(c[k]) for k in ("n_read", "n_write", "n_rmw",
                                          "n_abort")})), flush=True)
        if a.world_size > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
        return 0
    rt = run(cfg, a.steps, a.init, a.world_size, a.rank, a.device)
    c = rt.counters()
    if a.rank == 0:
        print(json.dumps(dict(
            rounds=rt.step_idx, world_size=a.world_size,
            replicas=cfg.n_replicas, local_copies=rt.n_copies,
            **{k: int(c[k]) for k in ("n_read", "n_write", "n_rmw",
                                      "n_abort")})), flush=True)
    if a.world_size > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
