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
replicas) grid row-major over its ranks.  ``run_fleet`` runs one
process; a fleet group spread over several ranks would need a
``torch.distributed`` subgroup a fleet group and is not ported.  The
serving workers (A13) are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from hermes_tpu_torch.core.group import (DistGroup, LocalGroup, local_card,
                                         replica_devices)

__all__ = ["init_distributed", "replica_devices", "make_group", "run",
           "fleet_replica_groups", "group_of_rank", "run_fleet"]


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


def run_fleet(fcfg, steps: int, init_method: Optional[str] = None,
              world_size: int = 1, rank: int = 0, device="cuda"):
    """Run a sharded FLEET: G independent group runtimes, one replica
    group each (``fleet_replica_groups``), stepped in lockstep, each
    labeled with its group.  Returns the per-group runtimes (group g =
    rts[g]).  One process: a fleet group spread over several ranks needs
    a ``torch.distributed`` subgroup a group, which is not ported."""
    from hermes_tpu_torch.runtime import FastRuntime

    if world_size > 1:
        raise NotImplementedError(
            "a fleet across processes needs a torch.distributed subgroup "
            "per fleet group; run_fleet runs one process (group_of_rank "
            "gives the layout)")
    groups = fleet_replica_groups(fcfg.groups, device)
    rts = []
    for g in range(fcfg.groups):
        rt = FastRuntime(fcfg.group_cfg(g), backend="sharded",
                         group=groups[g])
        rt.fleet_group = g
        rts.append(rt)
    for _ in range(steps):
        for rt in rts:
            rt.step_once()
    return rts


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
                    "each, one replica group a fleet group, in one "
                    "process; prints one JSON line a group")
    a = ap.parse_args(argv)
    cfg = HermesConfig(n_replicas=a.replicas, n_keys=a.keys,
                       n_sessions=a.sessions, wrap_stream=True)
    if a.fleet_groups > 1:
        from hermes_tpu_torch.config import FleetConfig

        if a.world_size > 1:
            ap.error("--fleet-groups runs one process (a fleet across "
                     "ranks is not ported)")
        rts = run_fleet(FleetConfig(groups=a.fleet_groups, base=cfg),
                        a.steps, device=a.device)
        for g, rt in enumerate(rts):
            c = rt.counters()
            print(json.dumps(dict(
                group=g, rounds=rt.step_idx, replicas=cfg.n_replicas,
                **{k: int(c[k]) for k in ("n_read", "n_write", "n_rmw",
                                          "n_abort")})), flush=True)
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
