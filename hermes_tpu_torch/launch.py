"""Process bootstrap for the sharded engine: the port of
``hermes_tpu/launch.py``'s ``init_distributed``, ``replica_mesh`` and
``run``.

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

``run_fleet`` (A11c) and the serving workers (A13) are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from hermes_tpu_torch.core.group import (DistGroup, LocalGroup, local_card,
                                         replica_devices)

__all__ = ["init_distributed", "replica_devices", "make_group", "run"]


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
    a = ap.parse_args(argv)
    cfg = HermesConfig(n_replicas=a.replicas, n_keys=a.keys,
                       n_sessions=a.sessions, wrap_stream=True)
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
