"""The replica group: how the sharded engine's blocks move between
replicas.  The counterpart of the reference's ``'replica'`` mesh axis and
of ``hermes_tpu/launch.py:replica_mesh``.

The JAX sharded engine (``hermes_tpu/core/faststep.py``,
``fast_round_sharded``) runs one shard body a device under ``shard_map``;
each shard is one replica with its own table copy, and the round moves
three kinds of block over the ``'replica'`` axis:

* ``gather_src`` — the compacted INV block and the VAL bits, all-gathered
  (``_ici_gather_src``): every replica gets every source's block;
* ``route_back`` — the ACK block, all-to-all (``_ici_route_back``):
  replica p's verdicts on replica q's slots go back to q;
* ``psum`` / ``pmax`` / ``pmin`` — the sharded rebase's reductions.

The port's shard body runs over a leading axis of ``R_local`` local
replicas (``core/faststep.py``, ``fast_round_sharded``), so a group's
collectives take and give per-replica rows ``(R_local, ...)``:

* ``LocalGroup(device)``: one process holds all R replicas (R_local = R),
  the card's path.  The gather is the identity, the route back swaps the
  acker and source axes of the ``(R, R, C, ...)`` ack block, and the
  reductions are over axis 0, broadcast back to every row.
* ``DistGroup(process_group, device)``: R/W contiguous replicas on each
  of W ranks, through ``torch.distributed``: ``all_gather_into_tensor``,
  ``all_to_all_single`` on the rank axis with the local transposes around
  it, and ``all_reduce``.  gloo on the CPU; on CUDA it requires NCCL and
  one distinct card a rank (told apart by the card's UUID, so ranks on
  separate hosts may each hold their host's card 0), and raises
  otherwise.  Nothing picks a backend behind the caller's back.
"""

from __future__ import annotations

import os
import socket

import torch

from hermes_tpu_torch import device as device_lib


class LocalGroup:
    """All R replicas in this process, on ``device``."""

    rank = 0
    world = 1

    def __init__(self, device="cuda"):
        self.device = device_lib.resolve(device)

    def n_local(self, n_replicas: int) -> int:
        return n_replicas

    def first(self, n_replicas: int) -> int:
        """Global id of this process's first local replica."""
        return 0

    def gather_src(self, x):
        return x

    def route_back(self, block):
        return block.transpose(0, 1).contiguous()

    def psum(self, x):
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)

    def pmax(self, x):
        return x.amax(0, keepdim=True).expand_as(x)

    def pmin(self, x):
        return x.amin(0, keepdim=True).expand_as(x)

    def fetch_row(self, x, replica: int):
        """Replica ``replica``'s row of the per-replica rows ``x``."""
        return x[replica]


class DistGroup:
    """R/W contiguous replicas on each of the W ranks of
    ``process_group`` (None: the default group), on ``device``.  On CUDA
    the ranks' cards are compared over ``side_group``, a gloo group of
    the same ranks; without one it is made here, which every rank of the
    default group must then enter (a fleet over ranks makes them all
    beforehand: ``launch.run_fleet``)."""

    def __init__(self, process_group=None, device="cuda", side_group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed initialised "
                               "(launch.init_distributed)")
        self._dist = dist
        self.pg = process_group
        self.world = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        self.device = device_lib.resolve(device)
        backend = dist.get_backend(process_group)
        if self.device.type == "cuda":
            if backend != "nccl":
                raise ValueError(f"DistGroup on CUDA needs the nccl backend, "
                                 f"the group has {backend!r}")
            # the ranks' cards are compared over a gloo side group: NCCL
            # itself may refuse or hang with two ranks on one card
            side = side_group or dist.new_group(
                ranks=None if process_group is None
                else dist.get_process_group_ranks(process_group),
                backend="gloo")
            every = [None] * self.world
            dist.all_gather_object(every, card_id(self.device), group=side)
            if len(set(every)) != self.world:
                raise ValueError(
                    "DistGroup on CUDA needs one distinct device a rank, got "
                    f"cards {every}")
        elif backend != "gloo":
            raise ValueError(f"DistGroup on the CPU needs the gloo backend, "
                             f"the group has {backend!r}")

    def n_local(self, n_replicas: int) -> int:
        if n_replicas % self.world:
            raise ValueError(f"{n_replicas} replicas do not split over "
                             f"{self.world} ranks")
        return n_replicas // self.world

    def first(self, n_replicas: int) -> int:
        return self.rank * self.n_local(n_replicas)

    def gather_src(self, x):
        is_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        self._dist.all_gather_into_tensor(out, src, group=self.pg)
        return out.to(torch.bool) if is_bool else out

    def route_back(self, block):
        """``block[a, s]`` (local acker a, global source s) -> ``out[s_l,
        a_g]`` (local source s_l, global acker a_g)."""
        rl, r = block.shape[0], block.shape[1]
        tail = tuple(block.shape[2:])
        w = self.world
        # chunk w' holds this rank's acks of rank w''s sources: (W, s_l, a_l)
        send = block.reshape((rl, w, r // w) + tail).transpose(0, 1)
        send = send.transpose(1, 2).contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.pg)
        # recv[w, s_l, a_l]: acker (w, a_l)'s ack of my source s_l
        return recv.transpose(0, 1).reshape((r // w, r) + tail).contiguous()

    def _reduce(self, x, op):
        local = {"sum": lambda: x.sum(0, keepdim=True, dtype=x.dtype),
                 "max": lambda: x.amax(0, keepdim=True),
                 "min": lambda: x.amin(0, keepdim=True)}[op]().contiguous()
        rop = {"sum": self._dist.ReduceOp.SUM, "max": self._dist.ReduceOp.MAX,
               "min": self._dist.ReduceOp.MIN}[op]
        self._dist.all_reduce(local, op=rop, group=self.pg)
        return local.expand_as(x)

    def psum(self, x):
        return self._reduce(x, "sum")

    def pmax(self, x):
        return self._reduce(x, "max")

    def pmin(self, x):
        return self._reduce(x, "min")

    def fetch_row(self, x, replica: int):
        rl = x.shape[0]
        owner, local = divmod(replica, rl)
        buf = (x[local].contiguous() if owner == self.rank
               else torch.empty_like(x[0]))
        self._dist.broadcast(buf, src=self._dist.get_global_rank(
            self.pg, owner) if self.pg is not None else owner, group=self.pg)
        return buf


def card_id(device) -> str:
    """What tells one card from every other, on any host: its UUID, or
    the host's name and the card's index where torch gives no UUID."""
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{torch.device(device).index}"


def local_card(rank: int) -> int:
    """The index of this rank's card on its own host: ``LOCAL_RANK`` where
    the launcher sets it, else the rank modulo the host's card count (one
    card a rank on every host)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % torch.cuda.device_count()


def replica_devices(n=None, device="cuda"):
    """The devices the replicas run on, one a replica: the counterpart of
    ``hermes_tpu/launch.py:replica_mesh``.  On the card, the first ``n``
    cards (all of them by default), raising when there are fewer; on the
    CPU, ``n`` times the CPU."""
    dev = device_lib.resolve(device)
    if dev.type == "cpu":
        return [dev] * (n or 1)
    have = torch.cuda.device_count()
    n = n or have
    if have < n:
        raise RuntimeError(f"need {n} cards for {n} replicas, have {have}")
    return [torch.device("cuda", i) for i in range(n)]
