"""One bulk-synchronous protocol step of the reference engine, composed
from the phases: the port of ``hermes_tpu/core/step.py``.

    coordinate -> [INV broadcast] -> apply_inv -> [ACK route-back]
               -> collect_acks    -> [VAL broadcast] -> apply_val

The three exchanges are the transport seam.  ``_step_core`` is the one
step body every backend runs, parameterised over them:

* ``build_step_batched`` — every replica in one process: the broadcast
  expands the outbound (R, L, ...) block to (R_dst, R_src, L, ...), the
  route-back swaps the acker and source axes;
* ``build_step_sharded`` — the blocks move through a replica group
  (``core/group.py``, the fast sharded engine's group): the broadcast is
  ``gather_src`` (the reference's ``all_gather``) expanded over the local
  replicas, the route-back is ``route_back`` (its ``all_to_all``).  A
  ``LocalGroup`` holds all R replicas; on a ``DistGroup`` rank the state
  holds that rank's R/W replicas (``place_sharded``);
* the host-mediated transports (``transport/``) run the same body with
  exchanges through the host (``runtime.Runtime``, ``distributed.py``).

The four builders return compiled calls (``core/graphs.py``), as the
reference's return ``jax.jit``s: ``build_step_batched`` and
``build_step_sharded`` a round ``(rs, stream, ctl) -> (rs, comp)``,
``build_step_scan`` / ``build_step_sharded_scan`` a chunk of ``rounds``
rounds that drops the completions (the reference's ``lax.scan``).  On
the card each is a CUDA graph after its second call; the round reads no
host value, so it has one variant.  The first call binds the state, the
stream and the ctl rows; the table is updated in place and every other
leaf copied back into its bound leaf, so the state returned IS the bound
state, and a call adds its rounds to the bound step on the device.  A
``DistGroup``'s round stays eager (its collectives leave the device),
with the same binding and step.  ``step_round`` / ``sharded_round`` are
the uncompiled round functions.  Nothing here syncs the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import graphs, phases
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t


class StepCtl(NamedTuple):
    """Per-round control, on the state's device: the round ``step`` (a
    0-dim int32 tensor, as the reference's ``jnp.int32``) and the
    membership rows ``epoch`` / ``live_mask`` (R,) int32 and ``frozen``
    (R,) bool."""

    step: torch.Tensor
    epoch: torch.Tensor
    live_mask: torch.Tensor
    frozen: torch.Tensor


def make_ctl(cfg: HermesConfig, step: int, device="cpu") -> StepCtl:
    r = cfg.n_replicas
    return StepCtl(
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
        epoch=torch.zeros((r,), dtype=torch.int32, device=device),
        live_mask=torch.full((r,), cfg.full_mask, dtype=torch.int32,
                             device=device),
        frozen=torch.zeros((r,), dtype=torch.bool, device=device))


def _per_replica_ctl(cfg: HermesConfig, ctl: StepCtl, first: int = 0,
                     n: int = None) -> st.Ctl:
    """The per-replica ``Ctl`` rows of replicas ``first .. first + n``
    (all R by default) from a StepCtl holding those replicas' rows."""
    n = cfg.n_replicas if n is None else n
    dev = ctl.epoch.device
    return st.Ctl(
        step=ctl.step.expand(n),
        my_cid=torch.arange(first, first + n, dtype=torch.int32, device=dev),
        epoch=ctl.epoch, live_mask=ctl.live_mask, frozen=ctl.frozen)


def phase_fns(cfg: HermesConfig):
    """The four protocol phases bound to a config: the one source every
    backend runs."""
    return dict(
        coordinate=functools.partial(phases.coordinate, cfg),
        apply_inv=functools.partial(phases.apply_inv, cfg),
        collect_acks=functools.partial(phases.collect_acks, cfg),
        apply_val=functools.partial(phases.apply_val, cfg),
    )


def lockstep_bcast(block):
    """Broadcast in one process: per-source outbound (R, ...) -> per-dst
    inbound (R_dst, R_src, ...)."""
    r = block[0].shape[0]
    return type(block)(*(x[None].expand((r,) + tuple(x.shape))
                         for x in block))


def lockstep_route_back(block):
    """ACK routing in one process: out[p][q, l] -> in[q][p, l]."""
    return type(block)(*(x.transpose(0, 1) for x in block))


def group_exchanges(group):
    """The broadcast and route-back of a replica group: every source's
    block gathered (``gather_src``) and expanded over the local
    replicas; the acks routed back (``route_back``)."""

    def bcast(block):
        n = block[0].shape[0]
        return type(block)(*(
            g[None].expand((n,) + tuple(g.shape))
            for g in (group.gather_src(x.contiguous()) for x in block)))

    def route_back(block):
        out = []
        for x in block:
            if x.dtype == torch.bool:  # moved as bytes, as gather_src does
                out.append(group.route_back(x.to(torch.uint8)).to(torch.bool))
            else:
                out.append(group.route_back(x.contiguous()))
        return type(block)(*out)

    return bcast, route_back


def _step_core(cfg: HermesConfig, ph, exchange_inv, exchange_ack,
               exchange_val, rs: st.ReplicaState, stream, ctl: st.Ctl):
    """The step body over the exchange primitives: every backend runs
    this one, so the protocol cannot diverge between them."""
    c = ph["coordinate"](ctl, rs.table, rs.sess, rs.replay, stream)
    in_inv = exchange_inv(c.out_inv)
    a = ph["apply_inv"](ctl, c.table, c.sess, rs.meta, in_inv)
    in_ack = exchange_ack(a.out_ack)
    k = ph["collect_acks"](ctl, a.table, a.sess, c.replay, a.meta, in_ack)
    in_val = exchange_val(k.out_val)
    table = ph["apply_val"](ctl, k.table, in_val)

    comp = phases.merge_completions(c.comp, a.comp, k.comp)
    meta = k.meta._replace(
        n_read=k.meta.n_read + (comp.code == t.C_READ).sum(
            dim=-1, dtype=torch.int32))
    return st.ReplicaState(table, k.sess, k.replay, meta), comp


def step_round(cfg: HermesConfig):
    """The R-replica round in one process, uncompiled: ``(rs, stream,
    ctl) -> (rs, comp)``, every leaf with its leading R axis (the table
    updated in place)."""
    ph = phase_fns(cfg)

    def step(rs: st.ReplicaState, stream: st.OpStream, ctl: StepCtl):
        return _step_core(cfg, ph, lockstep_bcast, lockstep_route_back,
                          lockstep_bcast, rs, stream,
                          _per_replica_ctl(cfg, ctl))

    return step


def sharded_round(cfg: HermesConfig, group):
    """The round over a replica group, uncompiled: the state holds the
    group's local replicas (``place_sharded``), ``ctl`` their membership
    rows."""
    bcast, route_back = group_exchanges(group)
    ph = phase_fns(cfg)
    n = group.n_local(cfg.n_replicas)
    first = group.first(cfg.n_replicas)

    def step(rs: st.ReplicaState, stream: st.OpStream, ctl: StepCtl):
        return _step_core(cfg, ph, bcast, route_back, bcast, rs, stream,
                          _per_replica_ctl(cfg, ctl, first, n))

    return step


def _scan(step, rounds: int):
    """``rounds`` rounds of ``step`` from round ``ctl.step``, the
    membership constant, the completions dropped."""

    def chunk(rs: st.ReplicaState, stream: st.OpStream, ctl: StepCtl):
        for off in range(rounds):
            rs, _comp = step(rs, stream, ctl._replace(step=ctl.step + off))
        return rs

    return chunk


def _compiled(fn, name: str, group=None, **kw) -> graphs.Compiled:
    """``fn`` as a compiled call of one variant; a CUDA graph on the card
    unless ``group`` is a ``DistGroup``."""
    from hermes_tpu_torch.core.group import LocalGroup

    return graphs.Compiled(fn, graphs.one_variant, name=name,
                           graph=group is None or isinstance(group,
                                                             LocalGroup),
                           **kw)


def build_step_batched(cfg: HermesConfig):
    """The R-replica round compiled (the reference's ``jax.jit`` of the
    batched step): ``(rs, stream, ctl) -> (rs, comp)``, ``rs`` the bound
    state, ``comp`` the completions in the next of the ring's slots."""
    return _compiled(step_round(cfg), "step_batched")


def build_step_scan(cfg: HermesConfig, rounds: int):
    """``rounds`` batched rounds in one compiled call from round
    ``ctl.step``, the membership constant, the completions dropped;
    returns the bound state and adds ``rounds`` to the bound step."""
    return _compiled(_scan(step_round(cfg), rounds), "step_scan",
                     rounds=rounds, comps=False)


def build_step_sharded(cfg: HermesConfig, group):
    """The round over a replica group compiled (as
    ``build_step_batched``); a ``DistGroup``'s is called eagerly."""
    return _compiled(sharded_round(cfg, group), "step_sharded", group)


def build_step_sharded_scan(cfg: HermesConfig, group, rounds: int):
    """``rounds`` sharded rounds in one compiled call (as
    ``build_step_scan``)."""
    return _compiled(_scan(sharded_round(cfg, group), rounds),
                     "step_sharded_scan", group, rounds=rounds,
                     comps=False)


def _local(x, rows, device):
    return x[rows].to(device).contiguous()


def place_sharded(cfg: HermesConfig, group, rs: st.ReplicaState,
                  stream: st.OpStream):
    """The group's local replicas' rows of a batched state and stream, on
    the group's device (the table leaves with their drop rows)."""
    first = group.first(cfg.n_replicas)
    rows = slice(first, first + group.n_local(cfg.n_replicas))
    dev = group.device
    table = st.KeyTable(*(st.with_drop_row(_local(x, rows, dev))
                          for x in rs.table))
    out = st.ReplicaState(
        table=table,
        sess=st.Sessions(*(_local(x, rows, dev) for x in rs.sess)),
        replay=st.ReplaySlots(*(_local(x, rows, dev) for x in rs.replay)),
        meta=st.Meta(*(_local(x, rows, dev) for x in rs.meta)))
    stream = st.OpStream(*(None if x is None else _local(x, rows, dev)
                           for x in stream))
    return out, stream
