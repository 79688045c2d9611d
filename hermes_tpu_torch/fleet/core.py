"""The fleet: G independent Hermes groups behind one key-routed client
facade.  The port of ``hermes_tpu/fleet/core.py``.

Hermes coordinates writes PER KEY, so the fleet is not a new protocol: it
is G complete single-group stacks (each a ``kvs.KVS`` over a
``FastRuntime`` with its OWN membership service, chaos scope and snapshot
scope) behind a ``FleetRouter`` that maps every fleet key to its owning
group and local dense slot.  Nothing is shared between groups:

  * a group's quorums, failure detector, fault schedules and version
    rebases see only that group's replicas;
  * linearizability is a PER-KEY property, so the checker runs per group
    over that group's history; ``verify_fleet`` proves the cross-group
    invariants the per-group checkers cannot see — routing injectivity
    (no two fleet keys alias one (group, slot)) and migration-uid
    namespace disjointness (no re-minted hi<=-2 witness in two groups'
    histories; ``Fleet.migrate`` reserves a fresh namespace per move).

Placement: each batched group's KVS gets ``device=``, round-robin over the
visible cards (``devices=`` overrides the list); on one card every group
shares ``cuda:0`` and its default stream, so group rounds run one after
another there, with no stream of their own.  Sharded groups take one
replica group each (``replica_groups=``, a ``LocalGroup`` a fleet group;
``launch.fleet_replica_groups`` builds the list).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from hermes_tpu_torch import device as device_lib
from hermes_tpu_torch.config import FleetConfig
from hermes_tpu_torch.fleet.router import FleetRouter
from hermes_tpu_torch.kvs import (C_REJECTED, BatchFutures, Completion,
                                  Future, KVS, MultiGetResult)


@dataclasses.dataclass
class _Group:
    """One fleet member: a full single-group serving stack."""

    gid: int
    cfg: object
    kvs: KVS

    @property
    def rt(self):
        return self.kvs.rt


class _RoutedFuture(Future):
    """A group future viewed through the router: results echo the FLEET
    key the client submitted (the group KVS only saw the local slot)."""

    def __init__(self, inner: Future, fleet_key: int):
        super().__init__()
        self._inner = inner
        self._fleet_key = fleet_key

    def done(self) -> bool:
        return self._inner.done()

    def result(self) -> Completion:
        return dataclasses.replace(self._inner.result(),
                                   key=self._fleet_key)


class FleetBatch:
    """Merged view over the per-group ``BatchFutures`` of one fleet batch:
    the same columns (code/value/uid/found/step, the committed timestamp
    tsv/tsf) in FLEET submission order, filled as the owning groups
    complete their shares.  Ops on a draining fleet range complete at
    once as C_REJECTED and never reach a group.  (The reference's merged
    view leaves the timestamp columns zero; here each op carries its
    group's, so a batched writer can pin read fences through it.)"""

    def __init__(self, kinds: np.ndarray, keys: np.ndarray, groups: np.ndarray,
                 u: int, heap: bool = False):
        n = kinds.shape[0]
        self.kind = kinds
        self.key = keys          # FLEET keys (what the client submitted)
        self.group = groups      # owning group per op (-1 = fleet-rejected)
        self.code = np.zeros(n, np.int32)
        self.value = np.zeros((n, u), np.int32)
        self.uid = np.zeros((n, 2), np.int32)
        self.found = np.ones(n, bool)
        self.step = np.full(n, -1, np.int32)
        self.tsv = np.zeros(n, np.int64)
        self.tsf = np.zeros(n, np.int32)
        # heap mode: per-op byte payloads merged from the owning groups'
        # eager resolutions
        self._heap = heap
        self.data: List[Optional[bytes]] = [None] * n
        # (group, sub BatchFutures, fleet indices of its ops)
        self._subs: List[tuple] = []

    def __len__(self) -> int:
        return self.code.shape[0]

    def _pull(self) -> None:
        """Copy completed sub-batch columns into the fleet columns."""
        for _g, bf, gix in self._subs:
            done = (bf.code != 0) & (self.code[gix] == 0)
            if done.any():
                di = gix[done]
                self.code[di] = bf.code[done]
                self.value[di] = bf.value[done]
                self.uid[di] = bf.uid[done]
                self.found[di] = bf.found[done]
                self.step[di] = bf.step[done]
                self.tsv[di] = bf.tsv[done]
                self.tsf[di] = bf.tsf[done]
                if self._heap:
                    for j, i in zip(np.nonzero(done)[0], di):
                        self.data[int(i)] = bf.data[int(j)]

    def done_count(self) -> int:
        self._pull()
        return int(np.count_nonzero(self.code))

    def all_done(self) -> bool:
        return self.done_count() == len(self)

    def completion(self, i: int) -> Completion:
        self._pull()
        if self.code[i] == 0:
            raise RuntimeError("op not complete; run Fleet.run_batch()")
        # the single-group decode over the fleet columns (the fleet key,
        # not the group-local slot, is echoed)
        view = BatchFutures(self.kind, self.key, self.value.shape[1])
        view.code, view.value, view.uid = self.code, self.value, self.uid
        view.found, view.step = self.found, self.step
        view.tsv, view.tsf, view.data = self.tsv, self.tsf, self.data
        return view.completion(i)


class FleetReads(MultiGetResult):
    """Merged view over the per-group ``MultiGetResult``s of one fleet
    multi-get or scan: the inherited columns in FLEET submission order,
    filled as the owning groups answer their shares (locally where keys
    are Valid, through the round path otherwise).  Keys on a draining
    fleet range complete at once as C_REJECTED."""

    def __init__(self, keys: np.ndarray, groups: np.ndarray, u: int):
        super().__init__(keys, u)
        self.group = groups      # owning group per key (-1 = fleet-rejected)
        self._subs: List[tuple] = []  # (gid, MultiGetResult, fleet indices)

    def _pull(self) -> None:
        for _g, sub, gix in self._subs:
            sub._pull()
            done = (sub.code != 0) & (self.code[gix] == 0)
            if done.any():
                di = gix[done]
                self.code[di] = sub.code[done]
                self.value[di] = sub.value[done]
                self.found[di] = sub.found[done]
                self.local[di] = sub.local[done]
                self.step[di] = sub.step[done]
                if sub._heap is not None:
                    for j, i in zip(np.nonzero(done)[0], di):
                        self.data[int(i)] = sub.data[int(j)]

    @property
    def local_served(self) -> int:
        self._pull()
        return int(np.count_nonzero(self.local))


def _placement(device, devices) -> list:
    """The devices the groups go on, round-robin: ``devices`` as given,
    else every visible card for a CUDA ``device`` without an index, else
    ``device`` alone."""
    import torch

    if devices is not None:
        return [device_lib.resolve(d) for d in devices]
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class Fleet:
    """G key-sharded Hermes groups behind one routed client facade.

    Client surface (``kvs.KVS``'s, with the replica coordinate replaced by
    routing): ``put/get/rmw(session, key, ...)`` route by FLEET key — the
    owning group by the key, the (replica, session) lane inside it by the
    fleet session id.  ``submit_batch`` fans a whole mix out to the owning
    groups and merges the completions (``FleetBatch``).  ``step()`` runs
    one protocol round in EVERY group.
    """

    def __init__(self, fcfg: FleetConfig, backend: str = "batched",
                 replica_groups: Optional[Sequence] = None, record=False,
                 sparse_keys: bool = False, detect: Optional[int] = None,
                 device="cuda", devices: Optional[Sequence] = None):
        if sparse_keys:
            raise NotImplementedError(
                "fleet routing is dense-keyed: the fleet key IS the router "
                "slot; put a KeyIndex in front of Fleet to serve sparse "
                "client keys")
        if backend == "sharded" and (replica_groups is None or
                                     len(replica_groups) != fcfg.groups):
            raise ValueError(
                "sharded fleet needs one replica group per fleet group "
                "(launch.fleet_replica_groups builds the list)")
        if backend == "batched" and replica_groups is not None:
            raise ValueError("replica groups are for the sharded backend")
        self.cfg = fcfg
        self.backend = backend
        # heap mode must be fleet-uniform: a cross-group migration
        # re-appends extents into the destination's log
        for g in range(fcfg.groups):
            if fcfg.group_cfg(g).use_heap != fcfg.base.use_heap:
                raise ValueError(
                    f"group {g} disagrees with the fleet on value-heap "
                    "mode (max_value_bytes): heap mode is fleet-uniform")
        self.router = FleetRouter.from_config(fcfg)
        self.groups: List[_Group] = []
        devs = (_placement(device, devices) if replica_groups is None
                else None)
        for g in range(fcfg.groups):
            gcfg = fcfg.group_cfg(g)
            if replica_groups is not None:
                kvs = KVS(gcfg, backend=backend, record=record,
                          group=replica_groups[g])
            else:
                kvs = KVS(gcfg, backend=backend, record=record,
                          device=devs[g % len(devs)])
            grp = _Group(gid=g, cfg=gcfg, kvs=kvs)
            grp.rt.fleet_group = g  # per-group obs label (every trace)
            if detect is not None:
                from hermes_tpu_torch.membership import MembershipService

                grp.rt.attach_membership(
                    MembershipService(gcfg, confirm_steps=detect, group=g))
            self.groups.append(grp)
        self.rejected_ops = 0  # fleet-level (router drain) rejects
        # local slots a group lost to outbound migrations: the rows stay
        # behind (normalized, fenced for good), so the slots are never
        # re-allocated to an inbound migration
        self._retired_slots: Dict[int, set] = {}
        # migration-uid namespace ledger: hi word -> the group that minted
        # it.  migrate_range re-mints into hi = -(2 + dst_step); two
        # groups minting the SAME hi could alias witnesses across groups,
        # so each hi is reserved for one group
        self._mig_minted: Dict[int, int] = {}

    # -- group access --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.groups)

    def group(self, g: int) -> _Group:
        return self.groups[g]

    def runtimes(self):
        return [grp.rt for grp in self.groups]

    # -- routed sessions -----------------------------------------------------

    def _lane(self, grp: _Group, session: int):
        """The (replica, session) lane of a fleet session id inside one
        group: coordinators round-robin, lanes wrap the group's session
        width (two fleet sessions may share a lane; its queue keeps their
        order)."""
        r = session % grp.cfg.n_replicas
        s = (session // grp.cfg.n_replicas) % grp.cfg.n_sessions
        return r, s

    def route_op(self, kind: str, session: int, key: int, value=None):
        """Route one op and also report the (group, replica, session) lane
        it landed on (None for an op refused at the router: a draining
        range)."""
        g, slot = self.router.locate(int(key))
        if self.router.draining(int(key)):
            self.rejected_ops += 1
            fut = Future()
            fut._result = Completion(kind="rejected", key=int(key),
                                     found=False)
            return fut, None
        grp = self.groups[g]
        r, s = self._lane(grp, session)
        fut = getattr(grp.kvs, kind)(r, s, slot, *(
            (value,) if value is not None else ()))
        return _RoutedFuture(fut, int(key)), (int(g), r, s)

    def _route(self, kind: str, session: int, key: int, value):
        return self.route_op(kind, session, key, value)[0]

    def degraded(self, key: Optional[int] = None) -> bool:
        """Degraded mode, fleet view: with ``key``, whether the OWNING
        group cannot commit writes now; without, whether any group is
        degraded."""
        if key is not None:
            g, _slot = self.router.locate(int(key))
            return self.groups[int(g)].kvs.degraded()
        return any(grp.kvs.degraded() for grp in self.groups)

    def get(self, session: int, key: int) -> Future:
        return self._route("get", session, key, None)

    def put(self, session: int, key: int, value) -> Future:
        return self._route("put", session, key, value)

    def rmw(self, session: int, key: int, value) -> Future:
        return self._route("rmw", session, key, value)

    # -- batched fan-out -----------------------------------------------------

    GET, PUT, RMW = KVS.GET, KVS.PUT, KVS.RMW

    def submit_batch(self, kinds, keys, values=None) -> FleetBatch:
        """Fan one op mix out to the owning groups: a group's share keeps
        FLEET submission order, and ops on a draining fleet range
        complete at once as C_REJECTED."""
        kinds = np.ascontiguousarray(np.asarray(kinds, np.int32))
        keys = np.asarray(keys, np.int64)
        n = kinds.shape[0]
        if keys.shape != (n,):
            raise ValueError("keys must be shape (n,)")
        gids, slots = self.router.locate(keys)
        gids = np.asarray(gids, np.int32).copy()
        u = self.cfg.base.value_words - 2
        heap_mode = self.cfg.base.use_heap
        uval = np.zeros((n, u), np.int32)
        if values is not None and not heap_mode:
            v = np.asarray(values, np.int32)
            uval[:, : v.shape[1]] = v
        elif values is not None and len(values) != n:
            raise ValueError(f"values must carry {n} byte payloads")
        fb = FleetBatch(kinds, keys.copy(), gids, u, heap=heap_mode)
        draining = np.asarray(self.router.draining(keys), bool)
        if draining.any():
            fb.code[draining] = C_REJECTED
            fb.found[draining] = False
            fb.group[draining] = -1
            self.rejected_ops += int(draining.sum())
        for grp in self.groups:
            mine = (gids == grp.gid) & ~draining
            if not mine.any():
                continue
            gix = np.nonzero(mine)[0]
            if heap_mode:
                # byte payloads route verbatim: each owning group appends
                # the extent into ITS OWN heap (refs are group-local)
                share = (None if values is None
                         else [values[int(i)] for i in gix])
                bf = grp.kvs.submit_batch(kinds[gix], slots[gix], share)
            else:
                bf = grp.kvs.submit_batch(kinds[gix], slots[gix], uval[gix])
            fb._subs.append((grp.gid, bf, gix))
        return fb

    # -- local-read path -----------------------------------------------------

    def _read_session(self, grp: _Group, session):
        """The fence token a fleet read hands each group's KVS: an int
        fleet session id maps to the group's lane as on the write path;
        any other hashable token passes through verbatim."""
        if session is None:
            return None
        return (self._lane(grp, session) if isinstance(session, int)
                else session)

    def _reject_draining(self, fr: FleetReads, keys: np.ndarray) -> np.ndarray:
        """C_REJECTED every key on a draining fleet range; returns the
        draining mask."""
        draining = np.asarray(self.router.draining(keys), bool)
        if draining.any():
            fr.code[draining] = C_REJECTED
            fr.found[draining] = False
            fr.group[draining] = -1
            self.rejected_ops += int(draining.sum())
        return draining

    def multi_get(self, keys, session=None, wait: bool = True,
                  max_steps: int = 50_000) -> FleetReads:
        """Batched fleet read: the key vector fanned out to the owning
        groups' local-read paths (``kvs.KVS.multi_get``), the answers
        merged in FLEET key order.  ``session`` is a fleet session id or
        an opaque fence token.  Draining fleet ranges reject; with
        ``wait`` the round-path fallbacks are driven to completion."""
        keys = np.atleast_1d(np.asarray(keys, np.int64))
        n = keys.shape[0]
        u = self.cfg.base.value_words - 2
        gids, slots = self.router.locate(keys)
        gids = np.asarray(gids, np.int32).copy()
        fr = FleetReads(keys.copy(), gids, u)
        if n == 0:
            return fr
        draining = self._reject_draining(fr, keys)
        for grp in self.groups:
            mine = (gids == grp.gid) & ~draining
            if not mine.any():
                continue
            gix = np.nonzero(mine)[0]
            sub = grp.kvs.multi_get(
                np.asarray(slots)[gix],
                session=self._read_session(grp, session), wait=False)
            fr._subs.append((grp.gid, sub, gix))
        if wait:
            self.run_reads(fr, max_steps=max_steps)
        return fr

    def scan(self, lo: int, hi: int, session=None, wait: bool = True,
             max_steps: int = 50_000) -> FleetReads:
        """Fleet range scan over fleet keys ``[lo, hi)``: a contiguous
        group share rides ``kvs.KVS.scan``; a share fragmented by
        migrations goes through ``multi_get``.  Answers merge in fleet key
        order."""
        if not (0 <= lo < hi <= self.cfg.total_keys):
            raise ValueError(f"fleet scan range [{lo}, {hi}) outside "
                             f"[0, {self.cfg.total_keys})")
        keys = np.arange(lo, hi, dtype=np.int64)
        u = self.cfg.base.value_words - 2
        gids, slots = self.router.locate(keys)
        gids = np.asarray(gids, np.int32).copy()
        slots = np.asarray(slots)
        fr = FleetReads(keys, gids, u)
        draining = self._reject_draining(fr, keys)
        for grp in self.groups:
            mine = (gids == grp.gid) & ~draining
            if not mine.any():
                continue
            gix = np.nonzero(mine)[0]
            share = slots[gix]
            lane = self._read_session(grp, session)
            if share.size == 1 or (np.diff(share) == 1).all():
                sub = grp.kvs.scan(int(share[0]), int(share[-1]) + 1,
                                   session=lane, wait=False)
            else:
                sub = grp.kvs.multi_get(share, session=lane, wait=False)
            fr._subs.append((grp.gid, sub, gix))
        if wait:
            self.run_reads(fr, max_steps=max_steps)
        return fr

    def pin_read_fence(self, session, fleet_key: int, ts) -> None:
        """Pin a read-your-writes fence on the group owning
        ``fleet_key`` (``KVS.pin_read_fence``, routed)."""
        g, slot = self.router.locate(int(fleet_key))
        self.groups[int(g)].kvs.pin_read_fence(session, int(slot), ts)

    def run_reads(self, fr: FleetReads, max_steps: int = 50_000) -> bool:
        """Drive a FleetReads' round-path fallbacks to completion."""
        for _ in range(max_steps):
            if fr.all_done():
                return True
            self.step()
        self.flush()
        return fr.all_done()

    def read_stats(self) -> dict:
        """Fleet-wide local-read accounting (sum of the groups')."""
        agg: Dict[str, int] = {}
        for grp in self.groups:
            for k, v in grp.kvs.read_stats().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    # -- stepping ------------------------------------------------------------

    def step(self) -> int:
        """One protocol round in every group, in group order.  Returns the
        fleet-wide count of client ops resolved."""
        return sum(grp.kvs.step() for grp in self.groups)

    def flush(self) -> int:
        n = 0
        for grp in self.groups:
            n += grp.kvs.flush()
            grp.rt.flush_pipeline()
        return n

    def run_batch(self, fb: FleetBatch, max_steps: int = 50_000) -> bool:
        for _ in range(max_steps):
            if fb.all_done():
                return True
            self.step()
        self.flush()
        return fb.all_done()

    def run_until(self, futures, max_steps: int = 10_000) -> bool:
        for _ in range(max_steps):
            if all(f.done() for f in futures):
                return True
            self.step()
        self.flush()
        return all(f.done() for f in futures)

    def drain(self, max_steps: int = 10_000) -> bool:
        ok = True
        for grp in self.groups:
            for _ in range(max_steps):
                if not (grp.kvs._inflight or grp.kvs._queued_slots
                        or grp.kvs._bat):
                    break
                grp.kvs.step()
            else:
                ok = False
            grp.kvs.flush()
            grp.rt.flush_pipeline()
        return ok

    # -- observability -------------------------------------------------------

    def attach_obs(self, obs) -> None:
        """One obs context for the whole fleet: every event a group's
        runtime emits carries its group label (``rt.fleet_group``)."""
        for grp in self.groups:
            grp.rt.attach_obs(obs)

    def counters(self) -> dict:
        """Per-group counters and the fleet-wide aggregate."""
        per = []
        agg: Dict[str, int] = {}
        for grp in self.groups:
            c = grp.kvs.counters()
            c = {k: int(v) for k, v in c.items() if np.ndim(v) == 0}
            c["group"] = grp.gid
            per.append(c)
            for k in ("n_read", "n_write", "n_rmw", "n_abort"):
                agg[k] = agg.get(k, 0) + c[k]
        return dict(groups=per, fleet=agg)

    def interval_report(self, obs) -> None:
        """One interval record a group (group-labeled) and the fleet
        aggregate, which ``obs.report`` folds fleet-wide."""
        c = self.counters()
        for rec in c["groups"]:
            obs.interval(dict(rec, step=self.groups[rec["group"]].rt.step_idx))
        obs.interval(dict(c["fleet"], group="fleet"))

    # -- correctness ---------------------------------------------------------

    def check(self) -> dict:
        """Per-group linearizability verdicts and the fleet harness
        (``verify_fleet``).  Returns {ok, groups: [...],
        fleet_invariants}."""
        out: dict = {"groups": []}
        ok = True
        for grp in self.groups:
            v = grp.rt.check()
            out["groups"].append(dict(group=grp.gid, ok=bool(v.ok),
                                      keys_checked=v.keys_checked))
            ok &= bool(v.ok)
        verify_fleet(self)
        out["fleet_invariants"] = "ok"
        out["ok"] = ok
        return out

    # -- cross-group migration (through the fleet router flip) ---------------

    def migrate(self, lo: int, hi: int, dst_group: int,
                drain_steps: int = 2000, force: bool = False) -> dict:
        """Move fleet keys ``[lo, hi)`` between two fleet groups:
        ``elastic.migrate_range`` between the owning group's KVS and the
        destination's, the FLEET router carrying the drain and the atomic
        flip.  The keys' local slots must still be contiguous in the
        source (true until a range is split by migrations).

        Namespace discipline: the transfer re-mints uids into ``hi =
        -(2 + dst_step)``; the ledger reserves that hi for one group — on
        a cross-group collision the destination steps forward to a fresh
        namespace BEFORE anything is fenced."""
        from hermes_tpu_torch.elastic import migrate_range

        owners, slots = self.router.locate(np.arange(lo, hi))
        owners = np.asarray(owners)
        src_gid = int(owners[0])
        if not (owners == src_gid).all():
            raise ValueError(
                f"fleet range [{lo}, {hi}) spans groups "
                f"{sorted(set(owners.tolist()))}; migrate one owner's "
                "range at a time")
        if not (0 <= dst_group < len(self.groups)):
            raise ValueError(f"no group {dst_group}")
        if dst_group == src_gid:
            raise ValueError(f"range [{lo}, {hi}) already lives in group "
                             f"{dst_group}")
        llo, lhi = int(slots[0]), int(slots[-1]) + 1
        if not (np.diff(slots) == 1).all():
            raise ValueError(
                f"fleet range [{lo}, {hi}) is no longer slot-contiguous "
                "in its owner (split by earlier migrations); migrate the "
                "contiguous sub-ranges")
        src, dst = self.groups[src_gid], self.groups[dst_group]
        # the DESTINATION's spare slots: its own keys keep their slots and
        # slots earlier migrations drained away stay retired, so the free
        # set is the never-used remainder of its table
        dst_owned = self.router._local[
            np.asarray(self.router.rr._owner) == dst_group]
        retired_set = self._retired_slots.get(dst_group, ())
        retired = np.fromiter(retired_set, np.int64, len(retired_set))
        used = np.union1d(dst_owned.astype(np.int64), retired)
        free = np.setdiff1d(np.arange(dst.cfg.n_keys, dtype=np.int64), used)
        if free.size < hi - lo:
            raise ValueError(
                f"group {dst_group} has {free.size} spare slot(s) but the "
                f"migration needs {hi - lo}; size the destination's "
                "n_keys past its range (FleetConfig ranges/overrides)")
        dest_alloc = free[: hi - lo]
        # reserve a fresh migration-uid namespace for the destination
        while self._mig_minted.get(-(2 + dst.rt.step_idx),
                                   dst_group) != dst_group:
            dst.kvs.step()
        self._mig_minted[-(2 + dst.rt.step_idx)] = dst_group

        self.router.begin_drain(lo, hi)
        try:
            summary = migrate_range(src.kvs, dst.kvs, llo, lhi,
                                    router=None, dst_group=dst_group,
                                    drain_steps=drain_steps, force=force,
                                    dest_slots=dest_alloc)
        except BaseException:
            self.router.release(lo, hi)
            raise
        self.router.flip(lo, hi, dst_group,
                         dest_slots=summary["dest_slots"])
        self._retired_slots.setdefault(src_gid, set()).update(
            range(llo, lhi))
        summary["fleet_range"] = (lo, hi)
        summary["src_group"], summary["dst_group"] = src_gid, dst_group
        return summary

    # -- snapshot scope ------------------------------------------------------

    def save(self, dir_path: str) -> dict:
        """Fleet snapshot: one checksummed archive PER GROUP
        (``group{g}.npz``, the ``snapshot.save`` format: a group's archive
        restores alone) and a fleet manifest with the router state.  The
        groups must be quiescent (the per-group save refuses in-flight
        client ops)."""
        from hermes_tpu_torch import snapshot as snapshot_lib

        os.makedirs(dir_path, exist_ok=True)
        names = []
        for grp in self.groups:
            grp.rt.flush_pipeline()
            p = os.path.join(dir_path, f"group{grp.gid}.npz")
            snapshot_lib.save(p, grp.rt)
            names.append(os.path.basename(p))
        manifest = dict(
            version=1, kind="fleet", groups=len(self.groups),
            archives=names,
            owner=self.router.rr._owner.tolist(),
            local=self.router._local.tolist(),
            mig_minted={str(k): v for k, v in self._mig_minted.items()},
            retired_slots={str(g): sorted(s)
                           for g, s in self._retired_slots.items()},
        )
        with open(os.path.join(dir_path, "fleet.json"), "w") as f:
            json.dump(manifest, f)
        return manifest

    def load(self, dir_path: str) -> None:
        from hermes_tpu_torch import snapshot as snapshot_lib

        with open(os.path.join(dir_path, "fleet.json")) as f:
            manifest = json.load(f)
        if manifest.get("kind") != "fleet" or \
                manifest.get("groups") != len(self.groups):
            raise ValueError(
                f"{dir_path} is not a fleet snapshot for {len(self.groups)} "
                "group(s)")
        for grp, name in zip(self.groups, manifest["archives"]):
            snapshot_lib.load(os.path.join(dir_path, name), grp.rt)
        self.router.rr._owner[:] = np.asarray(manifest["owner"], np.int32)
        self.router._local[:] = np.asarray(manifest["local"], np.int32)
        self._mig_minted = {int(k): v for k, v
                            in manifest["mig_minted"].items()}
        self._retired_slots = {int(g): set(s) for g, s
                               in manifest["retired_slots"].items()}


def _migration_uids(rt) -> List[tuple]:
    """Every write uid in the migration namespace (hi <= -2) of the
    runtime's finalized history, one entry a recorded op.  The columnar
    recorder is read as columns (no Op objects at bench scale)."""
    from hermes_tpu_torch.checker import fast as fast_lib

    rec = rt.recorder
    if not isinstance(rec, fast_lib.ArrayRecorder):
        return [o.wuid for o in rt.history_ops()
                if getattr(o, "wuid", None) is not None and o.wuid[1] <= -2]
    rt.flush_pipeline()
    rec.finalize(rt._sess_view())
    cols = rec.columns()
    w = cols["wuid"][cols["kind"] != fast_lib.K_READ].astype(np.int64)
    lo = ((w & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)
    hi = (((w >> 32) & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)
    sel = hi <= -2
    return list(zip(lo[sel].tolist(), hi[sel].tolist()))


def verify_fleet(fleet: Fleet) -> dict:
    """The fleet invariants no per-group checker can see (module
    docstring).  Raises AssertionError on the first violation; returns a
    small evidence dict when everything holds.

      1. routing injectivity — no two fleet keys alias one (group, slot);
      2. migration-uid namespaces — every re-minted (hi <= -2) witness
         uid appears in at most ONE group's history;
      3. group-scoped membership — each group's failure-handling state
         (live mask, frozen set, membership service) is its own object
         over its own replicas.
    """
    fleet.router.check_injective()
    seen: Dict[tuple, int] = {}
    mig_uids = 0
    for grp in fleet.groups:
        if grp.rt.recorder is None:
            continue
        for w in _migration_uids(grp.rt):
            mig_uids += 1
            other = seen.setdefault(w, grp.gid)
            if other != grp.gid:
                raise AssertionError(
                    f"migration uid {w} appears in group {other} AND group "
                    f"{grp.gid}: cross-group witness aliasing (namespace "
                    "ledger broken)")
    svcs = [grp.rt.membership for grp in fleet.groups
            if grp.rt.membership is not None]
    if len(set(map(id, svcs))) != len(svcs):
        raise AssertionError(
            "two groups share one MembershipService instance: detector "
            "state must be group-scoped")
    for grp in fleet.groups:
        if len(grp.rt.live) != grp.cfg.n_replicas:
            raise AssertionError(f"group {grp.gid}'s live mask is not its "
                                 "own replicas'")
    return dict(migration_uids=mig_uids, groups=len(fleet.groups))
