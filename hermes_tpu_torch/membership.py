"""Host-side membership service: the port of ``hermes_tpu/membership.py``.

Hermes delegates membership to a lease-based service: a replica that stops
heartbeating is suspected, removed from the live set with an epoch bump,
and pending writes re-evaluate their ack quorum against the shrunken mask;
a removed replica self-fences (``FastRuntime.remove`` freezes it).

Detection input is in-band: every INV block carries an ``alive`` bit, each
replica records ``meta.last_seen[peer]`` and the round folds the staleness
into ``Meta.suspect_age`` (``core/faststep.py``).

Suspicion is a state machine with hysteresis: replica r enters ``suspect``
when NO live, unfrozen peer has heard from it for more than
``lease_steps`` rounds (the max over observers, so one partitioned
observer cannot eject a healthy replica); it must stay stale for
``confirm_steps`` further rounds before ``remove`` fires, and a fresh
heartbeat inside that window cancels the suspicion (``suspect_clear``).
``confirm_steps=0`` removes at first suspicion.  ``skew[r]`` biases the
observed age of replica r (the chaos schedules' ``hb_skew``).

Detector input transport: ``poll`` consumes the runtime's harvested age
columns (``rt.harvested_ages``, fed by ``FastRuntime.harvest_comp`` off the
completion fetch that already overlaps the card's execution) whenever they
are fresh, so an attached service adds no synchronous fetch to the
dispatch path.  The fallback, a synchronous copy of ``meta.last_seen``, is
traced as ``membership_fetch``: a pipelined run must show none.  Ages read
from the ring are up to ``pipeline_depth - 1`` rounds old.  The phases
engine's ``runtime.Runtime`` harvests no ages, so there the detector
always reads ``meta.last_seen`` (as the reference's does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from hermes_tpu_torch.config import HermesConfig


@dataclasses.dataclass
class MembershipEvent:
    step: int
    # 'remove' (detector-driven) | 'join' | 'shrink' (administrative);
    # suspect / suspect_clear are timeline-only
    kind: str
    replica: int
    live_mask: int
    # fleet group this event belongs to (-1: a single-group deployment)
    group: int = -1


class MembershipService:
    """Polls heartbeat ages and drives the suspect -> confirm -> remove
    machine (and the join bookkeeping) through a FastRuntime.  Attach with
    ``FastRuntime.attach_membership`` or call ``poll`` between rounds."""

    def __init__(self, cfg: HermesConfig, poll_interval: int = 1,
                 confirm_steps: int = 0, group: int = -1):
        if confirm_steps < 0:
            raise ValueError("confirm_steps must be >= 0")
        self.cfg = cfg
        self.poll_interval = poll_interval
        self.confirm_steps = confirm_steps
        self.group = group
        self.events: List[MembershipEvent] = []
        # replica -> round its current suspicion began
        self.suspects: Dict[int, int] = {}
        # replica -> round it (re)joined: ages observed shortly after a
        # join were computed from pre-join rounds (the harvest lags the
        # dispatch by the ring depth), so a full lease of post-join
        # observation must pass before they can ground a new suspicion
        self._joined_at: Dict[int, int] = {}
        # injected heartbeat clock skew, added to every observed age
        self.skew = np.zeros(cfg.n_replicas, np.int64)
        # partition oracle: directed heartbeat edges (src, dst) -> the
        # round they were severed.  The fast engines have no wire to cut,
        # so a ``partition`` schedule verb models the detector-visible
        # consequence: observer dst stops hearing src, its observed age
        # floored at ``step - since``
        self._severed: Dict[tuple, int] = {}

    # -- partition oracle ------------------------------------------------------

    def sever(self, src: int, dst: int, at_step: int) -> None:
        """Cut the directed heartbeat edge src -> dst (dst = -1: src's
        heartbeats reach no observer)."""
        dsts = range(self.cfg.n_replicas) if dst < 0 else (dst,)
        for d in dsts:
            if d != src:
                self._severed.setdefault((src, d), at_step)

    def restore(self, src: int = -1, dst: int = -1) -> int:
        """Re-connect matching severed edges (-1 = any); returns the number
        restored."""
        victims = [e for e in self._severed
                   if (src < 0 or e[0] == src) and (dst < 0 or e[1] == dst)]
        for e in victims:
            del self._severed[e]
        return len(victims)

    def heal_partitions(self) -> int:
        n = len(self._severed)
        self._severed.clear()
        return n

    def severed_edges(self) -> list:
        """The active severed (src, dst) edges."""
        return sorted(self._severed)

    # -- detector input ----------------------------------------------------------

    def _ages(self, rt):
        """(at_step, (R_obs, R_src) age matrix): the runtime's harvested
        ``suspect_age`` columns when fresh, else a synchronous copy of
        ``meta.last_seen`` (traced as ``membership_fetch``)."""
        cached = getattr(rt, "harvested_ages", None)
        if cached is not None:
            at_step, ages = cached
            # fresh: within one poll interval plus the ring depth (older
            # means harvesting stopped, e.g. fetch_completions was turned
            # off, so fetch)
            depth = getattr(rt.cfg, "pipeline_depth", 1)
            if rt.step_idx - at_step <= self.poll_interval + depth:
                return at_step, ages
        trace = getattr(rt, "_trace", None)
        if trace is not None:
            trace("membership_fetch")
        state = getattr(rt, "fs", None) or rt.rs  # FastRuntime | Runtime
        last_seen = state.meta.last_seen.cpu().numpy()
        return rt.step_idx, np.maximum(rt.step_idx - last_seen, 0)

    # -- the suspicion state machine -------------------------------------------

    def poll(self, rt) -> Optional[MembershipEvent]:
        if rt.step_idx % self.poll_interval != 0:
            return None
        at_step, ages = self._ages(rt)
        return self._drive(rt, at_step, ages)

    def _drive(self, rt, step: int, ages) -> Optional[MembershipEvent]:
        live = int(rt.live[0])
        trace = getattr(rt, "_trace", None)
        evt = None
        for r in range(self.cfg.n_replicas):
            if not (live >> r) & 1:
                self.suspects.pop(r, None)
                continue
            observers = [
                i
                for i in range(self.cfg.n_replicas)
                if i != r and (live >> i) & 1 and not rt.frozen[i]
            ]
            if not observers:
                continue
            ja = self._joined_at.get(r)
            if ja is not None and step - ja <= self.cfg.lease_steps:
                # join grace: no post-join lease window observed yet
                continue

            # freshest observation of r = min age over observers; a
            # severed edge r -> i floors observer i's view at its age
            def _age(i: int) -> int:
                a = int(ages[i, r])
                since = self._severed.get((r, i))
                if since is not None:
                    a = max(a, step - since)
                return a

            age = int(min(_age(i) for i in observers))
            age += int(self.skew[r])
            if age <= self.cfg.lease_steps:
                if self.suspects.pop(r, None) is not None:
                    # recovered inside the confirm window: the suspicion
                    # cancels (timeline only; self.events is the
                    # remove/join log)
                    if trace is not None:
                        trace("suspect_clear", replica=r, stale_steps=age)
                continue
            since = self.suspects.get(r)
            if since is None:
                self.suspects[r] = since = step
                # the detector's evidence precedes the membership outcome
                if trace is not None:
                    trace("suspect", replica=r, stale_steps=age)
            if step - since >= self.confirm_steps:
                del self.suspects[r]
                rt.remove(r)
                live = int(rt.live[0])
                evt = MembershipEvent(rt.step_idx, "remove", r, live,
                                      group=self.group)
                self.events.append(evt)
        return evt

    def note_join(self, rt, replica: int) -> None:
        self.suspects.pop(replica, None)
        self._joined_at[replica] = rt.step_idx
        self.events.append(
            MembershipEvent(rt.step_idx, "join", replica, int(rt.live[0]),
                            group=self.group))

    def note_shrink(self, rt, replica: int) -> None:
        """Administrative removal (``FastRuntime.shrink``): clears any
        suspicion and logs ``shrink``, so the log tells a planned removal
        from a detector ejection."""
        self.suspects.pop(replica, None)
        self._joined_at.pop(replica, None)
        self.events.append(
            MembershipEvent(rt.step_idx, "shrink", replica, int(rt.live[0]),
                            group=self.group))
