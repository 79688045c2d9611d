"""Declarative, seeded fault schedules and the runner that drives them:
the port of ``hermes_tpu/chaos/schedule.py``.

  * ``ChaosEvent`` / ``Schedule`` -- a parsed event program.  Text form,
    one event per line (``#`` comments allowed)::

        @12 freeze 2
        @18 thaw 2
        @30 crash_restart 2 donor=0
        @40 hb_skew 1 skew=9 until=55
        @25 partition 0 until=50       # acts through the detector
        @55 heal

    ``Schedule.parse`` / ``Schedule.format`` round-trip it;
    ``Schedule.random(cfg, seed, steps, spec)`` draws a seeded program
    from ``np.random.default_rng(seed)`` (the same seed gives the
    reference's program), its targets left to pre-drawn uniforms the
    runner resolves against eligibility at run time.
  * ``ChaosRunner`` -- drives a FastRuntime, a KVS or the phases
    engine's ``Runtime`` through a schedule:
    applies each due event if legal (the healthy floor, target
    eligibility), steps the workload, heals the cluster at the end,
    drains, and returns the run log.  Every applied event lands on the
    obs timeline, and the executed log (``result["events"]``,
    ``log_json()``) is deterministic: the same seed and config give a
    byte-identical log and final state.  ``crash_restart`` goes to
    ``chaos.recovery.restart_replica``; on the fast engines
    ``partition`` acts through the detector (``MembershipService.sever``)
    and ``hb_skew`` biases its observed ages.
  * ``NetChaos`` -- the window bookkeeping of the sim transport's drop /
    delay / duplicate schedule, installed as a ``SimTransport``'s
    schedule.

Verbs without a carrier are refused when the runner is built, never
dropped (the reference's ``_check_net_faults_routable``): the wire verbs
(``netdrop`` ... ``netcorrupt``) need ``wire=``, a
``chaos.net.FaultingTransport`` over the target's host transport; the
legacy ``net_*`` verbs ``net=`` (a ``NetChaos``) or ``wire=``;
``partition`` ``wire=`` or an attached detector; ``overload`` a load
shaper (``load=``, a ``workload.openloop.ShapedArrivals`` that
``serving.soak.run_open_loop`` consumes); ``powercut`` a caller's kill
carrier.
On the phases engine's ``Runtime`` a ``crash_restart`` is skipped and
logged (``chaos.recovery`` restarts the fast engines' state), as in the
reference.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

EVENT_KINDS = ("freeze", "thaw", "remove", "join", "crash_restart",
               "hb_skew", "net_drop", "net_delay", "net_dup",
               # wire-adversary verbs (the chaos/net.py interposer;
               # partition also drives the fast engines' detector oracle)
               "netdrop", "netdelay", "netdup", "netreorder", "netcorrupt",
               "partition", "heal",
               # overload adversary: multiply the attached load shaper's
               # open-loop arrival rate by x for a window
               "overload", "overload_clear",
               # durability adversary: SIGKILL the whole store process
               # mid-soak (no flush, no close: the kill -9 the WAL exists
               # for), carried by an attached callable (a soak child kills
               # itself; its parent recovers with chaos.recover_store)
               "powercut")

# wire verb -> FaultingTransport wire op.  The legacy net_* verbs keep
# their NetChaos routing (sim-transport schedule windows) but fall back to
# the interposer when only a FaultingTransport is attached: the same
# fault, injected one layer up.
WIRE_EVENTS = {"netdrop": "drop", "netdelay": "delay", "netdup": "dup",
               "netreorder": "reorder", "netcorrupt": "corrupt"}
LEGACY_NET_EVENTS = {"net_drop": "drop", "net_delay": "delay",
                     "net_dup": "dup"}


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One schedule entry.  ``replica`` is the target (net_*: the source
    edge end; -1 = runner-resolved via ``u``).  Field use by kind:
    join/crash_restart -> ``donor``; hb_skew -> ``skew`` + ``until``;
    net_* -> ``dst`` (-1 = any) + ``until`` (+ ``skew`` as the delay)."""

    step: int
    kind: str
    replica: int = -1
    donor: int = -1
    dst: int = -1
    skew: int = 0
    until: int = -1
    x: float = 0.0  # overload rate multiplier
    u: float = 0.0  # pre-drawn uniform for run-time target resolution

    def format(self) -> str:
        parts = [f"@{self.step}", self.kind]
        if self.replica >= 0:
            parts.append(str(self.replica))
        for f, dflt in (("donor", -1), ("dst", -1), ("skew", 0),
                        ("until", -1)):
            v = getattr(self, f)
            if v != dflt:
                parts.append(f"{f}={v}")
        if self.x:
            parts.append(f"x={self.x!r}")
        if self.u:
            parts.append(f"u={self.u!r}")
        return " ".join(parts)


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Seeded-schedule mix: per-step event probabilities (disjoint draws
    off one uniform) + shape knobs.  Defaults mirror the historical
    fault-soak mix, extended with the detector's fault classes."""

    p_freeze: float = 0.06
    p_thaw: float = 0.04
    p_join: float = 0.06
    p_crash: float = 0.02
    p_skew: float = 0.02
    p_net: float = 0.0  # sim engine only; ignored elsewhere
    # wire adversary: per-step rate of drawing ONE of the five
    # interposer verbs (netdrop/netdelay/netdup/netreorder/netcorrupt,
    # uniform among them) and of opening a directed partition
    p_wire: float = 0.0
    p_partition: float = 0.0
    skew_amount: int = 6
    skew_window: int = 12
    net_window: int = 10
    net_delay: int = 2
    partition_window: int = 14
    # legality floor: never freeze/crash below this many healthy replicas
    min_healthy: int = 3
    # detector-less fallback: a replica frozen longer than this is removed
    # by the runner's lease rule (a MembershipService overrides this)
    lease_remove_after: int = 6


class Schedule:
    """An ordered fault program (events sorted by step, stable)."""

    def __init__(self, events: Sequence[ChaosEvent]):
        for e in events:
            if e.kind not in EVENT_KINDS:
                raise ValueError(f"unknown chaos event kind {e.kind!r}")
        self.events: List[ChaosEvent] = sorted(events, key=lambda e: e.step)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def format(self) -> str:
        return "\n".join(e.format() for e in self.events) + "\n"

    @classmethod
    def parse(cls, text: str) -> "Schedule":
        """Parse the declarative text form (see module docstring)."""
        events = []
        for ln, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            if not toks[0].startswith("@"):
                raise ValueError(f"line {ln}: want '@STEP KIND ...', got {raw!r}")
            try:
                step = int(toks[0][1:])
            except ValueError:
                raise ValueError(f"line {ln}: bad step in {toks[0]!r}")
            if len(toks) < 2:
                raise ValueError(f"line {ln}: missing event kind")
            kind = toks[1]
            if kind not in EVENT_KINDS:
                raise ValueError(
                    f"line {ln}: unknown chaos event kind {kind!r} "
                    f"(want one of {', '.join(EVENT_KINDS)})")
            kw: dict = dict(step=step, kind=kind)
            pos = 2
            if pos < len(toks) and "=" not in toks[pos]:
                kw["replica"] = int(toks[pos])
                pos += 1
            for tok in toks[pos:]:
                if "=" not in tok:
                    raise ValueError(f"line {ln}: want key=value, got {tok!r}")
                k, v = tok.split("=", 1)
                if k not in ("donor", "dst", "skew", "until", "u", "x"):
                    raise ValueError(f"line {ln}: unknown field {k!r}")
                kw[k] = float(v) if k in ("u", "x") else int(v)
            try:
                events.append(ChaosEvent(**kw))
            except ValueError as e:
                raise ValueError(f"line {ln}: {e}")
        return cls(events)

    @classmethod
    def rolling_restart(cls, cfg, start: int = 4,
                        spacing: int = 12) -> "Schedule":
        """The rolling-restart drill program (``elastic/drill.py``):
        replica i crash-restarts at step
        ``start + i * spacing`` — every replica in sequence, each given
        ``spacing`` rounds to rejoin and re-validate before the next one
        dies.  Deterministic (no draws): the same config replays the same
        program, so drill runs are byte-identical on the same seed+config
        like every other schedule."""
        return cls([
            ChaosEvent(step=start + i * spacing, kind="crash_restart",
                       replica=i)
            for i in range(cfg.n_replicas)
        ])

    @classmethod
    def partition_drill(cls, cfg, rounds: int, window: int = 14,
                        spacing: int = 30, start: int = 8) -> "Schedule":
        """Deterministic partition+heal cycles: replica
        ``i % R``'s outbound side goes dark for ``window`` rounds starting
        at ``start + i*spacing``, followed by a ``heal`` two rounds after
        the window closes — so the cluster LOSES and REGAINS a replica
        each cycle (detector ejection -> epoch-fenced rejoin) instead of
        monotonically shrinking.  No draws: same config replays the same
        program (the bench partition cell and soak triage both want
        comparable cycles, not seed-lottery cluster sizes)."""
        events = []
        step, i = start, 0
        while step + window + 2 < rounds:
            events.append(ChaosEvent(step=step, kind="partition",
                                     replica=i % cfg.n_replicas,
                                     until=step + window))
            events.append(ChaosEvent(step=step + window + 2, kind="heal"))
            step += spacing
            i += 1
        return cls(events)

    @classmethod
    def overload_storm(cls, seed: int, steps: int, n_windows: int = 2,
                       x_range: Tuple[float, float] = (2.0, 6.0),
                       window: Tuple[int, int] = (8, 24)) -> "Schedule":
        """Seeded overload windows: ``n_windows`` bursts, each
        multiplying the attached load shaper's open-loop arrival rate by
        a drawn ``x`` for a drawn window length — the serving analogue of
        ``Schedule.random``'s fault draws.  Same seed => identical
        program => (with the seeded Poisson schedule) byte-identical
        executed arrivals; the runner REFUSES the program when no load
        shaper is attached (the net-fault routability rule)."""
        rng = np.random.default_rng(
            (int(seed) * 0xD1B54A32D192ED03 + 3) & 0xFFFFFFFFFFFFFFFF)
        events = []
        if n_windows <= 0:
            return cls(events)
        span = max(1, steps // n_windows)
        for i in range(n_windows):
            lo = i * span + 1
            w = int(rng.integers(window[0], window[1] + 1))
            start = lo + int(rng.integers(0, max(1, span - w)))
            xval = round(float(x_range[0] + (x_range[1] - x_range[0])
                               * rng.random()), 3)
            events.append(ChaosEvent(step=start, kind="overload", x=xval,
                                     until=min(steps - 1, start + w)))
        return cls(events)

    @classmethod
    def random(cls, cfg, seed: int, steps: int,
               spec: Optional[ChaosSpec] = None) -> "Schedule":
        """Seeded event program: one uniform per step selects the event
        class by the spec's rates; a second pre-drawn uniform resolves the
        target at RUN time (eligibility depends on cluster state, which is
        deterministic given the same seed + config)."""
        spec = spec or ChaosSpec()
        rng = np.random.default_rng(seed)
        events = []
        for step in range(steps):
            u = float(rng.random())
            pick = float(rng.random())
            lo = 0.0
            wire_verbs = tuple(WIRE_EVENTS)
            for kind, p in (("freeze", spec.p_freeze),
                            ("thaw", spec.p_thaw),
                            ("join", spec.p_join),
                            ("crash_restart", spec.p_crash),
                            ("hb_skew", spec.p_skew),
                            ("net_drop", spec.p_net / 3),
                            ("net_delay", spec.p_net / 3),
                            ("net_dup", spec.p_net / 3),
                            ("partition", spec.p_partition),
                            ) + tuple(
                                (v, spec.p_wire / len(wire_verbs))
                                for v in wire_verbs):
                if lo <= u < lo + p:
                    kw: dict = dict(step=step, kind=kind, u=pick)
                    if kind == "hb_skew":
                        kw.update(skew=spec.skew_amount,
                                  until=step + spec.skew_window)
                    elif kind.startswith("net_") or kind in WIRE_EVENTS:
                        kw.update(until=step + spec.net_window,
                                  skew=spec.net_delay)
                    elif kind == "partition":
                        # directed (dst=-1 -> the target's whole outbound
                        # side goes dark: an ASYMMETRIC partition — its
                        # inbound still flows)
                        kw.update(until=step + spec.partition_window)
                    events.append(ChaosEvent(**kw))
                    break
                lo += p
        return cls(events)


class NetChaos:
    """Window-driven adversarial schedule for the sim transport
    (``transport.sim.SimTransport(R, schedule=NetChaos())``): active
    windows drop / delay / duplicate messages on matching directed
    edges.  The runner opens windows from net_* events and
    ``clear()``s them when healing."""

    def __init__(self):
        # (kind, src, dst, from_step, until, delta); src/dst -1 = any
        self.windows: List[Tuple[str, int, int, int, int, int]] = []

    def add(self, kind: str, src: int, dst: int, from_step: int, until: int,
            delta: int = 0) -> None:
        self.windows.append((kind, src, dst, from_step, until, delta))

    def clear(self) -> None:
        self.windows.clear()

    def _match(self, kind: str, src: int, dst: int, step: int):
        for k, ws, wd, f, until, delta in self.windows:
            if k != kind:
                continue
            if ws >= 0 and ws != src:
                continue
            if wd >= 0 and wd != dst:
                continue
            if f <= step < until:
                return delta
        return None

    def __call__(self, kind: str, src: int, dst: int, step: int):
        if src == dst:
            return [step]  # loopback never traverses the faulty fabric
        if self._match("drop", src, dst, step) is not None:
            return []
        whens = [step]
        delta = self._match("delay", src, dst, step)
        if delta is not None:
            whens = [step + max(1, delta)]
        if self._match("dup", src, dst, step) is not None:
            whens = whens + [whens[0] + 1]
        return whens


class ChaosRunner:
    """Drive a workload target through a fault schedule (module docstring).

    ``target``: a FastRuntime, a KVS facade or a phases ``Runtime``.
    ``net``: the NetChaos installed in the target's SimTransport (sim
    engine only).
    ``wire``: the chaos.net.FaultingTransport interposer wrapping the
    target's HostTransport — carries the netdrop/netdelay/
    netdup/netreorder/netcorrupt/partition verbs (and the legacy net_*
    verbs when ``net`` is absent).  Schedules with net-fault lines are
    REFUSED at construction when no carrier is attached (the error names
    the transport class).
    ``snapshot_path``: opts crash_restart into snapshot-seeded restore;
    with ``snapshot_every`` > 0 the runner refreshes the snapshot itself
    at that cadence (fast engines, quiescent boundaries only — the KVS
    save requires no in-flight client ops, so the runner snapshots the
    RUNTIME under the facade).
    ``powercut``: the whole-process kill carrier — a callable
    ``powercut(step)`` that SIGKILLs the store process (in the durability
    gate's soak child: ``os.kill(os.getpid(), signal.SIGKILL)``).  It is
    expected NOT to return; schedules with powercut lines are refused at
    construction when no carrier is attached, same contract as the wire
    verbs."""

    def __init__(self, target, schedule: Schedule,
                 spec: Optional[ChaosSpec] = None,
                 net: Optional[NetChaos] = None,
                 wire=None,
                 load=None,
                 snapshot_path: Optional[str] = None,
                 powercut: Optional[Callable[[int], None]] = None,
                 on_step: Optional[Callable[[int], None]] = None):
        self.kvs = target if (hasattr(target, "rt")
                              and hasattr(target, "index")) else None
        self.rt = target.rt if self.kvs is not None else target
        self.target = target
        self.schedule = schedule
        self.spec = spec or ChaosSpec()
        self.net = net
        # the transport-generic fault interposer
        # (chaos.net.FaultingTransport wrapping the target's HostTransport)
        self.wire = wire
        # the open-loop load shaper (workload.ShapedArrivals or
        # anything with set_rate_x) the overload verbs act on
        self.load = load
        self._overload_until: Optional[int] = None
        # the whole-process kill carrier (see the class docstring)
        self.powercut = powercut
        self.snapshot_path = snapshot_path
        self.on_step = on_step
        self.log: List[dict] = []
        self.lost_ops = 0
        self.lost_client = 0
        self._frozen_since: Dict[int, int] = {}
        self._removed: set = set()
        self._skew_until: Dict[int, int] = {}
        # active partitions: (until, src, dst, start) — start is kept so
        # expiring one window can re-derive the oracle's severed set from
        # the windows still active (overlapping windows on the same src
        # must not end each other early)
        self._partition_until: List[Tuple[int, int, int, int]] = []
        # schedule cursor (tick() consumes events; run() drives tick —
        # a fleet runner drives MANY runners' ticks in lockstep,
        # one per group, each over its own group-scoped target)
        self._ev_iter = iter(self.schedule)
        self._nxt = next(self._ev_iter, None)
        self._check_net_faults_routable()

    def _transport_name(self) -> str:
        tr = getattr(self.rt, "transport", None)
        if tr is not None:
            return type(tr).__name__
        return (f"{type(self.rt).__name__}"
                f"[{getattr(self.rt, 'backend', '?')}] (no host transport)")

    def _check_net_faults_routable(self) -> None:
        """Refuse net-fault schedule lines UP FRONT when no interposer can
        carry them: before this check, a sim-only
        composition failed silently (events logged 'skipped') or late.  The
        error names the transport class so the fix is actionable."""
        wire_lines = [e for e in self.schedule if e.kind in WIRE_EVENTS]
        legacy_lines = [e for e in self.schedule
                        if e.kind in LEGACY_NET_EVENTS]
        part_lines = [e for e in self.schedule if e.kind == "partition"]
        over_lines = [e for e in self.schedule
                      if e.kind in ("overload", "overload_clear")]
        cut_lines = [e for e in self.schedule if e.kind == "powercut"]
        name = self._transport_name()
        if cut_lines and self.powercut is None:
            ls = ", ".join(e.format() for e in cut_lines[:3])
            raise ValueError(
                f"schedule contains powercut events ({ls}) but no kill "
                "carrier is attached: a powercut SIGKILLs the WHOLE store "
                "process, which only a harness can arrange — pass "
                "ChaosRunner(..., powercut=<callable(step)>) (the "
                "durability gate's soak child kills its own pid)")
        if over_lines and self.load is None:
            ls = ", ".join(e.format() for e in over_lines[:3])
            raise ValueError(
                f"schedule contains overload events ({ls}) but no load "
                "shaper is attached: pass the open-loop arrival schedule "
                "(workload.ShapedArrivals, or anything with set_rate_x) "
                "as ChaosRunner(..., load=...)")
        if wire_lines and self.wire is None:
            ls = ", ".join(e.format() for e in wire_lines[:3])
            raise ValueError(
                f"schedule contains wire-fault events ({ls}) but no fault "
                f"interposer is attached to {name}: wrap the transport in "
                "chaos.net.FaultingTransport and pass it as "
                "ChaosRunner(..., wire=...)")
        if legacy_lines and self.wire is None and self.net is None:
            ls = ", ".join(e.format() for e in legacy_lines[:3])
            raise ValueError(
                f"schedule contains net-fault events ({ls}) but {name} has "
                "no fault hook: pass net=NetChaos() installed as the "
                "SimTransport schedule, or wire=chaos.net.FaultingTransport "
                "wrapping the transport")
        if part_lines and self.wire is None:
            # fast engines: partition is detector-level (membership oracle)
            if self.rt.membership is None:
                ls = ", ".join(e.format() for e in part_lines[:3])
                raise ValueError(
                    f"schedule contains partition events ({ls}) but {name} "
                    "has no fault interposer and no MembershipService: on "
                    "the fast engines a partition acts through the "
                    "detector — attach_membership(...) first (or run the "
                    "sim engine with wire=FaultingTransport(...))")

    # -- bookkeeping ---------------------------------------------------------

    def _healthy(self) -> List[int]:
        return self.rt.healthy_replicas()

    def _note(self, step: int, kind: str, **fields) -> None:
        self.log.append(dict(step=step, kind=kind, **fields))

    def _pick(self, cands: Sequence[int], u: float) -> int:
        return int(sorted(cands)[int(u * len(cands)) % len(cands)])

    # -- event application ---------------------------------------------------

    def _apply(self, step: int, e: ChaosEvent) -> None:
        rt = self.rt
        healthy = self._healthy()
        if e.kind == "freeze":
            cands = ([e.replica] if e.replica >= 0 else
                     [r for r in healthy if r not in self._frozen_since])
            if len(healthy) <= self.spec.min_healthy or not cands:
                return
            r = self._pick(cands, e.u)
            rt.freeze(r)
            self._frozen_since[r] = step
            self._note(step, "freeze", replica=r)
        elif e.kind == "thaw":
            cands = ([e.replica] if e.replica >= 0
                     else list(self._frozen_since))
            cands = [r for r in cands if r in self._frozen_since]
            if not cands:
                return
            r = self._pick(cands, e.u)
            rt.thaw(r)
            del self._frozen_since[r]
            self._note(step, "thaw", replica=r)
        elif e.kind == "remove":
            r = e.replica
            if r < 0 or not (int(rt.live[0]) >> r) & 1:
                return
            # the legality floor applies to removes of HEALTHY replicas
            # too (removing a frozen one is the normal lease outcome): an
            # over-aggressive declarative schedule degrades to what the
            # cluster can absorb instead of emptying it
            if r in healthy and len(healthy) <= self.spec.min_healthy:
                self._note(step, "skipped", event=e.kind, replica=r,
                           reason="healthy floor")
                return
            rt.remove(r)
            self._removed.add(r)
            self._frozen_since.pop(r, None)
            self._note(step, "remove", replica=r)
        elif e.kind == "join":
            cands = ([e.replica] if e.replica >= 0 else list(self._removed))
            cands = [r for r in cands if r in self._removed]
            if not cands or not healthy:
                return
            r = self._pick(cands, e.u)
            donor = e.donor if e.donor >= 0 else healthy[0]
            rt.join(r, from_replica=donor)
            self._removed.discard(r)
            self._note(step, "join", replica=r, donor=donor)
        elif e.kind == "crash_restart":
            from hermes_tpu_torch.chaos import recovery

            if not hasattr(rt, "fs"):
                self._note(step, "skipped", event=e.kind,
                           reason="phases runtime")
                return
            cands = ([e.replica] if e.replica >= 0 else
                     [r for r in healthy if r not in self._frozen_since])
            if len(healthy) <= self.spec.min_healthy or not cands:
                return
            r = self._pick(cands, e.u)
            donor = e.donor if e.donor >= 0 else None
            s = recovery.restart_replica(self.target, r, donor=donor,
                                         snapshot_path=self.snapshot_path)
            self.lost_ops += s["lost_ops"]
            self.lost_client += s["lost_client_futures"]
            self._frozen_since.pop(r, None)
            self._removed.discard(r)
            self._note(step, "crash_restart", replica=r, donor=s["donor"],
                       source=s["source"], lost_ops=s["lost_ops"])
        elif e.kind == "hb_skew":
            svc = rt.membership
            if svc is None:
                self._note(step, "skipped", event=e.kind,
                           reason="no membership service")
                return
            cands = [e.replica] if e.replica >= 0 else healthy
            if not cands:
                return
            r = self._pick(cands, e.u)
            svc.skew[r] = e.skew
            self._skew_until[r] = e.until if e.until >= 0 else step + 8
            rt._trace("hb_skew", replica=r, skew=e.skew,
                      until=self._skew_until[r])
            self._note(step, "hb_skew", replica=r, skew=e.skew,
                       until=self._skew_until[r])
        elif e.kind in LEGACY_NET_EVENTS or e.kind in WIRE_EVENTS:
            # one body for both verb generations; only the carrier differs
            # (legacy net_* prefers the NetChaos sim schedule when present,
            # everything else rides the interposer — construction
            # refused schedules with no carrier at all)
            op = LEGACY_NET_EVENTS.get(e.kind) or WIRE_EVENTS[e.kind]
            R = rt.cfg.n_replicas
            src = e.replica if e.replica >= 0 else self._pick(range(R), e.u)
            until = e.until if e.until >= 0 else step + self.spec.net_window
            if e.kind in LEGACY_NET_EVENTS and self.net is not None:
                self.net.add(op, src, e.dst, step, until, delta=e.skew)
            else:
                self.wire.add(op, src, e.dst, step, until,
                              param=e.skew if e.skew else self.spec.net_delay)
            rt._trace(e.kind, src=src, dst=e.dst, until=until)
            self._note(step, e.kind, src=src, dst=e.dst, until=until)
            self._update_net_phase(step)
        elif e.kind == "partition":
            # directed: src -> dst goes dark (dst=-1: src's whole OUTBOUND
            # side — an asymmetric partition; src still hears the cluster).
            # On a wired engine the interposer blacks the edges out and the
            # detector sees the starvation organically; on the fast engines
            # (no wire) the membership oracle models exactly the
            # detector-visible consequence (membership.sever) — the data
            # plane of the fused round is untouched, so safety there rests
            # on the lease rule: the ejected replica is fenced by remove().
            R = rt.cfg.n_replicas
            src = e.replica if e.replica >= 0 else self._pick(range(R), e.u)
            until = e.until if e.until >= 0 else (
                step + self.spec.partition_window)
            if self.wire is not None:
                self.wire.add("partition", src, e.dst, step, until)
            svc = rt.membership
            if self.wire is None and svc is not None:
                svc.sever(src, e.dst, at_step=step)
            self._partition_until.append((until, src, e.dst, step))
            rt._trace("partition", src=src, dst=e.dst, until=until)
            self._note(step, "partition", src=src, dst=e.dst, until=until)
            self._update_net_phase(step)
        elif e.kind == "heal":
            self._heal_adversary(step)
            self._heal_cluster(step)
            self._note(step, "heal")
            self._update_net_phase(step)
        elif e.kind == "overload":
            x = e.x or 2.0
            self.load.set_rate_x(x)
            self._overload_until = e.until if e.until >= 0 else None
            rt._trace("overload", x=x, until=e.until)
            self._note(step, "overload", x=x, until=e.until)
        elif e.kind == "overload_clear":
            self.load.set_rate_x(1.0)
            self._overload_until = None
            rt._trace("overload_clear")
            self._note(step, "overload_clear")
        elif e.kind == "powercut":
            # note + trace BEFORE the carrier fires: it SIGKILLs this
            # process and does not return, so this log line (and whatever
            # the trace fsyncs) is all the forensic record the parent gets
            self._note(step, "powercut")
            rt._trace("powercut", step=step)
            self.powercut(step)
            # a mock carrier (tests) may return; nothing to clean up —
            # the real one never reaches here

    def _expire_overload(self, step: int) -> None:
        """Close an overload window whose ``until`` elapsed (explicit
        ``overload_clear`` events also close it)."""
        if self._overload_until is not None and step >= self._overload_until:
            self.load.set_rate_x(1.0)
            self._overload_until = None
            self.rt._trace("overload_clear")
            self._note(step, "overload_clear")

    def _expire_skews(self, step: int) -> None:
        svc = self.rt.membership
        for r, until in list(self._skew_until.items()):
            if step >= until:
                if svc is not None:
                    svc.skew[r] = 0
                del self._skew_until[r]

    def _expire_partitions(self, step: int) -> None:
        """Restore detector-oracle partitions whose window elapsed (wire
        windows expire by their own step test).  The severed set is
        RE-DERIVED from the still-active windows rather than edge-wise
        restored: a wildcard restore for one lapsed window must not end an
        overlapping window on the same src early."""
        if not self._partition_until:
            return
        svc = self.rt.membership
        live = [p for p in self._partition_until if p[0] > step]
        if len(live) != len(self._partition_until):
            self._partition_until = live
            if self.wire is None and svc is not None:
                svc.heal_partitions()
                # earliest-start first: sever() keeps the first since-step
                # per edge, so overlapping windows retain the oldest age
                for _until, src, dst, start in sorted(live,
                                                      key=lambda p: p[3]):
                    svc.sever(src, dst, at_step=start)
            self._update_net_phase(step)

    def _update_net_phase(self, step: int) -> None:
        """Publish the active adversary windows into the KVS stuck-op
        diagnostics channel (StuckOpError carries the
        partition/drop spec + affected peer pairs, like the drill
        phase)."""
        if self.kvs is None:
            return
        edges = []
        if self.wire is not None:
            edges = [f"{w['op']}:{w['src']}->{w['dst']}@{w['until']}"
                     for w in self.wire.active_windows(step)]
        else:
            edges = [f"partition:{src}->{dst}@{until}"
                     for until, src, dst, _start in self._partition_until
                     if until > step]
        self.kvs.net_phase = dict(windows=sorted(edges)) if edges else None

    def _heal_adversary(self, step: int) -> None:
        """Clear every active network-level fault: wire windows, legacy
        NetChaos windows, detector-oracle partitions, heartbeat skews."""
        rt = self.rt
        if self.net is not None:
            self.net.clear()
        if self.wire is not None:
            self.wire.heal(step)
        if rt.membership is not None:
            rt.membership.heal_partitions()
            for r in list(self._skew_until):
                rt.membership.skew[r] = 0
        self._skew_until.clear()
        self._partition_until.clear()
        # unconditional, like skews/partitions: an `overload x=N` with no
        # until= (open window awaiting an overload_clear) must not outlive
        # a heal
        if self.load is not None:
            self.load.set_rate_x(1.0)
            self._overload_until = None

    def _heal_cluster(self, step: int) -> None:
        """Thaw every frozen replica and rejoin every non-live one through
        the epoch-fenced state-transfer join — the partition+heal cycle's
        recovery half (a partitioned-but-alive replica kept its state; the
        join re-validates, it never diverges).  Skips loudly when no live
        donor exists."""
        rt = self.rt
        for r in list(self._frozen_since):
            rt.thaw(r)
            self._note(step, "thaw", replica=r, by="heal")
        self._frozen_since.clear()
        # the detector may have removed replicas on its own — rejoin every
        # non-live replica, not just the runner's bookkeeping
        for r in range(rt.cfg.n_replicas):
            if not (int(rt.live[0]) >> r) & 1:
                donors = self._healthy()
                if not donors:
                    self._note(step, "skipped", event="join", replica=r,
                               reason="no live donor")
                    continue
                rt.join(r, from_replica=donors[0])
                self._note(step, "join", replica=r, donor=donors[0],
                           by="heal")
        self._removed.clear()

    def _lease_rule(self, step: int) -> None:
        """Detector-less removal: a replica frozen past the lease window is
        ejected (the historical soak's stand-in for the membership
        service).  A real MembershipService owns this when attached."""
        if self.rt.membership is not None:
            return
        for r, since in list(self._frozen_since.items()):
            if step - since > self.spec.lease_remove_after:
                self.rt.remove(r)
                self._removed.add(r)
                del self._frozen_since[r]
                self._note(step, "remove", replica=r, by="lease")

    def _step_target(self) -> None:
        if self.kvs is not None:
            self.kvs.step()
        else:
            self.rt.step_once()

    # -- the drive -----------------------------------------------------------

    def tick(self, step: int) -> None:
        """Everything one scheduled round does EXCEPT stepping the
        target: expire lapsed windows, run the lease rule, apply due
        events.  ``run`` drives this loop for one target; a fleet runner
        (``fleet.FleetChaosRunner``) ticks one runner per group in
        lockstep and steps the groups itself."""
        self._expire_skews(step)
        self._expire_partitions(step)
        if self.load is not None:
            self._expire_overload(step)
        if self.kvs is not None and self.wire is not None:
            # wire windows expire by their own step test: refresh the
            # diagnostics channel so a stuck op is never blamed on a
            # window that already ended
            self._update_net_phase(step)
        self._lease_rule(step)
        while self._nxt is not None and self._nxt.step <= step:
            self._apply(step, self._nxt)
            self._nxt = next(self._ev_iter, None)

    def run(self, steps: int, heal: bool = True, drain_steps: int = 4000,
            check: bool = False) -> dict:
        """Run ``steps`` rounds with the schedule applied, then (``heal``)
        thaw/rejoin everything, clear skews and net windows, drain, and
        optionally run the linearizability gate.  Returns the result dict:
        executed event log, loss accounting, drained/verdict flags."""
        # run() always replays the schedule from its first event (the
        # pre-tick() contract): reset the cursor so a second run() — or a
        # run() after standalone tick() driving — is never silently empty
        self._ev_iter = iter(self.schedule)
        self._nxt = next(self._ev_iter, None)
        for step in range(steps):
            self.tick(step)
            self._step_target()
            if self.on_step is not None:
                self.on_step(step)
        result: dict = dict(steps=steps, lost_ops=self.lost_ops,
                            lost_client_futures=self.lost_client)
        if heal:
            rt = self.rt
            self._heal_adversary(steps)
            # (skip loudly if no live donor exists rather than crash: an
            # adversarial schedule can legally empty the healthy set)
            self._heal_cluster(steps)
            self._update_net_phase(steps)
            if self.kvs is not None:
                # pipelined KVS: _pending (the deferred round) refills on
                # every step, so quiescence is judged on client work only
                # and the final flush lands the last deferred round
                drained = True
                for _ in range(drain_steps):
                    if not (self.kvs._inflight or self.kvs._queued_slots
                            or self.kvs._bat):
                        break
                    self.kvs.step()
                else:
                    drained = False
                self.kvs.flush()
                rt.flush_pipeline()
            else:
                drained = rt.drain(drain_steps)
            result["drained"] = bool(drained)
        if check:
            v = self.rt.check()
            result["checked_ok"] = bool(v.ok)
            result["check_failures"] = [
                getattr(f, "reason", str(f))[:200]
                for f in (v.failures + v.undecided)[:3]]
            if not v.ok and self.rt.obs is not None \
                    and self.rt.obs.flight.dumps:
                # checker red: rt.check() just dumped the flight recorder
                # (obs/flightrec.py) — surface the archive path
                # in the chaos result so soak triage finds it
                result["flight_dump"] = self.rt.obs.flight.dumps[-1]
        result["events"] = self.log
        return result

    def log_json(self) -> str:
        """Canonical executed-event log (the determinism witness: same
        seed + config => byte-identical)."""
        return json.dumps(self.log, sort_keys=True, separators=(",", ":"))
