"""Fleet-wide chaos: per-group fault scopes, one lockstep drive.  The
port of ``hermes_tpu/fleet/chaos.py``.

Faults in a fleet are GROUP-SCOPED by construction: every group gets its
own ``chaos.ChaosRunner`` over its own KVS, runtime and membership
service, so a schedule line for group 0 cannot touch a group 1 replica.
What the fleet adds is the DRIVE: one lockstep loop ticking every group's
runner at the same round index and stepping all groups each round, so a
fleet-wide seeded program replays byte-identically (same seed and
FleetConfig: identical per-group executed logs and final states; the
same logs as the JAX package's).

Text form: one schedule per group, each line prefixed with its group
(``g1@12 freeze 2``); unprefixed lines go to group 0, so single-group
schedules stay valid fleet schedules.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

from hermes_tpu_torch.chaos.schedule import ChaosRunner, ChaosSpec, Schedule


def fleet_schedules(fcfg, seed: int, steps: int,
                    spec: Optional[ChaosSpec] = None) -> List[Schedule]:
    """One seeded program per group: group g draws from the seed ``seed *
    1_000_003 + g`` (deterministic, group-disjoint streams) over that
    group's OWN config, so per-group shapes draw per-group legal
    targets."""
    return [Schedule.random(fcfg.group_cfg(g), seed * 1_000_003 + g, steps,
                            spec)
            for g in range(fcfg.groups)]


def parse_fleet(text: str, groups: int) -> List[Schedule]:
    """Parse a fleet schedule: ``gN@STEP KIND ...`` lines route to group
    N; unprefixed ``@STEP ...`` lines route to group 0."""
    per: List[list] = [[] for _ in range(groups)]
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        g = 0
        if line.startswith("g"):
            head, _, rest = line.partition("@")
            try:
                g = int(head[1:])
            except ValueError:
                raise ValueError(f"line {ln}: bad group prefix {head!r}")
            if not (0 <= g < groups):
                raise ValueError(f"line {ln}: group {g} outside "
                                 f"[0, {groups})")
            line = "@" + rest
        per[g].append(line)
    return [Schedule.parse("\n".join(lines) + "\n") if lines
            else Schedule([]) for lines in per]


class FleetChaosRunner:
    """Drive a Fleet through per-group schedules in lockstep: round k
    ticks every group's runner (expiries, lease rule, due events, all
    group-scoped), then steps every group once.  Heal, drain and the
    per-group and fleet-level correctness gate ride the fleet facade."""

    def __init__(self, fleet, schedules: Sequence[Schedule],
                 spec: Optional[ChaosSpec] = None,
                 on_step: Optional[Callable[[int], None]] = None):
        if len(schedules) != len(fleet.groups):
            raise ValueError(
                f"need one schedule per group "
                f"({len(schedules)} != {len(fleet.groups)}); use "
                "Schedule([]) for groups the adversary leaves alone")
        self.fleet = fleet
        self.on_step = on_step
        self.runners = [
            ChaosRunner(grp.kvs, sched, spec=spec)
            for grp, sched in zip(fleet.groups, schedules)
        ]

    def run(self, steps: int, heal: bool = True, drain_steps: int = 4000,
            check: bool = False) -> dict:
        for step in range(steps):
            for runner in self.runners:
                runner.tick(step)
            self.fleet.step()
            if self.on_step is not None:
                self.on_step(step)
        result: dict = dict(
            steps=steps,
            lost_ops=sum(r.lost_ops for r in self.runners),
            lost_client_futures=sum(r.lost_client for r in self.runners),
        )
        if heal:
            for runner in self.runners:
                runner._heal_adversary(steps)
                runner._heal_cluster(steps)
                runner._update_net_phase(steps)
            result["drained"] = bool(self.fleet.drain(drain_steps))
        if check:
            verdicts = self.fleet.check()
            result["checked_ok"] = bool(verdicts["ok"])
            result["group_verdicts"] = verdicts["groups"]
        result["events"] = {g: runner.log
                            for g, runner in enumerate(self.runners)}
        return result

    def log_json(self) -> str:
        """Canonical fleet executed-event log (the determinism witness:
        same seed and FleetConfig give byte-identical text)."""
        return json.dumps([r.log for r in self.runners], sort_keys=True,
                          separators=(",", ":"))
