"""hermes_tpu_torch.fleet: key-sharded protocol groups, the port of
``hermes_tpu/fleet``.

Hermes coordinates writes per key, so throughput scales by running many
independent key-sharded replica groups side by side.  This package puts
G complete single-group stacks — each a ``kvs.KVS`` over a
``FastRuntime`` with its own membership service, chaos scope and
snapshot scope — behind:

  * ``FleetRouter`` (``router.py``) — fleet key -> (owning group, local
    dense slot), boundary-exact through ``keyindex.RangeRouter``, with
    the migration drain/flip state machine in fleet coordinates;
  * ``Fleet`` (``core.py``) — the routed client facade: sessions and
    batches routed by key, per-group checkers and the fleet-level
    ``verify_fleet`` (routing injectivity, migration-uid namespace
    disjointness, group-scoped membership), cross-group ``migrate``
    through the router flip, per-group snapshot scope;
  * ``FleetChaosRunner`` / ``fleet_schedules`` (``chaos.py``) —
    group-scoped fault programs driven in lockstep, replayed
    deterministically fleet-wide;
  * ``run_fleet_cells`` (``bench.py``) — per-group and concurrent
    committed writes/s (on one card the concurrent cell is the fleet's
    number).

Configuration is ``config.FleetConfig``; the replica groups of a sharded
fleet come from ``launch.fleet_replica_groups``.
"""

from hermes_tpu_torch.config import FleetConfig
from hermes_tpu_torch.fleet.bench import run_fleet_cells
from hermes_tpu_torch.fleet.chaos import (FleetChaosRunner, fleet_schedules,
                                          parse_fleet)
from hermes_tpu_torch.fleet.core import Fleet, FleetBatch, verify_fleet
from hermes_tpu_torch.fleet.router import FleetRouter

__all__ = [
    "Fleet", "FleetBatch", "FleetChaosRunner", "FleetConfig", "FleetRouter",
    "fleet_schedules", "parse_fleet", "run_fleet_cells", "verify_fleet",
]
