"""hermes_tpu_torch.chaos: fault injection and recovery, the port of
``hermes_tpu/chaos``.

  * ``recovery.py`` -- ``restart_replica`` (a full host-crash of one
    replica: lost in-flight ops as ``maybe_w``, fence + remove, snapshot
    or peer restore, rejoin with the donor's copy), ``recover_store``
    (a killed store back from its WAL) and ``wipe_volatile``.
  * ``schedule.py`` -- declarative, seeded fault programs (``Schedule``,
    ``ChaosEvent``, ``ChaosSpec``) and ``ChaosRunner``, which drives them
    against a FastRuntime, a KVS or the phases engine's Runtime with the
    failure detector (``membership.py``) deciding removals; every event on
    the obs timeline, the executed log byte-identical to the JAX
    package's.
  * ``net.py`` -- the wire adversary ``FaultingTransport``: seeded drop /
    delay / duplicate / reorder / corrupt / partition windows per
    directed peer pair over any host transport, corruption caught by the
    frame CRC.
"""

from hermes_tpu_torch.chaos.net import WIRE_OPS, FaultingTransport, WireWindow

from hermes_tpu_torch.chaos.recovery import (
    recover_store,
    restart_replica,
    wipe_volatile,
)
from hermes_tpu_torch.chaos.schedule import (
    EVENT_KINDS,
    ChaosEvent,
    ChaosRunner,
    ChaosSpec,
    NetChaos,
    Schedule,
)

__all__ = [
    "EVENT_KINDS", "ChaosEvent", "ChaosRunner", "ChaosSpec",
    "FaultingTransport", "NetChaos", "Schedule", "WIRE_OPS", "WireWindow",
    "recover_store", "restart_replica", "wipe_volatile",
]
