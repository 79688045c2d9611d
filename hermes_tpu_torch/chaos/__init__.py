"""hermes_tpu_torch.chaos: fault injection and recovery, the port of
``hermes_tpu/chaos``.

  * ``recovery.py`` -- ``restart_replica`` (a full host-crash of one
    replica: lost in-flight ops as ``maybe_w``, fence + remove, snapshot
    or peer restore, rejoin with the donor's copy), ``recover_store``
    (a killed store back from its WAL) and ``wipe_volatile``.
  * ``schedule.py`` -- declarative, seeded fault programs (``Schedule``,
    ``ChaosEvent``, ``ChaosSpec``) and ``ChaosRunner``, which drives them
    against a FastRuntime or a KVS with the failure detector
    (``membership.py``) deciding removals; every event on the obs
    timeline, the executed log byte-identical to the JAX package's.

Not ported yet: the wire adversary ``chaos/net.py`` and the sim transport
that carries ``NetChaos`` windows (ROADMAP A12).
"""

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
    "EVENT_KINDS", "ChaosEvent", "ChaosRunner", "ChaosSpec", "NetChaos",
    "Schedule", "recover_store", "restart_replica", "wipe_volatile",
]
