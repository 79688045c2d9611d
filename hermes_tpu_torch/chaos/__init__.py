"""hermes_tpu_torch.chaos: crash recovery, the part of
``hermes_tpu/chaos`` the durable store needs (``recovery.py``).  The
declarative fault schedules (``schedule.py``) are ROADMAP A11 and the
wire adversary (``net.py``) A12."""

from hermes_tpu_torch.chaos.recovery import (
    recover_store,
    restart_replica,
    wipe_volatile,
)

__all__ = ["recover_store", "restart_replica", "wipe_volatile"]
