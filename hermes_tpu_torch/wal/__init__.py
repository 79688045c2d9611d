"""The durability tier: the host-side write-ahead extent+commit log, a
port of ``hermes_tpu/wal``.

The completion stream already carries every committed write in round
order (``runtime.FastRuntime.harvest_comp`` feeds the recorder from it),
so durability is a TAP on that stream: ``GroupCommitWal`` appends
``(uid, key, ts=(ver, fc), value words + heap extent bytes)`` records in
CRC-framed segments, a flusher thread group-commits them with ONE fsync
per batch, and ``replay`` turns the segments back into table rows
idempotently (by packed timestamp).  Segments are byte-compatible with
the JAX package's: either package reads what the other wrote.

Public surface:
  * ``GroupCommitWal``       — the log + flusher (log.py)
  * ``WalError/WalCorrupt``  — loud refusal types
  * ``read_records/apply_records`` — recovery half (replay.py)
"""

from hermes_tpu_torch.wal.log import (  # noqa: F401
    GroupCommitWal,
    WalError,
    K_SEGHDR,
    K_ROUND,
    K_REMAP,
)
from hermes_tpu_torch.wal.replay import (  # noqa: F401
    WalCorrupt,
    read_records,
    apply_records,
)
