"""Host-mediated transport interface: the port of
``hermes_tpu/transport/base.py``.

The in-process backends (batched, sharded) make the exchange inside the
step (``core/step.py``).  A host-mediated backend implements this
interface instead: the runtime calls ``exchange_{inv,ack,val}`` between
phase invocations with numpy blocks (``state.Invs`` / ``Acks`` / ``Vals``
of numpy arrays):

  * INV/VAL outbound ``(R_src, L, ...)``, one lane block a source, sent to
    every destination;
  * ACK outbound ``(R_src, R_dst, L, ...)``: row p of source q answers the
    INVs q received from p and is routed back to p;
  * inbound (all kinds) ``(R_dst, R_src, L, ...)``.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class HostTransport(Protocol):
    def exchange_inv(self, out_inv, step: int): ...

    def exchange_ack(self, out_ack, step: int): ...

    def exchange_val(self, out_val, step: int): ...


class LockstepHostTransport:
    """Zero-delay host exchange: the batched backend's exchange, made on
    the host; the degenerate case of the sim transport."""

    def exchange_inv(self, out_inv, step: int):
        r = np.asarray(out_inv.valid).shape[0]
        return out_inv._replace(**{
            f: np.broadcast_to(np.asarray(v)[None], (r,) + np.asarray(v).shape)
            for f, v in out_inv._asdict().items()})

    def exchange_ack(self, out_ack, step: int):
        return out_ack._replace(**{
            f: np.swapaxes(np.asarray(v), 0, 1)
            for f, v in out_ack._asdict().items()})

    def exchange_val(self, out_val, step: int):
        r = np.asarray(out_val.valid).shape[0]
        return out_val._replace(**{
            f: np.broadcast_to(np.asarray(v)[None], (r,) + np.asarray(v).shape)
            for f, v in out_val._asdict().items()})
