"""The port's transport layer (``hermes_tpu/transport``): the
host-mediated exchange of the phases engine's message blocks.

  * ``base``  — the ``HostTransport`` interface and the zero-delay
    ``LockstepHostTransport``;
  * ``sim``   — the deterministic adversarial ``SimTransport``;
  * ``tcp``   — the C++ full-mesh socket exchanger (``native/
    tcp_transport.cpp``) and ``TcpHostTransport`` over it, one process a
    replica (``distributed.py``);
  * ``rdma``  — the interface stub (no NIC in scope);
  * ``codec`` — the block, frame (CRC), byte and columnar record codecs;
  * ``shm``   — the zero-copy SPSC column rings over shared memory that
    the serving plane's shm front ends feed one store through
    (``serving.ipc``).

The serving wire codecs live in ``serving/wire.py``.
"""

from hermes_tpu_torch.transport.base import (HostTransport,
                                             LockstepHostTransport)

__all__ = ["HostTransport", "LockstepHostTransport"]
