"""RDMA transport stub: the port of ``hermes_tpu/transport/rdma.py``.

The Hermes reference's primary transport is RDMA (ibverbs UD sends with
inlining, doorbell batching, credit flow control, a memcached-style
bootstrap for QP exchange).  No RDMA NIC is in scope, so the plugin
interface ships as a stub that fails loudly rather than degrading to
something slower.

A real backend would give the surface of ``transport.tcp.TcpMesh`` —
``exchange(out_slices: (R, B) uint8) -> (R, B) uint8`` with per-edge FIFO
delivery — on ibverbs: one UD QP a process, INV/ACK/VAL records inlined
into sends, doorbell-batched posts a step and a credit counter a peer.
"""

from __future__ import annotations


class RdmaMesh:
    """Interface-compatible stand-in for an ibverbs transport."""

    def __init__(self, my_rank: int, n_ranks: int, hosts: str | None = None,
                 **kw):
        raise NotImplementedError(
            "transport=rdma requires an RDMA NIC and an ibverbs build; this "
            "environment has neither.  Use transport=tcp (same wire contract "
            "over sockets) or the in-process backends.  See this module's "
            "docstring for the implementation contract.")
