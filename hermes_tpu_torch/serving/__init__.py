"""The serving front end: the port of ``hermes_tpu/serving``.

  * ``wire``      — the CRC-framed request/response codecs, scalar,
    batched-read and columnar (numpy only, byte-identical to the
    reference's);
  * ``admission`` — the overload ladder, per-tenant quotas and token
    buckets, scalar and vectorised (``admit_batch``);
  * ``server``    — ``Frontend`` over a ``kvs.KVS`` or ``fleet.Fleet``
    and the columnar ``ColumnarFrontend`` over one KVS, with
    ``verify_serving`` / ``verify_columnar``;
  * ``rpc``       — the byte-honest loopbacks, the TCP servers and
    clients, and the SO_REUSEPORT worker process;
  * ``soak``      — the seeded open-loop and columnar soaks;
  * ``ipc``       — N front-end worker processes feeding one store
    process through shared-memory column rings (``transport.shm``);
  * ``bench``     — the serving latency/throughput cells.

Exports resolve lazily (module ``__getattr__``), so a process that
imports only ``serving.ipc`` — an shm front-end worker — loads neither
``torch`` nor CUDA: only the store process touches the card.
"""

import importlib

__all__ = [
    "wire", "AdmissionControl", "TokenBucket", "LoopbackServer",
    "RpcClient", "TcpRpcServer", "ColumnarClient", "ColumnarLoopback",
    "ColumnarTcpServer", "ColumnarFrontend", "Frontend", "ServingConfig",
    "VirtualClock", "verify_columnar", "verify_serving", "committed_uids",
    "measure_capacity", "run_open_loop", "OneStoreServer", "ShmWorker",
    "StoreOwner", "run_shm_soak",
]

# the module each export lives in, imported on first use
_HOME = {
    "wire": None,
    "AdmissionControl": "admission", "TokenBucket": "admission",
    "OneStoreServer": "ipc", "ShmWorker": "ipc", "StoreOwner": "ipc",
    "run_shm_soak": "ipc",
    "ColumnarClient": "rpc", "ColumnarLoopback": "rpc",
    "ColumnarTcpServer": "rpc", "LoopbackServer": "rpc", "RpcClient": "rpc",
    "TcpRpcServer": "rpc",
    "ColumnarFrontend": "server", "Frontend": "server",
    "ServingConfig": "server", "VirtualClock": "server",
    "verify_columnar": "server", "verify_serving": "server",
    "committed_uids": "soak", "measure_capacity": "soak",
    "run_open_loop": "soak",
}


def __getattr__(name):
    # resolved names are cached in module globals, so this runs once a name
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if _HOME[name] is None:  # a submodule
        obj = importlib.import_module(f"{__name__}.{name}")
    else:
        obj = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                      name)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals()) | set(__all__))
