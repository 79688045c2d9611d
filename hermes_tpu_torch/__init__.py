"""hermes_tpu_torch: the PyTorch/CUDA port of hermes-tpu.

A replicated, linearizable in-memory KVS running the Hermes protocol as a
bulk-synchronous round over a packed key-state table — the batched fast
engine of ``hermes_tpu`` (the JAX package, which stays the reference),
rewritten for PyTorch on an NVIDIA H100, with the round's Pallas kernel
replaced by a hand-written CUDA kernel (``core/kernels.py``).

Entry points run on the card unless the caller passes ``device="cpu"``:

    from hermes_tpu_torch import HermesConfig, FastRuntime, KVS
    rt = FastRuntime(HermesConfig(n_keys=512, n_sessions=16), record=True)
    assert rt.drain(500) and rt.check().ok

This package imports ``torch`` and never ``jax`` or ``hermes_tpu``.  The
top-level exports resolve lazily (module ``__getattr__``): importing the
package, or a torch-free module under it (``serving.ipc``,
``transport.shm``, ``serving.wire``), loads no ``torch`` — the serving
front-end worker processes depend on that.
"""

import importlib

__all__ = ["HermesConfig", "WorkloadConfig", "FleetConfig", "FastRuntime",
           "Runtime", "KVS", "MultiGetResult", "KeyIndex", "RangeRouter",
           "Fleet", "FleetRouter", "Frontend", "ServingConfig"]

# the module each export lives in, imported on first use
_HOME = {
    "HermesConfig": "config", "WorkloadConfig": "config",
    "FleetConfig": "config", "KVS": "kvs", "MultiGetResult": "kvs",
    "KeyIndex": "keyindex", "RangeRouter": "keyindex", "Fleet": "fleet",
    "FleetRouter": "fleet.router", "FastRuntime": "runtime",
    "Runtime": "runtime", "Frontend": "serving.server",
    "ServingConfig": "serving.server",
}


def __getattr__(name):
    # resolved names are cached in module globals, so this runs once a name
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    obj = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals()) | set(__all__))
