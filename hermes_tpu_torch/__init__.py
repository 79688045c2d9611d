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

This package imports ``torch`` and never ``jax`` or ``hermes_tpu``.
"""

from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
from hermes_tpu_torch.kvs import KVS
from hermes_tpu_torch.runtime import FastRuntime

__all__ = ["HermesConfig", "WorkloadConfig", "FastRuntime", "KVS"]
