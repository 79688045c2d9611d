"""hermes_tpu_torch.analysis — the kernel matrix and its sanitizer.

Port of the kernel-matrix path of ``hermes_tpu/analysis``
(``python -m hermes_tpu.analysis --kernels``).  The reference proves kernel
invariants by walking jaxprs with an abstract interpreter; PyTorch and CUDA
have no jaxpr, so in the port those guarantees come from two places:

* a bound-checked build of every CUDA kernel (``csrc/guard.cuh``,
  ``core/dispatch.checked_build``), the counterpart of the reference's
  ``RefHazardPass``: every global-memory access is tested against its
  extent, outputs are poisoned before the launch, and findings carry the
  reference's codes (``analysis/findings.py``);
* the differential sanitizer (``analysis/diffcheck.py``): every kernel cell
  on seeded draws inside its declared input bounds, every output held
  inside its declared output bound (``analysis/seeds.py``).

``analysis/fixture_kernels.py`` holds the scan-accumulate sentinel and the
fixture kernels the red tests are built on.  The host half of the
reference's concurrency analysis is here too: ``hostlint.py`` (the static
lint against ``hermes_tpu_torch/concurrency.py``'s registry) and
``lockgraph.py`` (the dynamic lock-order sanitizer behind
``HERMES_LOCKLINT=1``).  The engine-level passes are not ported.

    python -m hermes_tpu_torch.analysis --kernels [--device cpu]

Exports resolve lazily (module ``__getattr__``): ``lockgraph`` is loaded
by the torch-free shm worker processes, which must not load ``torch``
through this package.
"""

import importlib

# the module each export lives in, imported on first use
_HOME = {
    "KernelCell": "diffcheck", "analyze_kernel": "diffcheck",
    "cell_by_name": "diffcheck", "diff_check": "diffcheck",
    "kernel_cells": "diffcheck", "run_kernel_matrix": "diffcheck",
    "AbsVal": "domain", "iv": "domain",
    "ERROR": "findings", "GATING": "findings", "INFO": "findings",
    "WARN": "findings", "Finding": "findings",
    "export_findings": "findings",
}
__all__ = sorted(_HOME)


def __getattr__(name):
    # resolved names are cached in module globals, so this runs once a name
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    obj = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals()) | set(__all__))
