"""hermes_tpu_torch.analysis — the static round analysis, the kernel
matrix and its sanitizer, and the host lock analysis.

Port of ``hermes_tpu/analysis``.  The round analysis proves, before a
round runs, that its hand-packed words are sound under the config's
declared bounds: ``graph.py`` records one round of either engine as a
functionalized FX graph (the counterpart of ``jax.make_jaxpr``, with one
node per hand-kernel call and per collective, and each node's site and
audit tag), ``interp.py`` walks it with the interval-and-mask domain of
``domain.py`` from the seeds of ``seeds.py``, and ``passes.py`` runs five
passes over it:

  bitpack   every shift/or pack overlap-free and int32-sign-safe
  dtype     torch's rule: no int64 wrap, no narrowing convert that
            changes a value, floats only where the config allows them
  scatter   every index inside its dimension; set-scatters carry
            injectivity evidence
  refhazard every hand-kernel node held to its declared input seeds and
            output bounds, its access pattern audited
  sharding  collectives name the declared axis with its size

``engines.py`` traces and analyzes the engine programs
(``analyze_config``), which the CLI, ``--analyze`` and the ``analysis``
gate share; findings inside a ``core/layouts.audited`` scope are info
findings with the tag.

The kernels' own guarantees (the reference interprets Pallas bodies; the
port's kernels are CUDA) come from two places:

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
``HERMES_LOCKLINT=1``).

    python -m hermes_tpu_torch.analysis [--config bench] [--engine both]
        [--device cpu]
    python -m hermes_tpu_torch.analysis --kernels [--device cpu]
    python -m hermes_tpu_torch.analysis --host [--device cpu]

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
    "export_findings": "findings", "findings_of": "findings",
    "key_counts": "findings", "diff_baseline": "findings",
    "load_baseline": "findings",
    "Program": "engines", "analyze_config": "engines",
    "analyze_program": "engines", "trace_program": "engines",
    "variant_of": "engines",
    "default_passes": "passes", "HandKernelPass": "passes",
    "lint_package": "hostlint", "lint_source": "hostlint",
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
