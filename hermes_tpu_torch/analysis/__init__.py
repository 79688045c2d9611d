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
fixture kernels the red tests are built on.  The engine-level passes and
the host lint of the reference are not ported.

    python -m hermes_tpu_torch.analysis --kernels [--device cpu]
"""

from hermes_tpu_torch.analysis.diffcheck import (  # noqa: F401
    KernelCell, analyze_kernel, cell_by_name, diff_check, kernel_cells,
    run_kernel_matrix)
from hermes_tpu_torch.analysis.domain import AbsVal, iv  # noqa: F401
from hermes_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR, GATING, INFO, WARN, Finding, export_findings)
