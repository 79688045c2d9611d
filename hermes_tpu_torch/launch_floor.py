"""What a launch-bound kernel of the port cannot go below, on the card:
device time a call (``profiling.device_per_call``) of an empty kernel and
of small fills and copies built the way the port builds its libraries,
beside PyTorch's fills and copy and the port's ``fx_loop_inc``,
``fx_store_at`` (a fill and one row) and ``fx_async_copy`` at the same
sizes.

    python -m hermes_tpu_torch.launch_floor

builds the variants below with nvcc (into ``build.BUILD_DIR``), checks
every fill and copy against what it must write, and prints one JSON line
(``us``: label -> device microseconds a call, two readings each).  It
needs the card.  The variants are measurement aids, not kernels of the
port: ``fill`` stores ``times`` (10) in every word of 1,024, a word or a
16-byte int4 a thread, in CTAs of the given width (``fx_loop_inc``'s
function); ``int4_copy`` copies one int4 a thread through registers
(``fx_async_copy``'s function without the Tensor Memory Accelerator).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from hermes_tpu_torch import build
from hermes_tpu_torch.analysis import fixture_kernels as fk
from hermes_tpu_torch.profiling import device_per_call

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}

__global__ void fill(int32_t* out, int units, int times, int vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= units) return;
  int32_t v = 0;
  for (int t = 0; t < times; ++t) v += 1;
  if (vec) reinterpret_cast<int4*>(out)[i] = make_int4(v, v, v, v);
  else out[i] = v;
}

__global__ void int4_copy(const int4* x, int4* out, int units) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < units) out[i] = x[i];
}
}  // namespace

extern "C" {
int floor_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int floor_fill(void* out, int n, int threads, int vec, void* stream) {
  const int units = vec ? n / 4 : n;
  fill<<<(units + threads - 1) / threads, threads, 0,
         static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(out),
                                              units, 10, vec);
  return static_cast<int>(cudaGetLastError());
}

int floor_int4_copy(const void* x, void* out, int n, void* stream) {
  const int units = n / 4;
  int4_copy<<<(units + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), units);
  return static_cast<int>(cudaGetLastError());
}
}  // extern "C"
"""

COPY_WORDS = (1024, 65536, 1028000)  # chip_smoke.FX_SHAPES of fx_async_copy


def load() -> ctypes.CDLL:
    """``SOURCE`` built as the port builds its release libraries."""
    tag = hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
    src = build.BUILD_DIR / f"launch_floor-{tag}.cu"
    out = build.BUILD_DIR / f"liblaunch_floor-{tag}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(SOURCE)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, str(src), "-o",
                        str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    V, I = ctypes.c_void_p, ctypes.c_int
    for name, args in (("floor_empty", [V]), ("floor_fill", [V, I, I, I, V]),
                       ("floor_int4_copy", [V, V, I, V])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, I
    return lib


def measure() -> dict:
    lib = load()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    us = {}

    def timed(label, call, want=None):
        err = call()
        if isinstance(err, int) and err != 0:
            raise RuntimeError(f"{label}: launch refused, CUDA error {err}")
        torch.cuda.synchronize()
        if want is not None and not want():
            raise AssertionError(f"{label} wrote the wrong values")
        us[label] = [device_per_call(call)[0] * 1e6 for _ in range(2)]

    o = torch.zeros(1024, dtype=torch.int32, device="cuda")
    tens = lambda: bool((o == 10).all())
    timed("empty 1x32", lambda: lib.floor_empty(stream()))
    timed("new_full 1024", lambda: o.new_full(o.shape, 10))
    timed("fx_loop_inc 1024", lambda: fk.fx_loop_inc(o, 10))
    v = torch.arange(1024, dtype=torch.int32, device="cuda").view(8, 128)
    idx = torch.tensor([[7]], dtype=torch.int32, device="cuda")
    timed("zeros_like 1024", lambda: torch.zeros_like(v))
    timed("fx_store_at 1024", lambda: fk.fx_store_at(idx, v))
    for vec, threads in ((0, 256), (1, 256), (1, 128)):
        o.zero_()
        timed(f"fill 1024 {'int4' if vec else 'word'} x{threads}",
              lambda vec=vec, threads=threads: lib.floor_fill(
                  o.data_ptr(), 1024, threads, vec, stream()), tens)
    for n in COPY_WORDS:
        x = torch.arange(n, dtype=torch.int32, device="cuda")
        y = torch.zeros_like(x)
        same = lambda: torch.equal(x, y)
        timed(f"clone {n}", lambda x=x: x.clone())
        timed(f"fx_async_copy {n}", lambda x=x: fk.fx_async_copy(x))
        timed(f"int4_copy {n}", lambda x=x, y=y, n=n: lib.floor_int4_copy(
            x.data_ptr(), y.data_ptr(), n, stream()), same)
    return dict(card=torch.cuda.get_device_name(0), us=us)


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_floor: this needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
