"""Builds the port's native code from the sources in the checkout, at first
use, into ``hermes_tpu_torch/_build/`` (listed in ``.gitignore``).

* CUDA kernels (``csrc/*.cu``): ``nvcc`` for ``sm_90a`` into a shared
  library with a plain C interface, loaded with ``ctypes`` — no PyTorch
  headers, so a build takes seconds.  The library's file name carries a
  hash of its source and flags, so an edited source never loads a stale
  build.  ``build_cuda_all`` starts one ``nvcc`` per source, all together.
* The checker's C++ witness core (``native/checker_core.cpp``): ``g++``.

Builds write to a temporary name and rename into place, so concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List

PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PKG / "_build"
CSRC = PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_loaded: Dict[pathlib.Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, not under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built here")
    return path


def cuda_sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: pathlib.Path, flags) -> pathlib.Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{h[:12]}.so"


def _start(cmd: List[str], out: pathlib.Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    return subprocess.Popen(cmd + ["-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, out: pathlib.Path) -> None:
    log, _ = proc.communicate()
    tmp = pathlib.Path(proc.args[-1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"build of {out.name} failed ({' '.join(proc.args)}):\n{log}")
    os.replace(tmp, out)


def build_cuda_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` that has no current library: one ``nvcc``
    per source, all started together.  Returns the seconds each source's
    build took (0.0 for a source that was already built)."""
    jobs, secs = [], {}
    t0 = time.perf_counter()
    for src in cuda_sources():
        out = _lib_path(src, NVCC_FLAGS)
        if out.exists():
            secs[src.name] = 0.0
            continue
        jobs.append((src, out, _start([nvcc(), *NVCC_FLAGS, str(src)], out)))
    for src, out, proc in jobs:
        _finish(proc, out)
        secs[src.name] = time.perf_counter() - t0
    return secs


def load_cuda(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    src = CSRC / f"{name}.cu"
    out = _lib_path(src, NVCC_FLAGS)
    if out not in _loaded:
        if not out.exists():
            _finish(_start([nvcc(), *NVCC_FLAGS, str(src)], out), out)
        _loaded[out] = ctypes.CDLL(str(out))
    return _loaded[out]


def load_cxx(src: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of a C++ source, built with ``g++`` if needed."""
    out = _lib_path(src, CXX_FLAGS)
    if out not in _loaded:
        if not out.exists():
            _finish(_start(["g++", *CXX_FLAGS, str(src)], out), out)
        _loaded[out] = ctypes.CDLL(str(out))
    return _loaded[out]
