"""Builds the port's native code from the sources in the checkout, at first
use, into ``hermes_tpu_torch/_build/`` (listed in ``.gitignore``).

* CUDA kernels (``csrc/*.cu``): ``nvcc`` for ``sm_90a`` into a shared
  library with a plain C interface, loaded with ``ctypes`` — no PyTorch
  headers, so a build takes seconds.  The library's file name carries a
  hash of its source and flags, so an edited source never loads a stale
  build.  ``build_cuda_all`` starts one ``nvcc`` per source, all together.
  The libraries link the shared CUDA runtime, which resolves to the one
  PyTorch has loaded: with a static runtime of their own, torch.profiler
  missed some of their launches (on an H100, 2 of 30 traces of one
  kernel; none of 150 with the shared runtime).
* Every source also has a bound-checked build, a second library compiled
  with ``-DHERMES_CHECKED`` (``csrc/guard.cuh``): each global-memory access
  is tested against its extent, a violation recorded and the access
  skipped.  ``core/dispatch.checked_build`` selects it; nothing selects it
  by itself.  ``BROKEN`` lists the test-only checked builds that leave a
  kernel's own clamp out, for the red tests of the guard.
* The host C++ libraries (``native/``): the checker's witness core
  (``checker_core.cpp``) and the TCP mesh (``tcp_transport.cpp``), both
  threaded (``-pthread``: ``THREAD_FLAGS``), each with ``g++``.

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared")
CHECKED_FLAGS = NVCC_FLAGS + ("-DHERMES_CHECKED",)
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
#: sources that start threads: the mesh's senders, the checker's workers
THREAD_FLAGS = CXX_FLAGS + ("-pthread",)
#: test-only checked builds: source name -> the define that breaks it
BROKEN = {"mega_apply": "HERMES_BROKEN_NO_CLAMP"}

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
    """The library of ``src`` built with ``flags``: named by a hash of the
    source, the headers it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def cuda_flags(name: str, checked: bool = False, broken: bool = False):
    """nvcc flags of ``csrc/<name>.cu``: the release build, the
    bound-checked one, or (``broken``) the checked one without the
    kernel's own clamp."""
    if not broken:
        return CHECKED_FLAGS if checked else NVCC_FLAGS
    if not checked:
        raise ValueError("a broken build exists only as a checked build")
    return CHECKED_FLAGS + (f"-D{BROKEN[name]}",)


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


def build_cuda_all() -> Dict[str, Dict[str, float]]:
    """Build every library of every ``csrc/*.cu`` that is not current: the
    release build, the checked build and the ``BROKEN`` ones, one ``nvcc``
    per library, all started together.  Returns, per kind of build
    (``release``, ``checked``, ``broken``), the seconds after which each
    source's library was there (0.0 for one that was already built)."""
    jobs = []
    secs: Dict[str, Dict[str, float]] = {"release": {}, "checked": {},
                                         "broken": {}}
    t0 = time.perf_counter()
    for src in cuda_sources():
        kinds = [("release", cuda_flags(src.stem)),
                 ("checked", cuda_flags(src.stem, checked=True))]
        if src.stem in BROKEN:
            kinds.append(("broken", cuda_flags(src.stem, True, True)))
        for kind, flags in kinds:
            out = _lib_path(src, flags)
            if out.exists():
                secs[kind][src.name] = 0.0
                continue
            jobs.append((kind, src, out,
                         _start([nvcc(), *flags, str(src)], out)))
    for kind, src, out, proc in jobs:
        _finish(proc, out)
        secs[kind][src.name] = time.perf_counter() - t0
    return secs


def load_cuda(name: str, checked: bool = False,
              broken: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (see ``cuda_flags`` for the
    three builds), built first if needed."""
    src = CSRC / f"{name}.cu"
    flags = cuda_flags(name, checked, broken)
    out = _lib_path(src, flags)
    if out not in _loaded:
        if not out.exists():
            _finish(_start([nvcc(), *flags, str(src)], out), out)
        _loaded[out] = ctypes.CDLL(str(out))
    return _loaded[out]


def load_cxx(src: pathlib.Path, flags=CXX_FLAGS) -> ctypes.CDLL:
    """The loaded library of a C++ source, built with ``g++`` and
    ``flags`` if needed."""
    out = _lib_path(src, flags)
    if out not in _loaded:
        if not out.exists():
            _finish(_start(["g++", *flags, str(src)], out), out)
        _loaded[out] = ctypes.CDLL(str(out))
    return _loaded[out]
