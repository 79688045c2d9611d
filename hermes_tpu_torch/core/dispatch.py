"""What every kernel wrapper of the port shares: argument checks, the
device rule (a CPU tensor goes to the plain version, a CUDA tensor to the
kernel) and the launch of a ``csrc/<name>.cu`` entry point through ctypes.
Used by ``core/kernels.py`` (its launch), ``core/megaround.py`` and
``core/probe_kernels.py``."""

from __future__ import annotations

import ctypes

import torch

from hermes_tpu_torch import build


def on_card(name: str, *xs) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix of
    devices or any other device."""
    dev = xs[0].device
    for x in xs[1:]:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors "
                         "only")
    return dev.type == "cuda"


def need(name: str, what: str, x, dtype, shape=None) -> None:
    """Raise unless ``x`` is a ``dtype`` tensor (of ``shape``, if given)."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype:
        got = x.dtype if isinstance(x, torch.Tensor) else type(x).__name__
        raise TypeError(f"{name}: {what} must be a {dtype} tensor, got {got}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(x.shape)}, want "
                         f"{tuple(shape)}")


_entry: dict = {}  # kernel name -> its typed C entry point


def launch(name: str, dev, *args) -> None:
    """Call ``hermes_<name>`` of ``csrc/<name>.cu`` (built at first use)
    with the tensors' pointers and the ints as they are, on the current
    stream; raise on a CUDA error."""
    fn = _entry.get(name)
    if fn is None:
        fn = getattr(build.load_cuda(name), f"hermes_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                       for a in args] + [ctypes.c_void_p]
        _entry[name] = fn
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a if isinstance(a, int) else a.data_ptr() for a in args),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
