"""Device time on the card from ``torch.profiler``: the busy time of a run
(the round's device metric) and the device time of one call (the kernels'
and the probe's)."""

from __future__ import annotations

import time

import torch


def _trace(run):
    """Device busy time (sum of CUDA kernel time), kernel count, wall time
    and the top kernels of ``run()``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n, top = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0.0)
            busy_us += us
            n += e.count
            top.append((us, e.count, e.key[:60]))
    top.sort(reverse=True)
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=n, top=top[:8])


def device_busy(run):
    """``_trace(run)``; raises when the trace shows no device time."""
    out = _trace(run)
    if out["busy_s"] <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return out


def device_per_call(call, n=20):
    """Device seconds and device launches per call of ``call()``, over one
    traced burst of ``n`` calls.  Raises if the trace holds no device time
    or no whole number of launches per call: a trace that missed launches
    (as it did on an H100 while the port's kernels linked a static CUDA
    runtime of their own; ``build.py`` links the shared one) is refused,
    not read."""
    out = _trace(lambda: [call() for _ in range(n)])
    if out["busy_s"] <= 0 or out["launches"] % n:
        raise RuntimeError(f"torch.profiler recorded {out['launches']} "
                           f"launches and {out['busy_s']} s for {n} calls")
    return out["busy_s"] / n, out["launches"] // n
