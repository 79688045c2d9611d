"""Device time on the card from ``torch.profiler``: the busy time of a run
(the round's device metric) and the device time of one call (the kernels'
and the probe's).

    python -m hermes_tpu_torch.profiling [--traces 250] [--calls 80]

counts the traces that lose device records (``lost_records``)."""

from __future__ import annotations

import sys
import time

import torch


#: the kernel of ``torch.cuda._sleep``, which each trace launches before
#: and after what it measures and leaves out of its counts: a trace can
#: come back one device record short (on an H100, a burst of 20 calls
#: traced at 19 launches, six times in a row), and a lost sentinel costs
#: nothing
SENTINEL = "spin_kernel"


def _trace(run):
    """Device busy time (sum of CUDA kernel time), kernel count, wall time,
    the top kernels of ``run()``, every kernel's count by name
    (``names``), the host's launch calls by API (``launch_calls``, the
    sentinel's two among them) and the top host operators by the device
    time of the kernels each launched itself (``top_ops``: which PyTorch
    call a kernel name stands for), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    busy_us, n, top, ops, names, api = 0.0, 0, [], [], {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and SENTINEL not in e.key:
            busy_us += us
            n += e.count
            top.append((us, e.count, e.key[:60]))
            names[e.key] = names.get(e.key, 0) + e.count
        elif e.device_type == DeviceType.CPU and us > 0 and (
                "_sleep" not in e.key):
            ops.append((us, e.count, e.key[:60]))
        if e.device_type == DeviceType.CPU and e.key.startswith(
                ("cudaLaunch", "cuLaunch")):
            api[e.key] = api.get(e.key, 0) + e.count
    top.sort(reverse=True)
    ops.sort(reverse=True)
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=n, top=top[:8],
                top_ops=ops[:8], names=names, launch_calls=api)


def device_busy(run):
    """``_trace(run)``; raises when the trace shows no device time."""
    out = _trace(run)
    if out["busy_s"] <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return out


# torch.profiler on an H100 loses device records in episodes: for some
# 100 ms, a few seconds to a quarter of a minute apart, consecutive traces
# come back short or empty (PyTorch's own kernels as well as the port's,
# with or without a pause inside the trace's ends; once six traces in a
# row, about two seconds; in one chip smoke ten in a row, one record
# of 20 short each).  A burst is therefore traced until two traces in a
# row hold the same whole number of launches per call, with a pause after
# a refused one to let the episode pass, twice as long after each refused
# trace in a row (at most ``_PAUSE_MAX_S``): some 80 s of episode before
# a burst gives up.
_TRACES = 24
_PAUSE_S = 0.25
_PAUSE_MAX_S = 4.0
# Besides, the older the process, the fewer of a burst's device records a
# trace keeps, the same ones in consecutive traces: one bench-a round
# traced after every phase of the chip smoke kept 787 records fresh and
# 736 at the end, while its host launch calls (``launch_calls``: 777,
# the sentinel's two among them) and aten ops stayed the same (H100,
# PERF.md section 6).  A count held exactly is taken early in a fresh
# process.

# A trace of some 3,000 launches or more comes back short every time (an
# H100: 3,074 of 3,075, 20,497 to 20,499 of 20,500), so a burst is cut to
# hold at most this many launches, or one call.
_LAUNCHES_MAX = 1000


def device_split(call, n=20):
    """Device seconds and device launches per call of ``call()``, and the
    device operations one call enqueues: a burst of ``n`` calls is traced
    until two consecutive traces agree on a whole number of launches per
    call (at most ``_TRACES`` traces; the second one is read).  A trace
    of more than ``_LAUNCHES_MAX`` launches cuts ``n`` to fit and counts
    as refused.  A trace with no device time or a count that is no
    multiple of ``n`` missed launches: it is refused, not read, and said
    so on stderr.  Raises if no two traces agree.  The operations are
    ``[name, seconds per call, launches per call]``, the longest first (at
    most eight)."""
    last, pause = None, _PAUSE_S
    for _ in range(_TRACES):
        out = _trace(lambda: [call() for _ in range(n)])
        if out["launches"] > _LAUNCHES_MAX and n > 1:
            n = max(1, n * _LAUNCHES_MAX // out["launches"])
            last = None
        elif out["busy_s"] <= 0 or out["launches"] % n:
            print(f"profiling: refused a trace of {out['launches']} launches "
                  f"and {out['busy_s']} s for {n} calls", file=sys.stderr,
                  flush=True)
            last = None
            time.sleep(pause)
            pause = min(2 * pause, _PAUSE_MAX_S)
        elif out["launches"] == last:
            ops = [[name, us / 1e6 / n, cnt / n] for us, cnt, name
                   in out["top"]]
            return out["busy_s"] / n, out["launches"] // n, ops
        else:
            last = out["launches"]
    raise RuntimeError(f"torch.profiler gave no two agreeing traces of {n} "
                       f"calls in {_TRACES}: the last held "
                       f"{out['launches']} launches and {out['busy_s']} s")


def device_launches(prepare, run):
    """The CUDA kernels ``run(prepare())`` launches, with ``prepare()``
    outside the trace (a fresh input a trace): traced until two
    consecutive traces agree (at most ``_TRACES``), refusing a trace with
    no device time as ``device_split`` does.  Raises if none agree."""
    last, pause = None, _PAUSE_S
    for _ in range(_TRACES):
        args = prepare()
        out = _trace(lambda: run(args))
        if out["busy_s"] <= 0:
            print(f"profiling: refused a trace of {out['launches']} launches "
                  "and no device time", file=sys.stderr, flush=True)
            last = None
            time.sleep(pause)
            pause = min(2 * pause, _PAUSE_MAX_S)
        elif out["launches"] == last:
            return last
        else:
            last = out["launches"]
    raise RuntimeError(f"torch.profiler gave no two agreeing traces in "
                       f"{_TRACES}: the last held {out['launches']} launches")


def device_per_call(call, n=20):
    """Device seconds and device launches per call of ``call()``
    (``device_split`` without the operations)."""
    return device_split(call, n)[:2]


def lost_records(traces=250, n=80):
    """Trace ``traces`` bursts of ``n`` one-kernel calls, of a PyTorch add
    and of the port's ``fx_pack`` in turns, and list every trace that does
    not hold ``n`` launches: ``[index, seconds since the start, launches
    seen]`` under each call's name."""
    from hermes_tpu_torch.analysis.fixture_kernels import fx_pack

    a = torch.ones((8, 128), dtype=torch.int32, device="cuda")
    calls = {"torch_add": lambda: a + a, "fx_pack": lambda: fx_pack(a, a)}
    short = {name: [] for name in calls}
    t0 = time.perf_counter()
    for i in range(traces):
        for name, call in calls.items():
            seen = _trace(lambda: [call() for _ in range(n)])["launches"]
            if seen != n:
                short[name].append([i, round(time.perf_counter() - t0, 3),
                                    seen])
    return dict(traces_each=traces, calls_a_trace=n,
                seconds=time.perf_counter() - t0, short=short)


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=lost_records.__doc__)
    ap.add_argument("--traces", type=int, default=250)
    ap.add_argument("--calls", type=int, default=80)
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiling: this needs a CUDA card")
    print(json.dumps(lost_records(ns.traces, ns.calls)), flush=True)
