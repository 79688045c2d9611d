"""Device time and device operations on the card.  What no lost record
can change: ``graph_ops`` (the device operations of a call, the nodes of
a CUDA graph it is captured into) and ``queued_s`` (the device time of
calls queued behind a spin kernel, from CUDA events).  From
``torch.profiler``, which loses records in episodes: ``_trace`` (kernels
by name, host launch calls) and ``device_split`` / ``device_per_call``
(``launch_floor.py``).

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


#: the host API calls that enqueue device work, as ``launch_calls``
#: counts them: kernel launches, graph launches, copies and fills
HOST_LAUNCH_APIS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                    "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                    "cuMemset")


def _trace(run):
    """Device busy time (sum of CUDA kernel time), kernel count, wall time,
    the top kernels of ``run()``, every kernel's count by name
    (``names``), the host's launch calls by API (``launch_calls``:
    ``HOST_LAUNCH_APIS``, the sentinel's two among them) and the top host
    operators by the device
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
                HOST_LAUNCH_APIS):
            api[e.key] = api.get(e.key, 0) + e.count
    top.sort(reverse=True)
    ops.sort(reverse=True)
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=n, top=top[:8],
                top_ops=ops[:8], names=names, launch_calls=api)


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


#: the CUDA driver's graph node types (``CUgraphNodeType``)
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_ops(call) -> dict:
    """The device operations one ``call()`` enqueues, by kind
    (``NODE_KINDS``; ``total`` their sum): ``call`` is run once on a
    stream of its own (its first-use state), then captured into a CUDA
    graph on that stream, which runs nothing, and the graph's nodes are
    counted through the driver.  Nothing is lost, as a profiler trace can
    lose records.  Raises if the call cannot be captured (it syncs, or
    copies from pageable host memory)."""
    import ctypes

    import gc

    from hermes_tpu_torch.core import graphs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
        # no garbage collection frees device memory inside the capture
        # (core/graphs.py)
        graphs.make_room(torch.cuda.current_device())
        collecting = gc.isenabled()
        gc.disable()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            call()
        finally:
            graph.capture_end()
            if collecting:
                gc.enable()
    torch.cuda.current_stream().wait_stream(side)
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    out = {}
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        if drv.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                  ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = NODE_KINDS.get(kind.value, f"type{kind.value}")
        out[name] = out.get(name, 0) + 1
    out["total"] = n.value
    return out


def queued_s(call, inner=20, spin_cycles=1 << 24, tries=4):
    """Device seconds a call with the host out of the way: ``inner``
    calls enqueued behind a spin kernel that outlasts their enqueueing,
    so they run back to back on the device between two CUDA events
    (nothing is lost, as a profiler trace can lose records).  None if the
    spin ended before the last call was enqueued, ``tries`` times over at
    a spin four times longer each time: a call that waits on the device
    cannot be queued."""
    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(inner):
            call()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden:
            return a.elapsed_time(b) / inner / 1e3
        spin_cycles *= 4
    return None


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
