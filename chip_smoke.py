#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``hermes_tpu_torch``) on one
NVIDIA H100: the quickest proof that the port builds, runs and is right
on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and
prints no result):

1. device  — the card (nvidia-smi name and power limit), torch and CUDA.
2. build   — nvcc of every ``hermes_tpu_torch/csrc/*.cu``, all at once.
3. kernels — every ported kernel against its plain PyTorch version on the
   same inputs, bit-exact (integer outputs: tolerance 0), at the
   reference's kernel-matrix shapes, the bench shape and a ragged one,
   with the kernel's and the plain version's times beside the least time
   the card could take: per call on the stream (CUDA events, median of 25
   samples of 10 calls) and on the device (torch.profiler, the kernels
   one call enqueues, mean of 20 calls).
4. reference — the whole round on the card against the same round on the
   CPU (which the CPU tests hold bit-exact against the JAX reference) at
   a small shape, through a freeze and a removal: identical every round.
5. main    — the flagship bench configuration (``config.bench_cfg("a")``:
   8 replicas, 2^20 keys, 65,536 sessions per replica, full width) on
   ``FastRuntime(device="cuda")``: committed writes/s and us/round over a
   timed window, every kernel's launch count over that window (must equal
   the rounds run), and a profiled window's device busy share.
6. checked — the same configuration with the columnar history recorder
   for 16 rounds, then quiesced until nothing is in flight: the
   linearizability check must pass, every key must be VALID again, and
   the device op counters must equal the recorded completions.
7. kvs     — a ``KVS`` at the full key count, value width and session
   count: puts from replica 0 read back from every replica, one RMW.

Then the kernels summary line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Without a card, or without the package
beside it, the script exits non-zero before any phase.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32 rate
# outside the tensor cores, the table's nearest figure for scalar
# integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNEL_SHAPES = ((4, 512), (1024, 600), (512, 2000), (8, 65536), (2, 40000))
BENCH_SHAPE = (8, 65536)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, samples=25, inner=10):
    """Median over ``samples`` of the CUDA-event time of ``inner`` calls,
    per call, in ms (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def stats_inputs(torch, R, S, seed):
    g = torch.Generator().manual_seed(seed)
    op = torch.randint(0, 4, (R, S), generator=g, dtype=torch.int32)
    invoke = torch.randint(0, 90, (R, S), generator=g, dtype=torch.int32)
    commit = torch.rand((R, S), generator=g) < 0.3
    abort = (torch.rand((R, S), generator=g) < 0.05) & ~commit
    read = (torch.rand((R, S), generator=g) < 0.3) & ~commit & ~abort
    step = torch.tensor(77, dtype=torch.int32)
    return step, op, invoke, commit, abort, read


def stats_bound_ms(R, S):
    """Least time for stats_block's work: each input read once (2 int32 +
    3 bool per lane, the step), each output written once (the int32 code
    per lane, the counter and histogram rows); ~10 scalar ops per lane."""
    nbytes = R * S * (4 + 4 + 1 + 1 + 1) + 4 + R * S * 4 + R * (8 + 64) * 4
    ops = 10 * R * S
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3


def phase_kernels(torch, kernels):
    rows, max_err, bench = [], 0, None
    for R, S in KERNEL_SHAPES:
        args = stats_inputs(torch, R, S, seed=R * 7919 + S)
        want = kernels.stats_block_plain(*args)
        dev = [a.cuda() for a in args]
        before = kernels.stats_block.launches
        got = kernels.stats_block(*dev)
        counted = kernels.stats_block.launches - before
        plain_dev = kernels.stats_block_plain(*dev)
        torch.cuda.synchronize()
        if counted != 1:
            raise AssertionError(f"one stats_block call counted {counted} "
                                 f"launches")
        for w, g, p in zip(want, got, plain_dev):
            err = int((w.to(torch.int64) - g.cpu().to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if err or not torch.equal(p.cpu(), w):
                raise AssertionError(f"stats_block disagrees with its plain "
                                     f"version at R={R} S={S}")
        # per call: the stream time of back-to-back calls (CUDA events,
        # median), and the device time of the kernels a call enqueues
        # (torch.profiler, mean over 20 calls)
        call = lambda: kernels.stats_block(*dev)
        plain = lambda: kernels.stats_block_plain(*dev)
        kdev = device_busy(torch, lambda: [call() for _ in range(20)])
        pdev = device_busy(torch, lambda: [plain() for _ in range(20)])
        row = dict(R=R, S=S, exact=True, counted_launches=counted,
                   call_us=cuda_ms(torch, call) * 1e3,
                   device_us=kdev["busy_s"] / 20 * 1e6,
                   device_launches=kdev["launches"] / 20,
                   plain_call_us=cuda_ms(torch, plain) * 1e3,
                   plain_device_us=pdev["busy_s"] / 20 * 1e6,
                   plain_device_launches=pdev["launches"] / 20,
                   bound_us=stats_bound_ms(R, S) * 1e3)
        rows.append(row)
        if (R, S) == BENCH_SHAPE:
            bench = row
    emit({"phase": "kernels", "stats_block": rows, "max_abs_err": max_err})
    return dict(name="stats_block", route="cuda",
                source="hermes_tpu_torch/csrc/stats_block.cu",
                replaces="hermes_tpu/core/kernels.py:96",
                max_abs_err=max_err, ms=bench["device_us"] / 1e3,
                plain_ms=bench["plain_device_us"] / 1e3,
                bound_ms=bench["bound_us"] / 1e3, bound_by="bytes",
                library_ms=None)


def phase_reference(torch, config, fst, convert, ycsb, card_device="cuda"):
    """The round on the card against the same round on the CPU — which
    the CPU test suite holds bit-exact against the JAX reference — at a
    small shape, through a freeze and a removal with the replay scan
    firing: every state leaf and completion equal after every round."""
    cfg = config.HermesConfig(
        n_replicas=4, n_keys=256, n_sessions=32, replay_slots=8,
        ops_per_session=16, arb_mode="sort", chain_writes=4,
        wrap_stream=True, device_stream=True, lane_budget_cfg=24,
        read_unroll=2, replay_age=2, replay_scan_every=2,
        workload=config.WorkloadConfig(read_frac=0.4, rmw_frac=0.3, seed=3))
    devs = {"cpu": torch.device("cpu"), "card": torch.device(card_device)}
    fs = {k: fst.init_fast_state(cfg, d) for k, d in devs.items()}
    stream = {k: fst.prep_stream(ycsb.stub_stream(cfg), d)
              for k, d in devs.items()}
    rounds, replayed = 40, 0
    for s in range(rounds):
        host = {}
        for k, d in devs.items():
            ctl = fst.make_fast_ctl(cfg, s, d)
            if s >= 10:  # replica 3 freezes, then leaves the membership
                ctl = ctl._replace(frozen=torch.tensor(
                    [False, False, False, True], device=d))
            if s >= 20:
                ctl = ctl._replace(
                    live_mask=torch.full((4,), 0b0111, dtype=torch.int32,
                                         device=d),
                    epoch=torch.ones(4, dtype=torch.int32, device=d))
            fs[k], comp = fst.fast_round_batched(cfg, ctl, fs[k], stream[k])
            leaves = [x.cpu() for c in comp for x in c]
            host[k] = (convert.fast_state_to_numpy(fs[k]), leaves)
        for a, b in zip(host["cpu"][0], host["card"][0]):
            for x, y in zip(a, b):
                if not (x.shape == y.shape and (x == y).all()):
                    raise AssertionError(f"card and CPU states differ at "
                                         f"round {s}")
        if not all(torch.equal(x, y)
                   for x, y in zip(host["cpu"][1], host["card"][1])):
            raise AssertionError(f"card and CPU completions differ at "
                                 f"round {s}")
        replayed = max(replayed, int(fs["card"].replay.active.sum()))
    if replayed == 0:
        raise AssertionError("the replay scan never fired in the reference "
                             "drive")
    emit({"phase": "reference", "rounds": rounds, "identical": True,
          "replay_slots_peak": replayed})


def device_busy(torch, run):
    """Device busy time (sum of CUDA kernel time), kernel count and wall
    time of ``run()``, from torch.profiler; raises when the trace shows no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top.sort(reverse=True)
    return dict(wall_s=wall, busy_s=busy_us / 1e6, launches=n, top=top[:8])


def phase_main(torch, kernels, config, FastRuntime, card):
    cfg = config.bench_cfg("a")
    rt = FastRuntime(cfg, device="cuda")
    rt.fetch_completions = False  # throughput drive: counters only
    rt.run(4)  # warm-up
    c0 = rt.counters()
    rounds = 60
    kernels.stats_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.stats_block.launches
    c1 = rt.counters()
    if launches != rounds:
        raise AssertionError(f"stats_block launched {launches} times in "
                             f"{rounds} main-path rounds")
    commits = int(c1["n_write"] + c1["n_rmw"] - c0["n_write"] - c0["n_rmw"])
    prof_rounds = 5
    busy = device_busy(torch, lambda: rt.run(prof_rounds))
    out = {"phase": "main", "card": card, "rounds": rounds,
           "writes_per_s": commits / wall, "us_per_round": wall / rounds * 1e6,
           "commits": commits, "stats_block_launches": launches,
           "reads": int(c1["n_read"] - c0["n_read"]),
           "aborts": int(c1["n_abort"] - c0["n_abort"])}
    out.update(profiled_rounds=prof_rounds,
               device_busy_share=busy["busy_s"] / busy["wall_s"],
               device_us_per_round=busy["busy_s"] / prof_rounds * 1e6,
               cuda_kernels_per_round=busy["launches"] / prof_rounds,
               profiled_us_per_round=busy["wall_s"] / prof_rounds * 1e6,
               top_device_us_per_round=[
                   [name, us / prof_rounds, cnt / prof_rounds]
                   for us, cnt, name in busy["top"]])
    emit(out)
    if commits <= 0:
        raise AssertionError("the main path committed nothing")
    return launches


def phase_checked(torch, kernels, config, FastRuntime, types):
    cfg = config.bench_cfg("a")
    rt = FastRuntime(cfg, record="array", device="cuda")
    rounds = 16
    kernels.stats_block.launches = 0
    rt.run(rounds)
    rt.quiesce = True  # no new work: in-flight writes and replays drain
    drained = 0
    while rt._inflight_count() and drained < 256:
        rt.step_once()
        drained += 1
    rt.flush_pipeline()
    if kernels.stats_block.launches != rounds + drained:
        raise AssertionError("stats_block launches != rounds in the checked run")
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded = rt.recorder.n_recorded
    valid = bool(((rt.fs.table.sst & 7) == types.VALID).all())
    hist = c["lat_hist"]
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    emit({"phase": "checked", "rounds": rounds, "drain_rounds": drained,
          "inflight_left": rt._inflight_count(), "device_ops": device_ops,
          "recorded_ops": recorded, "all_keys_valid": valid,
          "lat_bin0_share": float(hist[0] / max(1, hist.sum())),
          "check_ok": v.ok, "keys_checked": v.keys_checked,
          "check_s": check_s})
    if not v.ok:
        raise AssertionError(f"linearizability check failed: "
                             f"{[f.reason[:200] for f in v.failures[:3]]}")
    if rt._inflight_count() or not valid:
        raise AssertionError("the quiesced store did not converge to all-VALID")
    if device_ops != recorded:
        raise AssertionError(f"device op counters {device_ops} != recorded "
                             f"completions {recorded}")
    if hist[0] * 2 < hist.sum():
        raise AssertionError("commit latency bulk is not in bin 0")


def phase_kvs(torch, kernels, config, KVS):
    cfg = config.bench_cfg("a", over=dict(device_stream=False, read_unroll=1))
    kvs = KVS(cfg, device="cuda")
    kernels.stats_block.launches = 0
    keys = [3, 77, (1 << 20) - 1, 123456]
    puts = [kvs.put(0, i, k, [k, -k, 7, i, 0, 1]) for i, k in enumerate(keys)]
    if not kvs.run_until(puts, 64):
        raise AssertionError("puts did not commit")
    gets = [(r, k, kvs.get(r, 100 + i, k))
            for r in range(cfg.n_replicas) for i, k in enumerate(keys)]
    if not kvs.run_until([g for _, _, g in gets], 64):
        raise AssertionError("gets did not complete")
    for r, k, g in gets:
        want = [k, -k, 7, keys.index(k), 0, 1]
        if g.result().value != want:
            raise AssertionError(f"replica {r} read {g.result().value} for "
                                 f"key {k}, want {want}")
    m = kvs.rmw(5, 9, keys[0], [1, 2, 3, 4, 5, 6])
    if not kvs.run_until([m], 64):
        raise AssertionError("rmw did not complete")
    res = m.result()
    if res.kind != "rmw" or res.value != [keys[0], -keys[0], 7, 0, 0, 1]:
        raise AssertionError(f"rmw returned {res}")
    emit({"phase": "kvs", "keys": keys, "replicas_read": cfg.n_replicas,
          "rmw_displaced": res.value, "rounds": kvs.rt.step_idx,
          "stats_block_launches": kernels.stats_block.launches})
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != KVS rounds")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from hermes_tpu_torch import build, config, convert
        from hermes_tpu_torch.core import faststep as fst
        from hermes_tpu_torch.core import kernels, types
        from hermes_tpu_torch.workload import ycsb
        from hermes_tpu_torch.kvs import KVS
        from hermes_tpu_torch.runtime import FastRuntime
    except ImportError as e:
        print(f"chip_smoke: cannot import the port next to this script "
              f"({e})", file=sys.stderr)
        return 2
    try:
        card = nvidia_smi()
        emit({"phase": "device", "nvidia_smi": card,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})
        t0 = time.perf_counter()
        secs = build.build_cuda_all()
        emit({"phase": "build", "sources": secs,
              "seconds": time.perf_counter() - t0})
        stats_row = phase_kernels(torch, kernels)
        phase_reference(torch, config, fst, convert, ycsb)
        stats_row["launches"] = phase_main(torch, kernels, config,
                                           FastRuntime, card)
        phase_checked(torch, kernels, config, FastRuntime, types)
        phase_kvs(torch, kernels, config, KVS)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": [stats_row]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
