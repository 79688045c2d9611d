#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``hermes_tpu_torch``) on one
NVIDIA H100: the quickest proof that the port builds, runs and is right
on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and
prints no result):

1. device  — the card (nvidia-smi name and power limit), torch and CUDA.
2. build   — nvcc of every ``hermes_tpu_torch/csrc/*.cu``, all at once.
3. kernels — every ported kernel (``stats_block``, ``mega_route``,
   ``mega_apply``, ``mega_replay``, ``probe_serial``, ``probe_vgather``)
   against its plain PyTorch version on the same inputs, bit-exact
   (integer outputs: tolerance 0), at the reference's kernel-matrix
   shapes, the bench shape and a ragged one, with the kernel's and the
   plain version's times beside the least time the card could take: per
   call on the stream (CUDA events, median of 25 samples of 10 calls) and
   on the device (torch.profiler, the kernels one call enqueues, mean of
   20 calls in one trace); for the probe kernels also the
   library call that computes the same function (``index_put_``,
   ``index_select``) at the bench shape.
   probe — the table-step probe (``hermes_tpu_torch.table_probe``): every
   cell of its ``main`` on the card, each candidate's state after three
   chained steps held against the CPU port's on the same inputs, then
   timed; the probe kernels' launches over the phase must equal the calls
   it made.
4. reference — the whole round on the card against the same round on the
   CPU (which the CPU tests hold bit-exact against the JAX reference) at
   a small shape, through a freeze and a removal: identical every round.
   reference-mega: the same drive with ``mega_round=True``.
5. main    — the flagship bench configuration (``config.bench_cfg("a")``:
   8 replicas, 2^20 keys, 65,536 sessions per replica, full width) on
   ``FastRuntime(device="cuda")``: committed writes/s and us/round over a
   timed window, every kernel's launch count over that window (must equal
   the rounds run), and a profiled window's device busy share.
   main-mega: the same with ``mega_round=True`` (each mega kernel's
   launches must equal its rounds), printed beside main's numbers; ab:
   four more windows of the two runtimes in turns (fused and mega three
   windows each, in the order A B B A A B).
6. checked — the same configuration with the columnar history recorder
   for 16 rounds, then quiesced until nothing is in flight: the
   linearizability check must pass, every key must be VALID again, and
   the device op counters must equal the recorded completions.
   checked-mega: ``mega_round=True`` with replica 1 frozen from round 8
   until after the replay scan of round 32, which must take slots.
7. kvs     — a ``KVS`` at the full key count, value width and session
   count: puts from replica 0 read back from every replica, one RMW.

Then the kernels summary line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Without a card, or without the package
beside it, the script exits non-zero before any phase.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32 rate
# outside the tensor cores, the table's nearest figure for scalar
# integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# kernel shapes: the bench shape first (bench-a with mega_round: R=8,
# S=65,536, L=65,792, C=49,152, K=2^20, 256 replay slots, 8 value words),
# then the reference's kernel cells (analysis/diffcheck.py) and ragged ones
BENCH_INDEX = 0
STATS_SHAPES = ((8, 65536), (4, 512), (1024, 600), (512, 2000),
                (2, 40000))  # R, S
ROUTE_SHAPES = ((8, 65792, 49152), (2, 6, 6), (3, 1001, 700))  # R, L, C
APPLY_SHAPES = ((1 << 20, 8 * 65792), (16, 16), (100003, 77777))  # K, N
REPLAY_SHAPES = ((1 << 20, 8, 256, 8, 4096),  # K, R, RS, V, stuck rows
                 (16, 2, 2, 2, 6), (22, 2, 2, 2, 9), (5003, 3, 7, 3, 300))
REPLAY_STEP, REPLAY_AGE = 1000, 16
# K table rows, M messages: the bench table and lanes, the probe's cell,
# almost all duplicates, ragged (with keys outside [0, K))
PROBE_SHAPES = ((1 << 20, 49152), (4096, 4096), (8, 256), (1000, 777))
PROBE_OUT_OF_RANGE = 3  # the index of the shape with keys outside [0, K)


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


def route_inputs(torch, R, L, seed):
    """si and srank: a permutation of each row (the sort's lane order and
    the slot ranks); word: verdict words."""
    g = torch.Generator().manual_seed(seed)
    si = torch.argsort(torch.rand((R, L), generator=g), dim=1).to(torch.int32)
    srank = torch.argsort(torch.rand((R, L), generator=g), dim=1).to(
        torch.int32)
    word = torch.randint(0, 1 << 22, (R, L), generator=g, dtype=torch.int32)
    return si, word, srank


def apply_inputs(torch, K, N, seed):
    """Lane keys over the column, a few outside it (negative, K and past
    it), packed timestamps, three quarters of the rows masked in."""
    g = torch.Generator().manual_seed(seed)
    vpts = torch.randint(0, 1 << 24, (K,), generator=g, dtype=torch.int32)
    keys = torch.randint(0, K, (N,), generator=g, dtype=torch.int32)
    keys[:4] = torch.tensor([-1, K, K + 5, (1 << 29) - 1])
    pts = torch.randint(0, 1 << 25, (N,), generator=g, dtype=torch.int32)
    mask = torch.rand((N,), generator=g) < 0.75
    return vpts, keys, pts, mask


def replay_inputs(torch, fst, K, R, RS, V, n_stuck, seed):
    """A bank of K rows, VALID but for ``n_stuck`` aged rows in state
    INVALID, TRANS or REPLAY scattered over the key range and as many
    young ones; replay slots 40 % active but replica 0's first, replica 1
    frozen and, with 3 or more replicas, the last one without a free
    slot."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31, (K, 2 + V), generator=g,
                          dtype=torch.int64).to(torch.int32)
    state = torch.zeros((K,), dtype=torch.int32)
    sst_step = torch.full((K,), REPLAY_STEP, dtype=torch.int32)
    rows = torch.randperm(K, generator=g)
    aged, young = rows[:n_stuck], rows[n_stuck:2 * n_stuck]
    pick = torch.tensor([1, 3, 4], dtype=torch.int32)  # INVALID TRANS REPLAY
    for part, lo, hi in ((aged, 0, REPLAY_STEP - REPLAY_AGE),
                         (young, REPLAY_STEP - REPLAY_AGE, REPLAY_STEP + 1)):
        state[part] = pick[torch.randint(0, 3, (len(part),), generator=g)]
        sst_step[part] = torch.randint(lo, hi, (len(part),), generator=g,
                                       dtype=torch.int32)
    words[:, 1] = (sst_step << 3) | state
    active = torch.rand((R, RS), generator=g) < 0.4
    active[0, 0] = False  # replica 0 takes at least one candidate
    if R >= 3:
        active[R - 1] = True
    frozen = torch.zeros((R,), dtype=torch.bool)
    frozen[1 % R] = True
    replay = fst.FastReplay(
        active=active,
        key=torch.randint(0, K, (R, RS), generator=g, dtype=torch.int32),
        pts=torch.randint(0, 1 << 24, (R, RS), generator=g,
                          dtype=torch.int32),
        val=torch.randint(-128, 128, (R, RS, 4 * V), generator=g,
                          dtype=torch.int8),
        acks=torch.randint(0, 1 << R, (R, RS), generator=g,
                           dtype=torch.int32))
    vpts = torch.randint(0, 1 << 24, (K,), generator=g, dtype=torch.int32)
    step = torch.tensor(REPLAY_STEP, dtype=torch.int32)
    return step, frozen, vpts, fst._i32_to_bank(words), replay


def probe_inputs(torch, K, M, W, seed, out_of_range):
    """A (K, W) table, M keys in [0, K) (with ``out_of_range`` also -1,
    K, K+5, -K-3 and the int32 extremes) and M rows, all int32."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randint(-(1 << 31), 1 << 31, (K, W), generator=g,
                          dtype=torch.int64).to(torch.int32)
    keys = torch.randint(0, K, (M,), generator=g, dtype=torch.int32)
    if out_of_range:
        keys[:6] = torch.tensor([-1, K, K + 5, -K - 3, -(1 << 31),
                                 (1 << 31) - 1])
    rows = torch.randint(-(1 << 31), 1 << 31, (M, W), generator=g,
                         dtype=torch.int64).to(torch.int32)
    return table, keys, rows


def mega_cfg(config, R, K=16, L=6, RS=2, V=2, C=None):
    """A mega_round config with R replicas, K keys, L lanes of which RS
    replay slots, V value words and lane budget C."""
    return config.HermesConfig(
        n_replicas=R, n_keys=K, n_sessions=L - RS, replay_slots=RS,
        value_words=V, ops_per_session=4, lane_budget_cfg=C,
        arb_mode="sort", mega_round=True, replay_age=REPLAY_AGE)


def bound(nbytes, ops):
    """The least time in us for ``nbytes`` moved and ``ops`` scalar
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return dict(bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def stats_case(torch, port, shape, seed):
    """stats_block: each input read once (2 int32 + 3 bool per lane, the
    step), each output written once (the int32 code per lane, the counter
    and histogram rows); ~10 scalar ops per lane."""
    R, S = shape
    nbytes = R * S * (4 + 4 + 1 + 1 + 1) + 4 + R * S * 4 + R * (8 + 64) * 4
    return (stats_inputs(torch, R, S, seed=R * 7919 + S), None,
            dict(R=R, S=S, **bound(nbytes, 10 * R * S)))


def route_case(torch, port, shape, seed):
    """mega_route: si, word and srank read, lane_word and slot_lane
    written; a few operations per lane."""
    R, L, C = shape
    cfg = mega_cfg(port.config, R, L=L, C=C)
    args = (cfg, *route_inputs(torch, R, L, seed))
    nbytes = 3 * 4 * R * L + 4 * R * L + 4 * R * C
    return args, None, dict(R=R, L=L, C=C, **bound(nbytes, 6 * R * L))


def apply_case(torch, port, shape, seed):
    """mega_apply: keys, pts (int32) and mask (bool) read, the vpts column
    read and written once, post written; a few operations per row."""
    K, N = shape
    args = (mega_cfg(port.config, 2), *apply_inputs(torch, K, N, seed))
    nbytes = N * (4 + 4 + 1) + 2 * 4 * K + 4 * N
    return args, None, dict(K=K, N=N, **bound(nbytes, 6 * N))


def replay_case(torch, port, shape, seed):
    """mega_replay, held bit-exact at replay_age 16.  The timed calls run
    at replay_age -1, which counts every INVALID, TRANS or REPLAY row as
    stuck, so a call's REPLAY marks leave the stuck set, and each later
    call's work, as it was.  The least bytes of a timed call: every row's
    4-byte sst word; the slot leaves read and written (active, key, pts,
    acks, value bytes); each candidate's vpts and value bytes read and its
    sst written; a few operations per row.  ``sector_bound_us``: the
    32-byte sector each row's sst read costs in the 40-byte bank row."""
    K, R, RS, V, n_stuck = shape
    cfg = mega_cfg(port.config, R, K=K, L=RS + 4, RS=RS, V=V)
    args = (cfg, *replay_inputs(torch, port.fst, K, R, RS, V, n_stuck, seed))
    timing = (dataclasses.replace(cfg, replay_age=-1),) + args[1:]
    replay = args[5]
    active = port.mega.mega_replay_plain(*_to(torch, args, "cpu"))[1][0]
    n_cand = min(2 * n_stuck, RS)  # the timed calls' stuck rows
    nbytes = (4 * K + 2 * R * RS * (1 + 4 + 4 + 4 + 4 * V)
              + n_cand * (4 + 4 * V + 4) + R + 4)
    info = dict(K=K, R=R, RS=RS, V=V, stuck_rows=n_stuck,
                slots_taken=int((active & ~replay.active).sum()),
                sector_bound_us=32 * K / HBM_BYTES_PER_S * 1e6,
                **bound(nbytes, 8 * K))
    if info["slots_taken"] == 0:
        raise AssertionError(f"mega_replay takes no slot at {shape}")
    return args, timing, info


def _probe_case(torch, port, shape, seed):
    """Inputs of a probe kernel at (K, M), the table's W and the number D
    of distinct rows the keys land on."""
    K, M = shape
    W = port.probe.W
    table, keys, rows = probe_inputs(torch, K, M, W, seed,
                                     shape == PROBE_SHAPES[PROBE_OUT_OF_RANGE])
    D = len(port.pk.row_index(keys, K).unique())
    return table, keys, rows, W, dict(K=K, M=M, distinct_rows=D)


def serial_case(torch, port, shape, seed):
    """probe_serial: every key read; only the last message on each of the
    D distinct rows decides it, so D rows read and D rows written; a few
    operations per word."""
    table, keys, rows, W, info = _probe_case(torch, port, shape, seed)
    M, D = info["M"], info["distinct_rows"]
    info.update(bound(4 * M + 2 * 4 * D * W, 4 * M * W))
    return (table, keys, rows), None, info


def vgather_case(torch, port, shape, seed):
    """probe_vgather: every key read and every output row written; each
    of the D distinct table rows read once; a few operations per word."""
    table, keys, _rows, W, info = _probe_case(torch, port, shape, seed)
    M, D = info["M"], info["distinct_rows"]
    info.update(bound(4 * M + 4 * M * W + 4 * D * W, 3 * M * W))
    return (keys, table), None, info


def serial_library(table, keys, rows):
    """``index_put_`` of the rows at the keys (int64, made before the
    timed calls): the serial scatter but for the order on duplicate keys,
    which it leaves unspecified — a yardstick of time only."""
    k = keys.long()
    return lambda: table.index_put_((k,), rows)


def vgather_library(keys, table):
    """``index_select`` of the table rows at the keys (int64, made before
    the timed calls)."""
    k = keys.long()
    return lambda: table.index_select(0, k)


def _flat(tree):
    if hasattr(tree, "data_ptr"):
        return [tree]
    return [y for x in tree for y in _flat(x)]


def _to(torch, args, dev):
    """Fresh copies of a call's arguments on ``dev`` (tensors, and the
    tensors of a NamedTuple); other arguments as they are."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, copy=True)
        if hasattr(x, "_fields"):
            return type(x)(*(one(y) for y in x))
        return x
    return [one(x) for x in args]


def check_kernel(torch, wrapper, plain, args, label, timing_args=None,
                 library=None):
    """The kernel against its plain version on the same inputs (on the
    CPU and on the card), bit-exact, and its times: per call on the
    stream (CUDA events) and on the device (torch.profiler, the kernels
    one call enqueues, ``profiling.device_per_call``).  ``timing_args``
    (default ``args``) are the inputs of the repeated timed calls, which
    must do the same work every call.  ``library(*card_args)``, if given,
    returns a call of one PyTorch operation computing the same function,
    whose device time is taken the same way."""
    from hermes_tpu_torch.profiling import device_per_call

    want = _flat(plain(*_to(torch, args, "cpu")))
    before = wrapper.launches
    got = _flat(wrapper(*_to(torch, args, "cuda")))
    counted = wrapper.launches - before
    plain_dev = _flat(plain(*_to(torch, args, "cuda")))
    torch.cuda.synchronize()
    if counted != 1:
        raise AssertionError(f"one {label} call counted {counted} launches")
    err = 0
    for w, g, p in zip(want, got, plain_dev):
        w64 = w.to(torch.int64)
        err = max(err, int((w64 - g.cpu().to(torch.int64)).abs().max()))
        if not (torch.equal(g.cpu(), w) and torch.equal(p.cpu(), w)):
            raise AssertionError(f"{label} disagrees with its plain version")
    dev_args = _to(torch, timing_args or args, "cuda")
    call = lambda: wrapper(*dev_args)
    plain_call = lambda: plain(*dev_args)
    k_s, k_n = device_per_call(call)
    p_s, p_n = device_per_call(plain_call)
    out = dict(exact=True, max_abs_err=err, counted_launches=counted,
               call_us=cuda_ms(torch, call) * 1e3, device_us=k_s * 1e6,
               device_launches=k_n,
               plain_call_us=cuda_ms(torch, plain_call) * 1e3,
               plain_device_us=p_s * 1e6, plain_device_launches=p_n)
    if library is not None:
        l_s, l_n = device_per_call(library(*dev_args))
        out.update(library_device_us=l_s * 1e6, library_device_launches=l_n)
    return out


def phase_kernels(torch, port, kernels):
    """Every ported kernel against its plain version at each of its
    shapes; returns each kernel's row of the summary line, its times from
    the bench shape."""
    mega, pk = port.mega, port.pk
    specs = (  # name, wrapper, plain, file:line it replaces, shapes, case,
        #        the library call of the same function
        ("stats_block", kernels.stats_block, kernels.stats_block_plain,
         "hermes_tpu/core/kernels.py:96", STATS_SHAPES, stats_case, None),
        ("mega_route", mega.mega_route, mega.mega_route_plain,
         "hermes_tpu/core/megaround.py:157", ROUTE_SHAPES, route_case, None),
        ("mega_apply", mega.mega_apply, mega.mega_apply_plain,
         "hermes_tpu/core/megaround.py:230", APPLY_SHAPES, apply_case, None),
        ("mega_replay", mega.mega_replay, mega.mega_replay_plain,
         "hermes_tpu/core/megaround.py:363", REPLAY_SHAPES, replay_case,
         None),
        ("probe_serial", pk.probe_serial, pk.probe_serial_plain,
         "scripts/pallas_probe.py:162", PROBE_SHAPES, serial_case,
         serial_library),
        ("probe_vgather", pk.probe_vgather, pk.probe_vgather_plain,
         "scripts/pallas_probe.py:204", PROBE_SHAPES, vgather_case,
         vgather_library))
    out = {}
    for k, (name, wrapper, plain, replaces, shapes, case,
            library) in enumerate(specs):
        rows = []
        for i, shape in enumerate(shapes):
            args, timing, info = case(torch, port, shape, seed=10 * k + i)
            row = check_kernel(torch, wrapper, plain, args, name, timing,
                               library if i == BENCH_INDEX else None)
            rows.append(dict(info, **row))
        emit({"phase": "kernels", name: rows})
        bench = rows[BENCH_INDEX]
        out[name] = dict(
            name=name, route="cuda",
            source=f"hermes_tpu_torch/csrc/{name}.cu", replaces=replaces,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=bench["device_us"] / 1e3,
            plain_ms=bench["plain_device_us"] / 1e3,
            bound_ms=bench["bound_us"] / 1e3, bound_by=bench["bound_by"],
            library_ms=(bench["library_device_us"] / 1e3
                        if library else None))
    return out


def phase_probe(torch, probe, card):
    """Every cell of ``table_probe.main`` on the card: each candidate's
    state after three chained steps held against the CPU port's on the
    same inputs (``table_probe.check_state``: bit-exact, but for the
    ``torch`` bank at duplicated keys, whose rows mixed from several
    messages are counted), then the cell timed.  The probe kernels'
    counts are set to 0 before and must equal, after, the calls of their
    candidates.  Returns each probe kernel's launches."""
    for w in probe.KERNEL.values():
        w.launches = 0
    calls = {cand: 0 for cand in probe.KERNEL}
    cells = []
    for cand, K, M in probe.CELLS:
        fn, args = probe.candidate_step(cand, K, M, "cuda")
        got = probe.run_chain(fn, args)
        fn_cpu, args_cpu = probe.candidate_step(cand, K, M, "cpu")
        mixed = probe.check_state(cand, got, probe.run_chain(fn_cpu, args_cpu),
                                  args_cpu)
        cells.append(probe.cell(cand, K, M, "cuda"))
        if cand == "torch":
            cells[-1]["mixed_dup_rows"] = mixed
        if cand in calls:
            calls[cand] += 3 + cells[-1]["calls"]
    launches = {w.__name__: w.launches for w in probe.KERNEL.values()}
    want = {probe.KERNEL[c].__name__: n for c, n in calls.items()}
    emit({"phase": "probe", "card": card, "cells": cells,
          "matches_cpu": True, "launches": launches})
    if launches != want:
        raise AssertionError(f"probe kernel launches {launches}, want the "
                             f"calls made {want}")
    return launches


def phase_reference(torch, config, fst, convert, ycsb, card_device="cuda",
                    mega_round=False):
    """The round on the card against the same round on the CPU — which
    the CPU test suite holds bit-exact against the JAX reference — at a
    small shape, through a freeze and a removal with the replay scan
    firing: every state leaf and completion equal after every round."""
    cfg = config.HermesConfig(
        n_replicas=4, n_keys=256, n_sessions=32, replay_slots=8,
        ops_per_session=16, arb_mode="sort", chain_writes=4,
        wrap_stream=True, device_stream=True, lane_budget_cfg=24,
        read_unroll=2, replay_age=2, replay_scan_every=2,
        mega_round=mega_round,
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
    emit({"phase": "reference-mega" if mega_round else "reference",
          "rounds": rounds, "identical": True,
          "replay_slots_peak": replayed})


def expected_launches(cfg, first, last):
    """Launches each kernel of the round makes over steps [first, last):
    one a round, ``mega_replay`` only on the replay scan's rounds."""
    n = last - first
    out = {"stats_block": n}
    if cfg.use_mega_round:
        scans = sum(1 for s in range(first, last)
                    if s % cfg.replay_scan_every == 0)
        out.update(mega_route=n, mega_apply=n, mega_replay=scans)
    return out


MAIN_ROUNDS = 60


def timed_window(torch, rt, rounds=MAIN_ROUNDS):
    """Committed writes and RMWs, reads, aborts and host seconds of
    ``rounds`` rounds, ending in a device sync."""
    c0 = rt.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = rt.counters()
    d = {k: int(c1[k] - c0[k]) for k in ("n_write", "n_rmw", "n_read",
                                         "n_abort")}
    return wall, d["n_write"] + d["n_rmw"], d


def phase_main(torch, counters, config, FastRuntime, card, mega_round=False,
               fused=None):
    """Throughput window of bench-a; returns its numbers (with the launch
    count of each kernel over the timed window) and the runtime."""
    from hermes_tpu_torch.profiling import device_busy

    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, device="cuda")
    rt.fetch_completions = False  # throughput drive: counters only
    rt.run(4)  # warm-up
    rounds = MAIN_ROUNDS
    first = rt.step_idx
    for w in counters.values():
        w.launches = 0
    wall, commits, d = timed_window(torch, rt, rounds)
    launches = {name: w.launches for name, w in counters.items()}
    want = expected_launches(cfg, first, rt.step_idx)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in {rounds} "
                             f"main-path rounds, want {want}")
    prof_rounds = 5
    busy = device_busy(lambda: rt.run(prof_rounds))
    out = {"phase": "main-mega" if mega_round else "main", "card": card,
           "rounds": rounds, "writes_per_s": commits / wall,
           "us_per_round": wall / rounds * 1e6, "commits": commits,
           "launches": {k: launches[k] for k in want},
           "reads": d["n_read"], "aborts": d["n_abort"]}
    out.update(profiled_rounds=prof_rounds,
               device_busy_share=busy["busy_s"] / busy["wall_s"],
               device_us_per_round=busy["busy_s"] / prof_rounds * 1e6,
               cuda_kernels_per_round=busy["launches"] / prof_rounds,
               profiled_us_per_round=busy["wall_s"] / prof_rounds * 1e6,
               top_device_us_per_round=[
                   [name, us / prof_rounds, cnt / prof_rounds]
                   for us, cnt, name in busy["top"]])
    if fused is not None:  # the A/B: the fused round's numbers of this call
        out["fused"] = {k: fused[k] for k in (
            "writes_per_s", "us_per_round", "device_us_per_round",
            "cuda_kernels_per_round")}
    emit(out)
    if commits <= 0:
        raise AssertionError("the main path committed nothing")
    return out, rt


def phase_ab(torch, main, fused_rt, main_mega, mega_rt):
    """More timed windows of the two bench-a runtimes in turns: after
    main (fused) and main-mega, mega, fused, fused, mega, so each ran
    three windows in the order A B B A A B.  Host-clock writes/s and
    us/round of every window."""
    runs = {"fused": [main], "mega": [main_mega]}
    for name, rt in (("mega", mega_rt), ("fused", fused_rt),
                     ("fused", fused_rt), ("mega", mega_rt)):
        wall, commits, _ = timed_window(torch, rt)
        runs[name].append({"writes_per_s": commits / wall,
                           "us_per_round": wall / MAIN_ROUNDS * 1e6})
    out = {"phase": "ab", "order": "fused mega mega fused fused mega",
           "rounds_per_window": MAIN_ROUNDS}
    for name, ws in runs.items():
        out[name] = {k: [w[k] for w in ws]
                     for k in ("writes_per_s", "us_per_round")}
        out[name]["median_us_per_round"] = statistics.median(
            out[name]["us_per_round"])
    emit(out)


def phase_checked(torch, counters, config, FastRuntime, types,
                  mega_round=False):
    """bench-a with the columnar recorder, then quiesced until nothing is
    in flight and checked.  With ``mega_round`` replica 1 is frozen from
    round 8 until after the replay scan of round 32, which must take
    slots."""
    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, record="array", device="cuda")
    freeze = (8, 33) if mega_round else None
    rounds = 40 if mega_round else 16
    for w in counters.values():
        w.launches = 0
    for s in range(rounds):
        if freeze and s == freeze[0]:
            rt.freeze(1)
        if freeze and s == freeze[1]:
            rt.thaw(1)
        rt.step_once()
    rt.quiesce = True  # no new work: in-flight writes and replays drain
    drained = 0
    while rt._inflight_count() and drained < 256:
        rt.step_once()
        drained += 1
    rt.flush_pipeline()
    launches = {name: w.launches for name, w in counters.items()}
    want = expected_launches(cfg, 0, rt.step_idx)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in the checked "
                             f"run, want {want}")
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded = rt.recorder.n_recorded
    valid = bool(((rt.fs.table.sst & 7) == types.VALID).all())
    replay_peak = int(rt.fs.meta.replay_peak.max())
    hist = c["lat_hist"]
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    emit({"phase": "checked-mega" if mega_round else "checked",
          "rounds": rounds, "frozen_rounds": freeze,
          "drain_rounds": drained, "launches": {k: launches[k] for k in want},
          "replay_peak": replay_peak,
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
    if freeze and replay_peak == 0:
        raise AssertionError("the replay scan took no slot in the frozen "
                             "window")
    if not freeze and hist[0] * 2 < hist.sum():
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
        from hermes_tpu_torch import build, config, convert, table_probe
        from hermes_tpu_torch.core import faststep as fst
        from hermes_tpu_torch.core import kernels, types
        from hermes_tpu_torch.core import megaround as mega
        from hermes_tpu_torch.core import probe_kernels as pk
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
        counters = {"stats_block": kernels.stats_block,
                    "mega_route": mega.mega_route,
                    "mega_apply": mega.mega_apply,
                    "mega_replay": mega.mega_replay}
        port = SimpleNamespace(config=config, fst=fst, mega=mega, pk=pk,
                               probe=table_probe)
        rows = phase_kernels(torch, port, kernels)
        probe_launches = phase_probe(torch, table_probe, card)
        phase_reference(torch, config, fst, convert, ycsb)
        phase_reference(torch, config, fst, convert, ycsb, mega_round=True)
        main, fused_rt = phase_main(torch, counters, config, FastRuntime,
                                    card)
        main_mega, mega_rt = phase_main(torch, counters, config,
                                        FastRuntime, card, mega_round=True,
                                        fused=main)
        phase_ab(torch, main, fused_rt, main_mega, mega_rt)
        del fused_rt, mega_rt
        for name, row in rows.items():
            row["launches"] = (
                probe_launches[name] if name in probe_launches
                else (main if name == "stats_block"
                      else main_mega)["launches"][name])
        phase_checked(torch, counters, config, FastRuntime, types)
        phase_checked(torch, counters, config, FastRuntime, types,
                      mega_round=True)
        phase_kvs(torch, kernels, config, KVS)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
