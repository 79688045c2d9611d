"""The obs-overhead gate, the port's ``scripts/check_obs_overhead.py``: the
instrumented fast round must behave exactly as the uninstrumented one and
cost at most a bounded share more.

  * Behaviour (hard): the same op stream through ``build_fast_scan`` with
    ``phase_metrics`` on and off gives equal base Meta columns
    (``BASE_COLS``); the phase columns (``PHASE_COLS``) are filled when it
    is on and stay zero when it is off.
  * Timing: the two variants alternate inside one loop of ``--reps``
    (``time_interleaved``), each run ending in ``torch.cuda.synchronize()``
    on the card; the clamped overhead of the medians must stay under
    ``--max-overhead`` (0.25: a host bound at this smoke shape, where
    timing noise dwarfs the phase sums).
  * Tracing: a KVS burst traced one op in ``--trace-sample`` with an obs
    context attached, against the untraced build: equal counters, the
    same clamped-median bound.  ``HERMES_LOCKLINT`` is forced to ``0`` at
    import and no ``lock_*`` series may reach the traced registry: the
    gate must not measure the lock sanitizer.

``--shape bench`` times phase metrics on against off at
``config.bench_cfg("a")`` instead (record-only, no bound): the
measurement the JAX package's docstring places at the profile shape.

    python -m hermes_tpu_torch.checks.obs_overhead [--device cpu]
        [--shape gate|bench] [--rounds 20] [--chunks 2] [--reps 9]
        [--max-overhead 0.25] [--trace-sample 64] [--out FILE]
"""

from __future__ import annotations

import os
import sys
import time

# instrumentation must not measure instrumentation: the lock sanitizer's
# series would land in the traced leg's registry (see the docstring)
os.environ["HERMES_LOCKLINT"] = "0"

import numpy as np  # noqa: E402

from hermes_tpu_torch import checks  # noqa: E402

BASE_COLS = ("n_read", "n_write", "n_rmw", "n_abort",
             "lat_sum", "lat_cnt", "lat_hist", "max_pts")
PHASE_COLS = ("n_inv", "n_rebcast", "n_nack", "n_retry",
              "replay_peak", "qwait_sum", "qwait_hist")


def _cfg(phase_metrics: bool, shape: str = "gate"):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig, bench_cfg

    if shape == "bench":
        return bench_cfg("a", over=dict(phase_metrics=phase_metrics))
    return HermesConfig(
        n_replicas=4, n_keys=1 << 12, value_words=2, n_sessions=256,
        replay_slots=32, ops_per_session=64, wrap_stream=True,
        lane_budget_cfg=128, rebroadcast_every=4, replay_scan_every=32,
        phase_metrics=phase_metrics,
        workload=WorkloadConfig(read_frac=0.5, seed=0),
    )


def build_runner(phase_metrics: bool, rounds: int, chunks: int,
                 device="cuda", shape: str = "gate"):
    """Warm one fast-scan variant; returns (meta as numpy, run_fn).  A run
    starts from a fresh state and ends with the device idle."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.workload import ycsb

    dev = device_lib.resolve(device)
    cfg = _cfg(phase_metrics, shape)
    chunk = fst.build_fast_scan(cfg, rounds)
    raw = (ycsb.stub_stream(cfg) if cfg.device_stream
           else ycsb.make_streams(cfg))
    stream = fst.prep_stream(raw, dev)

    def full_run():
        fs = fst.init_fast_state(cfg, dev)
        for c in range(chunks):
            fs = chunk(fs, stream, fst.make_fast_ctl(cfg, c * rounds, dev))
        checks.sync(dev)
        return fs

    fs = full_run()  # warm: the kernels' load, the allocator's pools
    meta = type(fs.meta)(*(x.cpu().numpy() for x in fs.meta))
    return meta, full_run


def build_traced_runner(trace_sample: int, n_ops: int, device="cuda"):
    """Warm one KVS client-burst variant, traced (sampler and obs
    attached) or untraced; returns (burst_fn, counts_fn)."""
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.obs import Observability

    cfg = HermesConfig(
        n_replicas=3, n_keys=256, value_words=4, n_sessions=32,
        replay_slots=8, ops_per_session=4, pipeline_depth=2,
        trace_sample=trace_sample,
        workload=WorkloadConfig(read_frac=0.5, seed=0),
    )
    kv = KVS(cfg, backend="batched", device=device)
    dev = kv.rt.device
    obs = None
    if trace_sample:
        obs = Observability()
        kv.rt.attach_obs(obs)

    def burst():
        futs = []
        for i in range(n_ops):
            r, s, k = i % 3, i % 32, i % 256
            futs.append(kv.put(r, s, k, [i, i + 1]) if i % 2
                        else kv.get(r, s, k))
        assert kv.run_until(futs), "burst did not drain"
        checks.sync(dev)

    def counts():
        c = kv.rt.counters()
        return {k: int(np.asarray(c[k]).sum())
                for k in ("n_read", "n_write", "n_rmw", "n_abort")}

    burst()  # warm
    if obs is not None:
        from hermes_tpu_torch.analysis.lockgraph import LOCK_METRIC_PREFIX

        leaked = [n for n in obs.registry.names()
                  if n.startswith(LOCK_METRIC_PREFIX)]
        assert not leaked, (
            f"lock sanitizer series leaked into the overhead gate's "
            f"traced registry: {leaked} — HERMES_LOCKLINT must stay off "
            f"here (instrumentation measuring instrumentation)")
    return burst, counts


def time_interleaved(runners, reps: int):
    """One timing loop over all variants, alternating within each rep;
    returns (medians, per-rep times), parallel to ``runners``."""
    times = [[] for _ in runners]
    for _ in range(reps):
        for i, run in enumerate(runners):
            t0 = time.perf_counter()
            run()
            times[i].append(time.perf_counter() - t0)
    return [sorted(t)[reps // 2] for t in times], times


def behaviour_failures(meta_on, meta_off) -> list:
    """The behaviour gate's violations."""
    failures = []
    for col in BASE_COLS:
        a, b = getattr(meta_on, col), getattr(meta_off, col)
        if not np.array_equal(a, b):
            failures.append(
                f"base column {col} diverged between instrumented and "
                f"uninstrumented runs (sum {a.sum()} vs {b.sum()}) — "
                f"instrumentation changed protocol behavior")
    if int(meta_on.n_inv.sum()) == 0:
        failures.append("instrumented run recorded no INV broadcasts "
                        "(phase counters dead)")
    if int(meta_on.qwait_hist.sum()) == 0:
        failures.append("instrumented run recorded an empty quorum-wait "
                        "histogram")
    for col in PHASE_COLS:
        if getattr(meta_off, col).any():
            failures.append(f"uninstrumented run wrote phase column {col}")
    return failures


def _overhead(t_on: float, t_off: float) -> float:
    # clamped at 0: two noisy medians can subtract below zero
    return max(0.0, (t_on - t_off) / t_off) if t_off > 0 else 0.0


def check_phase_metrics(report: dict, args) -> list:
    meta_on, run_on = build_runner(True, args.rounds, args.chunks,
                                   args.device, args.shape)
    meta_off, run_off = build_runner(False, args.rounds, args.chunks,
                                     args.device, args.shape)
    (t_on, t_off), (times_on, times_off) = time_interleaved(
        [run_on, run_off], args.reps)
    failures = behaviour_failures(meta_on, meta_off)
    overhead = _overhead(t_on, t_off)
    if args.shape == "gate" and overhead > args.max_overhead:
        failures.append(
            f"instrumentation overhead {overhead:.1%} exceeds "
            f"{args.max_overhead:.0%} gate (median {t_on*1e3:.1f} ms vs "
            f"{t_off*1e3:.1f} ms over {args.rounds * args.chunks} rounds)")
    report.update(
        shape=args.shape, rounds=args.rounds * args.chunks, reps=args.reps,
        wall_s_instrumented=t_on, wall_s_uninstrumented=t_off,
        overhead_frac=overhead,
        max_overhead=args.max_overhead if args.shape == "gate" else None,
        times_instrumented=times_on, times_uninstrumented=times_off,
        commits=int(meta_on.n_write.sum() + meta_on.n_rmw.sum()),
        n_inv=int(meta_on.n_inv.sum()))
    return failures


def check_tracing(report: dict, args) -> list:
    burst_tr, counts_fn_tr = build_traced_runner(
        args.trace_sample, args.trace_ops, args.device)
    burst_un, counts_fn_un = build_traced_runner(0, args.trace_ops,
                                                 args.device)
    (t_tr, t_un), (times_tr, times_un) = time_interleaved(
        [burst_tr, burst_un], args.reps)
    counts_tr, counts_un = counts_fn_tr(), counts_fn_un()
    failures = []
    if counts_tr != counts_un:
        failures.append(
            f"tracing changed KVS behavior: counters {counts_tr} "
            f"(traced 1/{args.trace_sample}) vs {counts_un} (untraced)")
    trace_overhead = _overhead(t_tr, t_un)
    if trace_overhead > args.max_overhead:
        failures.append(
            f"tracing overhead {trace_overhead:.1%} at sample rate "
            f"1/{args.trace_sample} exceeds {args.max_overhead:.0%} gate "
            f"(median {t_tr*1e3:.1f} ms vs {t_un*1e3:.1f} ms per "
            f"{args.trace_ops}-op burst)")
    report["traced"] = dict(
        trace_sample=args.trace_sample, ops_per_burst=args.trace_ops,
        wall_s_traced=t_tr, wall_s_untraced=t_un,
        trace_overhead_frac=trace_overhead, times_traced=times_tr,
        times_untraced=times_un, counters=counts_tr)
    return failures


def main(argv=None) -> int:
    ap = checks.parser("obs_overhead", __doc__)
    ap.add_argument("--shape", choices=("gate", "bench"), default="gate",
                    help="gate: the bounded smoke shape; bench: "
                    "config.bench_cfg('a'), record-only (no bound, no "
                    "tracing leg)")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=9,
                    help="interleaved reps a variant (the JAX package's "
                    "gate takes 5; the port's eager round on a shared host "
                    "needs more for a stable median: ROADMAP C)")
    ap.add_argument("--max-overhead", type=float, default=0.25,
                    help="instrumented/uninstrumented wall-time bound at "
                    "the gate shape (a host bound)")
    ap.add_argument("--trace-sample", type=int, default=64,
                    help="1-in-N op tracing rate for the tracing leg "
                    "(0 skips the leg)")
    ap.add_argument("--trace-ops", type=int, default=192,
                    help="client ops per burst in the tracing leg")
    args = ap.parse_args(argv)
    from hermes_tpu_torch import device as device_lib

    if device_lib.resolve(args.device).type == "cpu":
        # the host is what is timed here: torch's intra-op thread pool on
        # this smoke shape spreads one variant's reps up to fourfold on a
        # shared host (ROADMAP C), so the CPU times one thread
        import torch

        torch.set_num_threads(1)
    report: dict = {"gate": "obs-overhead"}
    failures = check_phase_metrics(report, args)
    if args.shape == "gate" and args.trace_sample > 0:
        failures += check_tracing(report, args)
    else:
        report["traced"] = None
    report["ok"] = not failures
    report["failures"] = failures
    return checks.finish(report, args.device, args.out)


if __name__ == "__main__":
    sys.exit(main())
