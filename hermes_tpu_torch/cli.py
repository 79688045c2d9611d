"""CLI: run a replicated-KVS workload on the port's engines.

    python -m hermes_tpu_torch --replicas 8 --keys $((1<<20)) \\
        --sessions 1024 --arb-mode sort --chain-writes 128 --check
    python -m hermes_tpu_torch --arb-mode sort --mega-round --check
    python -m hermes_tpu_torch --backend fast-sharded --replicas 8 --check
    python -m hermes_tpu_torch --value-words 6 --reads 20000 --check
    python -m hermes_tpu_torch --value-words 3 --value-bytes 1024 --check
    python -m hermes_tpu_torch --steps 400 --report-every 50 \\
        --freeze 2:100:200 --metrics-out run.jsonl
    python -m hermes_tpu_torch.obs.report run.jsonl
    python -m hermes_tpu_torch --replicas 5 --steps 200 --chaos 7 \\
        --detect 3 --check
    python -m hermes_tpu_torch --replicas 4 --value-words 6 --drill resize \\
        --check
    python -m hermes_tpu_torch --keys 4096 --value-words 6 --drill migrate \\
        --check
    python -m hermes_tpu_torch --value-words 6 --fleet-groups 3 --check
    python -m hermes_tpu_torch --backend sim --keys 512 --sessions 16 \
        --check
    python -m hermes_tpu_torch --value-words 6 --serve 2000 --check
    python -m hermes_tpu_torch --value-words 6 --bench-latency
    python -m hermes_tpu_torch --acceptance all --scale 0.01
    python -m hermes_tpu_torch --value-words 6 --serve 2000 --locklint

The default fast-backend drive of ``hermes_tpu/cli.py``: with ``--steps
0`` (the default) the run drains every session's op stream; ``--check``
records the history and runs the linearizability gate (sampled over 512
keys).  It prints the summary record, then the verdict.  ``--reads N``
(the local-read path) and ``--value-bytes N`` (the value heap) are the
reference's two client drives through ``kvs.KVS``; each prints one JSON
summary line.  ``--metrics-out`` writes the obs run log of the fast
drive (interval records every ``--report-every`` steps, the fault events
of ``--freeze`` windows, spans, the summary with its histograms and the
registry), which ``python -m hermes_tpu_torch.obs.report`` renders.
``--detect CONFIRM`` attaches the failure detector; ``--chaos SEED`` or
``--chaos-schedule FILE`` drives a fault schedule over ``--steps`` rounds,
then heals and drains; ``--drill rolling|resize|migrate`` runs an
elastic drill and prints one JSON line; ``--degraded-floor N`` sets
``min_healthy_for_writes`` of the client drives.  ``--fleet-groups N``
runs N key-sharded groups behind the routed ``fleet.Fleet`` facade: a
seeded mix of ``--fleet-ops`` ops over every group's range, one JSON
line with per-group and fleet counters (``--check``: every group's
checker and ``verify_fleet``).  ``--serve N`` drives N open-loop Poisson
ops (``--serve-rate``, ``--serve-deadline-us``) through the serving front
end's byte-honest loopback over the KVS and prints one JSON line
(``--check``: the checker; the serving invariants always hold or the run
raises); ``--trace-sample`` and ``--metrics-out`` trace it and
``--wal-dir`` logs it.  ``--bench-latency`` measures the serving latency
point from a real client socket (one JSON line).
``--backend fast-sharded`` runs the three drives on the sharded engine
(one table copy a replica, every replica in this process: a
``LocalGroup``).  ``--backend batched|sharded|sim`` runs the reference
phases engine (``runtime.Runtime``): the R replicas in one process, the
blocks through a ``LocalGroup``, or through the deterministic
``SimTransport``; the default drive, ``--freeze``, ``--detect``,
``--check`` and ``--metrics-out`` apply, the client drives, the drills,
``--chaos`` and ``--wal-dir`` are the fast engines' (as in the
reference).  ``--wal-dir DIR`` taps the fast drive's harvest into a
write-ahead log (``--wal-sync``).  ``--acceptance N|all|all+variants``
runs the BASELINE scenarios (``acceptance.py``) at ``--scale``, one
``config N: PASS|FAIL {counters}`` line each.  ``--profile DIR`` writes a
torch.profiler trace of the fast or phases drive, ``--profile-out FILE``
the run config's op census (``obs/profile.py``).  ``--locklint`` runs
``--serve`` or ``--bench-latency`` under the lock-order sanitizer
(``HERMES_LOCKLINT=1``) and adds its report to the JSON line.
``--analyze FILE`` traces the run config's round on the run's backend
(``analysis/engines.py``, fake tensors: no device work), writes the
findings as run-log analysis records and prints the gating count, then
runs the config as usual; as in the reference it takes the fast backends
only and no acceptance run.  ``--no-donate`` (no copying round to select:
the port updates the table in place) is refused.  The run is on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

#: --value-bytes --check: post-compaction utilization floor (live bytes
#: over the allocated log prefix); granule rounding is the only slack
VALUES_UTIL_FLOOR = 0.75


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hermes_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--backend",
                    choices=["fast", "fast-sharded", "batched", "sharded",
                             "sim"],
                    default="fast",
                    help="fast: the batched engine (one shared table); "
                         "fast-sharded: one table copy a replica, real "
                         "INV/ACK/VAL exchange; batched/sharded/sim: the "
                         "reference phases engine (sim: host-mediated, "
                         "deterministic)")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--keys", type=int, default=1 << 16)
    ap.add_argument("--value-words", type=int, default=2)
    ap.add_argument("--sessions", type=int, default=256)
    ap.add_argument("--replay-slots", type=int, default=64)
    ap.add_argument("--ops-per-session", type=int, default=256)
    ap.add_argument("--arb-mode", choices=["race", "sort"], default="race",
                    help="same-key issue arbitration strategy")
    ap.add_argument("--chain-writes", type=int, default=0,
                    help="intra-round same-key write chain length (needs "
                         "--arb-mode sort)")
    ap.add_argument("--mega-round", action="store_true",
                    help="the mega round: route-back, arbiter apply and "
                         "replay scan as three CUDA kernels (needs "
                         "--arb-mode sort)")
    ap.add_argument("--steps", type=int, default=0, help="0 = run until drained")
    ap.add_argument("--check", action="store_true",
                    help="record history + linearizability gate")
    ap.add_argument("--distribution", choices=["uniform", "zipfian"],
                    default="uniform")
    ap.add_argument("--zipf-theta", type=float, default=0.99)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=None, metavar="N",
                    help="local-read drive: N ops, reads through the "
                         "batched multi_get, writes through submit_batch, "
                         "interleaved; one JSON summary line.  --check "
                         "also gates the stale-read check.  Needs "
                         "--value-words >= 3")
    ap.add_argument("--read-frac", type=float, default=0.95,
                    help="read fraction of the --reads mix (YCSB-B's 0.95)")
    ap.add_argument("--read-latest", action="store_true",
                    help="--reads: latest-distribution read keys (YCSB-D)")
    ap.add_argument("--value-bytes", type=int, default=None, metavar="N",
                    help="value-heap drive: byte values up to N bytes "
                         "(ycsb.value_sizes) through submit_batch puts and "
                         "one multi_get, then a compaction; one JSON "
                         "summary line.  --check also gates the stale-read "
                         "check and the post-compaction utilization.  "
                         "Needs --value-words >= 3")
    ap.add_argument("--values-ops", type=int, default=4096, metavar="N",
                    help="op count of the --value-bytes drive")
    ap.add_argument("--report-every", type=int, default=0,
                    help="steps between stat lines (stderr, and interval "
                         "records in --metrics-out)")
    ap.add_argument("--metrics-out", type=str, default=None,
                    metavar="RUN_JSONL",
                    help="obs run log: interval metrics + trace events + "
                         "summary on one monotonic clock "
                         "(hermes_tpu_torch.obs); render with python -m "
                         "hermes_tpu_torch.obs.report")
    ap.add_argument("--trace-steps", action="store_true",
                    help="with --metrics-out: per-step dispatch/readback "
                         "spans (faults, drains and intervals are always "
                         "traced)")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="per-op tracing (cfg.trace_sample): trace ~1 in N "
                         "submitted client ops with a seeded sampler; 0 "
                         "disables")
    ap.add_argument("--freeze", action="append", default=[],
                    metavar="R:FROM:TO",
                    help="failure injection: freeze replica R at step FROM, "
                         "thaw at step TO (repeatable; emits obs fault "
                         "events)")
    ap.add_argument("--degraded-floor", type=int, default=0, metavar="N",
                    help="degraded mode (cfg.min_healthy_for_writes): with "
                         "fewer than N healthy replicas the client drives "
                         "shed new writes as kind='rejected'; 0 disables")
    ap.add_argument("--detect", type=int, default=None, metavar="CONFIRM",
                    help="attach the lease failure detector "
                         "(membership.MembershipService) with this confirm "
                         "window in rounds (0 = remove at first "
                         "suspicion); its input rides the completion "
                         "harvest")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="drive a seeded fault schedule "
                         "(chaos.Schedule.random: freeze / thaw / join / "
                         "crash-restart / hb-skew) over --steps rounds, "
                         "then heal and drain; events ride the obs "
                         "timeline")
    ap.add_argument("--chaos-schedule", type=str, default=None,
                    metavar="FILE",
                    help="a declarative fault schedule file ('@STEP KIND "
                         "[replica] [k=v...]' lines, chaos.Schedule.parse) "
                         "instead of a seeded one; needs --steps")
    ap.add_argument("--drill", default=None,
                    choices=["rolling", "resize", "migrate"],
                    help="an elastic drill: 'rolling' crash-restarts every "
                         "replica in sequence under load, 'resize' shrinks "
                         "and grows every replica live through the KVS, "
                         "'migrate' moves a key range between two stores "
                         "under load (resize and migrate need --value-words "
                         ">= 3); --check gates each with the checker; one "
                         "JSON line")
    ap.add_argument("--fleet-groups", type=int, default=0, metavar="N",
                    help="fleet drive: N key-sharded groups of --replicas "
                         "each behind the routed facade (fleet.Fleet), a "
                         "seeded get/put mix over every group's range; "
                         "--check gates every group's history and the "
                         "fleet invariants (verify_fleet); --steps bounds "
                         "the drive's rounds.  Needs --value-words >= 3 and "
                         "--backend fast")
    ap.add_argument("--fleet-ops", type=int, default=512,
                    help="ops in the fleet mix (--fleet-groups)")
    ap.add_argument("--serve", type=int, default=None, metavar="N",
                    help="serving front-end drive (hermes_tpu_torch."
                         "serving): N open-loop Poisson ops through the "
                         "byte-honest loopback RPC server over the KVS "
                         "(admission, deadlines, backpressure, the shed "
                         "ladder), one JSON summary line; --check also "
                         "gates the checker.  Needs --value-words >= 3; "
                         "fast batched backend")
    ap.add_argument("--serve-rate", type=float, default=8000.0,
                    help="open-loop arrival rate (ops per virtual second) "
                         "of --serve")
    ap.add_argument("--serve-deadline-us", type=int, default=50_000,
                    metavar="US",
                    help="client deadline of --serve ops (virtual "
                         "microseconds; 0 = none)")
    ap.add_argument("--bench-latency", action="store_true",
                    help="measure the serving latency operating point "
                         "end to end from a real client socket (framed "
                         "RPC over localhost TCP) and print one JSON line "
                         "with p50/p99")
    ap.add_argument("--locklint", action="store_true",
                    help="run the serving drive (--serve, --bench-latency) "
                         "under the dynamic lock-order sanitizer "
                         "(HERMES_LOCKLINT=1: every serving-tier lock is an "
                         "instrumented analysis.lockgraph.ObsLock) and add "
                         "the held-before graph's report to the JSON line; "
                         "a lock-order cycle fails the run")
    ap.add_argument("--wal-dir", type=str, default=None, metavar="DIR",
                    help="append every committed write of the fast drive "
                         "to a CRC-framed write-ahead log under DIR "
                         "(created if missing); recover a killed store "
                         "with chaos.recover_store")
    ap.add_argument("--wal-sync", choices=["commit", "round", "off"],
                    default="commit",
                    help="WAL durability mode (with --wal-dir)")
    ap.add_argument("--acceptance", default=None,
                    choices=["1", "2", "2r", "3", "3c", "4", "5", "all",
                             "all+variants"],
                    help="run BASELINE acceptance config N (1-5, or the "
                         "2r/3c variants); 'all' = configs 1-5 (the exit "
                         "code covers exactly those), 'all+variants' also "
                         "runs 2r and 3c; ignores most other flags")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="acceptance size scale (1.0 = the full 2^20-key "
                         "shape)")
    ap.add_argument("--lane-budget", type=int, default=None,
                    help="outbound-lane compaction budget of the fast round")
    ap.add_argument("--wrap-stream", action="store_true",
                    help="cycle op streams forever (use --steps)")
    ap.add_argument("--rmw-retries", type=int, default=0,
                    help="RMW nack retry-in-place budget (0 = abort on nack)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="in-flight dispatch ring depth: >= 2 overlaps the "
                         "completion readback with the next round; fast "
                         "backends only; with --acceptance, runs the "
                         "scenarios pipelined")
    ap.add_argument("--no-auto-rebase", action="store_true",
                    help="no automatic version rebase at counter polls (the "
                         "packed-ts overflow error is the only budget "
                         "behaviour)")
    ap.add_argument("--no-donate", action="store_true",
                    help="refused: the reference's copying A/B baseline of "
                         "state donation; the port updates the table in "
                         "place and has no copying round to select")
    ap.add_argument("--check-keys", type=int, default=512,
                    help="keys the --check gate samples")
    ap.add_argument("--metrics-jsonl", type=str, default=None,
                    help="legacy interval-metrics JSONL (see --metrics-out)")
    ap.add_argument("--op-timeout", type=int, default=0, metavar="ROUNDS",
                    help="stuck-op watchdog budget (cfg.op_timeout_rounds); "
                         "0 disables")
    ap.add_argument("--op-retries", type=int, default=0, metavar="N",
                    help="bounded client retry (cfg.op_retry_limit) of ops "
                         "wedged on a fenced replica; needs --op-timeout; 0 "
                         "disables")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run "
                         "(trace.json, Chrome format) into DIR")
    ap.add_argument("--profile-out", type=str, default=None,
                    metavar="PROFILE_JSONL",
                    help="write the run config's round op census as obs "
                         "profile records (obs.profile.round_record; fast "
                         "backends only; a fresh state, apart from the run)")
    ap.add_argument("--analyze", type=str, default=None,
                    metavar="FINDINGS_JSONL",
                    help="run the static round analysis "
                         "(hermes_tpu_torch.analysis) on the run config's "
                         "round and write the findings as obs analysis "
                         "records, then run (fast backends only; traced "
                         "with fake tensors: no device work)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    return ap


FAST = ("fast", "fast-sharded")


def _backend(args) -> str:
    return "batched" if args.backend == "fast" else "sharded"


def _run_values(args, cfg) -> int:
    """The value-heap drive: N byte puts of memcached-shaped sizes, one
    batched read-back and one compaction; one JSON line.  ``--check``
    gates the linearizability checker, the stale-read check and the
    post-compaction utilization floor."""
    import dataclasses

    from hermes_tpu_torch.checker import linearizability as lin
    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.core import layouts
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload.ycsb import value_payload, value_sizes

    cfg = dataclasses.replace(cfg, max_value_bytes=args.value_bytes,
                              heap_bytes=min(layouts.MAX_HEAP_BYTES, 1 << 22))
    kvs = KVS(cfg, backend=_backend(args), record=default_record(args.check),
              device=args.device)
    n = args.values_ops
    rng = np.random.default_rng(args.seed)
    lens = value_sizes(dict(n=n, max_bytes=args.value_bytes), args.seed)
    chunk = min(2048, cfg.n_keys)
    latest = {}
    written = 0
    t0 = time.perf_counter()
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        # unique keys a batch: same-key writes of one batch commit in
        # arbiter order, so byte-exactness needs one write a key
        kk = rng.permutation(cfg.n_keys)[:m].astype(np.int64)
        pays = [value_payload(args.seed, lo + j, int(lens[lo + j]))
                for j in range(m)]
        bf = kvs.submit_batch(np.full(m, KVS.PUT, np.int32), kk, pays)
        if not kvs.run_batch(bf, max_steps=args.steps or 50_000):
            print(json.dumps({"ok": False,
                              "error": "value puts did not drain"}))
            return 1
        for k, p in zip(kk, pays):
            latest[int(k)] = p
        written += int(sum(len(p) for p in pays))
    put_wall = time.perf_counter() - t0
    skeys = np.asarray(sorted(latest), np.int64)
    t0 = time.perf_counter()
    res = kvs.multi_get(skeys)
    if not res.all_done():
        print(json.dumps({"ok": False, "error": "reads did not drain"}))
        return 1
    get_wall = time.perf_counter() - t0
    exact = all(res.data[j] == latest[int(k)] for j, k in enumerate(skeys))
    stats = kvs.heap_gc(reason="quickstart")
    util = (stats["live_bytes"] / stats["used_bytes"]) if stats else None
    gb = 1 << 30
    summary = dict(ops=n, value_bytes_cap=args.value_bytes,
                   bytes_written=written,
                   wall_s=round(put_wall + get_wall, 3),
                   writes_per_sec=round(n / put_wall, 1),
                   put_gb_per_sec=round(written / put_wall / gb, 4),
                   byte_exact=bool(exact),
                   heap=kvs.heap.stats(),
                   post_gc_util=round(util, 4) if util else None)
    ok = exact
    if args.check:
        v = kvs.rt.check(max_keys=args.check_keys)
        stale = lin.stale_read(kvs.rt.history_ops())
        summary["checked_ok"] = bool(v.ok)
        summary["stale_read"] = [repr(e) for e in stale[:4]]
        summary["util_floor"] = VALUES_UTIL_FLOOR
        ok = (ok and bool(v.ok) and not stale
              and util is not None and util >= VALUES_UTIL_FLOOR)
    summary["ok"] = bool(ok)
    print(json.dumps(summary, default=str))
    return 0 if ok else 1


def _run_reads(args, cfg) -> int:
    """The local-read drive: N ops at ``--read-frac``, reads through the
    batched local-read path, writes through submit_batch; one JSON line.
    ``--check`` gates the linearizability checker and the stale-read
    check."""
    from hermes_tpu_torch.checker import linearizability as lin
    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload.openloop import MixSpec, make_mix

    kvs = KVS(cfg, backend=_backend(args), record=default_record(args.check),
              device=args.device)
    dist = "latest" if args.read_latest else cfg.workload.distribution
    spec = MixSpec(name=dist, distribution=dist,
                   zipf_theta=cfg.workload.zipf_theta,
                   read_frac=args.read_frac)
    n = args.reads
    mix = make_mix(spec, cfg.n_keys, n, args.seed,
                   value_words=cfg.value_words - 2)
    chunk = 4096
    t0 = time.perf_counter()
    reads = writes = local = 0
    for lo in range(0, n, chunk):
        kk = mix["key"][lo: lo + chunk]
        wr = mix["kind"][lo: lo + chunk] != 0
        if wr.any():
            bf = kvs.submit_batch(
                np.full(int(wr.sum()), KVS.PUT, np.int32), kk[wr],
                mix["value"][lo: lo + chunk][wr])
            if not kvs.run_batch(bf, max_steps=args.steps or 50_000):
                print(json.dumps({"ok": False,
                                  "error": "write share did not drain"}))
                return 1
            writes += int(wr.sum())
        rd = ~wr
        if rd.any():
            res = kvs.multi_get(kk[rd])
            if not res.all_done():
                print(json.dumps({"ok": False,
                                  "error": "read share did not drain"}))
                return 1
            reads += int(rd.sum())
            local += res.local_served
    wall = time.perf_counter() - t0
    summary = dict(ops=n, reads=reads, writes=writes,
                   read_frac=args.read_frac, distribution=dist,
                   wall_s=round(wall, 3),
                   reads_per_sec=round(reads / wall, 1) if reads else 0.0,
                   **kvs.read_stats())
    ok = True
    if args.check:
        v = kvs.rt.check(max_keys=args.check_keys)
        stale = lin.stale_read(kvs.rt.history_ops())
        summary["checked_ok"] = bool(v.ok)
        summary["stale_read"] = [repr(e) for e in stale[:4]]
        ok = bool(v.ok) and not stale
    summary["ok"] = bool(ok)
    print(json.dumps(summary, default=str))
    return 0 if ok else 1


def _run_drill(args, cfg) -> int:
    """The elastic drills, rolling restart or rolling resize, checked with
    ``--check``; one JSON summary line with the worst-window dip."""
    from hermes_tpu_torch import elastic
    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.runtime import FastRuntime

    backend = _backend(args)
    rec = default_record(args.check)
    summary: dict = {"drill": args.drill, "backend": backend}
    if args.drill == "rolling":
        rt = FastRuntime(cfg, backend=backend, record=rec,
                         device=args.device)
        if args.detect is not None:
            from hermes_tpu_torch.membership import MembershipService

            rt.attach_membership(
                MembershipService(cfg, confirm_steps=args.detect))
        res = elastic.run_rolling_restart(
            rt, steps=args.steps or None, check=args.check)
        ok = (res["restarts"] == cfg.n_replicas and res.get("drained", True)
              and res.get("checked_ok", not args.check))
        summary.update(restarts=res["restarts"], drained=res.get("drained"),
                       lost_ops=res["lost_ops"], dip=res["dip"],
                       checked_ok=res.get("checked_ok"))
    elif args.drill == "resize":
        kvs = KVS(cfg, backend=backend, record=rec, device=args.device)
        # a standing load that outlasts the drill (R cycles of 2 x 8
        # rounds plus each shrink's drain, up to R*S completions a round):
        # a load that dries up mid-drill reads as a 100 % dip
        rounds_est = cfg.n_replicas * (2 * 8 + 6) + 24
        n_ops = rounds_est * cfg.n_replicas * cfg.n_sessions
        bf = elastic.submit_drill_mix(kvs, n_ops, seed=args.seed)
        res = elastic.rolling_resize(kvs, check=args.check)
        kvs.run_batch(bf)
        ok = (res["resizes"] == cfg.n_replicas and bf.all_done()
              and res.get("checked_ok", not args.check))
        summary.update(resizes=res["resizes"], dip=res["dip"],
                       rejected_ops=res["rejected_ops"],
                       load_done=bf.done_count(),
                       checked_ok=res.get("checked_ok"))
    else:  # migrate
        res = elastic.migration_drill(cfg, backend=backend, record=rec,
                                      seed=args.seed, check=args.check,
                                      device=args.device)
        ok = (res.get("src_checked_ok", not args.check)
              and res.get("dst_checked_ok", not args.check))
        summary.update({k: v for k, v in res.items() if k != "dest_slots"})
    summary["ok"] = bool(ok)
    print(json.dumps(summary, default=str))
    return 0 if ok else 1


def _run_fleet(args, cfg) -> int:
    """The fleet drive: N key-sharded groups behind the routed facade, a
    seeded get/put mix over every group's range, per-group and fleet
    counters as one JSON line; ``--check`` runs every group's checker and
    ``verify_fleet``."""
    from hermes_tpu_torch.config import FleetConfig
    from hermes_tpu_torch.fleet import Fleet

    fcfg = FleetConfig(groups=args.fleet_groups, base=cfg)
    fleet = Fleet(fcfg, record="array" if args.check else False,
                  device=args.device)
    rng = np.random.default_rng(args.seed)
    n = args.fleet_ops
    keys = rng.integers(0, fcfg.total_keys, size=n).astype(np.int64)
    kinds = np.where(rng.random(n) < cfg.workload.read_frac,
                     Fleet.GET, Fleet.PUT).astype(np.int32)
    values = rng.integers(0, 1 << 20,
                          size=(n, cfg.value_words - 2)).astype(np.int32)
    t0 = time.perf_counter()
    fb = fleet.submit_batch(kinds, keys, values)
    drained = fleet.run_batch(fb, max_steps=args.steps or 50_000)
    wall = time.perf_counter() - t0
    summary = dict(fleet_groups=args.fleet_groups, ops=n,
                   done=fb.done_count(), drained=bool(drained),
                   wall_s=round(wall, 3),
                   ranges=fleet.router.owned_ranges(),
                   counters=fleet.counters())
    ok = drained
    if args.check:
        verdicts = fleet.check()
        summary["checked_ok"] = verdicts["ok"]
        summary["group_verdicts"] = verdicts["groups"]
        ok = ok and verdicts["ok"]
    summary["ok"] = bool(ok)
    print(json.dumps(summary, default=str))
    return 0 if ok else 1


def _run_serve(args, cfg) -> int:
    """The serving drive: N open-loop Poisson ops through the loopback
    RPC path over the KVS (admission, deadlines, backpressure, shedding)
    as one JSON summary line; ``verify_serving`` runs inside
    ``run_open_loop`` (it raises on a broken invariant), ``--check``
    adds the checker."""
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving import ServingConfig, run_open_loop
    from hermes_tpu_torch.workload.openloop import MixSpec

    kvs = KVS(cfg, record="array" if args.check else False,
              device=args.device)
    obs = None
    if args.metrics_out or args.trace_sample:
        # the traced serving drive: spans and series ride the run log;
        # the report renders the per-op critical path
        from hermes_tpu_torch.obs import Observability

        obs = kvs.rt.attach_obs(Observability(path=args.metrics_out,
                                              trace_steps=args.trace_steps))
    scfg = ServingConfig(trace_sample=args.trace_sample,
                         trace_seed=args.seed)
    spec = MixSpec(name=cfg.workload.distribution,
                   distribution=cfg.workload.distribution,
                   zipf_theta=cfg.workload.zipf_theta,
                   read_frac=cfg.workload.read_frac)
    res = run_open_loop(
        kvs, scfg, spec,
        rate_per_s=args.serve_rate, n=args.serve, seed=args.seed,
        deadline_us=args.serve_deadline_us)
    if kvs.wal is not None:
        kvs.wal.sync()
        kvs.wal.close()
    summary = {k: v for k, v in res.items() if not k.startswith("_")}
    ok = True
    if args.check:
        # the verdict is a trace event: the run log closes after it
        v = kvs.rt.check(max_keys=args.check_keys)
        summary["checked_ok"] = bool(v.ok)
        ok = ok and v.ok
    if obs is not None:
        obs.series_snapshot()
        obs.close()
    if args.locklint:
        ok = _append_locklint(summary) and ok
    summary["ok"] = bool(ok)
    print(json.dumps(summary, default=str))
    return 0 if ok else 1


def _run_bench_latency(args) -> int:
    """The serving latency point measured end to end from a real client
    socket: a closed-loop capacity probe, then open loop at 0.2x it (a
    fixed rate above this machine's service rate would measure queueing
    delay, not service latency)."""
    from hermes_tpu_torch.device import resolve
    from hermes_tpu_torch.serving.bench import (DISPATCH_LOOP_P50_MS,
                                                host_cfg,
                                                improves_dispatch_loop,
                                                run_socket_cell)
    from hermes_tpu_torch.serving.server import ServingConfig
    from hermes_tpu_torch.workload.openloop import MixSpec

    on_card = resolve(args.device).type == "cuda"
    scfg = ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e5,
                         tenant_quota=64, queue_cap=256)
    cfg = host_cfg("latency", on_card)
    probe = run_socket_cell(cfg, scfg, MixSpec(), n=32, mode="closed",
                            window=8, seed=args.seed, device=args.device)
    cell = run_socket_cell(cfg, scfg, MixSpec(), n=64, mode="open",
                           rate_per_s=max(10.0,
                                          0.2 * probe["ops_per_sec"]),
                           seed=args.seed, device=args.device)
    cell["capacity_probe_ops_per_sec"] = probe["ops_per_sec"]
    cell["dispatch_loop_p50_ms"] = DISPATCH_LOOP_P50_MS
    cell["improves_dispatch_loop"] = improves_dispatch_loop(cell["p50_us"])
    # a cell that lost its server or part of its answers is not a pass,
    # however good the answered-prefix percentiles look
    cell["ok"] = (bool(cell["improves_dispatch_loop"])
                  and cell["error"] is None and probe["error"] is None)
    if args.locklint:
        cell["ok"] = _append_locklint(cell) and cell["ok"]
    print(json.dumps(cell, default=str))
    return 0 if cell["ok"] else 1


def _run_acceptance(args) -> int:
    """The BASELINE acceptance scenarios: one line a config, ``config N:
    PASS|FAIL {counters}``; exit 1 if any failed."""
    from hermes_tpu_torch import acceptance

    # 'all' is the judged set 1-5: its exit code covers exactly those
    which = ([1, 2, 3, 4, 5] if args.acceptance == "all"
             else [1, 2, "2r", 3, "3c", 4, 5]
             if args.acceptance == "all+variants"
             else [args.acceptance if args.acceptance in ("2r", "3c")
                   else int(args.acceptance)])
    rc = 0
    for n in which:
        counters, verdict = acceptance.run_config(
            n, scale=args.scale, pipeline_depth=args.pipeline_depth,
            log=lambda s: print(s, file=sys.stderr), device=args.device)
        ok = counters["drained"] and (verdict is None or verdict.ok)
        print(f"config {n}: {'PASS' if ok else 'FAIL'} {counters}")
        rc |= 0 if ok else 1
    return rc


def _append_locklint(summary: dict) -> bool:
    """Add the lock sanitizer's held-before graph report to a drive's
    summary; a cycle (a potential deadlock) fails the run."""
    from hermes_tpu_torch.analysis import lockgraph

    rep = lockgraph.global_graph().report()
    summary["locklint"] = rep
    return not rep["cycles"]


def _freeze_faults(ap, args):
    """The --freeze windows as (step, replica, action) in firing order,
    thaw before freeze at one step; argument errors leave before any
    output file exists."""
    windows: dict = {}
    for spec in args.freeze:
        try:
            r, lo, hi = (int(x) for x in spec.split(":"))
        except ValueError:
            ap.error(f"--freeze wants R:FROM:TO, got {spec!r}")
        if not 0 <= r < args.replicas:
            ap.error(f"--freeze replica {r} out of range "
                     f"(0..{args.replicas - 1})")
        if not 0 <= lo < hi:
            ap.error(f"--freeze window {lo}:{hi} must satisfy 0 <= FROM < TO")
        windows.setdefault(r, []).append((lo, hi))
    faults = []
    for r, wins in windows.items():
        wins.sort()
        for (_, hi_a), (lo_b, _) in zip(wins, wins[1:]):
            if lo_b < hi_a:
                ap.error(f"--freeze windows for replica {r} overlap "
                         f"(..:{hi_a} vs {lo_b}:..)")
        for lo, hi in wins:
            faults += [(lo, r, "freeze"), (hi, r, "thaw")]
    faults.sort(key=lambda f: (f[0], f[2] != "thaw", f[1]))
    if faults:
        if args.steps <= 0:
            ap.error("--freeze needs a bounded run (--steps > 0)")
        if faults[-1][0] >= args.steps:
            ap.error(f"--freeze window ends at step {faults[-1][0]} but the "
                     f"run stops after --steps {args.steps}; the thaw would "
                     "never fire (want TO < --steps)")
    return faults


def main(argv=None) -> int:
    from hermes_tpu_torch import stats as stats_lib
    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.runtime import FastRuntime, Runtime

    ap = build_parser()
    args = ap.parse_args(argv)
    chaos_on = args.chaos is not None or args.chaos_schedule
    drives = [name for name, on in (
        ("--reads", args.reads is not None),
        ("--value-bytes", args.value_bytes is not None),
        ("--drill", bool(args.drill)), ("--chaos", bool(chaos_on)),
        ("--fleet-groups", bool(args.fleet_groups)),
        ("--serve", args.serve is not None),
        ("--bench-latency", args.bench_latency)) if on]
    if args.locklint:
        # before any serving or transport object mints its locks
        # (concurrency.make_lock reads the switch at mint time)
        os.environ["HERMES_LOCKLINT"] = "1"
    if args.no_donate:
        ap.error("--no-donate selects the reference's copying baseline of "
                 "state donation; the port updates the table in place and "
                 "has no copying round")
    if ((args.no_auto_rebase or args.rmw_retries)
            and args.backend not in FAST):
        ap.error("--arb-mode/--chain-writes/--mega-round/--no-auto-rebase/"
                 "--rmw-retries only affect the fast backends "
                 "(core/faststep.py / runtime.FastRuntime); use --backend "
                 "fast or fast-sharded")
    if args.pipeline_depth < 1:
        ap.error("--pipeline-depth must be >= 1")
    if args.pipeline_depth > 1 and args.backend not in FAST:
        ap.error("--pipeline-depth/--no-donate only affect the fast "
                 "backends (runtime.FastRuntime's harvest ring / donated "
                 "state); use --backend fast or fast-sharded")
    if args.profile_out and args.backend not in FAST:
        ap.error("--profile-out censuses the fast round (core/faststep.py); "
                 "use --backend fast or fast-sharded")
    if args.profile_out and args.acceptance:
        ap.error("--profile-out does not apply to acceptance runs (they "
                 "build their own configs); census a run config instead")
    if args.analyze and args.backend not in FAST:
        ap.error("--analyze traces the fast round (core/faststep.py); "
                 "use --backend fast or fast-sharded")
    if args.analyze and args.acceptance:
        ap.error("--analyze does not apply to acceptance runs (they build "
                 "their own configs); analyze a run config instead")
    if args.profile and args.acceptance:
        ap.error("--profile traces the run drive; acceptance runs build "
                 "their own runtimes, trace a run config instead")
    if args.chaos is not None and args.chaos_schedule:
        ap.error("--chaos and --chaos-schedule are mutually exclusive")
    if args.drill and args.acceptance:
        ap.error("--drill and --acceptance are mutually exclusive")
    # the serving drives' refusals, in the reference CLI's words
    others = bool(args.acceptance or args.drill or args.fleet_groups
                  or chaos_on or args.freeze)
    if args.serve is not None:
        if args.serve < 1:
            ap.error("--serve wants a positive op count")
        if args.bench_latency:
            ap.error("--serve and --bench-latency are separate drives; "
                     "pick one")
        if args.backend != "fast":
            ap.error("--serve drives the fast batched backend through the "
                     "KVS facade (hermes_tpu_torch/serving)")
        if args.value_words < 3:
            ap.error("--serve needs --value-words >= 3 (words 0-1 carry "
                     "the write uid)")
        if others:
            ap.error("--serve is its own drive; drop --acceptance/--drill/"
                     "--fleet-groups/--chaos/--freeze")
    if args.bench_latency and others:
        ap.error("--bench-latency is its own drive; drop --acceptance/"
                 "--drill/--fleet-groups/--chaos/--freeze")
    if args.backend not in FAST:
        # the reference CLI's refusals on its phases backends
        if args.arb_mode != "race" or args.chain_writes or args.mega_round:
            ap.error("--arb-mode/--chain-writes/--mega-round only affect "
                     "the fast backends (core/faststep.py / "
                     "runtime.FastRuntime); use --backend fast or "
                     "fast-sharded")
        for flag, on in (("--drill", bool(args.drill)),
                         ("--chaos/--chaos-schedule", bool(chaos_on))):
            if on:
                ap.error(f"{flag} drive the fast runtimes; use --backend "
                         "fast or fast-sharded")
        for flag, on in (("--fleet-groups", bool(args.fleet_groups)),
                         ("--reads", args.reads is not None),
                         ("--value-bytes", args.value_bytes is not None)):
            if on:
                ap.error(f"{flag} drives the fast batched backend through "
                         "the KVS facade")
        if args.wal_dir is not None:
            ap.error("--wal-dir rides the fast engines' harvest path; "
                     f"the {args.backend!r} backend has no WAL tap "
                     "(use --backend fast or fast-sharded)")
    if len(drives) > 1:
        ap.error(f"{' and '.join(drives)} are separate drives; pick one")
    if args.drill:
        if args.freeze:
            ap.error("--drill and --freeze are mutually exclusive (drills "
                     "build their own schedules)")
        if args.drill in ("resize", "migrate") and args.value_words < 3:
            ap.error(f"--drill {args.drill} drives the client KVS: needs "
                     "--value-words >= 3 (words 0-1 carry the write uid)")
    if args.fleet_groups:
        if args.fleet_groups < 1:
            ap.error("--fleet-groups must be >= 1")
        if args.backend != "fast":
            ap.error("--fleet-groups drives the fast batched backend "
                     "through the KVS facade (hermes_tpu_torch.fleet); "
                     "sharded fleets are launched via hermes_tpu_torch."
                     "launch --fleet-groups")
        if args.value_words < 3:
            ap.error("--fleet-groups needs --value-words >= 3 (words 0-1 "
                     "carry the write uid)")
        if args.acceptance or args.freeze:
            ap.error("--fleet-groups is its own drive; drop --acceptance/"
                     "--drill/--chaos/--freeze")
    if chaos_on:
        if args.steps <= 0:
            ap.error("--chaos needs a bounded run (--steps > 0)")
        if args.freeze:
            ap.error("--chaos and --freeze are mutually exclusive (put "
                     "freeze windows in the schedule instead)")
    if args.acceptance and (args.reads is not None
                            or args.value_bytes is not None):
        ap.error("--reads/--value-bytes are their own drives; drop "
                 "--acceptance")
    if args.reads is not None:
        if args.reads < 1:
            ap.error("--reads wants a positive op count")
        if not (0.0 <= args.read_frac <= 1.0):
            ap.error("--read-frac must be in [0, 1]")
        if args.value_words < 3:
            ap.error("--reads needs --value-words >= 3 (words 0-1 carry "
                     "the write uid)")
    if args.value_bytes is not None:
        if args.value_bytes < 1:
            ap.error("--value-bytes wants a positive byte cap")
        if args.values_ops < 1:
            ap.error("--values-ops wants a positive op count")
        if args.value_words < 3:
            ap.error("--value-bytes needs --value-words >= 3 (words 0-1 "
                     "carry the write uid, word 2 the packed heap ref)")
    if args.chain_writes and args.arb_mode != "sort":
        ap.error("--chain-writes needs --arb-mode sort")
    if args.mega_round and args.arb_mode != "sort":
        ap.error("--mega-round needs --arb-mode sort (the mega route "
                 "kernel consumes the fused sort's verdicts)")
    if args.acceptance:
        return _run_acceptance(args)
    cfg = HermesConfig(
        n_replicas=args.replicas,
        n_keys=args.keys,
        value_words=args.value_words,
        n_sessions=args.sessions,
        replay_slots=args.replay_slots,
        ops_per_session=args.ops_per_session,
        lane_budget_cfg=args.lane_budget,
        wrap_stream=args.wrap_stream,
        arb_mode=args.arb_mode,
        chain_writes=args.chain_writes,
        mega_round=args.mega_round,
        rmw_retries=args.rmw_retries,
        auto_rebase=not args.no_auto_rebase,
        pipeline_depth=args.pipeline_depth,
        op_timeout_rounds=args.op_timeout,
        op_retry_limit=args.op_retries,
        trace_sample=args.trace_sample,
        min_healthy_for_writes=args.degraded_floor,
        wal_dir=args.wal_dir,
        wal_sync=args.wal_sync,
        workload=WorkloadConfig(distribution=args.distribution,
                                zipf_theta=args.zipf_theta, seed=args.seed),
    )
    if args.reads is not None:
        return _run_reads(args, cfg)
    if args.value_bytes is not None:
        return _run_values(args, cfg)
    if args.drill:
        return _run_drill(args, cfg)
    if args.fleet_groups:
        return _run_fleet(args, cfg)
    if args.serve is not None:
        return _run_serve(args, cfg)
    if args.bench_latency:
        return _run_bench_latency(args)
    faults = _freeze_faults(ap, args)
    sched = None
    if chaos_on:
        from hermes_tpu_torch import chaos as chaos_lib

        if args.chaos_schedule:
            with open(args.chaos_schedule) as f:
                sched = chaos_lib.Schedule.parse(f.read())
        else:
            sched = chaos_lib.Schedule.random(cfg, args.chaos, args.steps)
    if args.analyze:
        from hermes_tpu_torch import analysis as ana

        reports = [ana.analyze_program(ana.trace_program(
            cfg, _backend(args), device=args.device))]
        ana.export_findings(args.analyze, reports)
        n_gating = sum(1 for r in reports for f in r["findings"]
                       if f.severity in ana.GATING)
        print(f"analysis: {n_gating} gating finding(s) -> {args.analyze}")
    if args.backend in FAST:
        rt = FastRuntime(cfg, backend=_backend(args),
                         record=default_record(args.check),
                         device=args.device)
        if cfg.use_wal:
            from hermes_tpu_torch.wal import GroupCommitWal

            rt.attach_wal(GroupCommitWal(cfg))
        meta_of = lambda: rt.fs.meta
    else:
        rt = Runtime(cfg, backend=args.backend, record=args.check,
                     device=args.device)
        meta_of = lambda: rt.rs.meta
    logger = None
    if args.metrics_jsonl:
        from hermes_tpu_torch.obs.metrics import JsonlExporter

        logger = JsonlExporter(open(args.metrics_jsonl, "w"))
    obs = None
    if args.metrics_out:
        from hermes_tpu_torch.obs import Observability

        obs = rt.attach_obs(Observability(path=args.metrics_out,
                                          trace_steps=args.trace_steps))
    if args.detect is not None:
        from hermes_tpu_torch.membership import MembershipService

        rt.attach_membership(MembershipService(cfg,
                                               confirm_steps=args.detect))
    t0 = time.perf_counter()

    def report(s):
        if args.report_every and (s + 1) % args.report_every == 0:
            rec = stats_lib.summarize(meta_of(), time.perf_counter() - t0,
                                      s + 1)
            print(rec, file=sys.stderr)
            if logger:
                logger.write(dict(rec))
            if obs:
                obs.interval(rec)

    trace = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        trace = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if rt.device.type == "cuda" else []))
    with trace if trace is not None else contextlib.nullcontext():
        if sched is not None:
            runner = chaos_lib.ChaosRunner(rt, sched, on_step=report)
            res = runner.run(args.steps)
            print(f"chaos: {len(runner.log)} event(s) applied, "
                  f"lost_ops={res['lost_ops']}, drained={res['drained']}",
                  file=sys.stderr)
        elif args.steps > 0:
            for s in range(args.steps):
                while faults and faults[0][0] <= s:
                    _, r, action = faults.pop(0)
                    getattr(rt, action)(r)
                rt.step_once()
                report(s)
        elif not rt.drain():
            print("WARNING: did not drain", file=sys.stderr)
    if trace is not None:
        os.makedirs(args.profile, exist_ok=True)
        trace.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if rt.wal is not None:
        # the drive's last rounds are on disk before the summary claims
        # them committed
        rt.wal.sync()
        w = rt.wal.stats()
        print(f"wal: {w['records']} record(s), {w['fsyncs']} fsync(s), "
              f"{w['bytes']} byte(s), {w['segments']} segment(s), "
              f"sync={w['sync']}", file=sys.stderr)
        rt.wal.close()
    if rt.device.type == "cuda":
        import torch

        torch.cuda.synchronize(rt.device)
    wall = time.perf_counter() - t0
    rec = stats_lib.summarize(meta_of(), wall, rt.step_idx,
                              hists=obs is not None)
    if obs:
        obs.summary(rec)
        obs.registry_snapshot()
        rec = {k: v for k, v in rec.items()
               if k not in ("lat_hist", "qwait_hist")}
    print(rec)
    if logger:
        logger.write(dict(rec))
        logger.fp.close()
    if args.profile_out:
        from hermes_tpu_torch.obs import profile as prof

        eng = _backend(args)
        prof.export_profile(args.profile_out, [prof.round_record(
            prof.op_census(cfg, eng, device=args.device), backend=eng)])
    try:
        if args.check:
            # the verdict is a trace event: the run log closes after it
            v = rt.check(max_keys=args.check_keys)
            print(f"linearizability: {'PASS' if v.ok else 'FAIL'} "
                  f"({v.keys_checked} keys)")
            if not v.ok:
                for f in v.failures[:5]:
                    print("  ", f.reason[:200])
                return 1
        return 0
    finally:
        if obs:
            obs.close()


if __name__ == "__main__":
    sys.exit(main())
