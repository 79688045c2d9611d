"""CLI: run a replicated-KVS workload on the port's fast engine.

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
checker and ``verify_fleet``).
``--backend fast-sharded`` runs the three drives on the sharded engine
(one table copy a replica, every replica in this process: a
``LocalGroup``).  The run is on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# keys the --check gate samples (the reference CLI's --check-keys default)
CHECK_KEYS = 512

#: --value-bytes --check: post-compaction utilization floor (live bytes
#: over the allocated log prefix); granule rounding is the only slack
VALUES_UTIL_FLOOR = 0.75


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hermes_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--backend", choices=["fast", "fast-sharded"],
                    default="fast",
                    help="fast: the batched engine (one shared table); "
                         "fast-sharded: one table copy a replica, real "
                         "INV/ACK/VAL exchange")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    return ap


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
        v = kvs.rt.check(max_keys=CHECK_KEYS)
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
        v = kvs.rt.check(max_keys=CHECK_KEYS)
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
    from hermes_tpu_torch.runtime import FastRuntime

    ap = build_parser()
    args = ap.parse_args(argv)
    chaos_on = args.chaos is not None or args.chaos_schedule
    drives = [name for name, on in (
        ("--reads", args.reads is not None),
        ("--value-bytes", args.value_bytes is not None),
        ("--drill", bool(args.drill)), ("--chaos", bool(chaos_on)),
        ("--fleet-groups", bool(args.fleet_groups))) if on]
    if args.chaos is not None and args.chaos_schedule:
        ap.error("--chaos and --chaos-schedule are mutually exclusive")
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
        if args.freeze:
            ap.error("--fleet-groups is its own drive; drop --freeze")
    if chaos_on:
        if args.steps <= 0:
            ap.error("--chaos needs a bounded run (--steps > 0)")
        if args.freeze:
            ap.error("--chaos and --freeze are mutually exclusive (put "
                     "freeze windows in the schedule instead)")
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
    cfg = HermesConfig(
        n_replicas=args.replicas,
        n_keys=args.keys,
        value_words=args.value_words,
        n_sessions=args.sessions,
        replay_slots=args.replay_slots,
        ops_per_session=args.ops_per_session,
        arb_mode=args.arb_mode,
        chain_writes=args.chain_writes,
        mega_round=args.mega_round,
        trace_sample=args.trace_sample,
        min_healthy_for_writes=args.degraded_floor,
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
    faults = _freeze_faults(ap, args)
    sched = None
    if chaos_on:
        from hermes_tpu_torch import chaos as chaos_lib

        if args.chaos_schedule:
            with open(args.chaos_schedule) as f:
                sched = chaos_lib.Schedule.parse(f.read())
        else:
            sched = chaos_lib.Schedule.random(cfg, args.chaos, args.steps)
    rt = FastRuntime(cfg, backend=_backend(args),
                     record=default_record(args.check), device=args.device)
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
            rec = stats_lib.summarize(rt.fs.meta, time.perf_counter() - t0,
                                      s + 1)
            print(rec, file=sys.stderr)
            if obs:
                obs.interval(rec)

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
    if rt.device.type == "cuda":
        import torch

        torch.cuda.synchronize(rt.device)
    wall = time.perf_counter() - t0
    rec = stats_lib.summarize(rt.fs.meta, wall, rt.step_idx,
                              hists=obs is not None)
    if obs:
        obs.summary(rec)
        obs.registry_snapshot()
        obs.close()
        rec = {k: v for k, v in rec.items()
               if k not in ("lat_hist", "qwait_hist")}
    print(rec)
    if args.check:
        v = rt.check(max_keys=CHECK_KEYS)
        print(f"linearizability: {'PASS' if v.ok else 'FAIL'} "
              f"({v.keys_checked} keys)")
        if not v.ok:
            for f in v.failures[:5]:
                print("  ", f.reason[:200])
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
