"""Run-timeline merge + human report renderer: a copy of
``hermes_tpu/obs/report.py``.

Consumes the JSONL records an Observability run emits (interval metrics,
trace events, span begin/end on one monotonic clock) and renders one
causally ordered story: interval throughput next to the fault events
that explain its dips, the per-op critical-path breakdown from the trace
spans, and the device phase histograms from the final summary.  Run as
``python -m hermes_tpu_torch.obs.report run.jsonl``; it renders the same
text as ``scripts/obs_report.py`` on the same file.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, List, Optional

FAULT_EVENTS = ("freeze", "thaw", "remove", "join", "suspect",
                # round-14 serving envelope: shed-ladder transitions and
                # overload windows are fault-class events — an operator
                # reading the timeline sees WHEN the front door closed
                "shed", "shed_clear", "degraded", "degraded_clear",
                "overload", "overload_clear")


def load_records(paths: Iterable[str]) -> List[dict]:
    """Read + merge one or more obs JSONL files into a single timeline,
    stably sorted by ``t`` (records from one file keep their write order —
    the clock is monotonic per file).  Each record is tagged with a
    ``_src`` file index so cumulative counters from different run logs are
    never differenced against each other."""
    recs: List[dict] = []
    for src, path in enumerate(paths):
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if line:
                    rec = json.loads(line)
                    rec["_src"] = src
                    recs.append(rec)
    recs.sort(key=lambda r: r.get("t", 0.0))
    return recs


def interval_throughput(records: List[dict]) -> List[dict]:
    """Per-interval commit/read rates from consecutive cumulative metrics
    records (kind metrics/summary carrying ``commits``).  Counters are
    cumulative per run log, so deltas are taken within each ``_src``
    stream — a merged multi-file timeline never mixes streams."""
    out = []
    prev: dict = {}  # _src -> last metrics record of that stream
    for r in records:
        if r.get("kind") not in ("metrics", "summary") or "commits" not in r:
            continue
        p = prev.get(r.get("_src", 0))
        if p is not None:
            dc = r["commits"] - p["commits"]
            dr = r.get("n_read", 0) - p.get("n_read", 0)
            if dc < 0 or dr < 0 or r.get("steps", 0) < p.get("steps", 0):
                # counter reset: a fresh runtime wrote into the same log
                # (bench.py emits one summary per mix cell) — start a new
                # segment instead of differencing unrelated runs
                p = None
        if p is not None:
            dt = r["t"] - p["t"]
            out.append(dict(
                t0=p["t"], t1=r["t"],
                commits=dc,
                commits_per_s=round(dc / dt, 1) if dt > 0 else None,
                reads=dr,
            ))
        prev[r.get("_src", 0)] = r
    return out


def fleet_totals(records: List[dict]) -> Optional[dict]:
    """Per-group + fleet-wide aggregation over group-labeled records
    (round-13, hermes_tpu/fleet): the fleet facade emits interval/summary
    records and trace events carrying ``group``; this folds each group's
    LAST cumulative counters plus its event census into one table, with
    the fleet aggregate as the counter sums.  Returns None when no record
    carries a group label (single-group runs keep their old report)."""
    last: dict = {}   # group -> last group-labeled metrics/summary record
    events: dict = {}  # group -> event-name census
    for r in records:
        g = r.get("group")
        if g is None or g == "fleet":
            continue
        if r.get("kind") in ("metrics", "summary"):
            last[g] = r
        elif r.get("kind") == "event":
            events.setdefault(g, {})
            name = r.get("name", "?")
            events[g][name] = events[g].get(name, 0) + 1
    if not last and not events:
        return None
    counter_keys = ("n_read", "n_write", "n_rmw", "n_abort", "commits")
    groups = {}
    agg: dict = {}
    for g in sorted(set(last) | set(events)):
        row = {k: last[g][k] for k in counter_keys
               if g in last and k in last[g]}
        row["events"] = events.get(g, {})
        groups[g] = row
        for k, v in row.items():
            if k != "events":
                agg[k] = agg.get(k, 0) + v
    return dict(groups=groups, fleet=agg)


def critical_path(records: List[dict]) -> Optional[dict]:
    """Per-op latency attribution from the round-18 trace spans
    (obs/tracing.py): group the op spans by trace id and break the
    sampled population's p50/p99 down by phase, in PROTOCOL ROUNDS
    (r1 - r0 — the deterministic unit) plus wall p99 where the span
    measured one.  Returns None when the run traced nothing.

    The headline line this feeds: "p99 ops spend X rounds in the queue
    and Y rounds in device rounds"."""
    from hermes_tpu_torch.obs.tracing import OP_SPANS
    from hermes_tpu_torch.stats import percentile_nearest_rank

    per: dict = {}  # trace id -> {span name: record}
    for r in records:
        if r.get("kind") != "span_end" or r.get("name") not in OP_SPANS:
            continue
        tr = r.get("trace")
        if tr:
            per.setdefault(tr, {})[r["name"]] = r
    if not per:
        return None
    phases: dict = {}
    for name in OP_SPANS:
        spans = [s[name] for s in per.values() if name in s]
        rounds = sorted(s["r1"] - s["r0"] for s in spans)
        durs = sorted(s["dur_s"] for s in spans
                      if s.get("dur_s") is not None)
        if rounds:
            row = dict(
                n=len(rounds),
                p50_rounds=percentile_nearest_rank(rounds, 0.5),
                p99_rounds=percentile_nearest_rank(rounds, 0.99))
            if durs:
                row["p99_dur_s"] = percentile_nearest_rank(durs, 0.99)
            phases[name] = row
    return dict(traces=len(per), phases=phases)


_PHASE_LABELS = {"fe_queue": "intake queue (admit -> issue)",
                 "op_queue": "client queue (submit -> inject)",
                 "op_rounds": "device rounds (inject -> resolve)",
                 "fe_resolve": "end to end (admit -> resolve)"}


def _fmt_fields(r: dict, skip=("t", "kind", "name", "_src")) -> str:
    return " ".join(f"{k}={v}" for k, v in r.items()
                    if k not in skip and not isinstance(v, list))


def _render_hist(counts: List[int], width: int = 40) -> List[str]:
    from hermes_tpu_torch.obs.metrics import percentile_from_counts

    total = sum(counts)
    lines = []
    if total == 0:
        return ["  (empty)"]
    peak = max(counts)
    for i, c in enumerate(counts):
        if c == 0:
            continue
        bar = "#" * max(1, round(c / peak * width))
        lines.append(f"  {i:>3} | {bar} {c}")
    p50 = percentile_from_counts(counts, 0.5)
    p99 = percentile_from_counts(counts, 0.99)
    lines.append(f"  n={total} p50={p50} p99={p99} (bins are protocol"
                 " rounds; last bin clips)")
    return lines


def render_report(records: List[dict], max_timeline: Optional[int] = None
                  ) -> str:
    """Human ``obs report``: kind census, fault-event list, merged
    timeline with per-interval throughput, and the phase histograms from
    the last record that carries them."""
    by_kind: dict = {}
    for r in records:
        by_kind[r.get("kind", "?")] = by_kind.get(r.get("kind", "?"), 0) + 1
    lines = ["== obs report =="]
    if records:
        span = records[-1].get("t", 0.0) - records[0].get("t", 0.0)
        census = " ".join(f"{k}={v}" for k, v in sorted(by_kind.items()))
        lines.append(f"{len(records)} records over {span:.3f}s ({census})")
    else:
        lines.append("no records")
        return "\n".join(lines) + "\n"

    faults = [r for r in records
              if r.get("kind") == "event" and r.get("name") in FAULT_EVENTS]
    lines.append("")
    lines.append(f"-- membership / fault events ({len(faults)}) --")
    for r in faults:
        lines.append(f"  t={r['t']:9.3f}s {r['name']:<8} {_fmt_fields(r)}")
    if not faults:
        lines.append("  (none)")

    ivals = interval_throughput(records)
    ival_by_t1 = {iv["t1"]: iv for iv in ivals}

    lines.append("")
    lines.append("-- timeline --")
    shown = records if max_timeline is None else records[-max_timeline:]
    for r in shown:
        kind = r.get("kind", "?")
        if kind in ("metrics", "summary"):
            iv = ival_by_t1.get(r.get("t"))
            rate = (f" [{iv['commits_per_s']}/s over "
                    f"{iv['t1'] - iv['t0']:.3f}s]" if iv else "")
            core = " ".join(
                f"{k}={r[k]}" for k in
                ("steps", "commits", "n_read", "n_abort", "ops_per_sec")
                if k in r)
            lines.append(f"  t={r['t']:9.3f}s {kind:<10} {core}{rate}")
        elif kind == "span_end":
            lines.append(f"  t={r['t']:9.3f}s span       "
                         f"{r.get('name')} dur={r.get('dur_s')}s "
                         f"{_fmt_fields(r, skip=('t', 'kind', 'name', 'dur_s', '_src'))}")
        elif kind == "span_begin":
            continue  # the end record carries the duration
        else:
            lines.append(f"  t={r['t']:9.3f}s {kind:<10} "
                         f"{r.get('name', '')} {_fmt_fields(r)}")

    # round-8 serving-pipeline overlap: the runtimes accumulate per-round
    # host work vs device wait into the registry (runtime.step_once /
    # harvest_comp); the last registry record carries the totals
    last_reg = None
    for r in records:
        if r.get("kind") == "registry" and "device_wait_s" in r:
            last_reg = r
    if last_reg is not None:
        host = float(last_reg.get("host_work_s", 0.0))
        wait = float(last_reg["device_wait_s"])
        tot = host + wait
        lines.append("")
        lines.append("-- serving-pipeline overlap --")
        lines.append(
            f"  host_work={host:.3f}s device_wait={wait:.3f}s"
            + (f" (host loop blocked on readback {wait / tot:.0%}"
               f" of its time)" if tot > 0 else "")
            + (f" ring depth={last_reg['pipeline_depth']}"
               if "pipeline_depth" in last_reg else ""))

    # round-18 per-op critical path: sampled traces broken down by phase
    cp = critical_path(records)
    if cp is not None:
        lines.append("")
        lines.append(f"-- per-op critical path ({cp['traces']} sampled "
                     f"trace(s)) --")
        for name, row in cp["phases"].items():
            extra = (f" p99_wall={row['p99_dur_s']}s"
                     if "p99_dur_s" in row else "")
            lines.append(
                f"  {name:<10} {_PHASE_LABELS.get(name, ''):<34} "
                f"n={row['n']} p50={row['p50_rounds']} "
                f"p99={row['p99_rounds']} rounds{extra}")

    # round-13 fleet aggregation: when records carry group labels, render
    # the per-group counter table and the fleet-wide sums
    ft = fleet_totals(records)
    if ft is not None:
        lines.append("")
        lines.append(f"-- fleet (per-group / aggregate, "
                     f"{len(ft['groups'])} group(s)) --")
        for g, row in ft["groups"].items():
            ev = " ".join(f"{k}={v}" for k, v in sorted(row["events"].items()))
            cts = " ".join(f"{k}={v}" for k, v in row.items()
                           if k != "events")
            lines.append(f"  group {g}: {cts}"
                         + (f"  [{ev}]" if ev else ""))
        lines.append("  fleet:   " + " ".join(
            f"{k}={v}" for k, v in ft["fleet"].items()))

    last_hists = None
    for r in records:
        if isinstance(r.get("lat_hist"), list) or isinstance(
                r.get("qwait_hist"), list):
            last_hists = r
    lines.append("")
    lines.append("-- phase histograms --")
    if last_hists is None:
        lines.append("  (no histogram-bearing record; run with hists=True "
                     "intervals, e.g. cli --metrics-out)")
    else:
        for field, title in (("lat_hist", "commit latency (load->commit)"),
                             ("qwait_hist", "ACK quorum-wait (issue->commit)")):
            h = last_hists.get(field)
            if isinstance(h, list):
                lines.append(f"  {title}:")
                lines.extend("  " + ln for ln in _render_hist(h))
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m hermes_tpu_torch.obs.report`` — the profile.py pattern: the
    renderer is importable library code and its CLI lives beside it;
    ``scripts/obs_report.py`` stays as a thin shim."""
    ap = argparse.ArgumentParser(
        description="Render obs run logs (--metrics-out JSONL) as one "
                    "causally ordered timeline report.")
    ap.add_argument("paths", nargs="+", help="obs JSONL run logs to merge")
    ap.add_argument("--max-timeline", type=int, default=None,
                    help="show only the last N timeline records")
    ap.add_argument("--json", action="store_true",
                    help="emit the merged record list as JSON instead of "
                    "the human report")
    args = ap.parse_args(argv)

    records = load_records(args.paths)
    if args.json:
        json.dump(records, sys.stdout)
        sys.stdout.write("\n")
        return 0
    sys.stdout.write(render_report(records, max_timeline=args.max_timeline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
