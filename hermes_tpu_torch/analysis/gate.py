"""The ``analysis`` gate: the port's counterpart of
``scripts/check_analysis.py``.

The static round analysis (``analysis/engines.py``) must report no NEW
error or warn finding on the fast engines, at the default, bench,
bench-rmw and bench-mega configs, batched and sharded, fused and split
sort (the split program is added to each fused config), nor on the
kernel matrix (``analysis/diffcheck.py``: every kernel cell held to its
declared bounds, whose sanitizer must hold).

    python -m hermes_tpu_torch.analysis.gate [--update] [--out FINDINGS]
        [--configs default,bench] [--no-kernels] [--device cpu]

The rounds are traced with fake tensors, so the configs analyze at their
full shapes in seconds on either device.  ``analysis_baseline.json``
beside this module grandfathers known findings (keyed without line
numbers); it ships empty, and ``--update`` rewrites it, and nothing else,
after an INTENTIONAL change.  Info findings (audited assumptions) never
gate but are counted.  One JSON summary line; exit 1 on a finding not in
the baseline or a sanitizer violation, 2 on an unknown config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

#: the port's grandfathered analysis findings (ships empty)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "analysis_baseline.json")


def gate_configs() -> dict:
    """The analyzed matrix: named configs.  The default (race arbiter) and
    the bench operating shapes (sort + chaining + fused sort; the split
    program is added automatically as the A/B variant), the mega path's
    kernels analyzed inside the round programs."""
    from hermes_tpu_torch.config import HermesConfig, bench_cfg

    return {
        "default": HermesConfig(),
        "bench": bench_cfg("a"),
        "bench-rmw": bench_cfg("rmw"),
        "bench-mega": dataclasses.replace(bench_cfg("a"), mega_round=True),
    }


def _count(findings, sev: dict) -> None:
    from hermes_tpu_torch.analysis.findings import ERROR, INFO, WARN

    for f in findings:
        key = {ERROR: "errors", WARN: "warnings", INFO: "infos"}[f.severity]
        sev[key] += f.count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hermes_tpu_torch.analysis"
                                 ".gate", description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline's grandfathered findings "
                    "instead of failing on drift")
    ap.add_argument("--out", default=None, metavar="FINDINGS_JSONL",
                    help="also export every finding as run-log JSONL")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the gate configs")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel matrix and its sanitizer")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from hermes_tpu_torch import analysis as ana
    from hermes_tpu_torch import device as device_lib

    device_lib.resolve(args.device)  # raises when the card is absent
    names = gate_configs()
    if args.configs:
        want = args.configs.split(",")
        unknown = [w for w in want if w not in names]
        if unknown:
            # a typo must not turn into a vacuous green gate
            print(f"unknown gate config(s) {unknown}; have {sorted(names)}",
                  file=sys.stderr)
            return 2
        names = {k: names[k] for k in want}

    measured: dict = {}
    all_reports = []
    sev = dict(errors=0, warnings=0, infos=0)
    programs = {}
    for cname, cfg in names.items():
        print(f"analyzing {cname} (S={cfg.n_sessions}, K={cfg.n_keys}, "
              f"arb={cfg.arb_mode}, fused={cfg.use_fused_sort}, "
              f"mega={cfg.use_mega_round})...", file=sys.stderr)
        reports = ana.analyze_config(cfg, device=args.device)
        for r in reports:
            for f in r["findings"]:
                f.engine = f"{cname}:{f.engine}"
            _count(r["findings"], sev)
            programs[f"{cname}:{r['engine']}"] = dict(
                nodes=r["n_eqns"], seconds=r["seconds"],
                kernels=r["kernels"])
        for k, v in ana.key_counts(ana.findings_of(reports)).items():
            measured[k] = measured.get(k, 0) + v
        all_reports.extend(reports)

    # the kernel matrix: its findings share the baseline currency (engine
    # key "kernel/<cell>"); a sanitizer violation means a declared bound is
    # unsound and fails the gate whatever the baseline says
    kernel_cells = {}
    sanitizer_ok = True
    if not args.no_kernels:
        print("analyzing the kernel matrix and its sanitizer...",
              file=sys.stderr)
        for r in ana.run_kernel_matrix(device=args.device):
            san = r.pop("sanitizer")
            kernel_cells[r["engine"]] = dict(
                seconds=r["seconds"], sanitizer_ok=san["ok"],
                draws=san["n_draws"])
            if not san["ok"]:
                sanitizer_ok = False
                print(f"SANITIZER VIOLATION in {r['engine']}: "
                      f"{san['violations']}", file=sys.stderr)
            _count(r["findings"], sev)
            for k, v in ana.key_counts(r["findings"]).items():
                measured[k] = measured.get(k, 0) + v
            all_reports.append(r)

    baseline = ana.load_baseline(args.baseline)
    new, stale = ana.diff_baseline(measured, baseline)
    if (new or stale) and args.update:
        notes = {}
        for r in all_reports:
            for f in r["findings"]:
                if f.severity in ana.GATING:
                    notes.setdefault(f.key, f.message)
        doc = {
            "_doc": "Grandfathered findings of the port's static round "
                    "analysis (python -m hermes_tpu_torch.analysis.gate).  "
                    "Keys carry no line number; rewrite with --update after "
                    "an INTENTIONAL change and commit the diff.  An empty "
                    "table means the engines analyze clean: keep it so.",
            "grandfathered": {k: {"count": c, "note": notes.get(k, "")}
                              for k, c in sorted(measured.items())},
        }
        with open(args.baseline, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"updated {args.baseline} ({len(measured)} grandfathered)",
              file=sys.stderr)
        new, stale = {}, {}

    if args.out:
        ana.export_findings(args.out, all_reports)
    ok = not new and sanitizer_ok
    print(json.dumps(dict(
        ok=ok, configs=sorted(names), device=args.device, **sev,
        gating_sites=len(measured), sanitizer_ok=sanitizer_ok,
        programs=programs, kernel_cells=kernel_cells,
        new_findings=sorted(new), stale_baseline=sorted(stale))))
    if new:
        print("NEW findings (fix, audit with layouts.audited, or "
              "consciously --update the baseline):", file=sys.stderr)
        for k in sorted(new):
            print(f"  {k} (+{new[k]})", file=sys.stderr)
    if stale:
        print("stale baseline entries (the code no longer produces them; "
              "--update prunes):", file=sys.stderr)
        for k in sorted(stale):
            print(f"  {k}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
