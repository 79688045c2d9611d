"""CLI: ``python -m hermes_tpu_torch.analysis --kernels`` — the kernel
matrix: every kernel cell run in the bound-checked build and through the
differential sanitizer, one JSON summary line, exit 1 on any gating
finding or sanitizer violation.

Runs on the card; ``--device cpu`` holds the kernels' plain versions to the
declared bounds instead (no access is bound-checked there, and an info
finding per cell says so).  ``--out`` also exports the findings as run-log
JSONL.  The reference's other modes (the engine programs, ``--host``) are
not ported.
"""

from __future__ import annotations

import argparse
import json
import sys


def _kernels_main(args) -> int:
    from hermes_tpu_torch import analysis as ana

    reports = ana.run_kernel_matrix(n_draws=args.draws, device=args.device)
    totals = {ana.ERROR: 0, ana.WARN: 0, ana.INFO: 0}
    ok = True
    cells = {}
    for r in reports:
        by = {s: [f for f in r["findings"] if f.severity == s] for s in totals}
        for s in totals:
            totals[s] += len(by[s])
        san = r["sanitizer"]
        ok = ok and san["ok"] and not by[ana.ERROR] and not by[ana.WARN]
        cells[r["engine"]] = dict(
            seconds=r["seconds"], n_sites=r["n_sites"], build=r["build"],
            errors=len(by[ana.ERROR]), warnings=len(by[ana.WARN]),
            infos=len(by[ana.INFO]), sanitizer_ok=san["ok"],
            draws=san["n_draws"])
        if not args.json:
            proved = " ".join(f"{k}={v}" for k, v in r["proved"].items())
            print(f"== {r['engine']}: {r['n_sites']} guard sites "
                  f"({r['build']} build), proved [{proved}], "
                  f"{len(by[ana.ERROR])} error / {len(by[ana.WARN])} warn / "
                  f"{len(by[ana.INFO])} info, sanitizer "
                  f"{'ok' if san['ok'] else 'VIOLATED'} "
                  f"({san['n_draws']} draws) in {r['seconds']}s",
                  file=sys.stderr)
            for f in r["findings"]:
                print(f"  [{f.severity:<5}] {f.pass_name}/{f.code} "
                      f"{f.site} in {f.fn} x{f.count}\n"
                      f"          {f.message}", file=sys.stderr)
            for v in san["violations"]:
                print(f"  [ESCAPE] out{v['out']} draw{v['draw']} "
                      f"{v['kind']}: concrete {v['concrete']} escapes "
                      f"declared {v['abstract']}", file=sys.stderr)
    if args.out:
        ana.export_findings(args.out, reports, extra={"config": "kernels"})
    print(json.dumps(dict(config="kernels", ok=ok, errors=totals[ana.ERROR],
                          warnings=totals[ana.WARN], infos=totals[ana.INFO],
                          cells=cells)))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hermes_tpu_torch.analysis",
        description="The kernel matrix: every kernel cell in the "
        "bound-checked build and through the differential sanitizer.")
    ap.add_argument("--kernels", action="store_true",
                    help="run the kernel matrix (the one mode ported)")
    ap.add_argument("--draws", type=int, default=3,
                    help="sanitizer draws per kernel cell")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON summary line, not the "
                    "per-cell report")
    ap.add_argument("--out", default=None, metavar="FINDINGS_JSONL",
                    help="export findings as run-log JSONL (kind=analysis)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if not args.kernels:
        ap.error("only the kernel matrix is ported: pass --kernels")
    return _kernels_main(args)


if __name__ == "__main__":
    sys.exit(main())
