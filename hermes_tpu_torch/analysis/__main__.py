"""CLI: ``python -m hermes_tpu_torch.analysis`` — analyze the fast engines.

The engine mode (the default) traces the round of the chosen config on
the chosen engines (``analysis/engines.py``) and prints the findings and
the proof counts; ``--out`` also exports run-log JSONL.  Exit code 1 iff
any ERROR finding exists (the baselined gate is ``gates.py``'s
``analysis``).  Two other modes:

* ``--kernels``: the kernel matrix, every kernel cell run in the
  bound-checked build and through the differential sanitizer, exit 1 on
  any gating finding or sanitizer violation (``--device cpu`` holds the
  kernels' plain versions to the declared bounds instead, with an info
  finding per cell saying so);
* ``--host``: the static host lock lint (``analysis/hostlint.py``) over
  the package, exit 1 on any ERROR finding.

Every mode takes ``--device`` (default ``cuda``; raises without a card).
The engine programs are traced with fake tensors on that device, so any
shape analyzes in seconds on the CPU too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _named_cfg(name: str, args):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.obs.profile import _cli_cfg

    if name == "default":
        return HermesConfig()
    C = args.lane_budget or (3 * args.sessions) // 4
    if name == "bench":
        # the bench operating shape (sort arbiter + chaining + fused sort)
        return _cli_cfg(args.sessions, C, arb_mode="sort", chain_writes=128,
                        fused_sort=True)
    if name == "rmw":
        cfg = _cli_cfg(args.sessions, C, arb_mode="sort", chain_writes=0,
                       fused_sort=True)
        return dataclasses.replace(
            cfg, rmw_retries=16,
            workload=WorkloadConfig(read_frac=0.5, rmw_frac=1.0, seed=0))
    raise KeyError(name)


def _print_findings(findings) -> None:
    for f in findings:
        tag = f" (audit: {f.audit})" if f.audit else ""
        print(f"  [{f.severity:<5}] {f.pass_name}/{f.code} "
              f"{f.site} in {f.fn} x{f.count}{tag}\n"
              f"          {f.message}", file=sys.stderr)


def _by_severity(findings) -> dict:
    from hermes_tpu_torch.analysis.findings import ERROR, INFO, WARN

    return {s: [f for f in findings if f.severity == s]
            for s in (ERROR, WARN, INFO)}


def _engine_main(args) -> int:
    from hermes_tpu_torch import analysis as ana

    cfg = _named_cfg(args.config, args)
    if args.split_sort:
        cfg = dataclasses.replace(cfg, fused_sort=False, mega_round=False)
    engines = (("batched", "sharded") if args.engine == "both"
               else (args.engine,))
    variants = "as-is" if (args.no_variants or args.split_sort) else "both"
    reports = ana.analyze_config(cfg, engines=engines, variants=variants,
                                 device=args.device)
    n_err = n_warn = n_info = 0
    for r in reports:
        by = _by_severity(r["findings"])
        n_err += len(by[ana.ERROR])
        n_warn += len(by[ana.WARN])
        n_info += len(by[ana.INFO])
        if not args.json:
            proved = " ".join(f"{k}={v}" for k, v in r["proved"].items())
            print(f"== {r['engine']} @ {args.config}: {r['n_eqns']} nodes, "
                  f"proved [{proved}], {len(by[ana.ERROR])} error / "
                  f"{len(by[ana.WARN])} warn / {len(by[ana.INFO])} info "
                  f"in {r['seconds']}s", file=sys.stderr)
            _print_findings(r["findings"])
    if args.out:
        ana.export_findings(args.out, reports, extra={"config": args.config})
    print(json.dumps(dict(
        config=args.config, engines=list(engines), device=args.device,
        programs=[r["engine"] for r in reports],
        nodes={r["engine"]: r["n_eqns"] for r in reports},
        errors=n_err, warnings=n_warn, infos=n_info)))
    return 1 if n_err else 0


def _host_main(args) -> int:
    """The static host lock lint over the package: one JSON summary line,
    exit 1 iff any ERROR finding (the baselined gate with the red legs and
    the soak is ``python -m hermes_tpu_torch.analysis.hostlint``)."""
    from hermes_tpu_torch import analysis as ana
    from hermes_tpu_torch.analysis import hostlint

    rep = hostlint.lint_package()
    by = _by_severity(rep["findings"])
    if not args.json:
        proved = " ".join(f"{k}={v}" for k, v in rep["proved"].items())
        print(f"== host: {rep['n_eqns']} files, proved [{proved}], "
              f"{len(by[ana.ERROR])} error / {len(by[ana.WARN])} warn / "
              f"{len(by[ana.INFO])} info", file=sys.stderr)
        _print_findings(rep["findings"])
    if args.out:
        ana.export_findings(args.out, [rep], extra={"config": "host"})
    print(json.dumps(dict(
        config="host", engines=["host"], files=rep["n_eqns"],
        errors=len(by[ana.ERROR]), warnings=len(by[ana.WARN]),
        infos=len(by[ana.INFO]))))
    return 1 if by[ana.ERROR] else 0


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
            _print_findings(r["findings"])
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
        description="Static round analysis: prove the packed words "
        "(bit-pack intervals, dtype rules, scatter hazards, hand-kernel "
        "bounds, sharding consistency) of the fast protocol round; "
        "--kernels: the kernel matrix; --host: the host lock lint.")
    ap.add_argument("--config", choices=["default", "bench", "rmw"],
                    default="default")
    ap.add_argument("--sessions", type=int, default=16384,
                    help="bench/rmw config session count")
    ap.add_argument("--lane-budget", type=int, default=None)
    ap.add_argument("--engine", choices=["batched", "sharded", "both"],
                    default="batched")
    ap.add_argument("--split-sort", action="store_true",
                    help="analyze ONLY the split two-sort program")
    ap.add_argument("--no-variants", action="store_true",
                    help="analyze the config as-is (skip the split-sort "
                    "A/B program)")
    ap.add_argument("--kernels", action="store_true",
                    help="run ONLY the kernel matrix: every kernel cell in "
                    "the bound-checked build and through the differential "
                    "sanitizer")
    ap.add_argument("--draws", type=int, default=3,
                    help="sanitizer draws per kernel cell (--kernels)")
    ap.add_argument("--host", action="store_true",
                    help="run ONLY the host lock lint over the package")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON summary line, not the "
                    "per-program report")
    ap.add_argument("--out", default=None, metavar="FINDINGS_JSONL",
                    help="export findings as run-log JSONL (kind=analysis)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from hermes_tpu_torch import device as device_lib

    device_lib.resolve(args.device)  # raises when the card is absent
    if args.host:
        return _host_main(args)
    if args.kernels:
        return _kernels_main(args)
    return _engine_main(args)


if __name__ == "__main__":
    sys.exit(main())
