"""CLI: run a replicated-KVS workload on the port's batched fast engine.

    python -m hermes_tpu_torch --replicas 8 --keys $((1<<20)) \\
        --sessions 1024 --arb-mode sort --chain-writes 128 --check
    python -m hermes_tpu_torch --arb-mode sort --mega-round --check

The default fast-backend drive of ``hermes_tpu/cli.py``: with ``--steps
0`` (the default) the run drains every session's op stream; ``--check``
records the history and runs the linearizability gate (sampled over 512
keys).  It prints the summary record, then the verdict.  The run is on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

# keys the --check gate samples (the reference CLI's --check-keys default)
CHECK_KEYS = 512


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hermes_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    return ap


def main(argv=None) -> int:
    from hermes_tpu_torch import stats as stats_lib
    from hermes_tpu_torch.checker.fast import default_record
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.runtime import FastRuntime

    ap = build_parser()
    args = ap.parse_args(argv)
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
    )
    rt = FastRuntime(cfg, record=default_record(args.check),
                     device=args.device)
    t0 = time.perf_counter()
    if args.steps > 0:
        rt.run(args.steps)
    elif not rt.drain():
        print("WARNING: did not drain", file=sys.stderr)
    if rt.device.type == "cuda":
        import torch

        torch.cuda.synchronize(rt.device)
    wall = time.perf_counter() - t0
    print(stats_lib.summarize(rt.fs.meta, wall, rt.step_idx))
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
