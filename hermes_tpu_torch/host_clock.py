"""Host-clock cost of the port at one checkout, for comparing two checkouts
back to back on the same card: the bench-a round (fused and mega) in
timed windows, and the host time one kernel wrapper call takes to enqueue.

    python3 hermes_tpu_torch/host_clock.py --root DIR [--windows 3]

imports ``hermes_tpu_torch`` from ``DIR`` (a checkout of any commit of the
port that has the mega round) and prints one JSON line.  The host clock of a
shared machine drifts from minute to minute, so run the two checkouts in
turns (parent, change, change, parent), each in a process of its own, and
compare only what ran back to back.

* ``us_per_round``: ``--windows`` windows of 60 rounds of
  ``FastRuntime.run`` on ``config.bench_cfg("a")``, host clock ending in a
  device sync, after 4 warm-up rounds; fused and mega windows in turns.
* ``enqueue_us``: host microseconds a call of ``stats_block``,
  ``mega_route`` and ``mega_apply`` takes to return, at the kernel matrix's
  small shapes (where the device finishes before the host comes back, so
  the loop is bound by the host), median of 5 bursts of 2,000 calls.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROUNDS, BURST = 60, 2000


def _window(torch, rt) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.run(ROUNDS)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ROUNDS * 1e6


def _enqueue_us(torch, call) -> float:
    call()
    out = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BURST):
            call()
        out.append((time.perf_counter() - t0) / BURST * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the checkout whose hermes_tpu_torch is measured")
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[0] = os.path.abspath(args.root)  # in place of this file's folder
    import torch

    if not torch.cuda.is_available():
        print("host_clock: this needs a CUDA card", file=sys.stderr)
        return 2
    from hermes_tpu_torch import build, config
    from hermes_tpu_torch.core import kernels, megaround
    from hermes_tpu_torch.runtime import FastRuntime

    build.build_cuda_all()
    rts = {}
    for name, mega in (("fused", False), ("mega", True)):
        rt = FastRuntime(config.bench_cfg("a", over=dict(mega_round=mega)),
                         device="cuda")
        rt.fetch_completions = False
        rt.run(4)
        rts[name] = rt
    rounds = {name: [] for name in rts}
    for _ in range(args.windows):
        for name, rt in rts.items():
            rounds[name].append(_window(torch, rt))
    del rts

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    R, S = 4, 512
    i32 = lambda shape, hi: torch.randint(0, hi, shape, generator=g,
                                          dtype=torch.int32).to(dev)
    flag = lambda: (torch.rand((R, S), generator=g) < 0.3).to(dev)
    stats = (torch.tensor(77, dtype=torch.int32, device=dev), i32((R, S), 4),
             i32((R, S), 70), flag(), flag(), flag())
    cfg = config.HermesConfig(n_replicas=2, n_keys=16, n_sessions=4,
                              replay_slots=2, ops_per_session=4,
                              arb_mode="sort", mega_round=True)
    L, N = cfg.n_lanes, 16
    perm = lambda: torch.argsort(torch.rand((2, L), generator=g),
                                 dim=1).to(torch.int32).to(dev)
    route = (cfg, perm(), i32((2, L), 1 << 22), perm())
    apply_ = (cfg, i32((16,), 1 << 24), i32((N,), 16), i32((N,), 1 << 25),
              (torch.rand((N,), generator=g) < 0.75).to(dev))
    enqueue = {
        "stats_block": _enqueue_us(torch, lambda: kernels.stats_block(*stats)),
        "mega_route": _enqueue_us(torch,
                                  lambda: megaround.mega_route(*route)),
        "mega_apply": _enqueue_us(torch,
                                  lambda: megaround.mega_apply(*apply_)),
    }
    print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                      "rounds_per_window": ROUNDS, "us_per_round": rounds,
                      "enqueue_calls": BURST, "enqueue_us": enqueue}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
