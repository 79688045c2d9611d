"""The serving gate's columnar floor, measured again and split.

``soak.measure_columnar_floor`` (the gate's cell, its own store and
envelope) runs several times in one process: each run's ops/s, its store
rounds and, over the whole call (the store's build and the warm-up
batch included), the host
milliseconds a round and the share of them the round's dispatch takes
(``FastRuntime.dispatch_round`` on the host clock); then the card's busy
share over one more run, from the CUDA events around each of its
compiled rounds' replays (``graphs.timed_all``).

    python -m hermes_tpu_torch.serving.floor_probe [--runs 10] [--device cpu]

Prints one JSON object.  Without ``--device`` it wants the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def probe(runs: int = 10, device="cuda") -> dict:
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.runtime import FastRuntime
    from hermes_tpu_torch.serving.soak import measure_columnar_floor

    dev = device_lib.resolve(device)
    spent = []
    real = FastRuntime.dispatch_round

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    FastRuntime.dispatch_round = timed
    try:
        measure_columnar_floor(device=device)  # kernel loads, allocator
        cells = []
        for _ in range(runs):
            spent.clear()
            t0 = time.perf_counter()
            fl = measure_columnar_floor(device=device)
            cells.append(dict(ops_per_sec=fl["ops_per_sec"],
                              call_s=time.perf_counter() - t0,
                              rounds=len(spent), dispatch_s=sum(spent)))
    finally:
        FastRuntime.dispatch_round = real
    out = dict(device=dev.type, runs=cells,
               ops_per_sec=[c["ops_per_sec"] for c in cells],
               round_ms=[c["call_s"] / c["rounds"] * 1e3 for c in cells],
               dispatch_share=[c["dispatch_s"] / c["call_s"]
                               for c in cells])
    if dev.type == "cuda":
        import torch

        from hermes_tpu_torch.core import graphs

        torch.cuda.synchronize()
        with graphs.timed_all() as spans:
            t0 = time.perf_counter()
            measure_columnar_floor(device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        out["timed"] = dict(busy_s=busy, wall_s=wall, rounds=len(spans),
                            busy_share=busy / wall)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hermes_tpu_torch.serving.floor_probe",
        description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps(probe(a.runs, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
