"""The port's gates beside the census, analysis and hostlint ones: one
module per gate script of the JAX package, each leg function under the
script's own name, run by ``hermes_tpu_torch/gates.py``.

  * ``obs_overhead`` -- ``scripts/check_obs_overhead.py``: phase metrics
    and per-op tracing change no outcome and cost under a host bound;
  * ``pipeline``     -- ``scripts/check_pipeline.py``: the harvest ring is
    invisible, the round writes in place, one control upload a transition;
  * ``chaos``        -- ``scripts/check_chaos.py``: the seeded soak, its
    replay, torn snapshots, the sim engine's net chaos;
  * ``elastic``      -- ``scripts/check_elastic.py``: rolling restart,
    resize and range migration;
  * ``netchaos``     -- ``scripts/check_netchaos.py``: the wire adversary,
    the frame CRC, partitions at pipeline depth 2;
  * ``fleet``        -- ``scripts/check_fleet.py``: a four-group fleet's
    soak on both engines, a one-group rolling drill, the fleet chaos
    replay, the scale-out cells;
  * ``serving``      -- ``scripts/check_serving.py``: overload soaks at
    twice the probed capacity, the fleet facade, an overload storm, the
    read soak, the columnar and shm planes and their two floors, measured
    in the gate's own run;
  * ``heap``         -- ``scripts/check_heap.py``: the value heap's GC,
    byte-exact reads, a fleet move, torn heap snapshots, the census;
  * ``durability``   -- ``scripts/check_durability.py``: a store killed by
    its own ``powercut`` (the child, ``durability_soak``) loses no
    committed write.

Each runs as ``python -m hermes_tpu_torch.checks.<name> [--device
cuda|cpu] [--out FILE]``, prints one JSON report line (``gate``, each
leg's fields, ``ok``, ``device`` and the hand kernels' ``launches`` by
name) and exits 1 on a violation.  It writes a file only under ``--out``.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Sequence


def kernel_launches() -> dict:
    """Every round kernel wrapper's launch counter, by kernel name (on
    the CPU a wrapper runs its plain version and counts nothing)."""
    from hermes_tpu_torch.core import dispatch, kernels, megaround  # noqa: F401

    return {n: int(w.launches)
            for n, w in sorted(dispatch.HAND_KERNELS.items())
            if hasattr(w, "launches")}


def parser(module: str, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m hermes_tpu_torch.checks.{module}",
        description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the report to FILE (JSON)")
    return ap


def finish(report: dict, device, out=None) -> int:
    """Stamp the device and the launches on ``report``, print it as one
    line, write it under ``out`` when given; the exit code."""
    from hermes_tpu_torch import device as device_lib

    report["device"] = device_lib.resolve(device).type
    report["launches"] = kernel_launches()
    line = json.dumps(report, default=str)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if report.get("ok") else 1


def run_legs(gate: str, legs: Sequence[Callable], argv, module: str,
             doc: str) -> int:
    """The common ``main``: every leg ``leg(report, device=...)`` in
    order; an AssertionError stops the gate red (the JAX package's
    gates' rule), any other exception propagates."""
    args = parser(module, doc).parse_args(argv)
    from hermes_tpu_torch import device as device_lib

    device_lib.resolve(args.device)  # raises when the card is absent
    report: dict = {"gate": gate}
    try:
        for leg in legs:
            leg(report, device=args.device)
    except AssertionError as e:
        report["ok"] = False
        report["error"] = str(e)
    else:
        report["ok"] = True
    return finish(report, args.device, args.out)


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU): a timed run ends here."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rewrite_archive(src: str, dst: str, edit) -> None:
    """Copy the zip archive ``src`` to ``dst`` member by member through
    ``edit(name, data)`` (bytes, or None to leave the member out)."""
    import zipfile

    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = edit(name, zin.read(name))
            if data is not None:
                zout.writestr(name, data)


def leaves(tree) -> list:
    """The numpy leaves of a tree of NamedTuples, in field order."""
    if isinstance(tree, tuple):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def fast_leaves(rt) -> list:
    """A FastRuntime's state in the JAX package's shapes, as leaves."""
    from hermes_tpu_torch import convert

    return leaves(convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies))


def phases_leaves(rt) -> list:
    """A phases-engine Runtime's ReplicaState, as numpy leaves."""
    from hermes_tpu_torch import convert

    return leaves(convert.replica_state_to_numpy(rt.rs))


def leaves_equal(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))
