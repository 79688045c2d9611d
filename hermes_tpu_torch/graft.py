"""Entry points of the port for an outside harness: a one-card round
check and a multi-process dry run; the counterpart of the repo root's
``__graft_entry__.py``.

``entry(device)`` returns ``(fn, example_args)``: one bulk-synchronous
Hermes round (coordinate -> INV -> apply_inv -> ACK -> collect_acks -> VAL
-> apply_val) of an 8-replica store batched on one card, the fast round
with the sort arbiter and write chaining, as the bench runs it.

``dryrun_multichip(n)`` runs the deployed layout, one replica a process
over ``torch.distributed`` (gloo on the CPU, ``DistGroup``), on tiny
shapes: full rounds of the sharded fast engine and of the phases engine.

    python -m hermes_tpu_torch.graft [--device cpu] [--dryrun N]

Every path prints a heartbeat line the instant it is entered, so a
caller's timeout localises a hang.  ``HERMES_ENTRY_PROBE=0`` skips the
bounded card probe ``entry`` takes first (``probe.probe_backend``);
``HERMES_ENTRY_PROBE_TIMEOUT`` sets its bound in seconds (default 180).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def _hb(msg: str) -> None:
    """Heartbeat: every entry path announces itself when entered."""
    print(f"[graft pid={os.getpid()}] {msg}", flush=True)


def _cfg(n_replicas: int, tiny: bool):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=n_replicas,
        n_keys=256 if tiny else 4096,
        n_sessions=8 if tiny else 64,
        replay_slots=4 if tiny else 16,
        ops_per_session=8 if tiny else 64,
        read_unroll=2,  # the flagship local-read drain
        arb_mode="sort",  # the bench's arbitration
        chain_writes=4 if tiny else 16,
        workload=WorkloadConfig(read_frac=0.5, rmw_frac=0.2, seed=0),
    )


def entry(device="cuda"):
    """``(fn, example_args)``: the fast round of 8 replicas batched on
    ``device``; ``fn(*example_args)`` runs it once (the table in place)
    and returns ``(fs, comp)``.  On the card the bounded probe runs first
    and raises a diagnosis in place of a hang."""
    import torch

    _hb(f"entry(device={device!r}): entered")
    dev = torch.device(device)
    if dev.type == "cuda" and os.environ.get("HERMES_ENTRY_PROBE",
                                             "1") != "0":
        from hermes_tpu_torch.probe import probe_backend

        timeout_s = float(os.environ.get("HERMES_ENTRY_PROBE_TIMEOUT", "180"))
        _hb(f"entry(): probing the card (bounded, {timeout_s:.0f}s)")
        ok, info = probe_backend(timeout_s)
        if not ok:
            raise RuntimeError(f"entry(): the card is unavailable: {info}")
        _hb(f"entry(): card probe ok ({info}); building example args")
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.workload import ycsb

    dev = device_lib.resolve(device)
    cfg = _cfg(n_replicas=8, tiny=False)
    fs = fst.init_fast_state(cfg, dev)
    stream = fst.prep_stream(ycsb.make_streams(cfg), dev)
    ctl = fst.make_fast_ctl(cfg, 0, dev)

    def fn(fs, stream, ctl):
        return fst.fast_round_batched(cfg, ctl, fs, stream)

    return fn, (fs, stream, ctl)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, world: int, init: str) -> None:
    """One rank of the dry run: replica ``rank`` of ``world`` over gloo,
    two fast sharded rounds and one phases-engine round."""
    import torch
    import torch.distributed as dist

    from hermes_tpu_torch.core.group import DistGroup
    from hermes_tpu_torch.runtime import FastRuntime, Runtime

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        cfg = _cfg(n_replicas=world, tiny=True)
        group = DistGroup(None, "cpu")
        frt = FastRuntime(cfg, backend="sharded", group=group, device="cpu")
        frt.step_once()
        frt.step_once()  # the second round reuses the first one's state
        rt = Runtime(cfg, backend="sharded", group=group, device="cpu")
        rt.step_once()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    _hb(f"dryrun rank {rank}/{world}: ok")


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """Full rounds over ``n_devices`` processes, one Hermes replica a
    process: the INV and VAL blocks all-gathered and the ACK block routed
    back over gloo (``DistGroup``), on tiny shapes, for the sharded fast
    engine and the phases engine.  It runs on the CPU whatever the
    machine holds: NCCL needs a card a rank.  Raises if a rank fails or
    the run outlasts ``timeout_s``; stops every process it started."""
    _hb(f"dryrun_multichip(n={n_devices}): entered; {n_devices} gloo "
        "processes on the CPU")
    init = f"tcp://localhost:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hermes_tpu_torch.graft", "--dryrun-rank",
         str(r), "--world", str(n_devices), "--init", init],
        cwd=root, env=env) for r in range(n_devices)]
    try:
        rcs = [p.wait(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip: rank exit codes {rcs}")
    _hb("dryrun_multichip: every rank completed")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m hermes_tpu_torch.graft",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device entry() runs on (default: the card)")
    ap.add_argument("--dryrun", type=int, default=8, metavar="N",
                    help="processes of the multi-process dry run")
    ap.add_argument("--dryrun-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_rank is not None:
        _dryrun_rank(args.dryrun_rank, args.world, args.init)
        return 0
    # the dry run first: it never touches the card, so its signal is
    # recorded before a card fault could time the entry check out
    dryrun_multichip(args.dryrun)
    print("dryrun_multichip ok", flush=True)
    fn, ex = entry(args.device)
    fn(*ex)
    if ex[0].table.bank.is_cuda:
        import torch

        torch.cuda.synchronize()
    print("entry step ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
