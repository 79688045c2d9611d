"""Multi-process replica runner over the TCP transport: the port of
``hermes_tpu/distributed.py``.

One OS process = one replica.  The protocol phases are the same ones the
in-process backends run (``core/step._step_core`` over
``core/step.phase_fns``, here on one local replica), on the rank's
device; only the exchange differs: ``transport.tcp.TcpHostTransport``
over the C++ ``TcpMesh``, optionally wrapped in the wire adversary
``chaos.net.FaultingTransport``.  The mesh needs no NCCL, so several
ranks may share one card.

    python -m hermes_tpu_torch.distributed --rank R --n-ranks N \\
        [--steps S] [--base-port P] [--hosts ip0,ip1,...] \\
        [--out out_rank_R.pkl] [--device cuda|cpu]

Each rank writes its completion history and final table to ``--out``;
``combine_and_check(paths)`` merges them and runs the linearizability
gate.  The run is on the card unless ``--device cpu`` is given; asked for
the card on a machine without one, it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
import time

import numpy as np


def parse_wire_faults(spec: str):
    """Parse the ``--wire-faults`` mini-spec: semicolon-separated
    ``op:src:dst:from:until[:param]`` windows (op per chaos.net.WIRE_OPS;
    src/dst of -1 match any endpoint).  Every rank passes the SAME spec,
    so the per-rank interposers make consistent seeded decisions with no
    coordination."""
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        toks = part.split(":")
        if not (5 <= len(toks) <= 6):
            raise ValueError(
                f"bad wire fault {part!r}: want op:src:dst:from:until[:param]")
        out.append((toks[0], int(toks[1]), int(toks[2]), int(toks[3]),
                    int(toks[4]), int(toks[5]) if len(toks) == 6 else 0))
    return out


def fleet_base_port(base_port: int, fleet_group: int, n_ranks: int) -> int:
    """Process-to-group placement for TCP fleets: each key-sharded group
    is an independent n_ranks-process mesh on a disjoint port window."""
    if fleet_group < 0:
        raise ValueError("fleet_group must be >= 0")
    return base_port + fleet_group * 4 * n_ranks


def run_replica(cfg, rank: int, n_ranks: int, steps: int,
                base_port: int = 29500, hosts: str | None = None,
                out_path: str | None = None, wire_seed: int = 0,
                wire_faults: str | None = None, fleet_group: int = 0,
                device="cuda"):
    """Run replica ``rank`` of ``n_ranks`` for ``steps`` rounds over the
    TCP mesh on ``device``; returns (and pickles to ``out_path``) its
    history, final table, counters and wire counters."""
    import torch

    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.checker.history import HistoryRecorder
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.core import step as step_lib
    from hermes_tpu_torch.transport.tcp import TcpHostTransport
    from hermes_tpu_torch.workload import ycsb

    dev = device_lib.resolve(device)
    base_port = fleet_base_port(base_port, fleet_group, n_ranks)
    tcp_t = TcpHostTransport(cfg, rank, n_ranks, hosts=hosts,
                             base_port=base_port)
    transport = tcp_t
    wire = None
    if wire_faults:
        # the interposer runs per rank on the inbound path; the same spec
        # and seed on every rank give one consistent adversary
        from hermes_tpu_torch.chaos.net import FaultingTransport

        wire = FaultingTransport(tcp_t, n_ranks, seed=wire_seed,
                                 local_rank=rank)
        for op, src, dst, from_step, until, param in parse_wire_faults(
                wire_faults):
            wire.add(op, src, dst, from_step, until, param)
        transport = wire
    rs = st.init_replica_state(cfg, dev, n_rows=1)
    raw = ycsb.make_stream(cfg, rank)
    stream = st.OpStream(
        op=torch.tensor(np.asarray(raw.op)[None], dtype=torch.int32,
                        device=dev),
        key=torch.tensor(np.asarray(raw.key)[None], dtype=torch.int32,
                         device=dev))
    recorder = HistoryRecorder(cfg)
    ph = step_lib.phase_fns(cfg)
    ctl = st.Ctl(
        step=torch.zeros((1,), dtype=torch.int32, device=dev),
        my_cid=torch.full((1,), rank, dtype=torch.int32, device=dev),
        epoch=torch.zeros((1,), dtype=torch.int32, device=dev),
        live_mask=torch.full((1,), cfg.full_mask, dtype=torch.int32,
                             device=dev),
        frozen=torch.zeros((1,), dtype=torch.bool, device=dev))

    def ex(fn, s):
        """This rank's outbound block (its one local row) through the
        mesh; the inbound (R_src, ...) block back as the local row."""
        def go(blk):
            inb = fn(type(blk)(*(x[0] for x in blk)), s)
            return type(inb)(*(torch.tensor(np.asarray(x)[None], device=dev)
                               for x in inb))
        return go

    t0 = time.perf_counter()
    for s in range(steps):
        ctl = ctl._replace(step=torch.full((1,), s, dtype=torch.int32,
                                           device=dev))
        rs, comp = step_lib._step_core(
            cfg, ph, ex(transport.exchange_inv, s),
            ex(transport.exchange_ack, s), ex(transport.exchange_val, s),
            rs, stream, ctl)
        recorder.record_step(st.Completions(*(x.cpu().numpy()
                                              for x in comp)))
    seconds = time.perf_counter() - t0

    sess_np = st.Sessions(*(x.cpu().numpy() for x in rs.sess))
    # stamp the true replica id (the recorder saw one local row, 0)
    ops = [dataclasses.replace(o, replica=rank)
           for o in recorder.finalize(sess_np)]
    tbl = st.KeyTable(*(x[0].cpu().numpy().copy() for x in rs.table))
    meta = rs.meta
    result = dict(
        rank=rank,
        fleet_group=fleet_group,
        ops=ops,
        aborted=recorder.aborted_uids,
        table_state=tbl.state,
        table_ver=tbl.ver,
        table_fc=tbl.fc,
        table_val=tbl.val,
        sess_status=sess_np.status[0],
        counters=dict(
            n_read=int(meta.n_read[0]),
            n_write=int(meta.n_write[0]),
            n_rmw=int(meta.n_rmw[0]),
            n_abort=int(meta.n_abort[0]),
        ),
        corrupt_dropped=tcp_t.corrupt_dropped,
        wire=(dict(counters=dict(wire.counters),
                   fault_log_len=len(wire.fault_log))
              if wire is not None else None),
        seconds=seconds,
        rounds_per_s=steps / seconds if seconds > 0 else None,
        device=str(dev),
    )
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(result, f)
    tcp_t.close()
    return result


def combine_and_check(paths):
    """Merge per-rank results and run the linearizability gate."""
    from hermes_tpu_torch.checker import linearizability as lin

    results = []
    for p in paths:
        with open(p, "rb") as f:
            results.append(pickle.load(f))
    ops = [o for r in results for o in r["ops"]]
    aborted = set().union(*[r["aborted"] for r in results])
    verdict = lin.check_history(ops, aborted_uids=aborted)
    return verdict, results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hermes_tpu_torch.distributed",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--n-ranks", type=int, required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--base-port", type=int, default=29500)
    ap.add_argument("--hosts", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--n-keys", type=int, default=256)
    ap.add_argument("--n-sessions", type=int, default=8)
    ap.add_argument("--ops-per-session", type=int, default=24)
    ap.add_argument("--replay-slots", type=int, default=None,
                    help="replay slots a replica (default: the config's)")
    ap.add_argument("--value-words", type=int, default=None,
                    help="value words (default: the config's)")
    ap.add_argument("--replay-age", type=int, default=None,
                    help="replay age in rounds (default: the config's)")
    ap.add_argument("--read-frac", type=float, default=0.5)
    ap.add_argument("--rmw-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet-group", type=int, default=0,
                    help="key-sharded fleet group of this replica process: "
                         "groups are independent n-ranks meshes on "
                         "disjoint port windows (fleet_base_port)")
    ap.add_argument("--wire-seed", type=int, default=0,
                    help="seed for the adversarial wire interposer")
    ap.add_argument("--wire-faults", type=str, default=None,
                    help="semicolon-separated op:src:dst:from:until[:param] "
                         "windows injected by chaos.net.FaultingTransport "
                         "over the tcp transport (same spec on every rank)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the rank's phases run on (default: "
                         "the card; several ranks may share it)")
    return ap


def _main(argv=None):
    args = build_parser().parse_args(argv)

    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    over = {k: v for k, v in (("replay_slots", args.replay_slots),
                              ("value_words", args.value_words),
                              ("replay_age", args.replay_age))
            if v is not None}
    cfg = HermesConfig(
        n_replicas=args.n_ranks,
        n_keys=args.n_keys,
        n_sessions=args.n_sessions,
        ops_per_session=args.ops_per_session,
        workload=WorkloadConfig(read_frac=args.read_frac,
                                rmw_frac=args.rmw_frac, seed=args.seed),
        **over,
    )
    run_replica(cfg, args.rank, args.n_ranks, args.steps,
                base_port=args.base_port, hosts=args.hosts,
                out_path=args.out, wire_seed=args.wire_seed,
                wire_faults=args.wire_faults, fleet_group=args.fleet_group,
                device=args.device)


if __name__ == "__main__":
    _main()
