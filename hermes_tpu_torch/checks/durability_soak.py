"""The durability gate's child: the process ``checks/durability.py``
kills.

It puts waves at twice the store's in-flight capacity into a WAL-backed
KVS (``wal_sync='commit'``: a future resolves only after its group-commit
fsync), writes one JSON line for each commit a client observed to the
commits file, and dies by its own schedule: a ``powercut`` chaos event
fires in the middle of wave ``KILL_WAVE``, with ops in flight and the
dirty window non-empty, through a carrier that sends this process
``SIGKILL``.  No flush, no close, no exit handler.

The commits file is the parent's witness: every line is a write a client
saw resolve ``committed``, so after recovery every line's uid must be a
definite committed write of the replayed log
(``committed_write_lost == []``).  Lines are written only after the
resolution and flushed a wave (and by the carrier); a line lost in the
kill only shrinks the checked set.

    python -m hermes_tpu_torch.checks.durability_soak WAL_DIR BACKEND \\
        COMMITS_JSONL KILL_WAVE [--device cuda]

``KILL_WAVE < 0`` runs four waves without a powercut (the overhead leg
runs the same loop in-process through ``run_waves``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import signal
import sys

SEED = 29
N_REPLICAS = 3
PAYLOAD_WORDS = 4  # value_words = 2 uid words + payload


def soak_cfg(wal_dir, wal_sync="commit"):
    """One config for child and parent: ``recover_store`` refuses a log
    header of another config."""
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=N_REPLICAS, n_keys=128, n_sessions=8, replay_slots=8,
        value_words=2 + PAYLOAD_WORDS, ops_per_session=64,
        pipeline_depth=2, wal_dir=wal_dir, wal_sync=wal_sync,
        workload=WorkloadConfig(seed=SEED),
    )


def build_kvs(wal_dir, backend, wal_sync="commit", device="cuda"):
    from hermes_tpu_torch.kvs import KVS

    return KVS(soak_cfg(wal_dir, wal_sync), backend=backend, device=device)


def run_waves(kvs, waves, on_commit=None, on_wave=None, rng_seed=SEED):
    """The drive loop: a wave submits 2x-capacity puts of unique payloads,
    steps three rounds (the wave in flight), calls ``on_wave`` (the
    powercut's hook), resolves, and reports each committed put.  Returns
    the number of committed writes."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    cfg = kvs.cfg
    n = 2 * cfg.n_replicas * cfg.n_sessions  # 2x in-flight capacity
    committed = 0
    it = range(waves) if waves >= 0 else itertools.count()
    for wave in it:
        keys = rng.integers(0, cfg.n_keys, n)
        vals = np.empty((n, PAYLOAD_WORDS), np.int32)
        vals[:, 0] = wave
        vals[:, 1] = np.arange(n)
        vals[:, 2:] = rng.integers(0, 1 << 20, (n, PAYLOAD_WORDS - 2))
        bf = kvs.submit_batch(np.full(n, kvs.PUT, np.int32), keys, vals)
        for _ in range(3):
            kvs.step()
        if on_wave is not None:
            on_wave(wave)
        assert kvs.run_batch(bf), "soak wave did not resolve"
        for i in range(n):
            c = bf.completion(i)
            if c.kind == "put":
                committed += 1
                if on_commit is not None:
                    on_commit(c, wave)
            else:
                assert c.kind == "retry_after", (
                    f"unexpected completion {c.kind} for a put")
    return committed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hermes_tpu_torch.checks.durability_soak",
        description=__doc__.strip().splitlines()[0])
    ap.add_argument("wal_dir")
    ap.add_argument("backend", choices=("batched", "sharded"))
    ap.add_argument("commits")
    ap.add_argument("kill_wave", type=int)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    kvs = build_kvs(args.wal_dir, args.backend, device=args.device)
    out = open(args.commits, "w")

    def carrier(step):
        # the client's observations survive, the store's do not: that
        # asymmetry is what the parent checks
        out.flush()
        os.fsync(out.fileno())
        os.kill(os.getpid(), signal.SIGKILL)

    from hermes_tpu_torch import chaos

    sched = chaos.Schedule([chaos.ChaosEvent(step=args.kill_wave,
                                             kind="powercut")])
    runner = chaos.ChaosRunner(kvs, sched, powercut=carrier)

    def on_commit(c, wave):
        out.write(json.dumps(dict(uid=list(c.uid), key=c.key,
                                  ts=list(c.ts), wave=wave,
                                  durability=c.durability)) + "\n")

    def on_wave(wave):
        out.flush()
        runner.tick(wave)  # the powercut at kill_wave does not return

    if args.kill_wave >= 0:
        run_waves(kvs, -1, on_commit=on_commit, on_wave=on_wave)
        raise AssertionError("powercut never fired")
    run_waves(kvs, 4, on_commit=on_commit)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
