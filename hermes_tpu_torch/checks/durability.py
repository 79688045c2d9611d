"""The durability gate, the port's ``scripts/check_durability.py``: a
store killed by ``SIGKILL`` in the middle of a wave loses no write a
client was told was committed.

  1. ``check_kill`` (batched, sharded) -- the child
     (``checks/durability_soak.py``: put waves at twice the in-flight
     capacity, ``wal_sync='commit'``) fires a ``powercut`` chaos event
     whose carrier kills its own process.  The parent reaps it (on the
     card it waits until the card's memory is back), then recovers in
     this process with ``chaos.recover_store`` and requires:
       * ``committed_write_lost(witness, log) == []``;
       * each of the first 16 logged keys reads back its newest logged
         value;
       * recovery under ``RECOVERY_BOUND_S`` (ending in a sync on the
         card);
       * the recovered store commits new writes (the gate's fast-engine
         rounds: the child's launch counters die with it);
  2. ``check_wal_overhead`` -- the same drive loop with the WAL on
     (commit) and off, writes/s both ways, record-only.

    python -m hermes_tpu_torch.checks.durability [--device cpu] [--out FILE]
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from hermes_tpu_torch import checks
from hermes_tpu_torch.checks import durability_soak as soak

KILL_WAVE = 4
RECOVERY_BOUND_S = 90.0
CHILD_TIMEOUT_S = 420
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _read_commits(path):
    """The child's witness; a line torn by the kill only shrinks it (the
    child flushes a wave, so only the last line can tear)."""
    committed = []
    with open(path) as f:
        for ln in f:
            try:
                committed.append(json.loads(ln))
            except json.JSONDecodeError:
                break
    return committed


def _card_free(dev):
    import torch

    if dev.type != "cuda":
        return None
    checks.sync(dev)
    return torch.cuda.mem_get_info(dev)[0]


def _card_back(dev, free_before) -> None:
    """Wait until the reaped child's card memory is free again (within
    256 MiB of before it started, polled for 10 s)."""
    import torch

    if free_before is None:
        return
    for _ in range(100):
        if torch.cuda.mem_get_info(dev)[0] >= free_before - (256 << 20):
            return
        time.sleep(0.1)
    raise AssertionError("the card holds the killed child's memory after "
                         "it was reaped")


def run_child(d: str, backend: str, device="cuda"):
    """Run the soak child in ``d`` until its powercut; returns (wal_dir,
    the witness)."""
    from hermes_tpu_torch import device as device_lib

    dev = device_lib.resolve(device)
    wal_dir = os.path.join(d, "wal")
    commits = os.path.join(d, "commits.jsonl")
    free_before = _card_free(dev)
    p = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch.checks.durability_soak",
         wal_dir, backend, commits, str(KILL_WAVE), "--device", str(device)],
        cwd=ROOT, timeout=CHILD_TIMEOUT_S, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == -signal.SIGKILL, (
        f"{backend}: soak child exited {p.returncode}, want "
        f"-SIGKILL from its own powercut carrier\n{p.stderr[-2000:]}")
    _card_back(dev, free_before)
    committed = _read_commits(commits)
    assert committed, f"{backend}: child logged no committed writes"
    return wal_dir, committed


def newest_logged(records) -> dict:
    """key -> ((ver, fc), payload words) of its newest logged write."""
    newest = {}
    for rec in records:
        for i in range(int(rec["key"].shape[0])):
            k = int(rec["key"][i])
            ts = (int(rec["ver"][i]), int(rec["fc"][i]))
            if k not in newest or ts > newest[k][0]:
                newest[k] = (ts, rec["wv"][i, 2:].tolist())
    return newest


def check_kill(report: dict, backend: str, device="cuda") -> None:
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.chaos.recovery import recover_store
    from hermes_tpu_torch.checker.linearizability import committed_write_lost
    from hermes_tpu_torch.wal import crashdrive
    from hermes_tpu_torch.wal import replay as wal_replay

    dev = device_lib.resolve(device)
    with tempfile.TemporaryDirectory(prefix=f"durability_{backend}_") as d:
        wal_dir, committed = run_child(d, backend, device)
        # the dead store's log, parsed BEFORE recovery consumes it: the
        # history the checker cross-examines
        scan = wal_replay.read_records(wal_dir)
        ops = crashdrive.log_ops(scan["records"])
        t0 = time.perf_counter()
        kvs, rsum = recover_store(soak.soak_cfg(wal_dir), backend=backend,
                                  device=device)
        checks.sync(dev)
        recovery_s = time.perf_counter() - t0

        lost = committed_write_lost([tuple(c["uid"]) for c in committed],
                                    ops)
        assert lost == [], (
            f"{backend}: {len(lost)} committed write(s) LOST across the "
            f"kill -9 (first: {lost[:5]}) — the durability contract is void")
        assert recovery_s < RECOVERY_BOUND_S, (
            f"{backend}: recovery took {recovery_s:.1f}s "
            f"(bound {RECOVERY_BOUND_S}s)")

        # the recovered store SERVES each key's newest logged value
        served = 0
        for k, (_ts, want) in sorted(newest_logged(scan["records"]).items()
                                     )[:16]:
            fut = kvs.get(0, 0, k)
            assert kvs.run_until([fut]), f"{backend}: get({k}) never resolved"
            c = fut.result()
            assert c.found and c.value == want, (
                f"{backend}: recovered store serves {c.value} for key {k}, "
                f"log says {want}")
            served += 1

        # and it is still a store: fresh writes commit durably
        n_new = soak.run_waves(kvs, 1, rng_seed=soak.SEED + 1)
        assert n_new > 0, f"{backend}: no post-recovery write committed"
        kvs.wal.close()
    report[f"kill_{backend}"] = dict(
        committed_witnessed=len(committed), log_records=len(ops),
        committed_write_lost=[], torn_tail=bool(scan["torn_tail"]),
        applied=rsum["applied"], skipped=rsum["skipped"],
        recovery_s=recovery_s, keys_served=served,
        post_recovery_commits=n_new)


def check_kill_batched(report: dict, device="cuda") -> None:
    check_kill(report, "batched", device)


def check_kill_sharded(report: dict, device="cuda") -> None:
    check_kill(report, "sharded", device)


def check_wal_overhead(report: dict, device="cuda") -> None:
    """Writes/s with the WAL on (a group-commit fsync a resolved round)
    and off.  Record-only: the tax is the product."""
    from hermes_tpu_torch import device as device_lib

    dev = device_lib.resolve(device)
    cells = {}
    with tempfile.TemporaryDirectory(prefix="durability_overhead_") as d:
        for label, wal_dir in (("wal_off", None),
                               ("wal_on", os.path.join(d, "wal"))):
            kvs = soak.build_kvs(wal_dir, "batched", device=device)
            soak.run_waves(kvs, 1)  # warm, off the clock
            t0 = time.perf_counter()
            n = soak.run_waves(kvs, 4, rng_seed=soak.SEED + 2)
            checks.sync(dev)
            dt = time.perf_counter() - t0
            cells[label] = dict(writes=n, seconds=dt, writes_per_s=n / dt)
            if kvs.wal is not None:
                cells[label]["fsyncs"] = kvs.wal.stats()["fsyncs"]
                kvs.wal.close()
    on, off = cells["wal_on"]["writes_per_s"], cells["wal_off"]["writes_per_s"]
    cells["on_vs_off"] = on / off if off else None
    report["wal_overhead"] = cells


LEGS = (check_kill_batched, check_kill_sharded, check_wal_overhead)


def main(argv=None) -> int:
    return checks.run_legs("durability", LEGS, argv, "durability", __doc__)


if __name__ == "__main__":
    sys.exit(main())
