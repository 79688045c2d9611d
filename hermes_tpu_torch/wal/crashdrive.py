"""The kill -9 drive: a KVS with the write-ahead log on, killed by
``SIGKILL`` in the middle of a wave, and the checks its recovery must
pass.

    python -m hermes_tpu_torch.wal.crashdrive WAL_DIR WITNESS_DIR \\
        [--waves 5] [--wave-puts 131072] [--shape bench|small] \\
        [--device cuda]

The child (this module's ``main``) builds ``crash_cfg(shape, WAL_DIR)``
with ``wal_sync='commit'`` and puts waves of distinct keys through
``KVS.submit_batch``; the key sets of two waves overlap, so recovery
must pick the newest value.  After each resolved wave it writes the
committed keys, uids and values to ``WITNESS_DIR/wave-NNN.npz``
(tmp + fsync + rename), and before the last wave it writes that wave's
keys and values as ``pending.npz``.  In the last wave it sends itself
``SIGKILL`` once a log batch of the wave's first half is durable, its
second half submitted and unresolved.

The parent reaps the child, runs ``chaos.recover_store`` on the same
configuration and holds it to ``check_recovery``: no committed write is
missing from the log (``committed_write_lost == []``), every written key
reads back its newest logged value, which is the newest committed value
of the witness unless the killed wave's own write to the key survived,
and the store commits new writes.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

import numpy as np

SEED = 14


def crash_cfg(shape: str, wal_dir, **over):
    """The drive's configuration: the reads phase's KVS shape
    (``config.bench_cfg('a')`` with the client stream: 8 replicas, 2^20
    keys, 40-byte rows, 65,536 sessions) or a small one for CPU tests."""
    from hermes_tpu_torch import config

    kw = dict(device_stream=False, read_unroll=1, wal_dir=wal_dir,
              wal_sync="commit")
    kw.update(over)
    if shape == "bench":
        return config.bench_cfg("a", over=kw)
    return config.HermesConfig(n_replicas=3, n_keys=512, n_sessions=32,
                               replay_slots=8, value_words=6,
                               workload=config.WorkloadConfig(seed=SEED),
                               **kw)


def wave_ops(cfg, wave: int, n: int):
    """Keys (distinct within the wave) and payload words of wave
    ``wave``: word 0 the wave, word 1 the op's index."""
    rng = np.random.default_rng([SEED, wave])
    keys = rng.choice(cfg.n_keys, n, replace=False).astype(np.int64)
    vals = rng.integers(-(1 << 30), 1 << 30,
                        (n, cfg.value_words - 2)).astype(np.int32)
    vals[:, 0] = wave
    vals[:, 1] = np.arange(n)
    return keys, vals


def _save_atomic(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run_wave(kvs, wave: int, n: int, kill: bool = False):
    """Put one wave through ``submit_batch`` and drive it.  With ``kill``
    the wave goes in two halves: the first is driven until one of its log
    batches is durable, then the second is submitted and stepped once,
    and this process SIGKILLs itself with that half unresolved.  (One
    batch of the whole wave can fit one round, which can resolve whole in
    the very step its log batch turns durable: there would be no moment
    to kill it mid-wave.)"""
    keys, vals = wave_ops(kvs.cfg, wave, n)
    puts = np.full(n, kvs.PUT, np.int32)
    if not kill:
        bf = kvs.submit_batch(puts, keys, vals)
        for _ in range(10_000):
            if bf.all_done():
                break
            kvs.step()
        return bf, keys, vals
    h = n // 2
    lsn0 = kvs.wal.last_lsn()
    kvs.submit_batch(puts[:h], keys[:h], vals[:h])
    for _ in range(10_000):
        kvs.step()
        if kvs.wal.durable_lsn() > lsn0:
            kvs.submit_batch(puts[h:], keys[h:], vals[h:])
            kvs.step()
            os.kill(os.getpid(), signal.SIGKILL)
    raise RuntimeError("no log batch of the killed wave became durable")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wal_dir")
    ap.add_argument("witness_dir")
    ap.add_argument("--waves", type=int, default=5,
                    help="waves put; the last one is killed")
    ap.add_argument("--wave-puts", type=int, default=131072)
    ap.add_argument("--shape", choices=["bench", "small"], default="bench")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from hermes_tpu_torch.core import types as t
    from hermes_tpu_torch.kvs import KVS

    cfg = crash_cfg(args.shape, args.wal_dir)
    os.makedirs(args.witness_dir, exist_ok=True)
    kvs = KVS(cfg, device=args.device)
    for w in range(args.waves - 1):
        bf, keys, vals = run_wave(kvs, w, args.wave_puts)
        ok = bf.code == t.C_WRITE
        if not ok.all():
            raise RuntimeError(f"wave {w}: {int((~ok).sum())} puts failed")
        _save_atomic(os.path.join(args.witness_dir, f"wave-{w:03d}.npz"),
                     keys=keys, uids=bf.uid, values=vals,
                     durability=np.array([str(bf.durability)]))
    last = args.waves - 1
    keys, vals = wave_ops(cfg, last, args.wave_puts)
    _save_atomic(os.path.join(args.witness_dir, "pending.npz"), keys=keys,
                 values=vals)
    run_wave(kvs, last, args.wave_puts, kill=True)
    return 1  # unreachable: the wave kills this process


def read_witness(witness_dir: str):
    """(committed, pending): committed is a list of (keys, uids, values)
    per resolved wave in wave order; pending the killed wave's (keys,
    values) or None."""
    committed = []
    for name in sorted(os.listdir(witness_dir)):
        if name.startswith("wave-") and name.endswith(".npz"):
            with np.load(os.path.join(witness_dir, name)) as z:
                committed.append((z["keys"], z["uids"], z["values"]))
    pend = os.path.join(witness_dir, "pending.npz")
    pending = None
    if os.path.exists(pend):
        with np.load(pend) as z:
            pending = (z["keys"], z["values"])
    return committed, pending


def log_ops(records):
    """Every logged write as a definite committed checker op (uid in
    value words 0-1, the (ver, fc) witness in its own columns)."""
    from hermes_tpu_torch.checker.history import Op

    ops = []
    for rec in records:
        for i in range(int(rec["key"].shape[0])):
            step = int(rec["step"][i])
            ops.append(Op(
                "w", int(rec["key"][i]), 2 * step, 2 * step + 1,
                wuid=(int(rec["wv"][i, 0]), int(rec["wv"][i, 1])),
                ts=(int(rec["ver"][i]), int(rec["fc"][i]))))
    return ops


def _dense(cfg, pairs):
    """(values (K, U), present (K,)) from (keys, values) pairs applied in
    order: a later pair's write to a key replaces an earlier one."""
    val = np.zeros((cfg.n_keys, cfg.value_words - 2), np.int32)
    has = np.zeros(cfg.n_keys, bool)
    for keys, vals in pairs:
        val[keys] = vals
        has[keys] = True
    return val, has


def check_recovery(kvs, records, witness_dir: str) -> dict:
    """Hold a recovered store to the witness and the log; raises
    AssertionError on the first violation, else returns the counts."""
    from hermes_tpu_torch.checker import linearizability as lin

    cfg = kvs.cfg
    committed, pending = read_witness(witness_dir)
    if not committed:
        raise AssertionError("the child witnessed no committed write")
    uids = [tuple(int(x) for x in u) for _k, us, _v in committed for u in us]
    lost = lin.committed_write_lost(uids, log_ops(records))
    if lost:
        raise AssertionError(f"{len(lost)} committed write(s) lost across "
                             f"the kill -9 (first {lost[:4]})")
    newest, has_newest = _dense(cfg, [(k, v) for k, _u, v in committed])
    pend, has_pend = _dense(cfg, [pending] if pending is not None else [])
    # the newest LOGGED payload per key: what recovery must serve
    key = np.concatenate([r["key"] for r in records]).astype(np.int64)
    ts = np.concatenate([r["ver"].astype(np.int64) * (1 << 32) + r["fc"]
                         for r in records])
    wv = np.concatenate([r["wv"][:, 2:] for r in records])
    order = np.lexsort((ts, key))
    last = np.ones(order.size, bool)
    last[:-1] = key[order][1:] != key[order][:-1]
    logged, has_logged = _dense(cfg, [(key[order][last], wv[order][last])])
    keys = np.nonzero(has_newest | has_logged)[0]
    res = kvs.multi_get(keys)
    if not res.all_done():
        raise AssertionError("the read-back of the written keys did not "
                             "complete")
    got = res.value
    eq = lambda a: (got == a[keys]).all(axis=1)
    bad = np.nonzero(~has_logged[keys] | ~eq(logged))[0]
    if bad.size:
        k = int(keys[bad[0]])
        raise AssertionError(f"key {k}: recovered {got[bad[0]].tolist()}, "
                             f"the log's newest is {logged[k].tolist()}")
    # only the killed wave's own write may be newer than the witness
    from_pend = has_pend[keys] & eq(pend)
    ok = (has_newest[keys] & eq(newest)) | from_pend
    bad = np.nonzero(~ok)[0]
    if bad.size:
        k = int(keys[bad[0]])
        raise AssertionError(
            f"key {k}: recovered {got[bad[0]].tolist()} is neither the "
            "witness's newest committed value nor the killed wave's write")
    survived = from_pend & ~(has_newest[keys] & eq(newest))
    return dict(witnessed=len(uids), keys_read=int(keys.size),
                killed_wave_survivors=int(survived.sum()),
                log_records=int(key.size))


if __name__ == "__main__":
    sys.exit(main())
