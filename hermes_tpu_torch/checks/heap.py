"""The heap gate, the port's ``scripts/check_heap.py``: the value heap
holds end to end.

  1. ``check_heap_soak`` -- seeded overwrite churn (``ycsb.value_sizes``)
     at pipeline depth 2 on both engines against a small log, so that
     pressure GC and an explicit GC at a drained boundary both fire: every
     surviving value reads back byte-exact through ``multi_get`` and
     through the device extent gather against the host mirror, the
     checker green with ``stale_read == []``, and the compacted log at
     least ``UTIL_FLOOR`` live;
  2. ``check_fleet_migration`` -- a two-group heap-mode ``Fleet`` moves a
     live range: the extents reappear byte-exact behind the destination
     group's own refs, the fleet's checkers and invariants hold;
  3. ``check_torn_snapshot`` -- a clean snapshot restores every payload;
     the same archive with one bit flipped in the heap log member is
     refused;
  4. ``check_census_unchanged`` -- the heap-mode round has the
     fixed-word config's census on all four engines (batched, sharded,
     and both with the mega round), each within the port's own budget
     (``obs/op_budget.json``), the heap's dispatches within theirs
     (``heap_path`` one gather, ``heap_append`` no sparse op), and the
     extent gather analyzes clean.  The JAX package counts StableHLO ops
     (its "batched 12 / sharded 15, mega 4 / 7"); the port counts the
     aten ops of one real round (``obs/profile.py``), at
     ``profile.gate_cfg`` (the bench shape on the card, its cut on the
     CPU), and holds heap against fixed-word to equality.  The census
     runs ``kernel_total`` nowhere here (a profiler count) and leaves its
     rounds' launches on the counters: the mega rounds' B2-B4.

    python -m hermes_tpu_torch.checks.heap [--device cpu] [--out FILE]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

from hermes_tpu_torch import checks

SEED = 17
#: Post-compaction utilization floor: live bytes over the allocated
#: prefix.  Compaction packs extents back to back, so the only slack is
#: granule rounding (< 16 bytes an extent).
UTIL_FLOOR = 0.75


def _cfg(**over):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    kw = dict(
        n_replicas=3, n_keys=64, n_sessions=8, replay_slots=8,
        ops_per_session=96, value_words=3, pipeline_depth=2,
        max_value_bytes=256, heap_bytes=1 << 13,
        workload=WorkloadConfig(read_frac=0.5, seed=SEED),
    )
    kw.update(over)
    return HermesConfig(**kw)


def _store(backend: str, device="cuda"):
    from hermes_tpu_torch.kvs import KVS

    if backend == "sharded":
        return KVS(_cfg(), backend="sharded", record="array", device=device)
    return KVS(_cfg(), record=True, device=device)


def _churn(store, backend: str) -> dict:
    """The soak's overwrite churn; returns the newest payload a key."""
    import numpy as np

    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload.ycsb import value_payload, value_sizes

    cfg = store.cfg
    rng = np.random.default_rng(SEED)
    latest = {}
    rounds, per = 24, 16
    lens = value_sizes(dict(n=rounds * per, max_bytes=cfg.max_value_bytes),
                       SEED)
    for r in range(rounds):
        keys = rng.permutation(cfg.n_keys)[:per].astype(np.int64)
        pays = [value_payload(SEED, r * per + j, int(lens[r * per + j]))
                for j in range(per)]
        bf = store.submit_batch(np.full(per, KVS.PUT, np.int32), keys, pays)
        assert store.run_batch(bf, max_steps=4000), (
            f"{backend}: churn round {r} did not drain")
        for k, p in zip(keys, pays):
            latest[int(k)] = p
        if r == rounds // 2:
            assert store.heap_gc(reason="gate-midload"), (
                f"{backend}: mid-load GC skipped on a drained store")
    return latest


def check_heap_soak(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch.checker import linearizability as lin

    for backend in ("batched", "sharded"):
        store = _store(backend, device)
        cfg = store.cfg
        latest = _churn(store, backend)
        pressure_gcs = store.heap.gc_runs
        assert pressure_gcs >= 2, (
            f"{backend}: churn against a {cfg.heap_bytes}-byte log ran "
            f"only {pressure_gcs} GC(s) — the pressure path never engaged")
        stats = store.heap_gc(reason="gate-final")
        assert stats, f"{backend}: final GC skipped"
        util = stats["live_bytes"] / stats["used_bytes"]
        assert util >= UTIL_FLOOR, (
            f"{backend}: post-compaction utilization {util:.3f} < "
            f"{UTIL_FLOOR} — compaction is leaking dead extents")
        assert stats["used_bytes"] <= cfg.heap_bytes, backend

        # byte-exactness: the client path AND the device log agree with
        # the mirror for every surviving key
        skeys = np.asarray(sorted(latest), np.int64)
        res = store.multi_get(skeys)
        assert res.all_done()
        for j, k in enumerate(skeys):
            assert res.data[j] == latest[int(k)], (
                f"{backend}: key {int(k)} bytes diverged after GC")
        refs = np.asarray(res.value)[:, 0].astype(np.int32)
        rows, dlens = store.heap.device_gather(refs)
        for j, k in enumerate(skeys):
            got = rows[j, : int(dlens[j])].tobytes()
            assert got == latest[int(k)], (
                f"{backend}: device log diverged from mirror at key "
                f"{int(k)}")
        v = store.rt.check()
        assert v.ok, (f"{backend} checker FAIL: "
                      f"{[f.reason[:160] for f in v.failures[:2]]}")
        stale = lin.stale_read(store.rt.history_ops())
        assert stale == [], f"{backend}: stale reads {stale[:2]}"
        report[f"{backend}_soak"] = dict(
            churn_ops=24 * 16, keys_live=int(skeys.size),
            gc_runs=int(store.heap.gc_runs),
            reclaimed_bytes=int(store.heap.gc_reclaimed_bytes),
            post_gc_util=round(util, 4), util_floor=UTIL_FLOOR,
            checker_ok=True, stale_read=0)


def _fleet_move(device="cuda"):
    """The two-group heap fleet after its move: (fleet, summary, payloads,
    the multi_get result)."""
    import numpy as np

    from hermes_tpu_torch.config import FleetConfig
    from hermes_tpu_torch.fleet import Fleet
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload.ycsb import value_payload, value_sizes

    base = _cfg(n_keys=48, n_sessions=4, replay_slots=4, heap_bytes=1 << 14)
    fleet = Fleet(FleetConfig(groups=2, base=base,
                              ranges=((0, 32), (32, 64))), record=True,
                  device=device)
    n = 40
    keys = np.arange(n, dtype=np.int64)
    lens = value_sizes(dict(n=n, max_bytes=base.max_value_bytes), SEED + 1)
    pays = [value_payload(SEED + 1, i, int(lens[i])) for i in range(n)]
    fb = fleet.submit_batch(np.full(n, KVS.PUT, np.int32), keys, pays)
    for _ in range(6000):
        if fb.all_done():
            break
        fleet.step()
    assert fb.all_done(), "fleet puts did not drain"
    summary = fleet.migrate(0, 8, 1)
    res = fleet.multi_get(keys)
    for _ in range(6000):
        if res.all_done():
            break
        fleet.step()
    assert res.all_done()
    return fleet, summary, pays, res


def check_fleet_migration(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.fleet import verify_fleet

    fleet, summary, pays, res = _fleet_move(device)
    assert summary.get("heap_extents", 0) == 8, (
        f"migration moved {summary.get('heap_extents')} extents, wanted 8")
    for i, p in enumerate(pays):
        assert res.data[i] == p, (
            f"fleet key {i} bytes diverged across the migration")
    verdicts = fleet.check()
    assert verdicts["ok"], f"fleet checker FAIL {verdicts}"
    verify_fleet(fleet)
    report["fleet_migration"] = dict(
        keys=len(pays), migrated_extents=int(summary["heap_extents"]),
        byte_exact=True, checker_ok=True)


def check_torn_snapshot(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch import snapshot
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload.ycsb import value_payload, value_sizes

    store = KVS(_cfg(), device=device)
    n = 32
    lens = value_sizes(dict(n=n, max_bytes=256), SEED + 2)
    pays = [value_payload(SEED + 2, i, int(lens[i])) for i in range(n)]
    bf = store.submit_batch(np.full(n, KVS.PUT, np.int32),
                            np.arange(n, dtype=np.int64), pays)
    assert store.run_batch(bf)
    with tempfile.TemporaryDirectory(prefix="hermes_heap_gate_") as d:
        p = os.path.join(d, "heap.npz")
        snapshot.save(p, store)
        tgt = KVS(_cfg(), device=device)
        snapshot.load(p, tgt)
        res = tgt.multi_get(np.arange(n, dtype=np.int64))
        assert res.all_done()
        for i in range(n):
            assert res.data[i] == pays[i], (
                f"key {i} bytes diverged across snapshot restore")
        def flip(name, data):
            if name.startswith("kvs.heap.log"):
                data = bytearray(data)
                data[len(data) // 2] ^= 0xFF
            return bytes(data)

        torn = os.path.join(d, "torn.npz")
        checks.rewrite_archive(p, torn, flip)
        try:
            snapshot.load(torn, KVS(_cfg(), device=device))
        except ValueError:
            pass
        else:
            raise AssertionError(
                "a bit-flipped heap log LOADED — the torn-snapshot "
                "checksum is not covering the value heap")
    report["torn_snapshot"] = dict(restore_byte_exact=True, torn_red=True)


ENGINES = ("batched", "sharded", "batched_mega", "sharded_mega")


def _census_cfgs(dev):
    """(fixed-word, heap-mode) configs of the census: ``profile.gate_cfg``
    (the bench shape on the card, its cut on the CPU) and its heap."""
    from hermes_tpu_torch.obs import profile as prof

    cfg = prof.gate_cfg(small=dev.type == "cpu")
    return cfg, prof.heap_cfg(cfg)


def censuses(device="cuda") -> dict:
    """engine -> (fixed-word census, heap-mode census) of one round, the
    rounds' launches left on the counters."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.obs import profile as prof

    dev = device_lib.resolve(device)
    cfg, heap_cfg = _census_cfgs(dev)
    pairs = {}
    for engine in ENGINES:
        backend, _, mega = engine.partition("_")
        word, heap = ((dataclasses.replace(c, mega_round=True) if mega
                       else c) for c in (cfg, heap_cfg))
        pairs[engine] = tuple(
            prof.op_census(c, backend, dev, count_kernels=False,
                           keep_launches=True) for c in (word, heap))
    return pairs


def check_census_unchanged(report: dict, device="cuda") -> None:
    """The round census must not know the heap exists."""
    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.heap import core as heap_lib
    from hermes_tpu_torch.obs import profile as prof

    dev = device_lib.resolve(device)
    pairs = censuses(dev)
    budget, _card = prof.load_budget()
    for engine, (word, heap) in pairs.items():
        assert word == heap, (
            f"{engine}: heap mode MOVED the round census — the protocol "
            f"is carrying value bytes (fixed-word {prof._slim(word)} vs "
            f"heap {prof._slim(heap)})")
        assert heap["sparse_total"] <= budget[engine]["sparse_total"], (
            f"{engine}: sparse_total {heap['sparse_total']} over budget")
    heap_cfg = _census_cfgs(dev)[1]
    gather = heap_lib.gather_census(heap_cfg, batch=1024, device=dev)
    append = heap_lib.append_census(heap_cfg, chunk=4096, device=dev)
    for name, cen in (("heap_path", gather), ("heap_append", append)):
        for k, ceiling in budget[name].items():
            assert cen[k] <= ceiling, (
                f"{name}.{k}: {cen[k]} exceeds the budget ceiling "
                f"{ceiling}")
    findings = heap_lib.analyze_gather(heap_cfg, batch=1024, device=dev)
    assert findings == [], (
        f"extent gather analyzer findings: {[str(f) for f in findings[:3]]}")
    report["census_unchanged"] = dict(
        engines={e: p[0]["sparse_total"] for e, p in pairs.items()},
        aten={e: p[0]["aten_total"] for e, p in pairs.items()},
        heap_path_sparse=gather["sparse_total"],
        heap_append_sparse=append["sparse_total"],
        analyzer_findings=0)


LEGS = (check_census_unchanged, check_torn_snapshot, check_heap_soak,
        check_fleet_migration)


def main(argv=None) -> int:
    return checks.run_legs("heap", LEGS, argv, "heap", __doc__)


if __name__ == "__main__":
    sys.exit(main())
