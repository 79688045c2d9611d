"""The port's sparse-key index (hermes_tpu_torch/keyindex.py) against the
reference's (hermes_tpu/keyindex.py): the same insert sequences give the
same slots, the same bucket arrays and the same reverse map (exact
equality), ``KeyspaceFull`` comes at the same insert and a bulk batch is
refused whole; and the port's KVS in sparse-key mode gives the reference's
completions, client keys above 2^63 echoed exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from hermes_tpu import keyindex as ref_ki
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.kvs import KVS as RefKVS
from hermes_tpu_torch import keyindex as ki
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.kvs import KVS

torch.set_num_threads(1)


def _same_index(a, b):
    assert a.n_used == b.n_used
    np.testing.assert_array_equal(a._bucket_key, b._bucket_key)
    np.testing.assert_array_equal(a._bucket_slot, b._bucket_slot)
    np.testing.assert_array_equal(a._rev, b._rev)


def test_torch_splitmix64_equals_reference():
    x = np.random.default_rng(1).integers(0, 2**64 - 1, 4096,
                                          dtype=np.uint64)
    np.testing.assert_array_equal(ki._splitmix64(x), ref_ki._splitmix64(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_keyindex_random_64bit_slots_equal_reference(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64 - 1, size=700, dtype=np.uint64)
    keys[:5] = [2**64 - 2, 2**63, 2**63 + 1, 0, 1]  # the edges, unsigned
    a, b = ki.KeyIndex(512), ref_ki.KeyIndex(512)
    for lo in range(0, 400, 37):  # chunks with repeats across chunks
        chunk = keys[lo:lo + 53]
        np.testing.assert_array_equal(a.get_slots(chunk), b.get_slots(chunk))
    probe = keys[300:700]
    np.testing.assert_array_equal(a.get_slots(probe, insert=False),
                                  b.get_slots(probe, insert=False))
    _same_index(a, b)
    for s in range(a.n_used):
        assert a.key_of(s) == b.key_of(s)


def test_torch_keyindex_forced_collisions_equal_reference():
    a, b = ki.KeyIndex(64), ref_ki.KeyIndex(64)
    mask = np.uint64(a._cap - 1)
    target = ki._splitmix64(np.uint64(1)) & mask
    colliders, k = [1], 2
    while len(colliders) < 9:
        if (ki._splitmix64(np.uint64(k)) & mask) == target:
            colliders.append(k)
        k += 1
    # half one at a time, half in one bulk batch with duplicates
    got = [a.slot(c) for c in colliders[:4]]
    want = [b.slot(c) for c in colliders[:4]]
    bulk = np.asarray(colliders[4:] + colliders[2:6], np.uint64)
    got += a.get_slots(bulk).tolist()
    want += b.get_slots(bulk).tolist()
    assert got == want
    _same_index(a, b)
    assert a.slot(999_999_999_999, insert=False) == -1
    assert all(c in a for c in colliders)


def test_torch_keyindex_bulk_duplicates_equal_reference():
    a, b = ki.KeyIndex(16), ref_ki.KeyIndex(16)
    assert a.slot(100) == b.slot(100) == 0
    batch = np.array([200, 100, 300, 200, 300, 400, 2**64 - 2], np.uint64)
    np.testing.assert_array_equal(a.get_slots(batch), b.get_slots(batch))
    assert a.get_slots(batch).tolist() == [1, 0, 2, 1, 2, 3, 4]
    _same_index(a, b)
    with pytest.raises(ValueError, match="reserved"):
        a.get_slots(np.array([2**64 - 1], np.uint64))


def test_torch_keyindex_keyspace_full_at_the_same_insert():
    """One at a time: both raise at the ninth distinct key of eight."""
    a, b = ki.KeyIndex(8), ref_ki.KeyIndex(8)
    for k in range(8):
        assert a.slot(k * 10**15 + 7) == b.slot(k * 10**15 + 7)
    with pytest.raises(ki.KeyspaceFull):
        a.slot(5000)
    with pytest.raises(ref_ki.KeyspaceFull):
        b.slot(5000)
    assert a.slot(7, insert=False) == b.slot(7, insert=False) == 0
    _same_index(a, b)


def test_torch_keyindex_bulk_keyspace_full_is_atomic():
    a, b = ki.KeyIndex(8), ref_ki.KeyIndex(8)
    for idx in (a, b):
        idx.get_slots(np.arange(1, 7, dtype=np.uint64))
    for idx, exc in ((a, ki.KeyspaceFull), (b, ref_ki.KeyspaceFull)):
        with pytest.raises(exc):
            idx.get_slots(np.array([100, 200, 300], np.uint64))
    _same_index(a, b)
    assert a.n_used == 6 and a.slot(100, insert=False) == -1
    batch = np.array([100, 200], np.uint64)
    assert a.get_slots(batch).tolist() == b.get_slots(batch).tolist() == [6, 7]


def test_torch_keyindex_fuzz_equals_reference():
    rng = np.random.default_rng(7)
    a, b = ki.KeyIndex(128), ref_ki.KeyIndex(128)
    universe = rng.integers(0, 2**64 - 1, size=400, dtype=np.uint64)
    for _ in range(1500):
        k = int(universe[rng.integers(0, len(universe))])
        ins = bool(rng.random() < 0.5 and a.n_used < 128)
        assert a.slot(k, insert=ins) == b.slot(k, insert=ins)
    _same_index(a, b)


def _sparse_cfgs(**over):
    rc = RefConfig(n_replicas=3, n_keys=64, n_sessions=4, value_words=6,
                   replay_slots=8, workload=RefWL(seed=21), **over)
    return rc, HermesConfig(**dataclasses.asdict(rc))


def _sparse_drive(kvs):
    """Puts and gets on huge keys, an RMW, a batch with absent gets and
    duplicates: the completions as plain tuples."""
    k1, k2, k3 = 0xDEADBEEF_CAFEBABE, (1 << 62) + 12345, 2**64 - 2
    futs = [kvs.put(0, 0, k1, [7, 8, 9]), kvs.put(1, 0, k2, [11]),
            kvs.put(2, 3, k3, [5, 5])]
    assert kvs.run_until(futs)
    futs += [kvs.get(2, 1, k1), kvs.get(0, 2, k2), kvs.get(1, 1, k3),
             kvs.get(0, 3, 2**63 + 5)]  # absent: found False at once
    futs.append(kvs.rmw(1, 3, k1, [42]))
    assert kvs.run_until(futs)
    kinds = np.array([KVS.PUT, KVS.GET, KVS.PUT, KVS.GET, KVS.GET, KVS.PUT],
                     np.int32)
    keys = np.array([2**63 + 9, k1, 2**63 + 9, 2**64 - 3, k3, 17], np.uint64)
    bf = kvs.submit_batch(kinds, keys,
                          np.arange(12, dtype=np.int32).reshape(6, 2))
    assert kvs.run_batch(bf)
    comps = [f.result() for f in futs] + [bf.completion(i)
                                          for i in range(len(bf))]
    return ([(c.kind, c.key, c.value, c.uid, c.step, c.found, c.ts)
             for c in comps], bf, kvs.index)


def test_torch_kvs_sparse_keys_drive_identical_to_reference():
    rc, cfg = _sparse_cfgs()
    want, wbf, wix = _sparse_drive(RefKVS(rc, record=True, sparse_keys=True))
    kvs = KVS(cfg, record=True, sparse_keys=True, device="cpu")
    got, gbf, gix = _sparse_drive(kvs)
    assert got == want
    assert got[6][:3] == ("get", 2**63 + 5, None) and not got[6][5]
    assert gbf.key.dtype == wbf.key.dtype == np.uint64
    np.testing.assert_array_equal(gbf.key, wbf.key)
    assert int(gbf.key[3]) == 2**64 - 3
    for col in ("code", "value", "uid", "found", "step", "tsv", "tsf"):
        np.testing.assert_array_equal(getattr(gbf, col), getattr(wbf, col),
                                      err_msg=col)
    _same_index(gix, wix)
    assert kvs.rt.check().ok


def test_torch_kvs_sparse_keyspace_full_propagates_as_reference():
    rc, cfg = _sparse_cfgs()
    rc, cfg = (dataclasses.replace(rc, n_keys=4),
               dataclasses.replace(cfg, n_keys=4))
    for kvs, exc in ((KVS(cfg, sparse_keys=True, device="cpu"),
                      ki.KeyspaceFull),
                     (RefKVS(rc, sparse_keys=True), ref_ki.KeyspaceFull)):
        for i in range(4):
            kvs.put(0, 0, (i + 1) * 10**15, [i])
        with pytest.raises(exc):
            kvs.put(0, 1, 999 * 10**15, [9])
        # read probes of absent keys claim nothing
        assert not kvs.get(1, 1, 2**63).result().found
        assert len(kvs.index) == 4
