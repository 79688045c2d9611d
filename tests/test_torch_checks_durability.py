"""The port's durability gate (hermes_tpu_torch/checks/durability.py and
its child, checks/durability_soak.py) against the JAX package's
(scripts/check_durability.py, scripts/_durability_soak.py).

The gate runs green on the CPU.  Its kill legs' deterministic fields
equal the reference's at the same seed (the witnessed commits, the keys
served, the post-recovery commits, nothing lost); the port's child and
the reference's, each killed by its own powercut, witness the same
(wave, key) commits; and the two recovered stores serve the seed's
value, so the same value, for every key the killed wave never wrote and
no wave wrote twice (which put of a wave lands first, and its uid,
follow the flusher's clock).  The reference's child and its recovered
store run with their rounds settled (ROADMAP C).  The drive loop is the
reference's: in process, four waves commit the same uids.  Red: a witnessed commit that is missing from the log, and a child
that exits without its powercut, turn the gate red."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from hermes_tpu_torch.checks import durability as gate
from hermes_tpu_torch.checks import durability_soak as soak
from torch_gatepair import (ROOT, drop, run_port_gate,  # noqa: F401
                            settled_reference, temp_in_tmp_path)

torch.set_num_threads(1)


def test_torch_durability_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu"
    for backend in ("batched", "sharded"):
        k = rep[f"kill_{backend}"]
        assert k["committed_write_lost"] == [] and k["keys_served"] == 16
        assert k["post_recovery_commits"] > 0
    assert rep["wal_overhead"]["wal_on"]["fsyncs"] > 0


#: runs the reference's soak child with its rounds settled: each
#: dispatched round completes before host code goes on, as
#: ``torch_gatepair.settled_reference`` settles an in-process reference
#: (ROADMAP C: at depth 2 a host rewrite after a dispatch can leak into
#: the dispatched round, so what the child logs would follow the load)
SETTLED_CHILD = """
import runpy, sys
import jax
from hermes_tpu import runtime
dispatch = runtime.FastRuntime.dispatch_round
def settled(self, *args, **kwargs):
    comp = dispatch(self, *args, **kwargs)
    jax.block_until_ready((comp, self.fs))
    return comp
runtime.FastRuntime.dispatch_round = settled
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _ref_child(d, backend):
    wal_dir, commits = os.path.join(d, "wal"), os.path.join(d, "commits")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run(
        [sys.executable, "-c", SETTLED_CHILD,
         str(ROOT / "scripts" / "_durability_soak.py"), wal_dir, backend,
         commits, str(gate.KILL_WAVE)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    return wal_dir, gate._read_commits(commits)


def _seed_payloads(waves):
    """Each wave's keys and payload words as ``soak.run_waves`` draws
    them from the seed: (keys (n,), payload (n, PAYLOAD_WORDS))."""
    rng = np.random.default_rng(soak.SEED)
    n = 2 * soak.N_REPLICAS * soak.soak_cfg(None).n_sessions
    out = []
    for wave in range(waves):
        keys = rng.integers(0, 128, n)
        vals = np.empty((n, soak.PAYLOAD_WORDS), np.int32)
        vals[:, 0] = wave
        vals[:, 1] = np.arange(n)
        vals[:, 2:] = rng.integers(0, 1 << 20, (n, soak.PAYLOAD_WORDS - 2))
        out.append((keys, vals))
    return out


def _seed_values(keys, waves):
    """The payload the seed decides for each of ``keys`` (none written
    twice in one wave, none written by the killed wave): its put of the
    last of ``waves`` waves that wrote it, zeros if none did."""
    want = np.zeros((len(keys), soak.PAYLOAD_WORDS), np.int32)
    for wkeys, vals in _seed_payloads(waves):
        for i, k in enumerate(keys):
            hit = np.nonzero(wkeys == k)[0]
            if hit.size:
                want[i] = vals[hit[-1]]
    return want


def _wave4_keys(records) -> set:
    """Keys of any logged write of the killed wave (payload word 0)."""
    return {int(r["key"][i]) for r in records
            for i in range(int(r["key"].shape[0]))
            if int(r["wv"][i, 2]) == gate.KILL_WAVE}


def test_torch_durability_witness_and_recovery_equal_the_reference(
        tmp_path, settled_reference):
    from hermes_tpu.chaos.recovery import recover_store as ref_recover
    from hermes_tpu.wal import replay as ref_replay
    from hermes_tpu_torch.chaos.recovery import recover_store
    from hermes_tpu_torch.wal import replay

    ref = __import__("torch_gatepair").load_script("_durability_soak")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_wal, ref_commits = _ref_child(str(tmp_path / "ref"), "batched")
    wal, commits = gate.run_child(str(tmp_path / "port"), "batched", "cpu")
    # which session a put lands on, so its uid and ts, follows the
    # group-commit flusher's clock under wal_sync=commit: the witnessed
    # (wave, key) pairs are the seed's, the uids are not compared
    fields = ("wave", "key", "durability")
    assert (sorted(tuple(c[k] for k in fields) for c in commits)
            == sorted(tuple(c[k] for k in fields) for c in ref_commits))
    assert len(commits) == 4 * 2 * soak.N_REPLICAS * 8

    ref_records = ref_replay.read_records(ref_wal)["records"]
    records = replay.read_records(wal)["records"]
    # two puts of one key in one wave race (the same clock picks the
    # winner); a later wave's put wins for certain
    pairs = [(c["wave"], c["key"]) for c in commits]
    raced = {k for w, k in pairs if pairs.count((w, k)) > 1}
    keys = sorted(set(range(128)) - _wave4_keys(ref_records)
                  - _wave4_keys(records) - raced)
    ref_kvs, _ = ref_recover(ref.soak_cfg(ref_wal))
    kvs, _ = recover_store(soak.soak_cfg(wal), device="cpu")
    got, want = kvs.multi_get(keys), ref_kvs.multi_get(keys)
    assert got.all_done() and want.all_done()
    # each store's values are the seed's, then the two equal
    seed = _seed_values(keys, gate.KILL_WAVE)
    np.testing.assert_array_equal(np.asarray(want.value), seed,
                                  err_msg="the reference's recovered store")
    np.testing.assert_array_equal(got.value, seed,
                                  err_msg="the port's recovered store")
    np.testing.assert_array_equal(got.value, np.asarray(want.value))
    assert len(keys) > 16
    kvs.wal.close()
    ref_kvs.wal.close()


def test_torch_durability_kill_report_equals_the_reference(
        temp_in_tmp_path):
    timing = ("recovery_s", "log_records", "applied", "torn_tail")
    ref = __import__("torch_gatepair").load_script("check_durability")
    want, got = {}, {}
    ref.check_kill(want, "sharded")
    gate.check_kill(got, "sharded", device="cpu")
    assert drop(got["kill_sharded"], *timing) == drop(
        want["kill_sharded"], *timing)


def test_torch_durability_drive_loop_equals_the_reference():
    from hermes_tpu.kvs import KVS as RefKVS

    ref = __import__("torch_gatepair").load_script("_durability_soak")
    out = []
    for store in (RefKVS(ref.soak_cfg(None)),
                  soak.build_kvs(None, "batched", device="cpu")):
        seen = []
        n = soak.run_waves(store, 4, on_commit=lambda c, w: seen.append(
            (tuple(c.uid), c.key, tuple(c.ts), w)))
        out.append((n, seen))
    assert out[0] == out[1] and out[1][0] == 192


def test_torch_durability_red_on_a_witnessed_commit_missing_from_the_log(
        tmp_path, monkeypatch):
    from hermes_tpu_torch.wal import crashdrive

    log_ops = crashdrive.log_ops

    def missing(records):
        return log_ops(records)[1:]  # the log lost a committed write

    monkeypatch.setattr(crashdrive, "log_ops", missing)
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 1 and "committed write(s) LOST" in rep["error"]


def test_torch_durability_red_when_the_child_is_not_killed(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(gate, "KILL_WAVE", -1)  # no powercut: a clean exit
    with pytest.raises(AssertionError, match="exited 0, want -SIGKILL"):
        gate.check_kill({}, "batched", device="cpu")


def test_torch_durability_child_names_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch.checks.durability_soak",
         str(tmp_path / "wal"), "batched", str(tmp_path / "c"), "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "asks for the card" in p.stderr
    assert not (tmp_path / "c").exists()
