"""The sharded engine over a ``DistGroup`` (torch.distributed, gloo, two
processes of four replicas each) against the same drive on a
``LocalGroup`` (one process, eight replicas), which
tests/test_torch_sharded.py holds bit for bit against the JAX sharded
engine.

The drive exercises every collective of the group: the INV/VAL
all-gather and the ACK all-to-all every round (W=2, R_local=4, so the
route-back's transposes around the rank axis matter), a freeze window
that parts the copies, a join whose donor copy lives on the other rank
(the broadcast of ``fetch_row``), the rebase's sum / max / min
reductions and the counters' gather.  Each rank's rows of the final state
(every table copy, sessions, replay slots, Meta) must equal the local
run's rows.  Tolerance: exact.  The two processes meet through a
``file://`` rendezvous in the test's temporary directory and are given
90 s.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from hermes_tpu_torch import convert, launch
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.runtime import FastRuntime

    CFG = HermesConfig(n_replicas=8, n_keys=32, n_sessions=6,
                       replay_slots=4, ops_per_session=12, arb_mode="sort",
                       chain_writes=2, replay_age=2, replay_scan_every=2,
                       workload=WorkloadConfig(read_frac=0.3, rmw_frac=0.2,
                                               seed=53))

    def drive(rt):
        """Rounds with a freeze window, a remove and a cross-rank join,
        then a drain and a rebase; returns the copies-differed flag."""
        differed = False
        for s in range(24):
            if s == 3:
                rt.freeze(5)
            if s == 9:
                rt.remove(5)
            if s == 14:
                rt.join(5, 1)
            rt.step_once()
            b = rt.fs.table.bank.view(rt.n_copies, CFG.n_keys + 1, -1)
            differed |= not bool((b == b[0]).all())
        for _ in range(200):
            if rt._inflight_count() == 0:
                break
            rt.step_once()
        rt.rebase_versions(max_quiesce_rounds=64)
        for _ in range(6):
            rt.step_once()
        return differed

    def dump(rt, path, differed):
        fs = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
        arrays = {f"{part}.{f}": np.asarray(getattr(getattr(fs, part), f))
                  for part in ("table", "sess", "replay", "meta")
                  for f in getattr(fs, part)._fields}
        c = rt.counters()
        arrays["counters"] = np.array([int(c[k]) for k in (
            "n_read", "n_write", "n_rmw", "n_abort")])
        arrays["differed"] = np.array(differed)
        arrays["ver_base"] = (np.zeros(0) if rt._ver_base is None
                              else rt._ver_base)
        np.savez(path, **arrays)

    if __name__ == "__main__":
        init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
        launch.init_distributed(init, 2, rank, device="cpu")
        rt = FastRuntime(CFG, backend="sharded",
                         group=launch.make_group(2, rank, device="cpu"))
        assert rt.n_copies == 4
        differed = drive(rt)
        dump(rt, out, differed)
        import torch.distributed as dist
        dist.destroy_process_group()
''')


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_torch_dist_group_gloo_equals_local_group(tmp_path):
    script = tmp_path / "dist_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), init, str(r), str(outs[r])],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    sys.path.insert(0, str(tmp_path))
    try:
        import dist_worker
    finally:
        sys.path.remove(str(tmp_path))
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.runtime import FastRuntime

    torch.set_num_threads(1)
    rt = FastRuntime(dist_worker.CFG, backend="sharded",
                     group=LocalGroup("cpu"))
    local_differed = dist_worker.drive(rt)
    dist_worker.dump(rt, str(tmp_path / "local.npz"), local_differed)
    local = _load(tmp_path / "local.npz")
    ranks = [_load(o) for o in outs]
    assert bool(local["differed"]), "the copies never differed"
    assert local["ver_base"].size and local["ver_base"].any(), \
        "the rebase reclaimed nothing"
    K = dist_worker.CFG.n_keys
    for r, got in enumerate(ranks):
        assert bool(got["differed"]) or r == 0  # rank 1 holds replica 5
        np.testing.assert_array_equal(got["counters"], local["counters"])
        np.testing.assert_array_equal(got["ver_base"], local["ver_base"])
        for name, want in local.items():
            if name in ("counters", "differed", "ver_base"):
                continue
            rows = (slice(r * 4 * K, (r + 1) * 4 * K)
                    if name.startswith("table.") else slice(r * 4, r * 4 + 4))
            np.testing.assert_array_equal(got[name], want[rows],
                                          err_msg=f"rank {r} {name}")


def _fake_nccl_pair(monkeypatch, cards):
    """A two-rank NCCL group as rank 0 sees it, without a card: the ranks'
    card ids are ``cards`` (what ``card_id`` would give on each host)."""
    import torch.distributed as dist

    from hermes_tpu_torch.core import group

    def gather(out, obj, group=None):
        assert obj == cards[0]
        out[:] = cards

    for name, fn in (("is_initialized", lambda: True),
                     ("get_world_size", lambda pg=None: 2),
                     ("get_rank", lambda pg=None: 0),
                     ("get_backend", lambda pg=None: "nccl"),
                     ("new_group", lambda **kw: None),
                     ("all_gather_object", gather)):
        monkeypatch.setattr(dist, name, fn)
    monkeypatch.setattr(group.device_lib, "resolve",
                        lambda d: torch.device(d))
    monkeypatch.setattr(group, "card_id", lambda d: cards[0])
    return group


def test_dist_group_accepts_card_0_on_each_of_two_hosts(monkeypatch):
    """One card a rank on separate hosts: both ranks hold their host's
    card 0, which the group tells apart by card id and accepts; the same
    card twice is refused."""
    group = _fake_nccl_pair(monkeypatch, ["hostA:0", "hostB:0"])
    g = group.DistGroup(None, "cuda:0")
    assert (g.world, g.rank, g.n_local(8)) == (2, 0, 4)
    group = _fake_nccl_pair(monkeypatch, ["hostA:0", "hostA:0"])
    with pytest.raises(ValueError, match="distinct device"):
        group.DistGroup(None, "cuda:0")


@pytest.mark.parametrize("local_rank,count,rank,want", [
    ("1", 4, 5, 1),     # the launcher's LOCAL_RANK wins
    (None, 1, 1, 0),    # one card a host: every rank takes card 0
    (None, 4, 6, 2),    # four cards a host
])
def test_make_group_takes_this_hosts_card(monkeypatch, local_rank, count,
                                          rank, want):
    """On CUDA ``make_group`` gives rank r the card of its own host
    (``LOCAL_RANK``, else r modulo the host's cards), so a host with one
    card serves any rank of a multi-host group."""
    from hermes_tpu_torch import launch

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    seen = []
    monkeypatch.setattr(launch, "DistGroup",
                        lambda pg, dev: seen.append(dev) or dev)
    assert launch.make_group(8, rank, device="cuda") == torch.device(
        "cuda", want)
    assert seen == [torch.device("cuda", want)]
