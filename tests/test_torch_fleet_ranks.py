"""A sharded fleet over several ranks (``launch.run_fleet`` with
``world_size`` > 1: one gloo subgroup a fleet group, a ``DistGroup``
runtime a served group) against the one-process fleet
(``run_fleet(..., device="cpu")``, every group on a ``LocalGroup``),
whose counters ``tests/test_torch_fleet.py::
test_torch_run_fleet_equals_reference_counters`` holds to the JAX
package's ``run_fleet``.

Two fleet groups of four replicas over four ranks: each group spans two
ranks, two replicas a rank.  Every rank's local copies, sessions, replay
slots and Meta after the run equal the matching rows of the one-process
group, and its group's counters the one-process group's; the groups a
rank built are ``group_of_rank``'s.  The CLI drives three groups of two
replicas over two ranks (a rank straddling two groups serves both) and
prints one line a served group, counters equal to the one-process CLI's.
A layout that splits a group unevenly over its ranks is refused.
Tolerance: exact.  The processes meet through a ``file://`` rendezvous
in the test's temporary directory and are given 120 s.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hermes_tpu_torch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 12

WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from hermes_tpu_torch import convert, launch
    from hermes_tpu_torch.config import (FleetConfig, HermesConfig,
                                         WorkloadConfig)

    FCFG = FleetConfig(groups=2, base=HermesConfig(
        n_replicas=4, n_keys=64, n_sessions=8, ops_per_session=32,
        replay_slots=4, replay_scan_every=4, wrap_stream=True,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=29)))

    def dump(rts, path):
        arrays = {"groups": np.array([rt.fleet_group for rt in rts])}
        for rt in rts:
            g = rt.fleet_group
            fs = convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies)
            for part in ("table", "sess", "replay", "meta"):
                for f in getattr(fs, part)._fields:
                    arrays[f"g{g}.{part}.{f}"] = np.asarray(
                        getattr(getattr(fs, part), f))
            c = rt.counters()
            arrays[f"g{g}.counters"] = np.array([int(c[k]) for k in (
                "n_read", "n_write", "n_rmw", "n_abort")])
            arrays[f"g{g}.copies"] = np.array([rt.n_copies, rt.step_idx])
        np.savez(path, **arrays)

    if __name__ == "__main__":
        init, world, rank, steps, out = (sys.argv[1], int(sys.argv[2]),
                                         int(sys.argv[3]), int(sys.argv[4]),
                                         sys.argv[5])
        rts = launch.run_fleet(FCFG, steps, init, world, rank,
                               device="cpu")
        dump(rts, out)
        import torch.distributed as dist
        dist.destroy_process_group()
''')


def _run_ranks(argvs, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, env=env, cwd=cwd,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out + err)[-3000:]
    return [out for out, _ in outs]


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_ranks")
    script = tmp / "fleet_worker.py"
    script.write_text(WORKER)
    sys.path.insert(0, str(tmp))
    try:
        import fleet_worker
    finally:
        sys.path.remove(str(tmp))
    return tmp, script, fleet_worker


def test_torch_fleet_over_ranks_equals_the_one_process_fleet(worker):
    tmp, script, fw = worker
    init = f"file://{tmp / 'rendezvous'}"
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    _run_ranks([[sys.executable, str(script), init, str(WORLD), str(r),
                 str(STEPS), str(outs[r])] for r in range(WORLD)], str(tmp))
    torch.set_num_threads(1)
    fw.dump(launch.run_fleet(fw.FCFG, STEPS, device="cpu"),
            str(tmp / "local.npz"))
    local = _load(tmp / "local.npz")
    R, K = fw.FCFG.base.n_replicas, fw.FCFG.base.n_keys
    layout = launch.fleet_rank_layout(fw.FCFG.groups, R, WORLD)
    assert layout == [[0, 1], [2, 3]]
    assert local["groups"].tolist() == [0, 1]
    wrote = 0
    for r in range(WORLD):
        got = _load(outs[r])
        served = got["groups"].tolist()
        assert served == launch.group_of_rank(fw.FCFG.groups, R, WORLD, r)
        for g in served:
            i = layout[g].index(r)  # this rank's place in its group
            n = R // len(layout[g])
            assert got[f"g{g}.copies"].tolist() == [n, STEPS]
            np.testing.assert_array_equal(got[f"g{g}.counters"],
                                          local[f"g{g}.counters"])
            for name, want in local.items():
                if not name.startswith(f"g{g}.") or name.endswith(
                        (".counters", ".copies")):
                    continue
                rows = (slice(i * n * K, (i + 1) * n * K)
                        if name.startswith(f"g{g}.table.")
                        else slice(i * n, (i + 1) * n))
                np.testing.assert_array_equal(got[name], want[rows],
                                              err_msg=f"rank {r} {name}")
        wrote += int(sum(got[f"g{g}.counters"][1] for g in served))
    assert wrote > 0, "the fleet committed no write"


def test_torch_fleet_over_ranks_cli_prints_a_line_a_served_group(
        tmp_path, capsys):
    flags = ["--fleet-groups", "3", "--replicas", "2", "--keys", "64",
             "--sessions", "8", "--steps", "8", "--device", "cpu"]
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = _run_ranks([[sys.executable, "-m", "hermes_tpu_torch.launch",
                        *flags, "--world-size", "2", "--rank", str(r),
                        "--init", init] for r in range(2)], REPO)
    lines = [[json.loads(x) for x in out.splitlines() if x.startswith("{")]
             for out in outs]
    # rank 0 holds replicas 0-2: group 0 and half of group 1
    assert [[d["group"] for d in ls] for ls in lines] == [[0, 1], [1, 2]]
    for r, ls in enumerate(lines):
        for d in ls:
            assert d["rank"] == r and d["world_size"] == 2
            assert d["ranks"] == launch.fleet_rank_layout(3, 2, 2)[
                d["group"]]
            assert d["local_copies"] == 2 // len(d["ranks"])
    assert launch.main(flags) == 0
    want = {d["group"]: d for d in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    keys = ("rounds", "n_read", "n_write", "n_rmw", "n_abort")
    for ls in lines:
        for d in ls:
            assert {k: d[k] for k in keys} == \
                {k: want[d["group"]][k] for k in keys}, d


@pytest.mark.parametrize("groups,replicas,world", [(4, 3, 6), (2, 3, 4)])
def test_torch_fleet_over_ranks_refuses_an_uneven_layout(groups, replicas,
                                                         world):
    """4 groups of 3 over 6 ranks put 2 + 1 replicas of group 0 on ranks
    0 and 1; 2 groups of 3 over 4 ranks leave 6 replicas unsplittable."""
    from hermes_tpu_torch.config import FleetConfig, HermesConfig

    fcfg = FleetConfig(groups=groups, base=HermesConfig(
        n_replicas=replicas, n_keys=64, n_sessions=4))
    with pytest.raises(ValueError, match="equal share|do not split"):
        launch.run_fleet(fcfg, 1, "file:///nonexistent", world, 0,
                         device="cpu")
    with pytest.raises(ValueError, match="equal share|do not split"):
        launch.main(["--fleet-groups", str(groups), "--replicas",
                     str(replicas), "--world-size", str(world), "--rank",
                     "0", "--init", "file:///nonexistent", "--device",
                     "cpu"])
