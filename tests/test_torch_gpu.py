"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Each test skips on a machine without the card.  This file imports only
torch and the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
The tolerance is exact equality: every output is an integer and the
kernel's atomics are integer adds, so their order cannot change a bit.
"""

import pytest
import torch

from hermes_tpu_torch.core import kernels


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("R,S", [(4, 512), (1024, 600), (512, 2000),
                                 (8, 65536), (2, 40000)])
def test_stats_block_cuda_matches_plain(R, S):
    dev = _card()
    g = torch.Generator().manual_seed(R * 7919 + S)
    op = torch.randint(0, 4, (R, S), generator=g, dtype=torch.int32)
    invoke = torch.randint(0, 90, (R, S), generator=g, dtype=torch.int32)
    commit = torch.rand((R, S), generator=g) < 0.3
    abort = (torch.rand((R, S), generator=g) < 0.05) & ~commit
    read = (torch.rand((R, S), generator=g) < 0.3) & ~commit & ~abort
    step = torch.tensor(77, dtype=torch.int32)
    args = (step, op, invoke, commit, abort, read)
    want = kernels.stats_block_plain(*args)
    before = kernels.stats_block.launches
    got = kernels.stats_block(*(a.to(dev) for a in args))
    torch.cuda.synchronize(dev)
    assert kernels.stats_block.launches == before + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())


@pytest.mark.gpu
def test_stats_block_cuda_rejects_strided_input():
    dev = _card()
    op = torch.zeros((4, 64), dtype=torch.int32, device=dev)[:, ::2]
    z = torch.zeros((4, 32), dtype=torch.bool, device=dev)
    inv = torch.zeros((4, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.stats_block(torch.tensor(1, dtype=torch.int32, device=dev),
                            op, inv, z, z, z)


def _tree_np(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_np(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_tree_np(x) for x in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _assert_equal_trees(a, b, path):
    import numpy as np

    if hasattr(a, "_fields") or isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}[{i}]")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.gpu
@pytest.mark.parametrize("arb_mode", ["race", "sort"])
def test_round_on_card_matches_cpu(arb_mode):
    """The whole round on the card (sorts, scatters, the kernel) is
    bit-identical to the round on the CPU, which the CPU suite holds
    against the JAX reference — through a freeze and a removal, with the
    replay scan firing."""
    from hermes_tpu_torch import convert
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.workload import ycsb

    dev = _card()
    cfg = HermesConfig(
        n_replicas=4, n_keys=256, n_sessions=32, replay_slots=8,
        ops_per_session=16, arb_mode=arb_mode,
        chain_writes=4 if arb_mode == "sort" else 0, wrap_stream=True,
        device_stream=True, lane_budget_cfg=24, read_unroll=2, replay_age=2,
        replay_scan_every=2, workload=WorkloadConfig(read_frac=0.4,
                                                     rmw_frac=0.3, seed=3))
    states = {d: fst.init_fast_state(cfg, d) for d in ("cpu", dev)}
    streams = {d: fst.prep_stream(ycsb.stub_stream(cfg), d) for d in states}
    for s in range(40):
        outs = {}
        for d in states:
            ctl = fst.make_fast_ctl(cfg, s, d)
            if 10 <= s:
                ctl = ctl._replace(frozen=torch.tensor([0, 0, 0, 1], dtype=torch.bool, device=d))
            if 20 <= s:
                ctl = ctl._replace(
                    live_mask=torch.full((4,), 0b0111, dtype=torch.int32, device=d),
                    epoch=torch.ones(4, dtype=torch.int32, device=d))
            states[d], comp = fst.fast_round_batched(cfg, ctl, states[d], streams[d])
            outs[d] = (convert.fast_state_to_numpy(states[d]), _tree_np(comp))
        _assert_equal_trees(outs["cpu"], outs[dev], f"round {s}")


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_runtime_and_kvs_on_card_match_cpu(depth):
    """FastRuntime and KVS on the card (depth 2 harvests through the
    pinned asynchronous copy) give the CPU run's completions, Meta and a
    green checker."""
    import numpy as np

    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.runtime import FastRuntime

    dev = _card()
    cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=8, replay_slots=4,
                       ops_per_session=24, value_words=4, arb_mode="sort",
                       chain_writes=3, pipeline_depth=depth,
                       workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.3,
                                               seed=17))
    runs = {d: FastRuntime(cfg, record=True, device=d) for d in ("cpu", dev)}
    for s in range(30):
        outs = {d: _tree_np(rt.step_once()) for d, rt in runs.items()}
        if outs["cpu"] is None:
            assert outs[dev] is None
        else:
            _assert_equal_trees(outs["cpu"], outs[dev], f"step {s}")
    for rt in runs.values():
        assert rt.drain(400)
    _assert_equal_trees(_tree_np(runs["cpu"].fs.meta),
                        _tree_np(runs[dev].fs.meta), "meta")
    assert runs[dev].check().ok

    res = {}
    for d in ("cpu", dev):
        kvs = KVS(cfg, record=True, device=d)
        rng = np.random.default_rng(8)
        kinds = rng.choice([KVS.GET, KVS.PUT, KVS.RMW], 64)
        bf = kvs.submit_batch(kinds, rng.integers(0, 16, 64),
                              rng.integers(0, 1000, (64, 2)))
        assert kvs.run_batch(bf, 300)
        assert kvs.rt.check().ok
        res[d] = (bf.code, bf.value, bf.uid, bf.step)
    _assert_equal_trees(res["cpu"], res[dev], "kvs")
