"""The port's BASELINE acceptance scenarios (hermes_tpu_torch/acceptance.py)
against the reference's (hermes_tpu/acceptance.py).

Each scenario runs end to end in both packages from the same config at
scale 0.01 (the reference on JAX's CPU, the port on torch's): the
counters (reads, writes, RMWs, aborts, drained, and config 4's
stall detection) and the checker's verdict and keys checked must be
equal, at pipeline depth 1 and 2.  At depth 2 the reference is settled
(each dispatched round completes before host code goes on: its ``_ctl``
may alias host rows on the CPU, ROADMAP C); the port runs unsettled.
"""

import dataclasses

import jax
import pytest
import torch

from hermes_tpu import acceptance as ref
from hermes_tpu_torch import acceptance as port

torch.set_num_threads(1)

CONFIGS = (1, 2, "2r", 3, "3c", 4, 5)


@pytest.mark.parametrize("n", CONFIGS)
@pytest.mark.parametrize("scale", [0.004, 0.01, 1.0])
def test_torch_acceptance_configs_equal_the_reference(n, scale):
    a, b = ref._cfg(n, scale), port._cfg(n, scale)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_torch_acceptance_refuses_an_unknown_config():
    with pytest.raises(ValueError, match="not in 1..5"):
        port._cfg(6, 0.01)


@pytest.fixture
def settled_reference(monkeypatch):
    """The reference's FastRuntime settled each round (ROADMAP C)."""
    base = ref.FastRuntime

    class Settled(base):
        def dispatch_round(self, *args, **kwargs):
            comp = super().dispatch_round(*args, **kwargs)
            jax.block_until_ready((comp, self.fs))
            return comp

    monkeypatch.setattr(ref, "FastRuntime", Settled)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("n", CONFIGS)
def test_torch_acceptance_run_equals_the_reference(n, depth,
                                                   settled_reference):
    rc, rv = ref.run_config(n, scale=0.01, pipeline_depth=depth)
    pc, pv = port.run_config(n, scale=0.01, pipeline_depth=depth,
                             device="cpu")
    assert pc == rc
    assert pc["drained"] and pv.ok
    assert (pv.ok, pv.keys_checked) == (rv.ok, rv.keys_checked)
    if n == 4:
        assert pc["failure_detected"]


def test_torch_acceptance_sparse_variant_equals_the_reference():
    timing = ("preload_s", "client_ops_per_s")
    rc, rv = ref.run_sparse_variant(scale=0.004)
    pc, pv = port.run_sparse_variant(scale=0.004, device="cpu")
    assert ({k: v for k, v in pc.items() if k not in timing}
            == {k: v for k, v in rc.items() if k not in timing})
    assert pc["drained"] and pc["completed"] == pc["client_ops"]
    assert (pv.ok, pv.keys_checked) == (rv.ok, rv.keys_checked)


def test_torch_acceptance_run_all_and_the_sharded_backend():
    """``run_all`` drains and checks configs 1-5; config 4 on the sharded
    engine (a ``LocalGroup``) gives the batched engine's counters."""
    got = port.run_all(scale=0.004, device="cpu")
    assert sorted(got) == [1, 2, 3, 4, 5]
    assert all(c["drained"] and v.ok for c, v in got.values())
    sc, sv = port.run_config(4, scale=0.004, backend="sharded", device="cpu")
    assert sc == got[4][0] and sv.ok


def test_torch_acceptance_refuses_the_card_without_one():
    with pytest.raises(RuntimeError, match="asks for the card"):
        port.run_config(1, scale=0.004)


def test_torch_chip_smoke_acceptance_slice_rehearsal(monkeypatch):
    """``chip_smoke.phase_census`` and ``run_acceptance_slice``
    (acceptance, graft) on the CPU at scale 0.004, the four
    kernels' plain versions counted as their wrappers' launches: every
    phase passes and ``stats_block`` runs once a round."""
    from types import SimpleNamespace

    import chip_smoke
    from hermes_tpu_torch import concurrency, convert, graft, probe
    from hermes_tpu_torch.analysis import hostlint, lockgraph
    from hermes_tpu_torch.core import dispatch, kernels
    from hermes_tpu_torch.core import megaround as mega
    from hermes_tpu_torch.obs import profile as prof

    counters = {"stats_block": kernels.stats_block,
                "mega_route": mega.mega_route,
                "mega_apply": mega.mega_apply,
                "mega_replay": mega.mega_replay}
    for name, mod in (("stats_block", kernels), ("mega_route", mega),
                      ("mega_apply", mega), ("mega_replay", mega)):
        plain, w = getattr(mod, name + "_plain"), counters[name]
        monkeypatch.setattr(w, "launches", w.launches)  # put back after

        def counted(*a, _plain=plain, _w=w, **k):
            _w.launches += 1
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name + "_plain", counted)
    ac = SimpleNamespace(
        device="cpu", on_card=False, sync=lambda: None, prof=prof,
        acceptance=port, configs=chip_smoke.ACCEPTANCE_CONFIGS, scale=0.004,
        max_steps=2000, probe=probe, graft=graft, convert=convert,
        dispatch=dispatch, hostlint=hostlint, lockgraph=lockgraph,
        concurrency=concurrency)
    assert chip_smoke.phase_census(torch, ac, "cpu") == {
        "stats_block": 4, "mega_route": 2, "mega_apply": 2, "mega_replay": 9}
    got = chip_smoke.run_acceptance_slice(torch, ac, counters, "cpu")
    assert got["acceptance_launches"]["stats_block"] > 0
    assert got["acceptance_launches"]["mega_route"] == 0
    assert got["graft_launches"]["stats_block"] == 1
    assert port.FastRuntime is not None and port.FastRuntime.__name__ == \
        "FastRuntime"
