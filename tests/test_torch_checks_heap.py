"""The port's heap gate (hermes_tpu_torch/checks/heap.py) against the JAX
package's (scripts/check_heap.py).

The gate runs green on the CPU.  The soak, fleet-migration and
torn-snapshot legs' reports equal the reference legs' at the same seed
(churn, live keys, GC runs, reclaimed bytes, utilization, the extents
moved); the soak's surviving payloads and the fleet's read-back equal the
reference's byte for byte.  The census leg is the port's own (the JAX
package counts StableHLO ops): heap against fixed-word on all four
engines, the launches of its rounds left on the counters.  Red: a
heap-mode round that carries one more gather turns the gate red."""

import pytest
import torch

from hermes_tpu_torch.checks import heap as gate
from torch_gatepair import (load_script, run_port_gate,
                            settled_reference)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return load_script("check_heap")


def test_torch_heap_gate_green_on_cpu(tmp_path):
    rc, rep = run_port_gate(gate, tmp_path)
    assert rc == 0 and rep["ok"], rep
    assert rep["device"] == "cpu"
    cen = rep["census_unchanged"]
    assert cen["engines"] == {"batched": 15, "sharded": 18,
                              "batched_mega": 6, "sharded_mega": 9}
    assert (cen["heap_path_sparse"], cen["heap_append_sparse"]) == (1, 0)


def test_torch_heap_legs_report_as_the_reference(reference,
                                                 settled_reference):
    want, got = {}, {}
    for name in ("check_heap_soak", "check_fleet_migration",
                 "check_torn_snapshot"):
        getattr(reference, name)(want)
        getattr(gate, name)(got, device="cpu")
    assert got == want
    assert got["batched_soak"]["gc_runs"] >= 2


def test_torch_heap_churn_and_fleet_bytes_equal_the_reference(
        reference, settled_reference):
    from hermes_tpu.kvs import KVS as RefKVS

    ref_store = RefKVS(reference._cfg(), record=True)
    store = gate._store("batched", device="cpu")
    want, got = gate._churn(ref_store, "ref"), gate._churn(store, "port")
    assert got == want
    keys = sorted(got)
    assert (store.multi_get(keys).data
            == ref_store.multi_get(keys).data)
    _fleet, summary, pays, res = gate._fleet_move(device="cpu")
    assert res.data == pays and summary["heap_extents"] == 8


def test_torch_heap_census_keeps_the_mega_rounds_launches(monkeypatch):
    """On the card the census rounds' launches stay on the counters; on
    the CPU a wrapper counts only CUDA launches, so count the plain
    versions' calls through the same counters."""
    from hermes_tpu_torch.core import kernels, megaround

    wrapped = {}
    for mod, name in ((kernels, "stats_block"), (megaround, "mega_route"),
                      (megaround, "mega_apply"), (megaround, "mega_replay")):
        wrapper = getattr(mod, name)
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _w=wrapper, _p=plain, **k):
            _w.launches += 1
            return _p(*a, **k)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
        monkeypatch.setattr(wrapper, "launches", 0)
        wrapped[name] = wrapper
    gate.censuses(device="cpu")
    got = {n: w.launches for n, w in wrapped.items()}
    assert got == {"stats_block": 8, "mega_route": 4, "mega_apply": 4,
                   "mega_replay": 18}


def test_torch_heap_red_when_the_heap_round_gathers_more(monkeypatch):
    from hermes_tpu_torch.core import faststep as fst

    real = fst.fast_round_batched

    def heavier(cfg, ctl, fs, stream):
        if cfg.max_value_bytes:  # the heap's bytes ride the round
            fs.table.bank.index_select(0, stream.key.reshape(-1)[:1])
        return real(cfg, ctl, fs, stream)

    monkeypatch.setattr(fst, "fast_round_batched", heavier)
    with pytest.raises(AssertionError, match="batched: heap mode MOVED"):
        gate.check_census_unchanged({}, device="cpu")
