"""The port's op census, ledger and census gate (hermes_tpu_torch/obs/
profile.py, the read and heap censuses) against the reference's
(hermes_tpu/obs/profile.py, core/readpath.py, heap/core.py).

The reference counts StableHLO ops of an abstract lowering; the port
counts what one real round dispatches.  So the two are held equal where
the counts mean the same thing: the census shape, the budget predicate's
failures, the record schema, and the read and heap programs' sparse,
sort and scatter counts.  The round census itself is the port's own: it
must not depend on the shape, must count a hand-kernel call once and none
of its plain version's ops, and must equal the committed
``op_budget.json``.
"""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.config import WorkloadConfig as RefWorkload
from hermes_tpu.obs import profile as ref_prof
from hermes_tpu_torch.config import HermesConfig, WorkloadConfig, bench_cfg
from hermes_tpu_torch.core import kernels
from hermes_tpu_torch.obs import profile as prof

torch.set_num_threads(1)


def _kw(**over):
    kw = dict(n_replicas=4, n_keys=1 << 9, value_words=2, n_sessions=16,
              replay_slots=4, ops_per_session=16, wrap_stream=True,
              arb_mode="sort", chain_writes=4, lane_budget_cfg=12,
              rebroadcast_every=4, replay_scan_every=32)
    kw.update(over)
    return kw


def _pair(**over):
    kw = _kw(**over)
    return (RefConfig(workload=RefWorkload(read_frac=0.5, seed=0), **kw),
            HermesConfig(workload=WorkloadConfig(read_frac=0.5, seed=0), **kw))


@pytest.mark.parametrize("over", [{}, dict(fused_sort=False),
                                  dict(arb_mode="race", chain_writes=0,
                                       n_keys=1 << 12)])
def test_torch_census_shape_equals_reference(over):
    ref, port = _pair(**over)
    assert prof.census_shape(port) == ref_prof.census_shape(ref)


def _prefix(failures):
    # the advice after the dash differs: the reference's names a TPU cost
    return [f.split(" — ")[0] for f in failures]


@pytest.mark.parametrize("census,budget", [
    ({"batched": {"sparse_total": 12, "collective_total": 0}},
     {"batched": {"sparse_total": 12}}),
    ({"batched": {"sparse_total": 12, "collective_total": 0}},
     {"batched": {"sparse_total": 11, "collective_total": 0}}),
    ({}, {"batched": {"sparse_total": 99}}),
    ({"batched": {"sparse_total": 1}}, {"batched": {"no_such_metric": 1}}),
    ({"a": {"x": 3, "y": 9}, "b": {"x": 1}},
     {"a": {"x": 2, "y": 9}, "b": {"x": 0, "z": 1}, "c": {"x": 1}}),
])
def test_torch_check_budget_fails_as_the_reference(census, budget):
    assert (_prefix(prof.check_budget(census, budget))
            == _prefix(ref_prof.check_budget(census, budget)))


def test_torch_ledger_records_have_the_reference_schema(tmp_path):
    ref_cfg, port_cfg = _pair()
    want = ref_prof.round_ledger(ref_cfg, time_stages=False)
    got = prof.round_ledger(port_cfg, time_stages=False, device="cpu")
    assert set(got) == set(want)
    assert got["shape"] == want["shape"] and got["round_ms"] is None
    assert ([r["fusion"] for r in got["stages"]]
            == [r["fusion"] for r in want["stages"]])
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w) and g["modeled_ms"] is None
        assert g["ms"] is None
    # the stage deltas telescope to the full round's census
    assert (sum(r["sparse_delta"] for r in got["stages"])
            == got["census"]["sparse_total"])
    paths = {}
    for name, mod, led in (("ref", ref_prof, want), ("port", prof, got)):
        p = tmp_path / f"{name}.jsonl"
        mod.export_profile(str(p), mod.ledger_records(led)
                           + [mod.round_record(led["census"], backend="b")])
        paths[name] = [json.loads(line) for line in p.read_text().splitlines()]
    assert ([(r["kind"], r["record"], sorted(r)) for r in paths["port"]]
            == [(r["kind"], r["record"], sorted(r)) for r in paths["ref"]])
    t = [r["t"] for r in paths["port"]]
    assert t == sorted(t)


def test_torch_ledger_timed_on_the_cpu():
    """``time_stages=True`` on the CPU: host-clock ms of each stage (a
    CPU number, no device metric)."""
    _, cfg = _pair()
    led = prof.round_ledger(cfg, rounds=2, reps=1, device="cpu")
    assert led["round_ms"] is not None and led["round_ms"] > 0
    assert all(r["ms"] is not None for r in led["stages"])


def _ref_census(fn, *a, **k):
    cen = fn(*a, **k)
    return dict(sparse_total=cen["sparse_total"], sort=cen["stablehlo.sort"],
                scatter=cen["stablehlo.scatter"],
                collective_total=cen["collective_total"])


def _port_census(cen):
    return {k: cen[k] for k in ("sparse_total", "sort", "scatter",
                                "collective_total")}


@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_torch_read_censuses_equal_the_reference(backend):
    from hermes_tpu.core import readpath as ref_rp
    from hermes_tpu_torch.core import readpath

    ref_cfg, cfg = _pair(n_replicas=2, value_words=6, n_keys=1 << 12)
    assert (_port_census(readpath.read_census(cfg, backend, device="cpu"))
            == _ref_census(ref_rp.read_census, ref_cfg, backend))
    assert (_port_census(readpath.scan_census(cfg, backend, device="cpu"))
            == _ref_census(ref_rp.scan_census, ref_cfg, backend))


def test_torch_heap_censuses_equal_the_reference():
    from hermes_tpu import heap as ref_heap
    from hermes_tpu_torch.heap import core as heap

    over = dict(value_words=6, max_value_bytes=1024, heap_bytes=1 << 22)
    ref_cfg, cfg = _pair(**over)
    assert (_port_census(heap.gather_census(cfg, batch=1024, device="cpu"))
            == _ref_census(ref_heap.gather_census, ref_cfg, batch=1024))
    assert (_port_census(heap.append_census(cfg, chunk=4096, device="cpu"))
            == _ref_census(ref_heap.append_census, ref_cfg, chunk=4096))


SHAPES = (dict(n_keys=1 << 10, n_sessions=64, replay_slots=8),
          dict(n_keys=1 << 12, n_sessions=256, replay_slots=16))


@pytest.mark.parametrize("backend", ["batched", "sharded"])
@pytest.mark.parametrize("mega", [False, True])
def test_torch_round_census_does_not_depend_on_the_shape(backend, mega):
    a, b = (prof.op_census(bench_cfg("a", over=dict(mega_round=mega, **s)),
                           backend, device="cpu") for s in SHAPES)
    assert a == b
    assert a["kernel:stats_block"] == 1
    assert a["collective_total"] == (4 if backend == "sharded" else 0)
    if mega:
        assert a["kernel:mega_route"] == a["kernel:mega_apply"] == 1
        # round 0 holds the replay scan: once a copy on the sharded table
        assert a["kernel:mega_replay"] == (8 if backend == "sharded" else 1)


def test_torch_census_counts_a_hand_kernel_once_and_not_its_plain_ops(
        monkeypatch):
    """The plain version's ops stay outside the census: made to dispatch
    many more ops, it leaves the census as it was; the launch counters
    are put back."""
    cfg = bench_cfg("a", over=SHAPES[0])
    want = prof.op_census(cfg, "batched", device="cpu")
    plain = kernels.stats_block_plain

    def noisy(*args):
        for _ in range(50):
            torch.zeros(3).add_(1)
        return plain(*args)

    monkeypatch.setattr(kernels, "stats_block_plain", noisy)
    kernels.stats_block.launches = 7
    got = prof.op_census(cfg, "batched", device="cpu")
    assert kernels.stats_block.launches == 7
    kernels.stats_block.launches = 0
    assert got == want
    assert got["hand_kernel_calls"] == 1


def test_torch_op_budget_holds_the_measured_census():
    """The counterpart of the reference's budget-file test: every field
    of obs/op_budget.json equals the CPU census at the gate shape, and
    the gate passes."""
    rep = prof.gate(device="cpu")
    assert rep["ok"], rep["budget_failures"]
    budget, card = prof.load_budget()
    assert sorted(budget) == sorted(rep["census"])
    for sec, limits in budget.items():
        assert limits == {k: rep["census"][sec][k] for k in limits}, sec
    assert sorted(card) == sorted(prof.ENGINES)
    assert budget["sharded"]["collective_total"] == 4
    assert budget["read_path"]["sparse_total"] == 1
    assert budget["read_scan"]["sparse_total"] == 0


def test_torch_profile_gate_update_rewrites_only_the_measured_fields(
        tmp_path):
    doc = json.loads(prof.BUDGET_PATH.read_text())
    doc["batched"]["sparse_total"] = 0  # a stale ceiling
    p = tmp_path / "budget.json"
    p.write_text(json.dumps(doc))
    assert not prof.gate(device="cpu", path=p)["ok"]
    assert prof.gate(device="cpu", path=p, update=True)["ok"]
    new = json.loads(p.read_text())
    assert new == json.loads(prof.BUDGET_PATH.read_text())


def test_torch_profile_cli_check_and_ledger(tmp_path):
    r = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.obs.profile",
                        "--check", "--device", "cpu"], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["budget_failures"] == []
    out = tmp_path / "ledger.jsonl"
    assert prof.main(["64", "--census-only", "--device", "cpu",
                      "--arb-mode", "sort", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["record"] for r in recs] == ["round"] + ["fusion"] * 3
    assert all(r["device"] == "cpu" for r in recs)


def test_torch_profile_refuses_the_card_without_one():
    with pytest.raises(RuntimeError, match="asks for the card"):
        prof.op_census(bench_cfg("a", over=SHAPES[0]), "batched")
    with pytest.raises(SystemExit):
        prof.main(["--update"])


@pytest.mark.parametrize("got,fails", [(787, 0), (788, 1), (720, 1)])
def test_torch_check_card_holds_kernel_total_to_equality(got, fails):
    """The card section's rule: a count above the record and one below it
    (the 67 fewer kernels of a late census) both fail; an engine the
    census lacks fails as in ``check_budget``."""
    card = {"batched": {"kernel_total": 787}}
    out = prof.check_card({"batched": {"kernel_total": got}}, card)
    assert len(out) == fails
    assert prof.check_card({}, card) == [
        "batched: no census measured for budgeted engine"]
