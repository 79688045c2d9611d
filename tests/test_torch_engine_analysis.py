"""The port's static round analysis (hermes_tpu_torch/analysis: graph.py,
interp.py, passes.py, engines.py, gate.py) against the JAX package's
(hermes_tpu/analysis), on the CPU.

* Pass cases: each tiny case of tests/test_analysis.py written again as a
  torch function beside the reference's JAX function; both analyzers run,
  and the multisets of (pass, code, severity) are equal.  Where the
  reference analyzer cannot run a case on JAX 0.9.0 (its
  interpreter does not know JAX 0.9.0's ``jit`` primitive,
  hermes_tpu/analysis/interp.py:490, so a ``jnp`` op that lowers through a
  named call reaches its outputs as dtype-TOP), the port is held to what
  the reference test asserts, and the test says so.
* Red mutations: each flips a gating finding.
* Engines: both engines clean at ``_small_cfg`` and at the gate's cut bench
  shape, fused and split, mega too; the audit tags visible with port
  sites; each hand-kernel call one node; the eager round untouched by a
  trace (census, launch counters).
* Entry points: ``heap.analyze_gather``, ``--analyze``, ``python -m
  hermes_tpu_torch.analysis`` (engine mode, ``--host``), the ``analysis``
  gate passing and failing on a seeded baseline.

No test needs a card; every program traces in about a second (fake
tensors: nothing is materialized, whatever the shape).
"""

import collections
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hermes_tpu.analysis import domain as RD
from hermes_tpu.analysis import interp as RI
from hermes_tpu.analysis import passes as RP
from hermes_tpu_torch import analysis as ana
from hermes_tpu_torch.analysis import __main__ as ana_cli
from hermes_tpu_torch.analysis import domain as D
from hermes_tpu_torch.analysis import gate as gate_mod
from hermes_tpu_torch.analysis import graph as G
from hermes_tpu_torch.analysis import interp as I
from hermes_tpu_torch.analysis import passes as P
from hermes_tpu_torch.analysis import seeds
from hermes_tpu_torch.analysis.domain import iv
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import dispatch, kernels, layouts
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.obs import profile as prof

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
AUDIT_TAGS = ("replay-mark-dup-oob-dropped",
              "pts-mint-ver-bounded-by-watermark",
              "winner-row-dup-writes-identical",
              "stats-ctr-hist-grid-accumulate", "mega-route-unique-targets",
              "mega-apply-two-phase-revisit", "mega-replay-stream-accumulate")


# --------------------------------------------------------------------------
# the two analyzers on one tiny case each
# --------------------------------------------------------------------------


def _port(fn, in_avs, specs, passes=(), mesh_axes=None, cfg=None):
    """The port's analysis of ``fn`` over fake tensors of ``specs`` (shape,
    dtype): (output values, ctx)."""
    with G.fake_mode():
        args = tuple(torch.empty(s, dtype=d) for s, d in specs)
    gm, _ = G.trace(fn, args)
    ctx = I.Ctx(cfg=cfg, mesh_axes=mesh_axes, passes=passes)
    return I.eval_graph(gm, list(in_avs), ctx), ctx


def _ref(fn, in_avs, shapes, passes=(), mesh_axes=None):
    """The reference analyzer (tests/test_analysis.py's ``_run``)."""
    jx = jax.make_jaxpr(fn)(*shapes)
    ctx = RI.Ctx(passes=list(passes), mesh_axes=mesh_axes)
    return RI.eval_jaxpr(jx.jaxpr, in_avs, ctx, consts=list(jx.consts))


def _codes(passes) -> collections.Counter:
    return collections.Counter((f.pass_name, f.code, f.severity)
                               for p in passes for f in p.results())


def _riv(av):
    return RD.AbsVal(av.lo, av.hi, av.ones)


def _both(pass_cls, torch_fn, jax_fn, avs, specs, jshapes, **kw):
    mine, ref = pass_cls(**kw), getattr(RP, pass_cls.__name__)(**kw)
    _port(torch_fn, avs, specs, passes=[mine])
    _ref(jax_fn, [_riv(a) for a in avs], jshapes, passes=[ref])
    return mine, ref


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


I32 = torch.int32


# -- the interpreter (TestInterp, tests/test_analysis.py:117-153) -----------


def test_torch_interp_basic_bounds_equal_reference():
    outs, _ = _port(lambda x, y: (x + y) * 2, [iv(0, 10), iv(0, 5)],
                    [((8,), I32)] * 2)
    ref = _ref(lambda x, y: (x + y) * 2,
               [RD.iv(0, 10), RD.iv(0, 5)], [_sds((8,), jnp.int32)] * 2)
    assert (outs[0].lo, outs[0].hi) == (ref[0].lo, ref[0].hi) == (0, 30)


def test_torch_interp_remainder_contract():
    """``x % 64`` is [0, 63] for any x.  The reference asserts this
    (tests/test_analysis.py:127) but reaches TOP on JAX 0.9.0
    (``jnp.remainder`` lowers through a ``jit`` call its interpreter does
    not know), so the port is held to the asserted bound."""
    outs, _ = _port(lambda x: x % 64, [D.top(np.int32)], [((8,), I32)])
    assert (outs[0].lo, outs[0].hi) == (0, 63)


def test_torch_interp_negative_index_wrap_refined():
    """A torch gather of an index in [0, 4095] from a 4,096-row table is
    in bounds (the reference's ``t_[i]``, :132); and the wrap idiom the
    reference refines (``where(i < 0, i + n, i)``, :318) keeps the exact
    [0, n) bound on an index in [-n, n)."""
    p = P.ScatterHazardPass()
    _port(lambda t_, i: t_[i], [D.top(np.int32), iv(0, 4095)],
          [((4096,), I32), ((16,), torch.int64)], passes=[p])
    ref = RP.ScatterHazardPass()
    _ref(lambda t_, i: t_[i], [RD.top(np.int32), RD.iv(0, 4095)],
         [_sds((4096,), jnp.int32), _sds((16,), jnp.int32)], passes=[ref])
    assert not [f for f in p.results() if f.severity != "info"]
    assert not [f for f in ref.results() if f.severity != "info"]

    def wrapped(t_, i):
        return torch.gather(t_, 0, torch.where(i < 0, i + 4096, i))

    p = P.ScatterHazardPass()
    _port(wrapped, [D.top(np.int32), iv(-4096, 4095)],
          [((4096,), I32), ((16,), torch.int64)], passes=[p])
    assert p.results() == [] and p.n_proved == 1


def test_torch_interp_rotation_provably_bounded():
    """``faststep._rotated`` stays in [0, n) (the reference asserts it at
    :145 and reaches TOP on JAX 0.9.0, as above)."""
    outs, _ = _port(lambda i, stp: fst._rotated(i, stp, 64),
                    [iv(0, 63), iv(0, layouts.MAX_STEPS - 1)],
                    [((64,), I32), ((), I32)])
    assert (outs[0].lo, outs[0].hi) == (0, 63)


def test_torch_interp_unknown_op_is_top_and_an_info_finding():
    """An op without a transfer rule gives its dtype's full range and an
    ``unmodeled-op`` info finding at its site: never silent, never a
    crash."""
    outs, ctx = _port(lambda x: torch.cumprod(x, 0) + 1, [iv(0, 3)],
                      [((8,), I32)])
    assert D.is_top(outs[0], np.int32)
    (f,) = P.interp_findings(ctx)
    assert (f.pass_name, f.code, f.severity, f.op) == (
        "interp", "unmodeled-op", "info", "aten.cumprod.default")
    assert f.file == "tests/test_torch_engine_analysis.py" and f.line > 0


# -- bit-pack (TestBitPack, :155-226) ---------------------------------------


def test_torch_bitpack_overflowing_pack_is_caught():
    mine, ref = _both(P.BitPackPass, lambda band, sub: (band << 29) | sub,
                      lambda band, sub: (band << 29) | sub,
                      [iv(0, 2), iv(0, 1 << 29)], [((16,), I32)] * 2,
                      [_sds((16,), jnp.int32)] * 2)
    assert _codes([mine]) == _codes([ref])
    assert ("bitpack", "pack-overlap", "error") in _codes([mine])


def test_torch_bitpack_disjoint_pack_proved():
    mine, ref = _both(P.BitPackPass, lambda band, sub: (band << 29) | sub,
                      lambda band, sub: (band << 29) | sub,
                      [iv(0, 2), iv(0, (1 << 29) - 1)], [((16,), I32)] * 2,
                      [_sds((16,), jnp.int32)] * 2)
    assert not mine.results() and not ref.results()
    assert mine.n_proved >= 2


def test_torch_bitpack_negative_operand_caught():
    mine, ref = _both(P.BitPackPass, lambda x: (1 << 20) | x,
                      lambda x: (jnp.int32(1) << 20) | x,
                      [iv(-5, 10)], [((16,), I32)], [_sds((16,), jnp.int32)])
    assert _codes([mine]) == _codes([ref]) == collections.Counter(
        {("bitpack", "pack-negative-operand", "error"): 1})


def test_torch_bitpack_bitmap_union_not_flagged():
    mine, ref = _both(P.BitPackPass, lambda a, b: a | b, lambda a, b: a | b,
                      [iv(0, 7), iv(0, 7)], [((16,), I32)] * 2,
                      [_sds((16,), jnp.int32)] * 2)
    assert not mine.results() and not ref.results()


def test_torch_bitpack_not_mask_pack_overlap_caught():
    mine, ref = _both(
        P.BitPackPass,
        lambda epoch, frozen: (epoch << 0) | (~frozen).to(I32),
        lambda epoch, frozen: (epoch << 0) | (~frozen).astype(jnp.int32),
        [iv(0, 3), iv(0, 1)], [((8,), I32), ((8,), torch.bool)],
        [_sds((8,), jnp.int32), _sds((8,), jnp.bool_)])
    assert _codes([mine]) == _codes([ref])
    assert ("bitpack", "pack-overlap", "error") in _codes([mine])


def test_torch_bitpack_audited_pack_downgrades_to_info():
    from hermes_tpu.core import layouts as rl

    def f(x):
        with layouts.audited("test-known-bound"):
            return (x << 29) | 7

    def g(x):
        with rl.audited("test-known-bound"):
            return (x << 29) | jnp.int32(7)

    mine, ref = _both(P.BitPackPass, f, g, [D.top(np.int32)],
                      [((16,), I32)], [_sds((16,), jnp.int32)])
    assert _codes([mine]) == _codes([ref])
    res = mine.results()
    assert res and all(r.severity == "info" and r.audit == "test-known-bound"
                       for r in res)
    assert all(r.file == "tests/test_torch_engine_analysis.py"
               and r.line > 0 for r in res)


# -- dtype (TestDtype, :228-262) ---------------------------------------------


def test_torch_dtype_wrapping_convert_flagged():
    mine, ref = _both(P.DtypePromotionPass, lambda x: x.to(torch.uint32),
                      lambda x: x.astype(jnp.uint32), [D.top(np.int8)],
                      [((8,), torch.int8)], [_sds((8,), jnp.int8)])
    assert _codes([mine]) == _codes([ref]) == collections.Counter(
        {("dtype", "implicit-wrap-convert", "warn"): 1})


def test_torch_dtype_bitcast_is_explicit():
    mine, ref = _both(P.DtypePromotionPass, lambda x: x.view(torch.uint8),
                      lambda x: jax.lax.bitcast_convert_type(x, jnp.uint8),
                      [D.top(np.int8)], [((8,), torch.int8)],
                      [_sds((8,), jnp.int8)])
    assert not mine.results() and not ref.results()


def test_torch_dtype_value_preserving_convert_proved():
    mine, ref = _both(P.DtypePromotionPass, lambda x: x.to(torch.uint32),
                      lambda x: x.astype(jnp.uint32), [iv(0, 255)],
                      [((8,), torch.uint8)], [_sds((8,), jnp.uint8)])
    assert not mine.results() and not ref.results()
    assert mine.n_proved >= 1


def test_torch_dtype_float_in_integer_round_warns():
    mine, ref = _both(
        P.DtypePromotionPass,
        lambda x: (x.to(torch.float32) * 0.5).to(I32),
        lambda x: (x.astype(jnp.float32) * 0.5).astype(jnp.int32),
        [iv(0, 10)], [((8,), I32)], [_sds((8,), jnp.int32)],
        allow_float=False)
    assert _codes([mine]) == _codes([ref])
    assert {c for _p, c, _s in _codes([mine])} == {"float-in-round",
                                                   "float-to-int"}


def test_torch_dtype_int64_is_allowed_but_must_not_wrap():
    """Torch's rule: an int64 stream-hash word is sound (the reference's
    "no 64-bit" rule would flag it); an int64 product that can leave int64
    is an error; an int64 value narrowed into int32 must fit."""
    p = P.DtypePromotionPass()
    _port(lambda x: ((x & 0xFFFFFFFF) * 0x7FEB) & 0xFFFFFFFF,
          [D.top(np.int64)], [((8,), torch.int64)], passes=[p])
    assert p.results() == []
    p = P.DtypePromotionPass()
    _port(lambda x: x * x, [iv(0, 1 << 40)], [((8,), torch.int64)],
          passes=[p])
    assert _codes([p]) == collections.Counter(
        {("dtype", "int64-wrap", "error"): 1})
    p = P.DtypePromotionPass()
    _port(lambda x: (x >> 16).to(I32), [iv(0, 1 << 48)],
          [((8,), torch.int64)], passes=[p])
    assert _codes([p]) == collections.Counter(
        {("dtype", "implicit-wrap-convert", "warn"): 1})


# -- scatter (TestScatter, :264-300) -----------------------------------------


def test_torch_scatter_injective_permutation_not_flagged():
    """The reference proves its permutation scatter by trusting
    ``unique_indices=True`` (an info finding); torch has no such flag, and
    its counterpart is an index that is a permutation by construction
    (the sort's indices): proved, no finding.  Both: nothing gates."""
    p = P.ScatterHazardPass()

    def f(keys, vals):
        perm = torch.sort(keys, stable=True).indices
        return torch.zeros((64,), dtype=I32).scatter(0, perm, vals)

    _port(f, [iv(0, 99), iv(0, 100)], [((64,), I32)] * 2, passes=[p])
    ref = RP.ScatterHazardPass()

    def g(perm, vals):
        return jnp.zeros((64,), jnp.int32).at[perm].set(
            vals, unique_indices=True, mode="drop")

    _ref(g, [RD.iv(0, 63), RD.iv(0, 100)], [_sds((64,), jnp.int32)] * 2,
         passes=[ref])
    assert not [f_ for f_ in p.results() if f_.severity != "info"]
    assert not [f_ for f_ in ref.results() if f_.severity != "info"]
    assert p.results() == [] and p.n_proved >= 2


def test_torch_scatter_max_not_flagged():
    mine, ref = _both(
        P.ScatterHazardPass,
        lambda i, v: torch.zeros((64,), dtype=I32).scatter_reduce(
            0, i, v, "amax"),
        lambda i, v: jnp.zeros((64,), jnp.int32).at[i].max(v, mode="drop"),
        [iv(0, 63), iv(0, 100)], [((64,), torch.int64), ((64,), I32)],
        [_sds((64,), jnp.int32)] * 2)
    assert not mine.results() and not ref.results()


def test_torch_scatter_unannotated_set_scatter_warns():
    mine, ref = _both(
        P.ScatterHazardPass,
        lambda i, v: torch.zeros((64,), dtype=I32).scatter(0, i, v),
        lambda i, v: jnp.zeros((64,), jnp.int32).at[i].set(v, mode="drop"),
        [iv(0, 63), iv(0, 100)], [((64,), torch.int64), ((64,), I32)],
        [_sds((64,), jnp.int32)] * 2)
    assert _codes([mine]) == _codes([ref]) == collections.Counter(
        {("scatter", "scatter-set-not-injective", "warn"): 1})


def test_torch_scatter_promised_oob_index_error():
    mine, ref = _both(
        P.ScatterHazardPass, lambda t_, i: t_[i],
        lambda t_, i: t_.at[i].get(mode="promise_in_bounds"),
        [D.top(np.int32), iv(0, 1 << 20)],
        [((128,), I32), ((8,), torch.int64)],
        [_sds((128,), jnp.int32), _sds((8,), jnp.int32)])
    assert _codes([mine]) == _codes([ref]) == collections.Counter(
        {("scatter", "oob-promised-index", "error"): 1})


# -- sharding (TestSharding, :331-360) ---------------------------------------


def _tiny_sharded_torch():
    group = G.TracedGroup(LocalGroup("cpu"), 8)
    return lambda x: group.gather_src(x)


def _tiny_sharded_jax():
    from jax.sharding import Mesh, PartitionSpec as Ps

    from hermes_tpu.core import compat

    mesh = Mesh(np.array(jax.devices()[:8]), ("replica",))

    def body(x):
        return jax.lax.all_gather(x[0], "replica", axis=0, tiled=False)

    return compat.shard_map(body, mesh=mesh, in_specs=(Ps("replica"),),
                            out_specs=Ps("replica"))


@pytest.mark.parametrize("declared,code", [
    ({"replica": 8}, None), ({"shard": 8}, "unknown-mesh-axis"),
    ({}, "collective-in-batched-engine"),
    ({"replica": 4}, "axis-size-mismatch")])
def test_torch_sharding_cases_equal_reference(declared, code):
    """The reference's program also holds a ``shard_map`` equation, which
    its pass checks against the declaration beside the collective; the
    port's sharded round has none (its group is a Python object, and each
    collective is a node naming its axis and size).  So the port gives the
    collective's finding alone: the reference test's code, and no code the
    reference does not give."""
    mine, ref = P.ShardingConsistencyPass(), RP.ShardingConsistencyPass()
    _port(_tiny_sharded_torch(), [iv(0, 10)], [((8, 4), I32)], passes=[mine],
          mesh_axes=declared)
    _ref(_tiny_sharded_jax(), [RD.iv(0, 10)], [_sds((8, 4), jnp.int32)],
         passes=[ref], mesh_axes=declared)
    got = _codes([mine])
    if code is None:
        assert got == _codes([ref]) == collections.Counter()
        assert mine.n_proved >= 1
        return
    assert got == collections.Counter({("sharding", code, "error"): 1})
    assert set(got) <= set(_codes([ref]))


# -- the hand-kernel bound check ---------------------------------------------


def _stats_call(step, sess_op, invoke_step, commit, abort, read_done):
    return kernels.stats_block(step, sess_op, invoke_step, commit, abort,
                               read_done)


STATS_SPECS = [((), I32), ((2, 5), I32), ((2, 5), I32),
               ((2, 5), torch.bool), ((2, 5), torch.bool),
               ((2, 5), torch.bool)]


def test_torch_hand_kernel_inside_its_seeds_takes_its_bounds():
    p = P.HandKernelPass()
    outs, ctx = _port(_stats_call, seeds.seed_stats_block(), STATS_SPECS,
                      passes=[p])
    assert [(o.lo, o.hi) for o in outs] == [
        (o.lo, o.hi) for o in seeds.out_stats_block(5)]
    (f,) = p.results()  # the declared access pattern, unaudited here?
    assert (f.code, f.severity, f.audit) == (
        "grid-revisit-accumulator", "info", "stats-ctr-hist-grid-accumulate")
    assert p.n_proved == 1


def test_torch_hand_kernel_input_widened_past_its_seed_is_red():
    avs = list(seeds.seed_stats_block())
    avs[1] = iv(0, 7)  # an op code past OP_RMW
    p = P.HandKernelPass()
    _port(_stats_call, avs, STATS_SPECS, passes=[p])
    bad = [f for f in p.results() if f.severity == "error"]
    assert [f.code for f in bad] == ["kernel-input-escapes-seed"]
    assert bad[0].audit is None  # no audit discharges an input


def test_torch_hand_kernel_undeclared_is_red(monkeypatch):
    monkeypatch.setattr(seeds, "KERNELS", {
        k: v for k, v in seeds.KERNELS.items() if k != "stats_block"})
    p = P.HandKernelPass()
    outs, _ = _port(_stats_call, seeds.seed_stats_block(), STATS_SPECS,
                    passes=[p])
    assert [(f.code, f.severity) for f in p.results()] == [
        ("kernel-undeclared", "error")]
    assert D.is_top(outs[0], np.int32)


# --------------------------------------------------------------------------
# whole-engine analysis
# --------------------------------------------------------------------------


def _small_cfg(**kw):
    base = dict(n_replicas=3, n_keys=1 << 12, n_sessions=16,
                replay_slots=8, ops_per_session=8)
    base.update(kw)
    return HermesConfig(**base)


def _gating(reports):
    return [f for r in reports for f in r["findings"]
            if f.severity in ana.GATING]


def test_torch_engines_batched_race_clean():
    reports = ana.analyze_config(_small_cfg(), engines=("batched",),
                                 device="cpu")
    assert [r["engine"] for r in reports] == ["batched/race"]
    assert _gating(reports) == []


def test_torch_engines_fused_and_split_clean_on_both_engines():
    cfg = _small_cfg(arb_mode="sort", chain_writes=4, lane_budget_cfg=8)
    reports = ana.analyze_config(cfg, device="cpu")
    assert {r["engine"] for r in reports} == {
        "batched/fused", "batched/split", "sharded/fused", "sharded/split"}
    assert _gating(reports) == []


@pytest.mark.parametrize("mega", [False, True])
def test_torch_engines_clean_at_the_gate_cut_bench_shape(mega):
    cfg = dataclasses.replace(prof.gate_cfg(True), mega_round=mega)
    reports = ana.analyze_config(cfg, device="cpu")
    assert _gating(reports) == []
    for r in reports:
        fused_mega = mega and r["engine"].endswith("fused")
        want = ({"stats_block": 1} if not fused_mega else
                {"stats_block": 1, "mega_route": 1, "mega_apply": 1,
                 # the sharded round scans each local copy apart
                 "mega_replay": cfg.n_replicas
                 if r["engine"].startswith("sharded") else 1})
        assert r["kernels"] == want, r["engine"]
        # every finding at a port line, never <unknown>:0
        assert all(f.file.startswith("hermes_tpu_torch/") and f.line > 0
                   for f in r["findings"])
    tags = {f.audit for r in reports for f in r["findings"] if f.audit}
    assert set(AUDIT_TAGS if mega else AUDIT_TAGS[:4]) <= tags


def test_torch_engines_audited_assumptions_visible():
    reports = ana.analyze_config(_small_cfg(), engines=("batched",),
                                 device="cpu")
    infos = [f for r in reports for f in r["findings"]
             if f.severity == "info" and f.audit]
    audits = {f.audit for f in infos}
    assert "pts-mint-ver-bounded-by-watermark" in audits
    assert "winner-row-dup-writes-identical" in audits
    site = {f.audit: f.site for f in infos}
    assert site["winner-row-dup-writes-identical"].startswith(
        "hermes_tpu_torch/core/faststep.py:")
    # the audited bound is reported where it is assumed
    assert any(f.code == "audited-bound" for f in infos)


def test_torch_engines_wide_keys_on_sharded_flip_red():
    """n_keys past the INV key field (bypassing the config's validation):
    the wire-header pack must flag the alias."""
    cfg = _small_cfg()
    object.__setattr__(cfg, "n_keys", 1 << 30)
    rep = ana.analyze_program(ana.trace_program(cfg, "sharded", "cpu"))
    errs = [f for f in rep["findings"] if f.severity == "error"]
    assert any(f.code == "pack-overlap" for f in errs)


def test_torch_engines_wide_keys_trip_the_fused_assert():
    cfg = _small_cfg(arb_mode="sort")
    object.__setattr__(cfg, "n_keys", 1 << 30)
    assert cfg.use_fused_sort
    with pytest.raises(AssertionError, match="fused sort key overflow"):
        ana.trace_program(cfg, "batched", "cpu")
    # a failed trace leaves nothing switched on
    assert dispatch._trace is None and layouts._AUDITS is None


@pytest.mark.parametrize("mega", [False, True])
def test_torch_engines_dropped_audit_flips_red(monkeypatch, mega):
    monkeypatch.setattr(layouts, "audited", lambda tag: layouts.unaudited())
    cfg = dataclasses.replace(prof.gate_cfg(True), mega_round=mega)
    reports = ana.analyze_config(cfg, engines=("batched",), variants="as-is",
                                 device="cpu")
    codes = {f.code for f in _gating(reports)}
    assert "scatter-set-not-injective" in codes
    assert "grid-revisit-accumulator" in codes
    if mega:  # the minted ts is no longer assumed bounded
        assert "kernel-input-escapes-seed" in codes


def test_torch_engines_trace_leaves_the_eager_round_as_it_was():
    cfg = prof.gate_cfg(True)
    before_launches = {n: w.launches for n, w in dispatch.HAND_KERNELS.items()}
    before = prof.op_census(cfg, "batched", "cpu")
    ana.analyze_config(dataclasses.replace(cfg, mega_round=True),
                       device="cpu")
    assert prof.op_census(cfg, "batched", "cpu") == before
    assert {n: w.launches for n, w in dispatch.HAND_KERNELS.items()} == \
        before_launches
    assert dispatch._trace is None and layouts._AUDITS is None
    # outside a trace the audit scope is a shared no-op
    assert layouts.audited("x") is layouts.audited("y")
    budget, _card = prof.load_budget()
    assert prof.check_budget(prof.measure("cpu"), budget) == []


def test_torch_audit_tag_contract():
    for bad in ("", "a[b]", "x]"):
        with pytest.raises(ValueError):
            layouts.audited(bad)
    with layouts.unaudited():
        pass
    with G.recording():
        with layouts.audited("outer"):
            with layouts.audited("inner"):
                assert layouts.current_audit() == "inner"
            assert layouts.current_audit() == "outer"
        with pytest.raises(RuntimeError):
            with G.recording():
                pass
    assert layouts.current_audit() is None


def test_torch_seeds_of_the_round_mirror_the_reference():
    """The round seeds are the reference's, leaf for leaf, and the port's
    state trees match them (a field added without a seed raises)."""
    from hermes_tpu.analysis import seeds as ref_seeds
    from hermes_tpu.config import HermesConfig as RefConfig

    kw = dict(n_replicas=3, n_keys=40, n_sessions=6, replay_slots=3,
              ops_per_session=4, wrap_stream=True, rmw_retries=5)
    mine = seeds.seed_round_args(HermesConfig(**kw), has_uval=True)
    ref = ref_seeds.seed_round_args(RefConfig(**kw), has_uval=True)
    strip = lambda t: [(x.lo, x.hi, x.ones) for x in jax.tree.leaves(
        t, is_leaf=lambda v: isinstance(v, (D.AbsVal, RD.AbsVal)))
        if isinstance(x, (D.AbsVal, RD.AbsVal))]
    assert strip(mine[0]) == strip(ref[0])
    assert strip(mine[1]) == strip(ref[1])
    ctl = mine[2]
    assert [(x.lo, x.hi) for x in (ctl.step, ctl.my_cid, ctl.epoch,
                                   ctl.live_mask, ctl.frozen)] == [
        (x.lo, x.hi) for x in (ref[2].step, ref[2].my_cid, ref[2].epoch,
                               ref[2].live_mask, ref[2].frozen)]
    assert ctl.host_step == ctl.quiesce == seeds.HOST
    a, b = seeds.seed_heap_gather(HermesConfig()), \
        ref_seeds.seed_heap_gather(RefConfig())
    assert (a[1].lo, a[1].hi) == (b[1].lo, b[1].hi)
    with pytest.raises(ValueError, match="seed tree"):
        ana.engines.flat_seeds((1, 2), (iv(0),))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def test_torch_heap_analyze_gather_clean_and_red(monkeypatch):
    from hermes_tpu_torch.heap import core as heap

    cfg = prof.heap_cfg(prof.gate_cfg(False))
    found = heap.analyze_gather(cfg, device="cpu")
    assert [f for f in found if f.severity in ana.GATING] == []

    def unclamped(heap_bytes, cap):
        def gather(log, refs):
            gran = (refs >> 12) & ((1 << 19) - 1)
            off = torch.arange(cap, dtype=I32)
            return log[(gran[:, None] * 16 + off[None, :]).long()]
        return gather

    monkeypatch.setattr(heap, "build_extent_gather", unclamped)
    bad = heap.analyze_gather(cfg, device="cpu")
    assert [(f.code, f.severity, f.engine) for f in bad
            if f.severity in ana.GATING] == [
        ("oob-promised-index", "error", "heap/gather")]


def test_torch_cli_analyze_writes_findings_then_runs(tmp_path, capsys):
    from hermes_tpu_torch import cli

    out = tmp_path / "findings.jsonl"
    rc = cli.main(["--analyze", str(out), "--arb-mode", "sort",
                   "--mega-round", "--keys", "256", "--sessions", "8",
                   "--steps", "6", "--device", "cpu"])
    text = capsys.readouterr().out.splitlines()
    assert rc == 0
    said = [i for i, line in enumerate(text) if line.startswith("analysis:")]
    assert len(said) == 1 and text[said[0]] == \
        f"analysis: 0 gating finding(s) -> {out}"
    assert said[0] < len(text) - 1  # then the run's summary
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    head = [r for r in recs if r["record"] == "program"]
    assert [r["engine"] for r in head] == ["batched/fused"]
    assert all(r["kind"] == "analysis" and "t" in r for r in recs)
    assert head[0]["by_severity"]["error"] == head[0]["by_severity"]["warn"] \
        == 0


@pytest.mark.parametrize("argv", [
    ["--analyze", "f.jsonl", "--backend", "sim"],
    ["--analyze", "f.jsonl", "--acceptance", "1"]])
def test_torch_cli_analyze_refusals_match_reference(capsys, argv):
    """The reference's two ``--analyze`` refusals, word for word."""
    from hermes_tpu import cli as ref_cli
    from hermes_tpu_torch import cli

    with pytest.raises(SystemExit) as ei:
        cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as er:
        ref_cli.main(argv)
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert ei.value.code == er.value.code == 2
    assert got.replace("hermes_tpu_torch", "hermes_tpu") == want


def test_torch_analysis_cli_engine_mode(capsys, tmp_path):
    out = tmp_path / "f.jsonl"
    rc = ana_cli.main(["--config", "default", "--engine", "both", "--device",
                       "cpu", "--json", "--out", str(out)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert doc["programs"] == ["batched/race", "sharded/race"]
    assert doc["errors"] == doc["warnings"] == 0 and doc["infos"] > 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert all(r["config"] == "default" for r in recs)
    assert sum(r["record"] == "program" for r in recs) == 2
    rc = ana_cli.main(["--config", "bench", "--sessions", "64",
                       "--split-sort", "--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["programs"] == ["batched/split"]


def test_torch_analysis_cli_host_mode(capsys):
    rc = ana_cli.main(["--host", "--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["config"] == "host" and doc["errors"] == 0
    assert doc["files"] > 50


def test_torch_analysis_entry_points_need_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in ("hermes_tpu_torch.analysis", "hermes_tpu_torch.analysis.gate"):
        r = subprocess.run([sys.executable, "-m", mod], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and r.stdout == "", r
        assert "torch.cuda.is_available() is False" in r.stderr
    with pytest.raises(RuntimeError, match="is_available"):
        ana.trace_program(_small_cfg(), "batched")


def test_torch_findings_export_and_baseline_currency(tmp_path):
    reports = ana.analyze_config(_small_cfg(), engines=("batched",),
                                 device="cpu")
    out = tmp_path / "findings.jsonl"
    ana.export_findings(str(out), reports)
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert recs[0]["record"] == "program" and recs[0]["n_eqns"] > 0
    assert {r["record"] for r in recs} <= {"program", "finding"}
    f1 = ana.Finding(pass_name="bitpack", code="pack-overlap",
                     severity="error", message="m", file="f.py", fn="g",
                     op="or", engine="bench:batched/fused")
    f2 = ana.Finding(pass_name="scatter", code="x", severity="info",
                     message="m", engine="batched/fused")
    counts = ana.key_counts([f1, f2])
    assert list(counts) == ["bench:batched/fused|bitpack|pack-overlap|f.py|g"
                            "|or"]
    assert ana.diff_baseline(counts, {}) == (counts, {})
    assert ana.diff_baseline(counts, dict(counts)) == ({}, {})
    assert ana.diff_baseline({}, dict(counts)) == ({}, counts)
    assert ana.load_baseline(str(tmp_path / "none.json")) == {}


def test_torch_analysis_gate_pass_fail_update(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(gate_mod, "gate_configs",
                        lambda: {"tiny": _small_cfg(n_replicas=3)})
    baseline = tmp_path / "BASELINE.json"

    def run(*argv):
        return gate_mod.main(["--baseline", str(baseline), "--no-kernels",
                              "--device", "cpu", *argv])

    assert run() == 0  # clean engines, no baseline file
    monkeypatch.setattr(layouts, "audited", lambda tag: layouts.unaudited())
    assert run() == 1  # the audits dropped: new warn findings
    assert run("--update") == 0
    doc = json.loads(baseline.read_text())
    assert doc["grandfathered"]
    assert all(k.startswith("tiny:") for k in doc["grandfathered"])
    assert run() == 0
    assert run("--configs", "nope") == 2
    capsys.readouterr()
    # the shipped baseline is empty and the gate runs third in the port's
    # runner, as in the reference's: after the census and obs-overhead
    assert json.loads(pathlib.Path(gate_mod.BASELINE_PATH).read_text())[
        "grandfathered"] == {}
    from hermes_tpu_torch import gates

    names = [g[0] for g in gates.GATES]
    assert names[:3] == ["census", "obs-overhead", "analysis"]
    assert names.index("analysis") < names.index("hostlint")


def test_torch_analysis_gate_kernel_matrix_leg(capsys):
    rc = gate_mod.main(["--configs", "default", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["ok"] and doc["sanitizer_ok"]
    assert len(doc["kernel_cells"]) == 9 and doc["gating_sites"] == 0
    assert set(doc["programs"]) == {"default:batched/race",
                                    "default:sharded/race"}
