"""The port's own copies of the declared tables and the config (it imports
nothing of hermes_tpu) must stay equal to the reference's."""

import dataclasses
import importlib.util
import pathlib

import pytest

from hermes_tpu import config as ref_config
from hermes_tpu.core import layouts as ref_layouts
from hermes_tpu.core import types as ref_types
from hermes_tpu_torch import config
from hermes_tpu_torch.core import layouts, types


def test_layout_tables_equal_reference():
    assert [tuple(x) for x in layouts.ALL] == [tuple(x) for x in ref_layouts.ALL]
    assert tuple(layouts.STATS_CTR) == tuple(ref_layouts.STATS_CTR)
    for name in ("PTS_FC_BITS", "FC_MASK", "MAX_KEY_VERSIONS", "MAX_STEPS",
                 "MAX_VALUE_BYTES", "MAX_HEAP_BYTES", "ROT_STRIDE", "ROT_CAP",
                 "HEAP_GRANULE"):
        assert getattr(layouts, name) == getattr(ref_layouts, name), name


def test_type_constants_equal_reference():
    names = [n for n in dir(ref_types) if n.isupper()]
    assert names
    for n in names:
        assert getattr(types, n) == getattr(ref_types, n), n


def test_config_fields_and_properties_equal_reference():
    ref = ref_config.HermesConfig(n_replicas=5, n_keys=1 << 10,
                                  n_sessions=48, arb_mode="sort",
                                  chain_writes=7, lane_budget_cfg=40)
    cfg = config.HermesConfig(**dataclasses.asdict(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for p in ("full_mask", "n_lanes", "use_fused_sort", "lane_budget",
              "max_key_versions", "arb_slots", "use_heap", "use_wal",
              "use_mega_round"):
        assert getattr(cfg, p) == getattr(ref, p), p


@pytest.mark.parametrize("bad", [dict(n_replicas=0), dict(read_unroll=0),
                                 dict(chain_writes=3),
                                 dict(n_keys=(1 << 29) + 1),
                                 dict(value_words=1)])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        ref_config.HermesConfig(**bad)
    with pytest.raises(ValueError):
        config.HermesConfig(**bad)


MEGA_REFUSED = [dict(arb_mode="race"),
                dict(arb_mode="sort", fused_sort=False),
                dict(arb_mode="sort",
                     n_keys=(ref_config.MEGA_VPTS_VMEM_BYTES // 4) * 2)]


def test_mega_round_refused_loudly():
    """The mega_round configs the reference refuses, the port refuses
    too, with the same message."""
    assert config.MEGA_VPTS_VMEM_BYTES == ref_config.MEGA_VPTS_VMEM_BYTES
    for bad in MEGA_REFUSED:
        with pytest.raises(ValueError, match="mega_round") as ref_err:
            ref_config.HermesConfig(mega_round=True, **bad)
        with pytest.raises(ValueError, match="mega_round") as err:
            config.HermesConfig(mega_round=True, **bad)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [
    dict(arb_mode="sort", mega_round=True),
    dict(arb_mode="sort", mega_round=True, n_sessions=1 << 29,
         ops_per_session=1),
    dict(arb_mode="sort", mega_round=False),
    dict(arb_mode="sort", mega_round=True,
         n_keys=ref_config.MEGA_VPTS_VMEM_BYTES // 4)])
def test_mega_round_config_parity(kw):
    """Accepted mega configs: the same use_mega_round in both packages
    (off when the fused sort does not resolve, as with too many lanes)."""
    ref = ref_config.HermesConfig(**kw)
    cfg = config.HermesConfig(**dataclasses.asdict(ref))
    assert cfg.use_mega_round == ref.use_mega_round
    assert cfg.use_mega_round == (ref.mega_round and ref.use_fused_sort)


def test_bench_cfg_equals_bench_py():
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("bench", root / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for mix in bench.MIXES:
        assert (dataclasses.asdict(config.bench_cfg(mix))
                == dataclasses.asdict(bench._cfg(mix))), mix
    over = dict(n_sessions=1024)
    assert (dataclasses.asdict(config.bench_cfg("a", over))
            == dataclasses.asdict(bench._cfg("a", over)))
