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
              "max_key_versions", "arb_slots", "use_heap", "use_wal"):
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


def test_mega_round_refused_loudly():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        config.HermesConfig(arb_mode="sort", mega_round=True)


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
