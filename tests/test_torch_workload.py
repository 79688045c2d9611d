"""The port's value shapes and op mix (hermes_tpu_torch/workload) and its
host byte codecs (hermes_tpu_torch/transport/codec.py) against the
reference's: ``value_sizes``, ``value_payload``, ``latest_ages`` and
``make_mix`` byte-identical (``tobytes()`` equality) for several seeds and
every distribution; ``rows_to_words`` / ``words_to_rows`` equal on
high-bit bytes in every position."""

import numpy as np
import pytest

from hermes_tpu.transport import codec as ref_codec
from hermes_tpu.workload import openloop as ref_ol
from hermes_tpu.workload import ycsb as ref_ycsb
from hermes_tpu_torch.transport import codec
from hermes_tpu_torch.workload import openloop as ol
from hermes_tpu_torch.workload import ycsb

SEEDS = (0, 3, 17, 2**40 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_value_sizes_equal_reference(seed):
    assert ycsb.VALUE_SIZE_CLASSES == ref_ycsb.VALUE_SIZE_CLASSES
    for spec in (dict(n=4096, max_bytes=1024), dict(n=777, max_bytes=256),
                 dict(n=100), dict(n=50, max_bytes=8),
                 dict(n=300, max_bytes=2048, theta=0.5),
                 dict(n=64, max_bytes=64, classes=(4, 9, 64, 65))):
        got = ycsb.value_sizes(spec, seed)
        want = ref_ycsb.value_sizes(spec, seed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        ycsb.value_sizes(dict(n=4, max_bytes=0), seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_value_payload_equals_reference(seed):
    for i in (0, 1, 7, 12345, 2**31 + 3):
        for n in (0, 1, 2, 3, 4, 5, 15, 16, 17, 100, 1023, 1024, 4095):
            assert ycsb.value_payload(seed, i, n) == \
                ref_ycsb.value_payload(seed, i, n)
    assert ycsb.value_payload(seed, 1, -3) == b""


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_latest_ages_equal_reference(seed):
    assert ycsb.LATEST_WINDOW == ref_ycsb.LATEST_WINDOW
    for theta in (0.99, 0.5):
        got = ycsb.latest_ages(np.random.default_rng(seed), 2000, theta)
        want = ref_ycsb.latest_ages(np.random.default_rng(seed), 2000, theta)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert got.min() >= 0 and got.max() < ycsb.LATEST_WINDOW


@pytest.mark.parametrize("dist", ["uniform", "zipfian", "hotkey", "latest"])
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_make_mix_equals_reference(dist, seed):
    for kw in (dict(read_frac=0.95), dict(read_frac=0.5, rmw_frac=0.3,
                                          value_bytes=512),
               dict(read_frac=0.0, tenants=3, hot_keys=2, zipf_theta=0.7)):
        spec = ol.MixSpec(name=dist, distribution=dist, **kw)
        rspec = ref_ol.MixSpec(name=dist, distribution=dist, **kw)
        for n_keys, n, vw in ((64, 300, 1), (1 << 20, 1000, 4)):
            got = ol.make_mix(spec, n_keys, n, seed, value_words=vw)
            want = ref_ol.make_mix(rspec, n_keys, n, seed, value_words=vw)
            assert sorted(got) == sorted(want)
            for col in want:
                assert got[col].dtype == want[col].dtype, col
                assert got[col].tobytes() == want[col].tobytes(), col
    with pytest.raises(ValueError, match="distribution"):
        ol.make_mix(ol.MixSpec(distribution="nope"), 8, 4, seed)


@pytest.mark.parametrize("shape", [(16,), (5, 3, 16), (1, 4), (7, 40)])
def test_torch_codec_rows_words_equal_reference(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    rows8 = rng.integers(-128, 128, size=shape).astype(np.int8)
    rows8.reshape(-1)[:4] = [-1, -128, 127, 0]
    w = codec.rows_to_words(rows8)
    np.testing.assert_array_equal(w, ref_codec.rows_to_words(rows8))
    assert w.dtype == np.int32 and w.shape == shape[:-1] + (shape[-1] // 4,)
    back = codec.words_to_rows(w)
    np.testing.assert_array_equal(back, rows8)
    np.testing.assert_array_equal(back, ref_codec.words_to_rows(w))
    words = rng.integers(-(1 << 31), 1 << 31, size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(codec.words_to_rows(words),
                                  ref_codec.words_to_rows(words))
    one = np.array([0x11, 0x22, 0x33, -1], np.int8)
    assert int(codec.rows_to_words(one)[0]) == 0xFF332211 - (1 << 32)
