"""Op streams and the bank byte codec of the port against the reference.

* ``make_streams`` gives identical arrays in both packages;
* the counter-hash device stream (torch, int64 words) is bit-exact
  against the reference's host twin ``ycsb.device_stream_host`` for
  uniform keys; the port's numpy host twin is bit-exact for zipfian too
  (same float32 numpy math);
* the int32 <-> int8 bank codec round-trips and matches the reference's
  bytes, including sign bytes.

Tolerance everywhere: exact equality (all integer).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.core import faststep as ref_fst
from hermes_tpu.workload import ycsb as ref_ycsb
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.workload import ycsb

torch.set_num_threads(1)


def _pair(**kw):
    ref = RefConfig(**kw)
    return ref, HermesConfig(**dataclasses.asdict(ref))


@pytest.mark.parametrize("wl", [
    dict(read_frac=0.5, seed=3),
    dict(read_frac=0.3, rmw_frac=0.6, seed=4),
    dict(read_frac=0.5, distribution="zipfian", zipf_theta=0.99, seed=5),
])
def test_make_streams_identical(wl):
    ref_cfg, cfg = _pair(n_replicas=3, n_keys=512, n_sessions=16,
                         ops_per_session=24, workload=RefWL(**wl))
    ref = ref_ycsb.make_streams(ref_cfg)
    got = ycsb.make_streams(cfg)
    np.testing.assert_array_equal(ref.op, got.op)
    np.testing.assert_array_equal(ref.key, got.key)
    assert got.op.dtype == np.int32 and got.key.dtype == np.int32


def _grid(R, S, G, base=0):
    r, s, g = np.meshgrid(np.arange(R), np.arange(S),
                          np.arange(base, base + G), indexing="ij")
    return r, s, g


@pytest.mark.parametrize("seed,rmw", [(5, 0.0), (11, 0.4)])
def test_device_stream_hash_bit_exact_uniform(seed, rmw):
    ref_cfg, cfg = _pair(n_replicas=4, n_keys=512, n_sessions=32,
                         ops_per_session=8, device_stream=True,
                         workload=RefWL(read_frac=0.5, rmw_frac=rmw, seed=seed))
    # op indices far past any int16 boundary exercise the full uint32 words
    r, s, g = _grid(4, 32, 40, base=(1 << 20) - 7)
    rop, rkey = ref_ycsb.device_stream_host(
        ref_cfg, r.astype(np.uint32), s.astype(np.uint32), g.astype(np.uint32))
    read_t, rmw_t = ycsb.device_stream_params(cfg)
    u_op, u_rmw, key = ycsb.stream_hash(
        cfg, *(torch.from_numpy(a.astype(np.int64)) for a in (r, s, g)))
    op = torch.full_like(u_op, 2)
    op = torch.where(u_rmw < rmw_t, 3, op)
    op = torch.where(u_op < read_t, 1, op)
    np.testing.assert_array_equal(rop, op.numpy())
    np.testing.assert_array_equal(rkey, key.numpy())
    # the port's own numpy host twin is the same formula
    hop, hkey = ycsb.device_stream_host(cfg, r, s, g)
    np.testing.assert_array_equal(rop, hop)
    np.testing.assert_array_equal(rkey, hkey)


def test_device_stream_host_twin_bit_exact_zipfian():
    ref_cfg, cfg = _pair(n_replicas=3, n_keys=1 << 12, n_sessions=16,
                         ops_per_session=8, device_stream=True,
                         workload=RefWL(read_frac=0.5, distribution="zipfian",
                                        seed=7))
    r, s, g = _grid(3, 16, 64)
    rop, rkey = ref_ycsb.device_stream_host(
        ref_cfg, r.astype(np.uint32), s.astype(np.uint32), g.astype(np.uint32))
    hop, hkey = ycsb.device_stream_host(cfg, r, s, g)
    np.testing.assert_array_equal(rop, hop)
    np.testing.assert_array_equal(rkey, hkey)
    # the torch path agrees with the twin statistically (float32 pow may
    # round a rank boundary differently): the same hot keys dominate
    _, _, tkey = ycsb.stream_hash(
        cfg, *(torch.from_numpy(a.astype(np.int64)) for a in (r, s, g)))
    agree = float((tkey.numpy() == hkey).mean())
    assert agree > 0.99, agree


def test_bank_codec_roundtrip_and_reference_bytes():
    rng = np.random.default_rng(9)
    words = rng.integers(-(1 << 31), 1 << 31, (5, 7, 6), dtype=np.int64)
    words = words.astype(np.int32)
    words[0, 0] = [0, -1, -(1 << 31), (1 << 31) - 1, 0x00800080, -0x7F7F7F80]
    bank = fst._i32_to_bank(torch.from_numpy(words))
    assert bank.dtype == torch.int8 and bank.shape == (5, 7, 24)
    np.testing.assert_array_equal(
        np.asarray(ref_fst._i32_to_bank(jnp.asarray(words))), bank.numpy())
    back = fst._bank_to_i32(bank)
    np.testing.assert_array_equal(words, back.numpy())
    np.testing.assert_array_equal(
        np.asarray(ref_fst._bank_to_i32(jnp.asarray(bank.numpy()))), words)
    # the arithmetic byte order is little-endian: on a little-endian host a
    # raw view agrees (the codec never relies on it)
    if np.little_endian:
        np.testing.assert_array_equal(bank.view(torch.int32).numpy(), words)
