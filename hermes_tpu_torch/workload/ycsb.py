"""YCSB-style op streams and value shapes: the port of
``hermes_tpu/workload/ycsb.py``'s stream side and its value-size draws
(``value_sizes``, ``value_payload``, ``latest_ages``).

Two sources feed the fast engine.  ``make_streams`` pre-generates each
replica's (S, G) op stream host-side with numpy (the same generator calls
as the reference, so the arrays are identical).  With
``cfg.device_stream`` the round instead evaluates a stateless counter hash
of (replica, session, op index) on the device, inside the intake
(``core/faststep._coordinate``).

The hash is written ONCE, on int64 values that hold uint32 words (this
torch has no uint32 ``>>``): ``stream_hash`` runs unchanged on numpy int64
arrays (the host twin, ``device_stream_host``) and on torch int64 tensors
(the round).  Products are taken mod 2^32 by splitting the constant into
16-bit halves, so no intermediate leaves int64.  Uniform keys are
bit-exact against the reference's uint32 formula; the zipfian rank adds
float32 ``pow``, whose last-ULP rounding may differ between libraries, so
zipfian streams agree with the reference only statistically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.core.state import OpStream

_M32 = 0xFFFFFFFF


def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    """CDF of the Zipfian(theta) distribution over ranks 1..n."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def scrambled_zipfian(
    rng: np.random.Generator, n_keys: int, theta: float, scramble_seed: int,
    size,
) -> np.ndarray:
    """Scrambled-zipfian key draw (YCSB): rank by the Zipfian(theta) CDF,
    then spread the hot ranks over the key space with a fixed permutation
    keyed off ``scramble_seed``."""
    cdf = _zipf_cdf(n_keys, theta)
    ranks = np.searchsorted(cdf, rng.random(size=size))
    perm = np.random.default_rng(scramble_seed ^ 0x5CA1AB1E).permutation(n_keys)
    return perm[ranks]


# The read-heavy YCSB mixes (B, C, D), the one table the serving
# scenario matrix (workload.openloop.scenario_matrix) reads.
READ_MIXES = {
    "b": dict(read_frac=0.95, rmw_frac=0.0, distribution="zipfian"),
    "c": dict(read_frac=1.0, rmw_frac=0.0, distribution="zipfian"),
    "d": dict(read_frac=0.95, rmw_frac=0.0, distribution="latest"),
}

# The recency horizon of the 'latest' draw (YCSB-D): reads rank the last
# this-many writes by a Zipfian(theta) over age.
LATEST_WINDOW = 1024

# Memcached-shaped value-size classes (bytes) of the value heap's
# workload: a Zipfian over ASCENDING classes, so the smallest class is the
# most probable and the tail reaches into KBs.
VALUE_SIZE_CLASSES = (16, 32, 64, 128, 256, 512, 1024, 2048)


def value_sizes(spec: dict, seed: int) -> np.ndarray:
    """Seeded value-size draw: ``spec`` is ``{"n": count, "max_bytes":
    cap, "classes": sizes?, "theta": t?}``, a Zipfian(theta) over the
    size classes <= cap.  Same (spec, seed) => byte-identical array.
    Returns (n,) int64 byte lengths."""
    n = int(spec["n"])
    cap = int(spec.get("max_bytes", VALUE_SIZE_CLASSES[-1]))
    if cap < 1:
        raise ValueError("max_bytes must be >= 1")
    classes = tuple(c for c in spec.get("classes", VALUE_SIZE_CLASSES)
                    if c <= cap)
    if not classes:
        classes = (cap,)
    theta = float(spec.get("theta", 0.99))
    rng = np.random.default_rng(
        (int(seed) * 0xA24BAED4963EE407 + 5) & 0xFFFFFFFFFFFFFFFF)
    cdf = _zipf_cdf(len(classes), theta)
    ranks = np.searchsorted(cdf, rng.random(size=n))
    return np.asarray(classes, np.int64)[ranks]


def value_payload(seed: int, i: int, nbytes: int) -> bytes:
    """Deterministic payload bytes of op ``i``: the stream hash's
    ``_mix32`` over word indices, so a checked run recomputes any op's
    bytes from (seed, op index, length).  ``_mix32`` runs here on numpy
    int64 arrays of uint32 words; the words go out as native uint32."""
    if nbytes <= 0:
        return b""
    idx = np.arange((nbytes + 3) // 4, dtype=np.int64)
    salt = (seed * 0x9E3779B9 + i * 0x85EBCA6B) & _M32
    words = _mix32(idx ^ salt)
    return words.astype(np.uint32).tobytes()[:nbytes]


def latest_ages(rng: np.random.Generator, n: int, theta: float = 0.99
                ) -> np.ndarray:
    """Zipfian(theta) age draws in [0, LATEST_WINDOW): age 0 = the most
    recent write.  Callers clamp to the writes that exist yet."""
    cdf = _zipf_cdf(LATEST_WINDOW, theta)
    return np.searchsorted(cdf, rng.random(size=n)).astype(np.int64)


def sample_keys(
    rng: np.random.Generator, cfg: HermesConfig, size: tuple[int, ...]
) -> np.ndarray:
    wl = cfg.workload
    if wl.distribution == "uniform":
        return rng.integers(0, cfg.n_keys, size=size, dtype=np.int32)
    if wl.distribution == "zipfian":
        return scrambled_zipfian(rng, cfg.n_keys, wl.zipf_theta, wl.seed,
                                 size).astype(np.int32)
    raise ValueError(f"unknown distribution {wl.distribution!r}")


def make_stream(cfg: HermesConfig, replica: int) -> OpStream:
    """Pre-generate one replica's (S, G) op stream (numpy leaves)."""
    wl = cfg.workload
    rng = np.random.default_rng((wl.seed << 8) ^ replica)
    shape = (cfg.n_sessions, cfg.ops_per_session)
    u = rng.random(size=shape)
    op = np.where(u < wl.read_frac, t.OP_READ, t.OP_WRITE).astype(np.int32)
    if wl.rmw_frac > 0:
        is_upd = op == t.OP_WRITE
        rmw = rng.random(size=shape) < wl.rmw_frac
        op = np.where(is_upd & rmw, t.OP_RMW, op).astype(np.int32)
    key = sample_keys(rng, cfg, shape)
    return OpStream(op=op, key=key)


def make_streams(cfg: HermesConfig) -> OpStream:
    """All replicas' streams stacked on a leading R axis, (R, S, G) int32
    numpy leaves; ``core.faststep.prep_stream`` places them on a device."""
    parts = [make_stream(cfg, r) for r in range(cfg.n_replicas)]
    return OpStream(op=np.stack([p.op for p in parts]),
                    key=np.stack([p.key for p in parts]))


def stub_stream(cfg: HermesConfig) -> OpStream:
    """Placeholder stream for device_stream runs (never read; keeps the
    round's signature uniform)."""
    z = np.zeros((cfg.n_replicas, cfg.n_sessions, 1), np.int32)
    return OpStream(op=z, key=z)


# --------------------------------------------------------------------------
# Counter-hash op stream: one formula for numpy int64 arrays and torch
# int64 tensors, each value a uint32 word in [0, 2^32).
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for uint32 words ``x`` held in int64 and a
    uint32 constant ``c``: the constant is split into 16-bit halves so
    every partial product stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """xxhash-style avalanche on uint32 words (the reference's _mix32)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def device_stream_params(cfg: HermesConfig):
    """Thresholds the hash is compared against (16-bit fixed point)."""
    wl = cfg.workload
    return int(wl.read_frac * 65536), int(wl.rmw_frac * 65536)


@functools.lru_cache(maxsize=None)
def _zipf_consts(n: int, theta: float):
    """Constants of the YCSB analytic Zipfian inverse (Gray et al.):
    float64 precompute, returned as float32, as in the reference."""
    chunk = 1 << 22
    zetan = 0.0
    for lo in range(1, n + 1, chunk):
        ranks = np.arange(lo, min(n + 1, lo + chunk), dtype=np.float64)
        zetan += float(np.sum(ranks ** -theta))
    zeta2 = 1.0 + 0.5 ** theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    return (np.float32(zetan), np.float32(zeta2), np.float32(eta),
            np.float32(alpha))


def _zipf_rank(cfg: HermesConfig, kh):
    """uint32 hash word (int64) -> Zipfian rank (0 = hottest), float32
    elementwise math on numpy or torch."""
    zetan, zeta2, eta, alpha = (float(c) for c in
                                _zipf_consts(cfg.n_keys, cfg.workload.zipf_theta))
    if isinstance(kh, torch.Tensor):
        u = (kh >> 8).to(torch.float32) * (2.0 ** -24)
        tail = float(cfg.n_keys) * torch.pow(eta * u - eta + 1.0, alpha)
        rank = torch.where(u * zetan < 1.0, torch.zeros_like(u),
                           torch.where(u * zetan < zeta2,
                                       torch.ones_like(u), tail))
        return rank.clamp(max=float(cfg.n_keys - 1)).to(torch.int64)
    f32 = np.float32
    u = (kh >> 8).astype(f32) * f32(2.0 ** -24)
    tail = f32(cfg.n_keys) * (f32(eta) * u - f32(eta) + f32(1.0)) ** f32(alpha)
    rank = np.where(u * f32(zetan) < f32(1.0), f32(0.0),
                    np.where(u * f32(zetan) < f32(zeta2), f32(1.0), tail))
    return np.minimum(rank, f32(cfg.n_keys - 1)).astype(np.int64)


def stream_hash(cfg: HermesConfig, replica, session, op_idx):
    """The counter-hash op stream: (u_op, u_rmw, key) as uint32 words in
    int64, from broadcastable int64 (replica, session, op_idx) arrays or
    tensors."""
    seed_mixed = (cfg.workload.seed * 0x9E3779B9) & _M32
    base = _mix32(seed_mixed ^ _mix32(
        _mul32(replica, 0x85EBCA6B)
        ^ _mix32(_mul32(session, 0xC2B2AE35) ^ op_idx)))
    u_op = base & 0xFFFF
    u_rmw = (base >> 16) & 0xFFFF
    kh = _mix32(base ^ 0x27220A95)
    if cfg.workload.distribution == "zipfian":
        # scrambled zipfian: hash the rank over the power-of-two key space
        rank = _zipf_rank(cfg, kh)
        key = _mix32(_mul32(rank, 0x9E3779B1) ^ 0x1B873593) & (cfg.n_keys - 1)
    else:
        key = kh & (cfg.n_keys - 1)
    return u_op, u_rmw, key


def device_stream_host(cfg: HermesConfig, replica, session, op_idx):
    """Host twin of the device stream: (op, key) int32 numpy arrays for
    broadcastable non-negative index arrays."""
    read_t, rmw_t = device_stream_params(cfg)
    as64 = lambda a: np.asarray(a).astype(np.int64) & _M32
    u_op, u_rmw, key = stream_hash(cfg, as64(replica), as64(session),
                                   as64(op_idx))
    op = np.where(u_op < read_t, t.OP_READ,
                  np.where(u_rmw < rmw_t, t.OP_RMW, t.OP_WRITE)).astype(np.int32)
    return op, key.astype(np.int32)
