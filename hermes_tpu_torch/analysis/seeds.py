"""Declared bounds of the kernel matrix: for each kernel, the abstract
bound of every argument (the input seeds) and of every output.

The input seeds are the port's copy of the kernel seeds of
``hermes_tpu/analysis/seeds.py``, made from the port's own
``core/layouts.py`` tables and ``config.py``; the tests hold them equal to
the reference's.  The reference derives its output bounds by walking the
kernel's jaxpr.  The port walks nothing: each ``out_*`` below states the
bound, worked out by hand from the kernel's arithmetic and the layouts
tables, as tight as that proves and never tighter, with the derivation in
its docstring.  The differential sanitizer (``analysis/diffcheck.py``)
holds every concrete output inside them.
"""

from __future__ import annotations

import numpy as np

from hermes_tpu_torch.analysis.domain import AbsVal, iv, top
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import layouts
from hermes_tpu_torch.core import types as t

I32_TOP = top(np.int32)
I8_TOP = top(np.int8)
BOOL = iv(0, 1)
I32_MAX = (1 << 31) - 1


def pts_seed(cfg: HermesConfig) -> AbsVal:
    """Any legally minted packed timestamp: ver within the declared budget
    (the ``Meta.max_pts`` watermark and the rebase enforce it), any fc."""
    return iv(0, (layouts.MAX_KEY_VERSIONS << layouts.PTS_FC_BITS)
              | layouts.FC_MASK)


def step_seed(cfg: HermesConfig) -> AbsVal:
    """The round counter, bounded by the declared SST step field (2^28
    rounds)."""
    return iv(0, layouts.MAX_STEPS - 1)


# --------------------------------------------------------------------------
# stats_block
# --------------------------------------------------------------------------


def seed_stats_block() -> list:
    """``stats_block(step, sess_op, invoke_step, commit, abort,
    read_done)``: both steps inside the SST step field, the op code one of
    ``types.OP_NOP..OP_RMW``, three flags."""
    stp = iv(0, layouts.MAX_STEPS - 1)  # == step_seed(cfg) for any cfg
    return [stp, iv(t.OP_NOP, t.OP_RMW), stp, BOOL, BOOL, BOOL]


def out_stats_block(S: int) -> list:
    """``(code, ctr, hist)`` for S sessions a replica.

    * ``code`` is one of ``types.C_NONE..C_RMW_ABORT``: [0, 4].
    * ``hist[r, b]`` counts the committed sessions of replica r whose
      clipped latency is b; each of the S sessions lands in at most one
      bin: [0, S].
    * ``ctr`` is one (R, STATS_CTR.width) tensor, so its bound covers all
      its rows.  The five counting rows and the padding lie in [0, S].
      ``lat_sum`` adds ``step - invoke_step`` over the committed sessions;
      with the two steps drawn independently in [0, MAX_STEPS) each term
      lies in [-(MAX_STEPS-1), MAX_STEPS-1] and the sum of S of them in
      S times that.  For S >= 9 that leaves int32 and the sum WRAPS, so the
      row, and with it the tensor, is dtype-TOP; for S <= 8 it is the
      interval itself.  (In a run ``invoke_step <= step`` holds and the
      sum is small; the declared inputs do not say so, and no bound here
      is tighter than its inputs prove.)"""
    worst = S * (layouts.MAX_STEPS - 1)
    ctr = iv(-worst, max(worst, S)) if worst <= I32_MAX else I32_TOP
    return [iv(t.C_NONE, t.C_RMW_ABORT), ctr, iv(0, S)]


# --------------------------------------------------------------------------
# scan_acc (the scan-accumulate sentinel)
# --------------------------------------------------------------------------

SCAN_ACC_IN = iv(0, 100)


def seed_scan_acc() -> list:
    """``scan_acc(x)``: the sentinel's declared input, [0, 100]."""
    return [SCAN_ACC_IN]


def out_scan_acc(M: int) -> list:
    """The column sums of M rows in [lo, hi] lie in [M lo, M hi]: [0, 1600]
    at the sentinel's 16 rows (no wrap: far inside int32).  This is the
    bound a loop analysis must reach by widening: one pass of the loop
    body gives [0, 100], which the sentinel's draws escape."""
    if M * SCAN_ACC_IN.hi > I32_MAX:
        return [I32_TOP]
    return [iv(M * SCAN_ACC_IN.lo, M * SCAN_ACC_IN.hi)]


# --------------------------------------------------------------------------
# the mega round's kernels
# --------------------------------------------------------------------------


def _lane_word_hi() -> int:
    return (layouts.LANE_WORD.field("taken").mask
            | layouts.LANE_WORD.field("issue").mask
            | layouts.LANE_WORD.field("chain_rank").mask)


def seed_mega_route(cfg: HermesConfig) -> list:
    """``mega_route(si, word, srank)``: si a lane id ([0, n_lanes)), word
    the packed per-lane verdict (``layouts.LANE_WORD`` fields), srank the
    slot rank ([0, 2 n_lanes]: the kernel drops the ranks past the
    budget)."""
    L = cfg.n_lanes
    return [iv(0, L - 1), iv(0, _lane_word_hi()), iv(0, 2 * L)]


def out_mega_route(cfg: HermesConfig) -> list:
    """``(lane_word, slot_lane)``.  Both are zero-filled first.  Every
    element of ``lane_word`` is then 0 or one of the input words, so it
    keeps the word's bound, [0, taken | issue | chain_rank masks].  Every
    element of ``slot_lane`` is 0 or a lane id clipped to [0, n_lanes-1]."""
    return [iv(0, _lane_word_hi()), iv(0, cfg.n_lanes - 1)]


def seed_mega_apply(cfg: HermesConfig) -> list:
    """``mega_apply(vpts, keys, pts, mask)``: keys span the whole 29-bit
    WIRE field on purpose (the sharded path feeds untrusted inbound keys:
    the kernel must drop and clamp them, and the sanitizer draws them)."""
    return [pts_seed(cfg), iv(0, layouts.INV_PKF.field("key").cap - 1),
            pts_seed(cfg), BOOL]


def out_mega_apply(cfg: HermesConfig) -> list:
    """``(vpts, post)``.  ``vpts[k]`` ends as the maximum of its old value
    and the ``pts`` of some rows, all inside the packed-timestamp bound, so
    it stays inside it; ``post[m]`` is one element of that column.  A key
    outside [0, K) changes neither: it is dropped from the maximum and
    clamped for the read."""
    return [pts_seed(cfg), pts_seed(cfg)]


def seed_mega_replay(cfg: HermesConfig) -> list:
    """The mega_replay cell's arguments (step, active, frozen, bank, vpts,
    key, pts, acks, val): the same sources as the replay and table rows of
    the round's state."""
    key = iv(0, cfg.n_keys - 1)
    return [step_seed(cfg), BOOL, BOOL, I8_TOP, pts_seed(cfg), key,
            pts_seed(cfg), iv(0, cfg.full_mask), I8_TOP]


def out_mega_replay(cfg: HermesConfig) -> list:
    """``(bank, active, key, pts, acks, val)``.  The bank and the value
    bytes are opaque (int8 TOP in, int8 TOP out; the re-stamped sst bytes
    are any bytes too).  Each slot either keeps its old fields or is
    taken: ``active`` a flag; ``key`` the old key or ``row mod n_keys``,
    [0, n_keys-1]; ``pts`` the old one or ``vpts[row]``, both inside the
    packed-timestamp bound; ``acks`` the old bitmap or 0, [0, full_mask]."""
    return [I8_TOP, BOOL, iv(0, cfg.n_keys - 1), pts_seed(cfg),
            iv(0, cfg.full_mask), I8_TOP]
