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
holds every concrete output inside them, and the round analysis
(``analysis/passes.py``, ``HandKernelPass``) holds every hand-kernel call
of a traced round to them through ``KERNELS``.

The round seeds (``seed_round_args``) are the port's copy of the
reference's: one ``AbsVal`` per tensor leaf of the round's ``(fs, stream,
ctl)``, mirroring the state containers field by field, so a renamed or
added state field breaks the structure match loudly.  Facts that are
PROTOCOL invariants rather than config facts (a winner-row pts mirror
holds a watermark-bounded ts) are deliberately not seeded: the engine
audits those sites (``layouts.audited``), so the assumption shows in the
findings.  A leaf that is a host value (``FastCtl.host_step``,
``quiesce``) is fixed by the trace and seeded ``HOST``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from hermes_tpu_torch.analysis.domain import AbsVal, iv, top
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import layouts
from hermes_tpu_torch.core import types as t

I32_TOP = top(np.int32)
I8_TOP = top(np.int8)
U8_TOP = top(np.uint8)
BOOL = iv(0, 1)
I32_MAX = (1 << 31) - 1
COUNTER = iv(0, I32_MAX)  # monotone device counters (non-negative)
#: the seed of a round argument leaf that is a host value, not a tensor
HOST = "host"


def pts_seed(cfg: HermesConfig) -> AbsVal:
    """Any legally minted packed timestamp: ver within the declared budget
    (the ``Meta.max_pts`` watermark and the rebase enforce it), any fc."""
    return iv(0, (layouts.MAX_KEY_VERSIONS << layouts.PTS_FC_BITS)
              | layouts.FC_MASK)


def step_seed(cfg: HermesConfig) -> AbsVal:
    """The round counter, bounded by the declared SST step field (2^28
    rounds)."""
    return iv(0, layouts.MAX_STEPS - 1)


def op_idx_seed(cfg: HermesConfig) -> AbsVal:
    """Per-session op counter.  Clip mode tops out at ops_per_session;
    wrap mode grows until the write-uid formula op_idx*S + s would leave
    int31, the budget the config documents and validates."""
    if cfg.wrap_stream:
        return iv(0, max(cfg.ops_per_session,
                         (1 << 31) // max(1, cfg.n_sessions) - 1))
    return iv(0, cfg.ops_per_session)


# --------------------------------------------------------------------------
# the round's arguments
# --------------------------------------------------------------------------


def seed_fast_state(cfg: HermesConfig):
    """A ``FastState`` of seeds, one per leaf (either table layout: the
    bounds do not depend on it)."""
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core import state as st

    key = iv(0, cfg.n_keys - 1)
    pts = pts_seed(cfg)
    stp = step_seed(cfg)
    acks = iv(0, cfg.full_mask)
    meta = st.Meta(
        last_seen=stp, suspect_age=stp, n_read=COUNTER, n_write=COUNTER,
        n_rmw=COUNTER, n_abort=COUNTER, lat_sum=COUNTER, lat_cnt=COUNTER,
        lat_hist=COUNTER, max_pts=pts, n_inv=COUNTER, n_rebcast=COUNTER,
        n_nack=COUNTER, n_retry=COUNTER,
        replay_peak=iv(0, cfg.replay_slots), qwait_sum=COUNTER,
        qwait_hist=COUNTER,
    )
    return fst.FastState(
        table=fst.FastTable(vpts=pts, bank=I8_TOP),
        sess=fst.FastSess(
            status=iv(t.S_IDLE, t.S_DONE),
            op=iv(t.OP_NOP, t.OP_RMW),
            op_idx=op_idx_seed(cfg),
            key=key,
            val=I8_TOP,
            pts=pts,
            acks=acks,
            rd_val=I8_TOP,
            invoke_step=stp,
            retries=iv(0, max(1, cfg.rmw_retries)),
            issue_step=stp,
        ),
        replay=fst.FastReplay(active=BOOL, key=key, pts=pts, val=I8_TOP,
                              acks=acks),
        meta=meta,
    )


def seed_stream(cfg: HermesConfig, has_uval: bool = False):
    from hermes_tpu_torch.core import state as st

    return st.OpStream(op=iv(t.OP_NOP, t.OP_RMW), key=iv(0, cfg.n_keys - 1),
                       uval=I8_TOP if has_uval else None)


def seed_fast_ctl(cfg: HermesConfig):
    from hermes_tpu_torch.core import faststep as fst

    return fst.FastCtl(
        step=step_seed(cfg),
        host_step=HOST,
        my_cid=iv(0, cfg.n_replicas - 1),
        epoch=iv(0, layouts.BLOCK_META.field("epoch").cap - 1),
        live_mask=iv(0, cfg.full_mask),
        frozen=BOOL,
        quiesce=HOST,
    )


def seed_round_args(cfg: HermesConfig, has_uval: bool = False) -> tuple:
    """(fs, stream, ctl) seed trees, structure-matched to the round's
    arguments."""
    return (seed_fast_state(cfg), seed_stream(cfg, has_uval),
            seed_fast_ctl(cfg))


def seed_heap_gather(cfg: HermesConfig, batch: int = 1024) -> list:
    """Bounds for the extent gather (``heap/core.build_extent_gather``'s
    ``(log, refs)``): the log bytes are opaque (the port's log is uint8,
    so U8_TOP where the reference's int8 log has I8_TOP) and the refs span
    the FULL declared HEAP_REF word: refs arrive from table rows a wire
    could have corrupted, so the gather must clamp every derived byte
    index into the log, and the analysis proves its index in bounds from
    exactly this hull."""
    hi = (layouts.HEAP_REF.field("gran").mask
          | layouts.HEAP_REF.field("len").mask)
    return [U8_TOP, iv(0, hi)]


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


# --------------------------------------------------------------------------
# the hand kernels of the round, as the round analysis checks them
# --------------------------------------------------------------------------


class KernelDecl(NamedTuple):
    """What the round analysis holds a hand-kernel node to
    (``analysis/passes.py``, ``HandKernelPass``).  ``seeds(cfg)`` and
    ``outs(cfg, shapes)`` give one bound per tensor argument and output of
    the node, in the node's order (``analysis/graph.py``); ``shapes`` are
    the argument shapes.  ``hazard`` is ``(code, what)``: the access
    pattern of the kernel that its call site must declare with
    ``layouts.audited`` (the reference's ``grid-revisit-accumulator``
    discipline for its ``pallas_call`` sites)."""

    seeds: Callable
    outs: Callable
    hazard: tuple


KERNELS = {
    "stats_block": KernelDecl(
        lambda cfg: seed_stats_block(),
        lambda cfg, shapes: out_stats_block(shapes[1][1]),
        ("grid-revisit-accumulator",
         "ctr and hist are accumulated across the CTAs of each replica's "
         "cluster")),
    "mega_route": KernelDecl(
        seed_mega_route, lambda cfg, shapes: out_mega_route(cfg),
        ("scatter-set-not-injective",
         "the route-back stores each lane's word and each slot's lane at "
         "data-dependent targets: a repeated target keeps any one writer")),
    "mega_apply": KernelDecl(
        seed_mega_apply, lambda cfg, shapes: out_mega_apply(cfg),
        ("grid-revisit-accumulator",
         "vpts is max-accumulated in phase 0 and read back in phase 1 "
         "across a grid barrier")),
    "mega_replay": KernelDecl(
        seed_mega_replay, lambda cfg, shapes: out_mega_replay(cfg),
        ("grid-revisit-accumulator",
         "the stuck-row counts are accumulated across the table's spans and "
         "each span ranks its rows after the counts before it")),
}


#: The value an audited scope produces, where its audit states a bound: the
#: interpreter gives each node of the scope whose value leaves the scope
#: this bound (met with what it derived), so the audited assumption flows
#: on instead of a TOP, and reports it as an ``audited-bound`` info
#: finding.  A minted packed timestamp is a legal one: its ver is bounded
#: by the ``max_pts`` watermark and the rebase, and an inbound one was
#: minted so by its source (the sharded round decodes it from wire bytes,
#: which keep no bound).
AUDIT_BOUNDS = {
    "pts-mint-ver-bounded-by-watermark": pts_seed,
    "wire-pts-minted-under-watermark": pts_seed,
}
