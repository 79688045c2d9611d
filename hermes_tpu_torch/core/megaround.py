"""The mega round's three kernels: ``mega_route``, ``mega_apply`` and
``mega_replay``.

Port of ``hermes_tpu/core/megaround.py``.  With ``cfg.use_mega_round`` the
batched round (core/faststep.py) swaps three of its parts for them:

* the fused sort's route-back scatter -> ``mega_route``;
* the arbiter scatter-max into ``vpts`` and the post-arbiter verdict
  gather of ``_derived_acks`` -> ``mega_apply``;
* the gated stuck-key replay scan -> ``mega_replay``.

Each replaces a Pallas kernel with a CUDA kernel written for Hopper
(``csrc/mega_route.cu``, ``csrc/mega_apply.cu``, ``csrc/mega_replay.cu``,
built by ``build.py`` and loaded with ctypes); the source notes there and
the docstrings below say what bounds each one on the card and what its
design does about it.  The results are the reference's bit for bit: all
state is integer, and the only atomics are integer maxima.

Dispatch, as for ``kernels.stats_block``: a CPU tensor goes to the
function's plain version (``mega_*_plain``), a CUDA tensor launches the
kernel or raises.  ``cfg.use_mega_round`` alone decides whether the round
calls these: the port has no counterpart of the reference's ``resolve``
(kernel self-test, analyzer verdict) and no fallback to the fused-sort
program.  ``.launches`` on each wrapper counts the calls that launched its
kernel, one per call; each call is one device operation.

The engine's table carries one trailing drop row (core/faststep.py); the
round passes its first ``cfg.n_keys`` rows (``vpts[:K]``, ``bank[:K]``,
contiguous views), so ``K`` here is the reference's and the in-place
updates land in the table.  The sharded round (one table copy a replica,
each with its own drop row) calls ``mega_apply`` once a round over the
flat table of every copy, each replica's keys offset into its copy and a
wire key at or above the copy's K masked out and clamped to its K-1, and
``mega_replay`` once a copy on that copy's K-row view.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hermes_tpu_torch.core import layouts
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.core.dispatch import (CLUSTER_MAX, SMEM_BYTES_MAX, SMS,
                                            cdiv, hand_kernel, launch, need,
                                            on_card, out)

I32 = torch.int32
I32_MIN = -(1 << 31)

# bank row byte offsets of [pts | sst | val words] (faststep's BANK_* word
# indices times 4; importing faststep here would cycle)
_SST_OFF, _VAL_OFF = 4, 8
_STEP_SHIFT = layouts.SST.field("step").shift
_STATE_MASK = layouts.SST.field("state").mask


def _step_tensor(name: str, step, dev):
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=I32, device=dev)
    if step.dtype != I32 or step.numel() != 1 or step.device != dev:
        raise TypeError(f"{name}: step must be a one-element int32 tensor on "
                        f"{dev}, got {step.dtype} {tuple(step.shape)} on "
                        f"{step.device}")
    return step


# --------------------------------------------------------------------------
# mega_route: the fused sort's route-back scatter
# --------------------------------------------------------------------------


def mega_route_plain(cfg, si, word, srank):
    """``lane_word[r, clip(si)] = word`` and, where ``0 <= srank < C``,
    ``slot_lane[r, srank] = clip(si)``, over zeros.  Exact on the inputs
    the round gives it: ``si`` a permutation of each row, ``srank`` a
    bijection, so no target is written twice."""
    R, L = si.shape
    C = cfg.lane_budget
    lane = si.clamp(0, L - 1)
    lane_word = torch.zeros((R, L), dtype=I32, device=si.device).scatter_(
        1, lane.long(), word)
    tgt = torch.where((srank >= 0) & (srank < C), srank, C).long()
    slot_lane = torch.zeros((R, C + 1), dtype=I32, device=si.device).scatter_(
        1, tgt, lane)
    return lane_word, slot_lane[:, :C].contiguous()


#: the cluster size a row takes when it needs no more passes than with
#: the largest: on an H100 at the bench shape, clusters of 8 did the
#: route-back faster than clusters of 16 (PERF.md, the B2 row)
ROUTE_CLUSTER_PREFERRED = 8
#: the largest cluster mega_route may take: None leaves it to route_plan;
#: a size forces it (chip_smoke.py times 16 against 8)
ROUTE_CLUSTER = None
#: the least bytes of windows a CTA holds before a row takes more CTAs
ROUTE_MIN_WINDOW_BYTES = 4096


def _up4(n: int) -> int:
    return (n + 3) & ~3


class RoutePlan(NamedTuple):
    """``mega_route.cu``'s launch geometry: a cluster of ``cluster`` CTAs a
    replica row; ``passes`` passes, each holding ``cluster`` windows of
    ``wl`` lanes of ``lane_word`` and ``wc`` slots of ``slot_lane`` (the
    window ``pass * cluster + rank`` in CTA ``rank``'s shared memory); ``ps``
    positions of the row a CTA reads."""
    cluster: int
    passes: int
    wl: int
    wc: int
    ps: int

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.wl + self.wc)


def _route_windows(L: int, C: int, q: int):
    """(passes, wl, wc): as few passes as keep a CTA's two windows (each a
    multiple of 4 words, for the 16-byte write-out) within the card's
    shared memory."""
    passes = 1
    while True:
        wl = max(4, _up4(cdiv(L, q * passes)))
        wc = _up4(cdiv(C, q * passes))
        if 4 * (wl + wc) <= SMEM_BYTES_MAX:
            return passes, wl, wc
        passes += 1


@functools.lru_cache(maxsize=64)
def route_plan(R: int, L: int, C: int, cluster=None) -> RoutePlan:
    """The window plan of an (R, L) route-back with C slots: as many CTAs
    a row as give each at least ``ROUTE_MIN_WINDOW_BYTES`` of windows, at
    most ``cluster`` (default: the card's largest); of that size and
    ``ROUTE_CLUSTER_PREFERRED``, the one with fewer passes over the
    positions, the smaller on a tie (``cluster`` given: that size).  ``R``
    does not change it: one cluster a row."""
    top = CLUSTER_MAX if cluster is None else cluster
    if R < 1 or L < 1 or C < 0 or not 1 <= top <= CLUSTER_MAX:
        raise ValueError(f"route_plan: no plan for R={R} L={L} C={C} "
                         f"cluster={cluster}")
    q = max(1, min(top, cdiv(4 * (L + C), ROUTE_MIN_WINDOW_BYTES)))
    sizes = [q] if cluster is not None else sorted(
        {min(q, ROUTE_CLUSTER_PREFERRED), q})
    plans = [RoutePlan(n, *_route_windows(L, C, n), _up4(cdiv(L, n)))
             for n in sizes]
    return min(plans, key=lambda plan: plan.passes)


@hand_kernel(audit="mega-route-unique-targets")
def mega_route(cfg, si, word, srank):
    """Per-lane verdict route-back and slot ownership of the fused sort:
    returns ``(lane_word (R, L), slot_lane (R, C))`` from the (R, L) int32
    sorted lane ids ``si``, verdict words ``word`` and slot ranks
    ``srank``.

    Replaces ``hermes_tpu/core/megaround.py:mega_route`` (Pallas
    ``_route_kernel``).  Bound by memory: three int32 reads per lane and
    one int32 store per lane and slot, ~10 MB at the bench shape.  The
    Pallas kernel walks the lanes serially; the CUDA kernel gives each
    replica row a thread-block cluster whose CTAs hold the row's outputs
    in shared memory, in equal windows (``route_plan``): the scatter lands
    there through distributed shared memory, and each window goes out in
    one coalesced pass, so a call is one device operation.  Exact on the
    round's inputs, whose targets are unique (see ``mega_route_plain``)."""
    name = "mega_route"
    need(name, "si", si, I32)
    R, L = si.shape
    need(name, "word", word, I32, (R, L))
    need(name, "srank", srank, I32, (R, L))
    if not on_card(name, si, word, srank):
        return mega_route_plain(cfg, si, word, srank)
    C = cfg.lane_budget
    lane_word = out((R, L), I32, si.device)
    slot_lane = out((R, C), I32, si.device)
    if R and L:
        plan = route_plan(R, L, C, ROUTE_CLUSTER)
        launch(name, si.device, si, word, srank, lane_word, slot_lane,
               R, L, C, plan.cluster, plan.passes, plan.wl, plan.wc, plan.ps)
        mega_route.launches += 1
    return lane_word, slot_lane


mega_route.launches = 0


# --------------------------------------------------------------------------
# mega_apply: arbiter scatter-max + verdict read-back
# --------------------------------------------------------------------------


def mega_apply_plain(cfg, vpts, keys, pts, mask):
    """Scatter-max of every masked row's ``pts`` into ``vpts[key]`` for
    keys in [0, K) (others are dropped), in place; then ``post[m] =
    vpts[clip(key, 0, K-1)]`` for every row.  Returns ``(vpts, post)``."""
    K = vpts.shape[0]
    k = keys.reshape(-1)
    kc = k.clamp(0, K - 1).long()
    ok = mask.reshape(-1) & (k >= 0) & (k < K)
    # a dropped row contributes I32_MIN, which no max can pick
    vpts.scatter_reduce_(0, kc, torch.where(ok, pts.reshape(-1), I32_MIN),
                         "amax")
    return vpts, vpts[kc]


#: mega_apply.cu's threads a CTA and the 16-byte units of four rows a
#: thread holds across its grid barrier (its kThreads and kHeld; its C
#: entry checks both, the CPU tests replay the row assignment with them)
APPLY_THREADS = 256
APPLY_HELD = 2


@hand_kernel(audit="mega-apply-two-phase-revisit")
def mega_apply(cfg, vpts, keys, pts, mask):
    """The arbiter core: phase 0 scatter-MAXes every masked (key, pts) row
    into the (K,) int32 column ``vpts`` (in place), phase 1 reads the
    settled ``vpts[key]`` verdict for every row.  ``keys``/``pts`` are
    int32 and ``mask`` bool, all of N elements in any shape.  Returns
    ``(vpts, post (N,))``.  A key outside [0, K) drops from the max and is
    clamped for the read.

    Replaces ``hermes_tpu/core/megaround.py:mega_apply`` (Pallas
    ``_apply_kernel``, grid ``(2,)``).  Bound by memory: keys, pts and
    mask in, ``post`` out, and the 4 MB ``vpts`` column (2^20 keys), which
    stays in the card's 50 MB L2 between the phases.  The CUDA design is
    one cooperative launch of a persistent grid (no more CTAs than
    co-reside on the card): each thread applies its rows' maxima with
    integer ``atomicMax`` (exact in any order), keeps their clamped keys
    in registers across a grid barrier, and reads the verdicts back
    through L2.  Keys, pts and post move in 16-byte units where the
    pointers allow it (any pointer misaligned: row by row).  A refused
    cooperative launch raises; nothing falls back to two launches."""
    name = "mega_apply"
    need(name, "vpts", vpts, I32)
    need(name, "keys", keys, I32)
    need(name, "pts", pts, I32, keys.shape)
    need(name, "mask", mask, torch.bool, keys.shape)
    if vpts.dim() != 1 or vpts.shape[0] < 1:
        raise ValueError(f"{name}: vpts must be a non-empty (K,) column, got "
                         f"{tuple(vpts.shape)}")
    if not on_card(name, vpts, keys, pts, mask):
        return mega_apply_plain(cfg, vpts, keys, pts, mask)
    N = keys.numel()
    post = out((N,), I32, vpts.device)
    if N:
        launch(name, vpts.device, vpts, keys, pts, mask, post,
               vpts.shape[0], N, APPLY_THREADS, APPLY_HELD)
        mega_apply.launches += 1
    return vpts, post


mega_apply.launches = 0


# --------------------------------------------------------------------------
# mega_replay: the gated stuck-key replay scan
# --------------------------------------------------------------------------


def mega_replay_plain(cfg, step, frozen, table_vpts, table_bank, replay):
    """The replay scan over the ``rows`` rows of the table: the stuck rows
    (state INVALID, TRANS or REPLAY, and ``step - sst_step > replay_age``,
    from the pre-mark bytes) in ascending row order, at most RS of them,
    are the candidates; candidate i goes to replica r's i-th free slot
    unless r is frozen (a frozen replica's free slot is consumed all the
    same); every candidate some replica took gets its sst re-stamped
    ``(step << shift) | REPLAY`` in ``table_bank``, in place.  Returns
    ``(table_bank, (active, key, pts, acks, val))``, the replay fields new
    tensors."""
    from hermes_tpu_torch.core.faststep import _bank_to_i32, _i32_to_bank

    rows = table_vpts.shape[0]
    R, RS = replay.active.shape
    dev = table_bank.device
    sst = _bank_to_i32(table_bank[:, _SST_OFF:_SST_OFF + 4])[:, 0]
    state = sst & _STATE_MASK
    age = step - (sst >> _STEP_SHIFT)
    stuck = (((state == t.INVALID) | (state == t.TRANS)
              | (state == t.REPLAY)) & (age > cfg.replay_age))
    # candidate i = the i-th stuck row; cand is -1 past the last one
    rank = torch.cumsum(stuck.to(I32), 0, dtype=I32) - 1
    tgt = torch.where(stuck & (rank < RS), rank, RS).long()
    cand = torch.full((RS + 1,), -1, dtype=I32, device=dev).scatter_(
        0, tgt, torch.arange(rows, dtype=I32, device=dev))[:RS]
    free = ~replay.active
    free_rank = torch.cumsum(free.to(I32), 1, dtype=I32) - 1
    c_at = cand[free_rank.clamp(0, RS - 1).long()]  # (R, RS)
    take = free & (c_at >= 0) & ~frozen[:, None]
    row = c_at.clamp(min=0).long()
    new_replay = (
        take | replay.active,
        torch.where(take, torch.remainder(row, cfg.n_keys).to(I32),
                    replay.key),
        torch.where(take, table_vpts[row], replay.pts),
        torch.where(take, 0, replay.acks),
        torch.where(take[..., None], table_bank[row][..., _VAL_OFF:],
                    replay.val),
    )
    # marked rows: max over duplicate indices is order-free
    marked = torch.zeros((rows,), dtype=I32, device=dev).scatter_reduce_(
        0, row.reshape(-1), take.reshape(-1).to(I32), "amax")
    mark = _i32_to_bank(((step << _STEP_SHIFT) | t.REPLAY).reshape(1, 1))
    sst8 = table_bank[:, _SST_OFF:_SST_OFF + 4]
    sst8.copy_(torch.where(marked[:, None] != 0, mark, sst8))
    return table_bank, new_replay


#: mega_replay.cu's rows a CTA span is made of (its kUnitRows), its
#: threads a CTA (kThreads) and the CTAs of those it asks to co-reside on
#: each SM (kCtasPerSm, its launch bounds)
REPLAY_UNIT_ROWS = 1024
REPLAY_THREADS = 256
REPLAY_CTAS_PER_SM = 2
#: the most CTAs of mega_replay's grid: it must co-reside, which the C
#: entry checks against the card's own occupancy query
REPLAY_GRID_MAX = SMS * REPLAY_CTAS_PER_SM


class ReplayPlan(NamedTuple):
    """``mega_replay.cu``'s span CTAs: ``ctas`` of them, CTA b owning the
    rows ``[b * per * REPLAY_UNIT_ROWS, (b + 1) * per * REPLAY_UNIT_ROWS)``
    of the table (the last span ragged).  The grid adds one CTA a slot
    task (``replay_slot_tasks``)."""
    ctas: int
    per: int


@functools.lru_cache(maxsize=64)
def replay_plan(rows: int, cap: int = REPLAY_GRID_MAX) -> ReplayPlan:
    """Contiguous spans of whole ``REPLAY_UNIT_ROWS``-row units over
    ``rows`` rows: one unit a CTA while the units fit in ``cap`` CTAs, else
    as few units a CTA as keep the CTAs within ``cap``; exactly the CTAs
    the rows need."""
    if rows < 1 or cap < 1:
        raise ValueError(f"replay_plan: no plan for rows={rows} cap={cap}")
    units = cdiv(rows, REPLAY_UNIT_ROWS)
    per = cdiv(units, cap)
    return ReplayPlan(cdiv(units, per), per)


def replay_slot_tasks(R: int, RS: int) -> int:
    """mega_replay.cu's slot tasks, a CTA each: one a replica and chunk of
    ``REPLAY_THREADS`` slots."""
    return R * cdiv(RS, REPLAY_THREADS)


def _aligned(n: int, *xs) -> bool:
    return all(x.data_ptr() % n == 0 for x in xs)


def replay_access(bank, val, nval, active):
    """``(words, vec)`` for ``mega_replay.cu``, from the pointers and the
    bank's row of ``W4`` bytes: ``words`` 1 where the sst words are
    4-byte aligned (one 4-byte load or store a row), else 0 (bytes); and
    the width of the value copies (16: 8-byte loads and 16-byte stores; 8;
    or 1, bytes)."""
    W4 = bank.shape[1]
    V4 = W4 - _VAL_OFF
    words = int(_aligned(4, bank) and W4 % 4 == 0 and _SST_OFF % 4 == 0)
    v8 = (_aligned(8, bank, val, nval) and _aligned(4, active)
          and W4 % 8 == 0 and _VAL_OFF % 8 == 0 and V4 % 8 == 0)
    vec = (16 if v8 and _aligned(16, val, nval) and V4 % 16 == 0
           else 8 if v8 else 1)
    return words, vec


@hand_kernel(audit="mega-replay-stream-accumulate")
def mega_replay(cfg, step, frozen, table_vpts, table_bank, replay):
    """The gated replay scan (run every ``replay_scan_every`` rounds):
    ``step`` the round as a one-element int32 tensor on the table's device
    (or a Python int), ``frozen`` (R,) bool, ``table_vpts`` (rows,) int32,
    ``table_bank`` (rows, 4(2+V)) int8 (updated in place: the REPLAY
    marks), ``replay`` a FastReplay of (R, RS) slots.  Returns
    ``(table_bank, (active, key, pts, acks, val))``; see
    ``mega_replay_plain`` for the function.

    Replaces ``hermes_tpu/core/megaround.py:mega_replay`` (Pallas
    ``_replay_kernel``, a sequential grid over VMEM-sized table blocks
    with a candidate cursor carried in SMEM).  Bound by memory: every
    row's 4-byte sst word must be read (4 MB at 2^20 keys); in the
    40-byte bank row each read costs a 32-byte sector, ~34 MB.  Hopper
    blocks run in no order, so the streaming cursor becomes one
    cooperative launch of a persistent grid over contiguous spans of the
    table (``replay_plan``) and one more CTA a slot task, in three phases
    split by grid barriers: (A) each thread keeps its rows' stuck flags in
    a register bitmask and each span CTA writes its count, while the slot
    CTAs copy the old slots to the new tensors and rank each replica's
    free slots; (B) every CTA sums the counts before it, and a CTA whose
    prefix is below RS ranks its flags in row order into the candidate
    list; (C) the taken candidates' sst words are re-stamped over the
    whole grid, and the free slots that take a candidate are filled.  The
    round's step is read from a device pointer, so the round needs no host
    sync.  A refused cooperative launch raises; nothing falls back to
    three launches."""
    name = "mega_replay"
    dev = table_bank.device
    step = _step_tensor(name, step, dev)
    need(name, "active", replay.active, torch.bool)
    R, RS = replay.active.shape
    rows, W4 = table_bank.shape
    V4 = W4 - _VAL_OFF
    need(name, "frozen", frozen, torch.bool, (R,))
    need(name, "table_vpts", table_vpts, I32, (rows,))
    need(name, "table_bank", table_bank, torch.int8,
         (rows, 4 * (2 + cfg.value_words)))
    for what in ("key", "pts", "acks"):
        need(name, f"replay.{what}", getattr(replay, what), I32, (R, RS))
    need(name, "replay.val", replay.val, torch.int8, (R, RS, V4))
    leaves = (replay.active, replay.key, replay.pts, replay.acks, replay.val)
    if not on_card(name, step, frozen, table_vpts, table_bank, *leaves):
        return mega_replay_plain(cfg, step, frozen, table_vpts, table_bank,
                                 replay)
    if rows < 1 or R < 1 or RS < 1:
        raise ValueError(f"{name}: needs rows, R and RS >= 1, got "
                         f"{rows}, {R}, {RS}")
    new = tuple(out(x.shape, x.dtype, dev) for x in leaves)
    spans_max = REPLAY_GRID_MAX - replay_slot_tasks(R, RS)
    if spans_max < 1:
        raise ValueError(f"{name}: {R} replicas of {RS} slots leave no CTA "
                         f"of the {REPLAY_GRID_MAX} for the table")
    plan = replay_plan(rows, spans_max)
    # a stuck count a CTA, a free count a replica, the RS candidate rows
    n_scratch = plan.ctas + R + RS
    scratch = out((n_scratch,), I32, dev)
    words, vec = replay_access(table_bank, replay.val, new[4], replay.active)
    launch(name, dev, step, frozen, table_vpts, table_bank, *leaves, *new,
           scratch, n_scratch, rows, W4, R, RS, cfg.n_keys, cfg.replay_age,
           _STEP_SHIFT, _STATE_MASK, t.INVALID, t.TRANS, t.REPLAY,
           _SST_OFF, _VAL_OFF, plan.ctas, plan.per, words, vec)
    mega_replay.launches += 1
    return table_bank, new


mega_replay.launches = 0
