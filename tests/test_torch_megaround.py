"""The port's mega round (hermes_tpu_torch/core/megaround.py and its three
sites in core/faststep.py) against the reference's (hermes_tpu/core/
megaround.py, whose Pallas kernels run in interpret mode on the CPU, as
tests/test_megaround.py runs them).

* Each plain version against the JAX function called directly, at the
  reference's kernel cells (analysis/diffcheck.py: mega_route/r2l6,
  mega_apply/k16n16, mega_replay/k16b1, mega_replay/k22b3) and on seeded
  inputs that reach the edges: keys outside [0, K) for mega_apply; more
  stuck rows than replay slots, a frozen replica, partly active slots, a
  replica with no free slot and a ragged multi-block JAX grid for
  mega_replay.
* The port's mega round against the JAX mega round, round by round
  through a freeze and a thaw with the replay scan taking slots, and
  against the port's own fused round (the reference's contract,
  tests/test_megaround.py).
* FastRuntime with mega_round=True in both packages at pipeline depths 1
  and 2.
* The wrappers' dispatch: a CPU tensor takes the plain version and no
  kernel launch is counted; a wrong dtype raises.

Tolerance: exact equality (all state is integer).  The CUDA kernels are
held against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.core import faststep as ref_fst
from hermes_tpu.core import megaround as ref_mega
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import config as port_config
from hermes_tpu_torch import convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import megaround as mega
from hermes_tpu_torch.runtime import FastRuntime
from hermes_tpu_torch.workload import ycsb
from test_torch_faststep import Pair, assert_tree_equal, port_ctl
from test_torch_runtime import CFG as RT_CFG, _assert_same, _script

torch.set_num_threads(1)
CPU = torch.device("cpu")
I32_MAX = (1 << 31) - 1


def _kernel_cfg(n_keys=16, **kw):
    """diffcheck._mega_cfg: the config of the reference's kernel cells."""
    base = dict(n_replicas=2, n_keys=n_keys, n_sessions=4, replay_slots=2,
                ops_per_session=4, arb_mode="sort", mega_round=True)
    base.update(kw)
    return RefConfig(**base)


def _port(rc):
    return HermesConfig(**dataclasses.asdict(rc))


def _np(x):
    return np.asarray(jax.device_get(x))


# --------------------------------------------------------------------------
# plain versions against the JAX functions
# --------------------------------------------------------------------------


def _route_inputs(R, L, seed):
    rng = np.random.default_rng(seed)
    si = np.stack([rng.permutation(L) for _ in range(R)]).astype(np.int32)
    srank = np.stack([rng.permutation(L) for _ in range(R)]).astype(np.int32)
    word = rng.integers(0, 1 << 22, (R, L), dtype=np.int32)
    return si, word, srank


@pytest.mark.parametrize("cell", ["r2l6", "r3l40c25"])
def test_torch_mega_route_plain_matches_reference(cell):
    rc = (_kernel_cfg() if cell == "r2l6"
          else _kernel_cfg(n_replicas=3, n_sessions=32, replay_slots=8,
                           lane_budget_cfg=25))
    R, L = rc.n_replicas, rc.n_lanes
    assert rc.lane_budget == (6 if cell == "r2l6" else 25)
    args = _route_inputs(R, L, seed=R * 100 + L)
    want = ref_mega.mega_route(rc, *(jnp.asarray(a) for a in args))
    got = mega.mega_route_plain(_port(rc), *(torch.from_numpy(a) for a in args))
    for name, w, g in zip(("lane_word", "slot_lane"), want, got):
        np.testing.assert_array_equal(_np(w), g.numpy(), err_msg=name)


def _apply_inputs(K, N, seed):
    rng = np.random.default_rng(seed)
    vpts = rng.integers(0, 1 << 24, (K,), dtype=np.int32)
    # keys across the untrusted wire field: negative and >= K included
    keys = rng.integers(-K, 2 * K, (N,), dtype=np.int32)
    keys[:3] = (-1, K, (1 << 29) - 1)
    pts = rng.integers(-(1 << 30), 1 << 30, (N,), dtype=np.int32)
    mask = rng.random(N) < 0.7
    return vpts, keys, pts, mask


@pytest.mark.parametrize("K,N", [(16, 16), (37, 300)])
def test_torch_mega_apply_plain_matches_reference(K, N):
    rc = _kernel_cfg(n_keys=K)
    vpts, keys, pts, mask = _apply_inputs(K, N, seed=K + N)
    want_v, want_p = ref_mega.mega_apply(
        rc, jnp.asarray(vpts), jnp.asarray(keys), jnp.asarray(pts),
        jnp.asarray(mask.astype(np.int32)))
    tv = torch.from_numpy(vpts.copy())
    got_v, got_p = mega.mega_apply_plain(
        _port(rc), tv, torch.from_numpy(keys), torch.from_numpy(pts),
        torch.from_numpy(mask))
    assert got_v is tv  # in place
    np.testing.assert_array_equal(_np(want_v), got_v.numpy())
    np.testing.assert_array_equal(_np(want_p), got_p.numpy())
    # the edges were reached: a dropped key, a raised max
    assert (keys < 0).any() and (keys >= K).any()
    assert (got_v.numpy() != vpts).any()


def _replay_inputs(rc, step, seed, frozen=(), full=()):
    """A table of rows = n_keys rows with states and sst steps drawn so
    that many rows are stuck, and replay slots partly active."""
    rng = np.random.default_rng(seed)
    R, RS, K, V = rc.n_replicas, rc.replay_slots, rc.n_keys, rc.value_words
    state = rng.integers(0, 5, K)
    sst_step = rng.integers(0, step + 1, K)
    words = rng.integers(-(1 << 31), I32_MAX, (K, 2 + V), dtype=np.int64)
    words[:, 1] = (sst_step << 3) | state
    bank = words.astype("<i4").view(np.int8).reshape(K, 4 * (2 + V))
    vpts = rng.integers(0, 1 << 24, (K,), dtype=np.int32)
    active = rng.random((R, RS)) < 0.4
    active[list(full)] = True
    fz = np.zeros(R, bool)
    fz[list(frozen)] = True
    rep = dict(active=active,
               key=rng.integers(0, K, (R, RS), dtype=np.int32),
               pts=rng.integers(0, 1 << 24, (R, RS), dtype=np.int32),
               acks=rng.integers(0, 8, (R, RS), dtype=np.int32),
               val=rng.integers(-128, 128, (R, RS, 4 * V), dtype=np.int8))
    return fz, vpts, np.ascontiguousarray(bank), rep


def _replay_pair(rc, step, fz, vpts, bank, rep, block_bytes):
    want_bank, want = ref_mega.mega_replay(
        rc, jnp.int32(step), jnp.asarray(fz), jnp.asarray(vpts),
        jnp.asarray(bank),
        ref_fst.FastReplay(**{k: jnp.asarray(v) for k, v in rep.items()}),
        block_bytes=block_bytes)
    tbank = torch.from_numpy(bank.copy())
    trep = fst.FastReplay(**{k: torch.from_numpy(v.copy())
                             for k, v in rep.items()})
    got_bank, got = mega.mega_replay_plain(
        _port(rc), torch.tensor(step, dtype=torch.int32),
        torch.from_numpy(fz), torch.from_numpy(vpts), tbank, trep)
    assert got_bank is tbank  # marks in place
    np.testing.assert_array_equal(_np(want_bank), got_bank.numpy())
    for name, w, g in zip(("active", "key", "pts", "acks", "val"), want, got):
        np.testing.assert_array_equal(_np(w), g.numpy(), err_msg=name)
    return got


REPLAY_CASES = {
    # the reference's two kernel cells (one block; a ragged 3-block grid)
    "k16b1": dict(n_keys=16, block_bytes=1 << 20),
    "k22b3": dict(n_keys=22, block_bytes=8 * 40),
    # more stuck rows than slots, replica 1 frozen, replica 2 without a
    # free slot, a ragged 8-block JAX grid (7 rows a block over 50 rows)
    "k50_frozen_full": dict(n_keys=50, n_replicas=4, replay_slots=8,
                            value_words=3, frozen=(1,), full=(2,),
                            block_bytes=7 * 20),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_torch_mega_replay_plain_matches_reference(case):
    kw = dict(REPLAY_CASES[case])
    frozen, full = kw.pop("frozen", ()), kw.pop("full", ())
    block_bytes = kw.pop("block_bytes")
    rc = _kernel_cfg(replay_age=3, **kw)
    step = 40
    fz, vpts, bank, rep = _replay_inputs(rc, step, seed=rc.n_keys,
                                         frozen=frozen, full=full)
    got = _replay_pair(rc, step, fz, vpts, bank, rep, block_bytes)
    took = got[0].numpy() & ~rep["active"]
    assert took.any(), "no slot was taken: the take path did not run"
    if case == "k50_frozen_full":
        sst = bank[:, 4:8].copy().view("<i4")[:, 0]
        stuck = np.isin(sst & 7, (1, 3, 4)) & (step - (sst >> 3) > 3)
        assert stuck.sum() > rc.replay_slots
        assert not took[1].any() and not took[2].any()
        # the engine's own top-k form of the scan (the table with its drop
        # row) gives the same slots
        pad = lambda a: np.concatenate([a, np.zeros((1,) + a.shape[1:],
                                                    a.dtype)])
        table = fst.FastTable(vpts=torch.from_numpy(pad(vpts)),
                              bank=torch.from_numpy(pad(bank)))
        replay = fst.FastReplay(**{k: torch.from_numpy(v.copy())
                                   for k, v in rep.items()})
        _table, replay = fst._replay_scan(
            _port(rc), port_ctl(_port(rc), step, frozen=frozen), table,
            replay)
        for w, g in zip(got, (replay.active, replay.key, replay.pts,
                              replay.acks, replay.val)):
            assert torch.equal(w, g)


# --------------------------------------------------------------------------
# the mega round against the JAX mega round and the port's fused round
# --------------------------------------------------------------------------


def _mega_cfg(**kw):
    """tests/test_megaround.py:_cfg with the mega round on."""
    base = dict(n_replicas=3, n_keys=32, n_sessions=8, replay_slots=4,
                ops_per_session=24, arb_mode="sort", chain_writes=2,
                replay_scan_every=4, replay_age=4, rebroadcast_every=2,
                mega_round=True,
                workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=7))
    base.update(kw)
    return RefConfig(**base)


def _faults(s):
    """Replica 1 frozen for rounds 8-27: its missing acks strand writes,
    their keys age past replay_age and the scan takes them."""
    return dict(frozen=(1,)) if 8 <= s < 28 else {}


@pytest.mark.parametrize("n_keys", [32, 37])
def test_torch_mega_round_identical_to_reference(n_keys, monkeypatch):
    # 37 keys over 13-row blocks: the reference's replay grid is ragged
    monkeypatch.setattr(ref_mega, "REPLAY_BLOCK_BYTES", 13 * 16)
    rc = _mega_cfg(n_keys=n_keys)
    assert ref_mega.resolve(rc), "the JAX round would not run its kernels"
    launches = (mega.mega_route.launches, mega.mega_apply.launches,
                mega.mega_replay.launches)
    p = Pair(rc)
    for s in range(48):
        p.round(s, **_faults(s))
    assert int(p.fs.meta.replay_peak.max()) > 0, \
        "the replay kernel's take path did not run"
    assert int(p.fs.meta.n_write.sum() + p.fs.meta.n_rmw.sum()) > 0
    # CPU tensors: plain versions only
    assert (mega.mega_route.launches, mega.mega_apply.launches,
            mega.mega_replay.launches) == launches


def test_torch_mega_round_matches_fused_round():
    """The reference's own contract for the port: mega on and off give the
    same state and completions every round."""
    cfgs = {m: _port(_mega_cfg(mega_round=m)) for m in (False, True)}
    assert cfgs[True].use_mega_round and not cfgs[False].use_mega_round
    stream = fst.prep_stream(ycsb.make_streams(cfgs[True]), CPU)
    fs = {m: fst.init_fast_state(c, CPU) for m, c in cfgs.items()}
    for s in range(60):
        comps = {}
        for m, c in cfgs.items():
            fs[m], comps[m] = fst.fast_round_batched(
                c, port_ctl(c, s, **_faults(s)), fs[m], stream)
        assert_tree_equal(convert.fast_state_to_numpy(fs[False]),
                          convert.fast_state_to_numpy(fs[True]), f"r{s}.fs")
        assert_tree_equal(tuple(x.numpy() for x in comps[False]),
                          comps[True], f"r{s}.comp")
    assert int(fs[True].meta.replay_peak.max()) > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_torch_mega_runtime_identical_to_reference(depth):
    """FastRuntime with mega_round=True in both packages: the same
    harvested completions every step through a freeze, a thaw and a
    rebase, the same Meta after the drain, and a green checker."""
    rc = RefConfig(pipeline_depth=depth, mega_round=True, **RT_CFG)
    cfg = _port(rc)
    assert cfg.use_mega_round and ref_mega.resolve(rc)
    ref = RefRuntime(rc, record=True)
    rt = FastRuntime(cfg, record=True, device="cpu")
    got = _script(rt, 24)
    want = _script(ref, 24, settle=lambda: jax.block_until_ready(ref.fs))
    for s, (a, b) in enumerate(zip(want, got)):
        _assert_same(a, b, f"step {s}")
    for f, x in zip(rt.fs.meta._fields, rt.fs.meta):
        np.testing.assert_array_equal(_np(getattr(ref.fs.meta, f)),
                                      x.numpy(), err_msg=f)
    assert int(rt.fs.meta.replay_peak.max()) > 0
    assert rt.check().ok


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------


def _wrapper_calls():
    rc = _kernel_cfg()
    cfg = _port(rc)
    si, word, srank = (torch.from_numpy(a) for a in _route_inputs(2, 6, 1))
    vpts, keys, pts, mask = (torch.from_numpy(a)
                             for a in _apply_inputs(16, 16, 2))
    fz, rv, bank, rep = _replay_inputs(rc, 40, 3)
    trep = fst.FastReplay(**{k: torch.from_numpy(v) for k, v in rep.items()})
    return {
        "mega_route": (mega.mega_route, mega.mega_route_plain,
                       (cfg, si, word, srank), 1),
        "mega_apply": (mega.mega_apply, mega.mega_apply_plain,
                       (cfg, vpts, keys, pts, mask), 2),
        "mega_replay": (mega.mega_replay, mega.mega_replay_plain,
                        (cfg, torch.tensor(40, dtype=torch.int32),
                         torch.from_numpy(fz), torch.from_numpy(rv),
                         torch.from_numpy(bank), trep), 3),
    }


def _clone(args):
    return chip_smoke._to(torch, args, CPU)


@pytest.mark.parametrize("name", ["mega_route", "mega_apply", "mega_replay"])
def test_torch_mega_wrapper_takes_plain_path_on_cpu(name):
    wrapper, plain, args, _ = _wrapper_calls()[name]
    before = wrapper.launches
    got = wrapper(*_clone(args))
    want = plain(*_clone(args))
    assert wrapper.launches == before  # no kernel on the CPU
    for g, w in zip(chip_smoke._flat(got), chip_smoke._flat(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["mega_route", "mega_apply", "mega_replay"])
def test_torch_mega_wrapper_rejects_wrong_dtype(name):
    wrapper, _plain, args, i = _wrapper_calls()[name]
    args = list(_clone(args))
    x = args[i]
    args[i] = x.to(torch.int64) if x.dtype != torch.int64 else x.to(torch.int32)
    with pytest.raises(TypeError):
        wrapper(*args)


# --------------------------------------------------------------------------
# mega_route's launch geometry (csrc/mega_route.cu runs only on the card)
# --------------------------------------------------------------------------


def _windows(plan, n, w):
    """The non-empty windows of ``w`` elements over [0, n), in order:
    window ``pass * cluster + rank`` is CTA ``rank``'s in that pass."""
    return [(i * w, min(n, (i + 1) * w))
            for i in range(plan.cluster * plan.passes) if i * w < n]


def _shares(plan, n):
    """The CTAs' position shares of a row of ``n`` lanes."""
    return [(q * plan.ps, min(n, (q + 1) * plan.ps))
            for q in range(plan.cluster) if q * plan.ps < n]


def _route_by_plan(plan, L, C, si, word, srank):
    """mega_route.cu's algorithm over the plan, in numpy: each pass, every
    CTA's position share stores into the owning CTA's window (the
    cluster's shared memory), then each CTA writes its windows out.  An
    element the write-out misses keeps the poison -7."""
    R = si.shape[0]
    Q, wl, wc = plan.cluster, plan.wl, plan.wc
    lane_word = np.full((R, L), -7, np.int64)
    slot_lane = np.full((R, C), -7, np.int64)
    for p in range(plan.passes):
        win_l = np.zeros((R, Q, wl), np.int64)
        win_s = np.zeros((R, Q, max(wc, 1)), np.int64)
        for p0, p1 in _shares(plan, L):
            r = np.repeat(np.arange(R), p1 - p0)
            lane = np.clip(si[:, p0:p1], 0, L - 1).ravel()
            off = lane - p * Q * wl
            keep = (off >= 0) & (off < Q * wl)
            win_l[r[keep], off[keep] // wl, off[keep] % wl] = \
                word[:, p0:p1].ravel()[keep]
            s = srank[:, p0:p1].ravel()
            soff = s - p * Q * wc
            keep = (s >= 0) & (s < C) & (soff >= 0) & (soff < Q * wc)
            win_s[r[keep], soff[keep] // wc, soff[keep] % wc] = lane[keep]
        for q in range(Q):
            w = p * Q + q
            if w * wl < L:
                hi = min(L, (w + 1) * wl)
                lane_word[:, w * wl:hi] = win_l[:, q, :hi - w * wl]
            if w * wc < C:
                hi = min(C, (w + 1) * wc)
                slot_lane[:, w * wc:hi] = win_s[:, q, :hi - w * wc]
    return lane_word, slot_lane


def _covers_once(n, spans):
    seen = np.zeros(n, np.int64)
    for lo, hi in spans:
        assert 0 <= lo < hi <= n
        seen[lo:hi] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("shape", chip_smoke.ROUTE_SHAPES)
def test_torch_route_plan_windows_cover_each_target_once(shape):
    """At the bench shape, the multi-window one and the kernel-matrix and
    ragged shapes: the windows cover [0, L) and [0, C) exactly once, the
    position shares [0, L); a cluster of at most 16 CTAs, each within the
    card's shared memory; 16-byte windows; and the plan's windows route
    every target of a permutation to the plain version's place."""
    R, L, C = shape
    plan = mega.route_plan(R, L, C)
    assert 1 <= plan.cluster <= 16 and plan.passes >= 1
    assert plan.smem_bytes == 4 * (plan.wl + plan.wc) <= 232448
    assert plan.wl % 4 == 0 and plan.wc % 4 == 0 and plan.ps % 4 == 0
    assert _covers_once(L, _windows(plan, L, plan.wl))
    assert C == 0 or _covers_once(C, _windows(plan, C, plan.wc))
    assert _covers_once(L, _shares(plan, L))
    if shape == chip_smoke.ROUTE_SHAPES[0]:  # the bench shape: one pass,
        # clusters of 8 (of 16: the same passes, so the smaller)
        assert plan == (8, 1, 8224, 6144, 8224) and plan.smem_bytes == 57472
        assert mega.route_plan(R, L, C, cluster=16) == (16, 1, 4112, 3072,
                                                       4112)
    if shape == chip_smoke.ROUTE_SHAPES[-1]:  # 7.3 MB a row: clusters
        # of 16 (of 8 it would take 4 passes)
        assert plan.cluster == 16 and plan.passes == 2
        assert plan.smem_bytes == 229376
        assert mega.route_plan(R, L, C, cluster=8).passes == 4
    si, word, srank = _route_inputs(R, L, 7)
    lane = np.clip(si, 0, L - 1)
    want_lw = np.zeros((R, L), np.int64)
    np.put_along_axis(want_lw, lane, word, 1)
    want_sl = np.zeros((R, C + 1), np.int64)
    np.put_along_axis(want_sl, np.where(srank < C, srank, C), lane, 1)
    got_lw, got_sl = _route_by_plan(plan, L, C, si, word, srank)
    np.testing.assert_array_equal(got_lw, want_lw)
    np.testing.assert_array_equal(got_sl, want_sl[:, :C])


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_torch_route_plan_takes_passes_when_the_row_outgrows_the_cluster(
        cluster):
    """The same row planned on smaller clusters: more passes, never more
    shared memory than a CTA has, every target still placed once."""
    R, L, C = 2, 1 << 18, 200000
    plan = mega.route_plan(R, L, C, cluster=cluster)
    assert plan.cluster == cluster
    assert plan.smem_bytes <= 232448
    assert plan.passes >= -(-4 * (L + C) // (cluster * 232448))
    assert _covers_once(L, _windows(plan, L, plan.wl))
    assert _covers_once(C, _windows(plan, C, plan.wc))
    si, word, srank = _route_inputs(R, L, 8)
    lane_word, slot_lane = _route_by_plan(plan, L, C, si, word, srank)
    assert (lane_word >= 0).all() and (slot_lane >= 0).all()
    np.testing.assert_array_equal(
        np.take_along_axis(lane_word, si, 1), word)
    with pytest.raises(ValueError):
        mega.route_plan(R, L, C, cluster=17)


# --------------------------------------------------------------------------
# mega_apply's row assignment (csrc/mega_apply.cu runs only on the card)
# --------------------------------------------------------------------------

#: CTAs of mega_apply.cu that co-reside on an H100 at full occupancy (132
#: SMs, 8 CTAs of 256 threads each); the kernel queries its own
CO_RESIDENT = 132 * 8


def _apply_grid(N, cap, vec, held):
    """mega_apply.cu's grid: the CTAs its rows need (``held`` 16-byte
    units of four rows a thread, or one row a thread without 16-byte
    access), at least one and at most ``cap`` (what co-resides)."""
    per = mega.APPLY_THREADS * (held if vec else 1)
    units = -(-N // 4) if vec else N
    return max(1, min(cap, -(-units // per)))


def _apply_assignment(N, grid, vec, held):
    """The kernel's loops replayed in numpy: for each row, how many
    threads apply it in phase 0 and read it back in phase 1, and whether
    its reader kept the clamped key in registers across the grid barrier
    (the held units) or reads the key again."""
    T = grid * mega.APPLY_THREADS
    nv = N // 4 if vec else 0
    gt = np.arange(T)
    held_units = np.concatenate([gt + j * T for j in range(held)])
    held_units = held_units[held_units < nv]
    past_units = np.concatenate([np.arange(s, nv, T) for s in
                                 gt + held * T if s < nv] or
                                [np.zeros(0, np.int64)])
    scalar_rows = np.concatenate([np.arange(s, N, T) for s in gt + 4 * nv
                                  if s < N] or [np.zeros(0, np.int64)])
    rows = lambda units: (4 * units[:, None] + np.arange(4)).reshape(-1)
    applied = np.zeros(N, np.int64)
    kept = np.zeros(N, bool)
    for part in (rows(held_units), rows(past_units), scalar_rows):
        np.add.at(applied, part, 1)
    kept[rows(held_units)] = True
    return applied, kept


@pytest.mark.parametrize("N,cap,vec", [
    (N, CO_RESIDENT, vec) for _K, N in chip_smoke.APPLY_SHAPES
    for vec in (True, False)] + [
    (8 * 65792, 3, True),   # a grid too small to hold every row
    (7, CO_RESIDENT, True),  # fewer rows than one CTA has threads
])
def test_torch_apply_rows_cover_each_row_once(N, cap, vec):
    """At every chip_smoke.py shape, with and without 16-byte access, on
    a grid too small to hold every row and on one larger than N: every
    row is applied and read back by exactly one thread; the grid never
    exceeds what co-resides; at the bench shape every row's key stays in
    registers across the barrier; and the scatter-max and read-back give
    the plain version's column and verdicts."""
    held = mega.APPLY_HELD
    grid = _apply_grid(N, cap, vec, held)
    assert 1 <= grid <= cap
    applied, kept = _apply_assignment(N, grid, vec, held)
    assert (applied == 1).all()
    if vec and N == chip_smoke.APPLY_SHAPES[0][1] and cap == CO_RESIDENT:
        # 131,584 units, 512 a CTA
        assert kept.all() and grid == 257
    if cap == 3:
        assert not kept.all() and kept.any()  # keys read again
    if not vec:
        assert not kept.any()
    if N == 7:
        assert grid * mega.APPLY_THREADS > N
    K = 1 << 12
    vpts, keys, pts, mask = _apply_inputs(K, N, seed=N)
    ok = mask & (keys >= 0) & (keys < K)
    col = vpts.astype(np.int64)
    np.maximum.at(col, keys[ok], pts[ok])
    post = col[np.clip(keys, 0, K - 1)]
    want_v, want_p = mega.mega_apply_plain(
        None, torch.from_numpy(vpts.copy()), torch.from_numpy(keys),
        torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(col, want_v.numpy())
    np.testing.assert_array_equal(post, want_p.numpy())


APPLY_EDGES = {
    # every row on one key: all maxima land on one word (on the card, the
    # read-back after the barrier must see the last of them)
    "one_key": lambda K, keys, mask: (np.full_like(keys, K // 2), mask),
    # every key outside [0, K): all dropped, all clamped
    "all_outside": lambda K, keys, mask: (
        np.where(np.arange(keys.size) % 2, -1 - keys % 7, K + keys % 7)
        .astype(np.int32), mask),
    # every row masked out: the column is unchanged
    "masked_out": lambda K, keys, mask: (keys, np.zeros_like(mask)),
}


@pytest.mark.parametrize("edge", sorted(APPLY_EDGES))
@pytest.mark.parametrize("K,N", [(16, 7), (37, 300)])
def test_torch_mega_apply_plain_matches_reference_at_edges(edge, K, N):
    """The plain version against the JAX function at the CUDA kernel's
    edges: every row on one key, every key outside the column, every row
    masked out; N = 7 is fewer rows than one 16-byte unit a thread of one
    CTA takes."""
    rc = _kernel_cfg(n_keys=K)
    vpts, keys, pts, mask = _apply_inputs(K, N, seed=K * N)
    keys, mask = APPLY_EDGES[edge](K, keys, mask)
    want_v, want_p = ref_mega.mega_apply(
        rc, jnp.asarray(vpts), jnp.asarray(keys), jnp.asarray(pts),
        jnp.asarray(mask.astype(np.int32)))
    got_v, got_p = mega.mega_apply_plain(
        _port(rc), torch.from_numpy(vpts.copy()), torch.from_numpy(keys),
        torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(want_v), got_v.numpy())
    np.testing.assert_array_equal(_np(want_p), got_p.numpy())
    if edge == "one_key":
        assert (got_p.numpy() == got_v.numpy()[K // 2]).all()
    else:
        assert (got_v.numpy() == vpts).all()


# --------------------------------------------------------------------------
# mega_replay's plan and phases (csrc/mega_replay.cu runs only on the card)
# --------------------------------------------------------------------------

UNIT = mega.REPLAY_UNIT_ROWS


def _spans(plan, rows):
    span = plan.per * UNIT
    return [(b * span, min(rows, (b + 1) * span)) for b in range(plan.ctas)]


@pytest.mark.parametrize("rows,cap", [
    (K, mega.REPLAY_GRID_MAX) for K, *_ in chip_smoke.REPLAY_SHAPES] + [
    (1 << 20, 100),          # the bench table on a grid smaller than its units
    (2500, 2), (2500, 1),    # three units on two CTAs, on one
    (40 * UNIT + 3, 7)])     # more steps a thread than its flag mask holds
def test_torch_replay_plan_spans_cover_each_row_once(rows, cap):
    """Each row in exactly one CTA span; every span but the last of whole
    REPLAY_UNIT_ROWS-row units, starting on a unit; no more CTAs than the
    cap and exactly the CTAs the rows need (the C entry refuses any other
    plan); 2,500 rows make three CTAs, so the kernel-matrix cell
    mega_replay/k2500b3 still ranks candidates across CTAs."""
    plan = mega.replay_plan(rows, cap)
    assert 1 <= plan.ctas <= cap and plan.per >= 1
    assert (plan.ctas - 1) * plan.per * UNIT < rows <= plan.ctas * plan.per * UNIT
    spans = _spans(plan, rows)
    assert _covers_once(rows, spans)
    for lo, hi in spans[:-1]:
        assert lo % UNIT == 0 and (hi - lo) == plan.per * UNIT
    if rows == 2500 and cap >= 3:
        assert plan == (3, 1)
    if rows == 1 << 20 and cap == mega.REPLAY_GRID_MAX:
        assert mega.REPLAY_GRID_MAX == 132 * mega.REPLAY_CTAS_PER_SM
        assert plan.ctas * plan.per == 1024 and plan.ctas <= 264
    with pytest.raises(ValueError):
        mega.replay_plan(0, cap)


def _sst_of(bank):
    b = bank[:, 4:8].astype(np.int64) & 0xFF
    w = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return np.where(w >= 1 << 31, w - (1 << 32), w)


def _replay_by_plan(plan, cfg, step, frozen, vpts, bank, active, key, pts,
                    acks, val):
    """mega_replay.cu's three phases replayed in numpy, CTA by CTA and
    thread by thread on the plan's spans: the stuck flags a thread holds
    (row lo + k * 256 + t, step k), the per-CTA counts, the ranks of the
    flags from the per-(step, warp) counts and the ballots, chunk by chunk
    of 32 steps, the slot tasks' free ranks, the marks and the fills.
    Returns the bank and the five new slot fields; asserts that every
    candidate rank below ncand is written exactly once and that nothing
    reads an unwritten one."""
    T, WARPS, MASK = mega.REPLAY_THREADS, mega.REPLAY_THREADS // 32, 32
    rows = bank.shape[0]
    R, RS = active.shape
    bank = bank.copy()
    sst = _sst_of(bank)
    state, age = sst & 7, (step - (sst >> 3) + (1 << 31)) % (1 << 32) - (1 << 31)
    stuck = np.isin(state, (1, 3, 4)) & (age > cfg.replay_age)
    steps = plan.per * UNIT // T
    # phase A: slot tasks (copies of every slot, free counts, free ranks)
    new = [active.copy(), key.copy(), pts.copy(), acks.copy(), val.copy()]
    free = ~active
    nfree = free.sum(1)
    rank = np.cumsum(free, 1) - free
    held = np.where(free & ~frozen[:, None], rank, -1)
    # phase A: flags and counts, F[b, k, t]
    F = np.zeros((plan.ctas, steps, T), bool)
    for b, (lo, hi) in enumerate(_spans(plan, rows)):
        r = lo + np.arange(steps)[:, None] * T + np.arange(T)
        F[b] = np.where(r < hi, stuck[np.minimum(r, rows - 1)], False)
    counts = F.reshape(plan.ctas, -1).sum(1)
    # phase B
    cand = np.full(RS, -1, np.int64)
    tot = counts.sum()
    ncand = min(tot, RS)
    unfrozen = nfree[~frozen]
    ntake = min(unfrozen.max() if unfrozen.size else 0, ncand)
    for b, (lo, _hi) in enumerate(_spans(plan, rows)):
        carry = counts[:b].sum()
        if counts[b] == 0 or carry >= RS:
            continue
        for k0 in range(0, steps, MASK):
            if carry >= RS:
                break
            f = F[b, k0:k0 + MASK].reshape(-1, WARPS, 32)
            wc = f.sum(-1)  # the warps' ballot counts a step
            base = (np.cumsum(wc.ravel()) - wc.ravel()).reshape(wc.shape)
            lanes = np.cumsum(f, -1) - f  # popc(ballot & lanemask_lt)
            rk = carry + base[..., None] + lanes
            for k, w, l in zip(*np.nonzero(f & (rk < RS))):
                assert cand[rk[k, w, l]] == -1
                cand[rk[k, w, l]] = lo + (k0 + k) * T + w * 32 + l
            carry += f.sum()
    assert (cand[:ncand] >= 0).all()
    # phase C: marks, then fills over the old copies
    mark = (step << 3) | 4
    for i in range(ntake):
        bank[cand[i], 4:8] = np.array([mark], "<i4").view(np.int8)
    for r, s in zip(*np.nonzero((held >= 0) & (held < ncand))):
        row = cand[held[r, s]]
        assert row >= 0
        new[0][r, s], new[3][r, s] = True, 0
        new[1][r, s], new[2][r, s] = row % cfg.n_keys, vpts[row]
        new[4][r, s] = bank[row, 8:]
    return bank, new


REPLAY_PHASE_CASES = {  # K, R, RS, V, stuck rows, frozen replicas, cap
    **{f"smoke{i}": (*shape, None, mega.REPLAY_GRID_MAX)
       for i, shape in enumerate(chip_smoke.REPLAY_SHAPES[1:])},
    "cross_ctas_small_grid": (5003, 3, 7, 3, 300, None, 2),
    "mask_chunks": (40 * UNIT + 3, 2, 64, 2, 120, None, 1),
    "slot_chunks": (3000, 3, 300, 2, 500, None, mega.REPLAY_GRID_MAX),
    "all_frozen": (5003, 3, 7, 3, 300, (0, 1, 2), mega.REPLAY_GRID_MAX),
    "no_stuck_row": (2500, 2, 2, 2, 0, None, mega.REPLAY_GRID_MAX),
}


@pytest.mark.parametrize("case", sorted(REPLAY_PHASE_CASES))
def test_torch_replay_phases_in_numpy_match_plain(case):
    """The kernel's phases replayed in numpy on chip_smoke.replay_inputs'
    draws, on the span CTAs the wrapper plans (the grid's slot CTAs come
    after them), equal mega_replay_plain: at the kernels phase's small
    shapes
    (2,500 rows: candidates ranked across three CTAs), on a grid smaller
    than the units, with more steps a thread than its 32-step flag mask
    (ranks across mask chunks), with more slots a replica than a CTA has
    threads, with every replica frozen and with no stuck row."""
    K, R, RS, V, n_stuck, frozen, cap = REPLAY_PHASE_CASES[case]
    cfg = chip_smoke.mega_cfg(port_config, R, K=K, L=RS + 4, RS=RS, V=V)
    step, fz, vpts, bank, rep = chip_smoke.replay_inputs(
        torch, fst, K, R, RS, V, n_stuck, seed=K + RS)
    if frozen is not None:
        fz[list(frozen)] = True
    want_bank, want = mega.mega_replay_plain(cfg, step, fz, vpts, bank.clone(),
                                             rep)
    plan = mega.replay_plan(
        K, min(cap, mega.REPLAY_GRID_MAX - mega.replay_slot_tasks(R, RS)))
    got_bank, got = _replay_by_plan(
        plan, cfg, int(step), fz.numpy(), vpts.numpy(), bank.numpy(),
        *(x.numpy() for x in (rep.active, rep.key, rep.pts, rep.acks,
                              rep.val)))
    np.testing.assert_array_equal(got_bank, want_bank.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    taken = int((want[0] & ~rep.active).sum())
    if case in ("all_frozen", "no_stuck_row"):
        assert taken == 0
    else:
        assert taken > 0
    if case == "mask_chunks":
        assert plan.per * UNIT // mega.REPLAY_THREADS > 32
    if case == "slot_chunks":
        assert RS > mega.REPLAY_THREADS
