"""The Hermes protocol phases of the reference engine: the port of
``hermes_tpu/core/phases.py``.

One protocol step is

    coordinate  -> [INV broadcast]  -> apply_inv  -> [ACK route-back]
                -> collect_acks     -> [VAL broadcast] -> apply_val

each phase data-parallel over every session, message lane and key at
once.  The reference writes each phase for one replica and lifts it with
``vmap``; here every function takes the replicas' state with its leading
replica axis (R, or the local replicas of a rank) and indexes per
replica, so no ``vmap`` is involved.  ``ctl`` holds one row a replica.

Where the semantics of JAX and torch part, each site follows JAX:

* a gather index counts from the end when negative and is then clamped
  (``_gather_idx``); a scatter index counts from the end when in
  ``[-K, 0)``, and every other index outside ``[0, K)`` is dropped, as is
  every masked row (``_drop_idx``).  Masked rows leave the scatter: the
  table's leaves carry a hidden drop row (``state.with_drop_row``), the
  small blocks an extra column that is cut off;
* ``jnp.nonzero(x, size=n, fill_value=f)`` is ``_first_true``: a cumsum
  ranks the true positions and ``searchsorted`` finds the first n in
  ascending order, without a host sync;
* the scatter-min / scatter-max arbiters over all K keys, read back at
  the lanes' own keys, are ``_reduce_at``: a sort of the lanes by target
  and a segmented ``scatter_reduce_`` with the reference's fill values,
  so their work follows the lanes, not K; the latency histogram is a
  scatter-add of ones, exact in integers;
* int32 arithmetic wraps as in JAX (``faststep._wrap32``), and ``%`` is
  the floor remainder ``torch.remainder``.

The key table is updated in place (its leaves are returned as given);
sessions, replay slots, meta and blocks come back as new tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.core.timestamps import make_fc, ts_eq, ts_gt

I32 = torch.int32
I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1


# -- index semantics --------------------------------------------------------


def _gather_idx(idx, size: int):
    """JAX's gather index: negative counts from the end, then clamped."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _drop_idx(idx, mask, size: int):
    """JAX's ``mode="drop"`` scatter index: ``[-size, 0)`` counts from the
    end; masked rows and every other index outside ``[0, size)`` go to
    ``size``, the drop position."""
    j = torch.where(idx < 0, idx + size, idx)
    return torch.where(mask & (j >= 0) & (j < size), j, size)


def _rows(x, idx):
    """Per-replica gather: ``x`` (n, K, ...), ``idx`` (n, M) in [0, K) ->
    (n, M, ...)."""
    r = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[r, idx.long()]


def _with_drop(arr):
    """The (n*K + 1, ...) flat view of a table leaf made by
    ``state.with_drop_row``: its rows then the drop row."""
    n, k = arr.shape[:2]
    tail = tuple(arr.shape[2:])
    row = 1
    for d in tail:
        row *= d
    need = (arr.storage_offset() + arr.numel() + row) * arr.element_size()
    if not arr.is_contiguous() or arr.untyped_storage().nbytes() < need:
        raise ValueError("a phases-engine table leaf needs its drop row "
                         "(build it with state.with_drop_row)")
    return arr.as_strided((n * k + 1,) + tail, (row,) + arr.stride()[2:],
                          arr.storage_offset())


def _values(val, shape, like):
    """A scatter's values as a tensor of ``shape``: a Python scalar is
    filled on the device (a scalar tensor made on the host would be a
    blocking copy to the card)."""
    if torch.is_tensor(val):
        return val.to(like.dtype).expand(shape)
    return torch.full(shape, val, dtype=like.dtype, device=like.device)


def _set_(arr, idx, val, mask):
    """Masked scatter-set into a table leaf (n, K, ...), in place: rows
    where ``mask`` is False, or whose index JAX drops, land on the drop
    row."""
    n, k = arr.shape[:2]
    tail = tuple(arr.shape[2:])
    j = _drop_idx(idx, mask, k).long()
    base = torch.arange(n, device=j.device)[:, None] * k
    f = torch.where(j < k, base + j, n * k)
    val = _values(val, tuple(idx.shape) + tail, arr)
    _with_drop(arr).index_put_((f.reshape(-1),), val.reshape((-1,) + tail))
    return arr


def _set(arr, idx, val, mask):
    """Masked scatter-set into a small block (n, M, ...), functional: the
    masked rows go to an extra column that is cut off."""
    n, m = arr.shape[:2]
    tail = tuple(arr.shape[2:])
    ext = torch.cat([arr, arr.new_zeros((n, 1) + tail)], dim=1)
    j = _drop_idx(idx, mask, m)
    r = torch.arange(n, device=arr.device)[:, None]
    ext[r, j.long()] = _values(val, tuple(idx.shape) + tail, arr)
    return ext[:, :m].contiguous()


def _reduce_at(size: int, idx, val, mask, how: str, fill: int, at):
    """The reference's arbiter ``x = full(size, fill).at[where(mask, idx,
    size)].<how>(val, mode="drop")`` read back at ``at``, per replica
    row, without the (n, size) array: the lanes are sorted by their drop
    index, each run of one target reduced (``amin`` / ``amax``), and each
    ``at`` looked up among the targets (``fill`` where no lane names
    it).  Work in the lanes, not the keys; no host sync."""
    n, m = idx.shape
    dev = idx.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)[:, None] * (size + 1)
    tgt, order = torch.sort((rows + _drop_idx(idx, mask, size)).reshape(-1),
                            stable=True)
    head = torch.ones_like(tgt, dtype=torch.bool)
    head[1:] = tgt[1:] != tgt[:-1]
    seg = torch.cumsum(head, 0) - 1
    red = torch.full((n * m,), fill, dtype=I32, device=dev)
    red.scatter_reduce_(0, seg, val.expand(n, m).reshape(-1)[order].to(I32),
                        how, include_self=True)
    q = (rows + at).reshape(-1)
    pos = torch.searchsorted(tgt, q).clamp_(max=n * m - 1)
    return torch.where(tgt[pos] == q, red[seg[pos]], fill).reshape(at.shape)


def _first_true(x, size: int, fill: int):
    """``jnp.nonzero(x, size=size, fill_value=fill)`` of each row of the
    bool (n, M) ``x``: the first ``size`` true positions in ascending
    order, ``fill`` past them.  The running count of true positions is
    sorted, so the (j+1)-th true position is where the count first
    reaches j+1 (``searchsorted``); no host sync, one pass over ``x``."""
    n, m = x.shape
    rank = torch.cumsum(x, dim=1, dtype=I32)
    want = torch.arange(1, size + 1, dtype=I32,
                        device=x.device).expand(n, size).contiguous()
    pos = torch.searchsorted(rank, want)
    return torch.where(pos < m, pos, fill).to(I32)


def _hist_add(hist, lat, mask):
    """``hist.at[where(mask, clip(lat), nbin)].add(1, mode="drop")`` per
    replica: a scatter-add of ones (exact in integers)."""
    n, nbin = hist.shape
    j = torch.where(mask, lat.clamp(0, nbin - 1), nbin).long()
    add = torch.zeros((n, nbin + 1), dtype=I32, device=hist.device)
    add.scatter_add_(1, j, torch.ones_like(j, dtype=I32))
    return hist + add[:, :nbin]


def _count(x):
    """Per-replica count of a bool (n, M) mask, int32."""
    return x.sum(dim=-1, dtype=I32)


def _col(x):
    """A per-replica (n,) control row as an (n, 1) column."""
    return x[:, None]


# -- coordinate ---------------------------------------------------------------


class CoordinateOut(NamedTuple):
    table: st.KeyTable
    sess: st.Sessions
    replay: st.ReplaySlots
    out_inv: st.Invs
    comp: st.Completions


def coordinate(cfg: HermesConfig, ctl: st.Ctl, table: st.KeyTable,
               sess: st.Sessions, replay: st.ReplaySlots,
               stream: st.OpStream) -> CoordinateOut:
    """Op intake, local reads, update issue (with local same-key
    arbitration) and the replay scan; emits the outbound INV lanes
    (sessions ++ replay slots) and the read/NOP completions."""
    S, K, G = cfg.n_sessions, cfg.n_keys, cfg.ops_per_session
    RS = cfg.replay_slots
    n = sess.status.shape[0]
    dev = sess.status.device
    idx = torch.arange(S, dtype=I32, device=dev)[None, :].expand(n, S)
    frozen = _col(ctl.frozen)
    step = _col(ctl.step)

    # --- 1) op intake ---------------------------------------------------
    if cfg.wrap_stream:
        can_load = (sess.status == t.S_IDLE) & ~frozen
        g = torch.remainder(sess.op_idx, G)
    else:
        can_load = ((sess.status == t.S_IDLE) & (sess.op_idx < G) & ~frozen)
        g = sess.op_idx.clamp(0, G - 1)
    gl = g.long()[..., None]
    new_op = stream.op.gather(2, gl)[..., 0]
    new_key = stream.key.gather(2, gl)[..., 0]
    new_val = fst._write_value(cfg, ctl.my_cid, sess.op_idx)
    if stream.uval is not None:
        if stream.uval.dtype != I32:
            raise ValueError("the phases engine takes uval as int32 words "
                             "(R, S, G, value_words - 2)")
        w = stream.uval.shape[-1]
        u = stream.uval.gather(2, gl[..., None].expand(n, S, 1, w))[:, :, 0]
        new_val = torch.cat([new_val[..., :2], u], dim=-1)

    is_nop = can_load & (new_op == t.OP_NOP)
    loaded = torch.where(new_op == t.OP_READ, t.S_READ,
                         torch.where(new_op == t.OP_NOP, t.S_IDLE, t.S_ISSUE))
    status = torch.where(can_load, loaded, sess.status)
    if not cfg.wrap_stream:
        status = torch.where((status == t.S_IDLE) & (sess.op_idx >= G),
                             t.S_DONE, status)
    status = status.to(I32)
    key = torch.where(can_load, new_key, sess.key)
    sess = sess._replace(
        status=status,
        op=torch.where(can_load, new_op, sess.op),
        key=key,
        val=torch.where(can_load[..., None], new_val, sess.val),
        invoke_step=torch.where(can_load, step, sess.invoke_step).to(I32),
        op_idx=torch.where(is_nop, sess.op_idx + 1, sess.op_idx),
    )

    # --- 2) local reads -------------------------------------------------
    gk = _gather_idx(sess.key, K)
    kstate = _rows(table.state, gk)
    read_done = (sess.status == t.S_READ) & (kstate == t.VALID) & ~frozen
    rd_val = _rows(table.val, gk)
    sess = sess._replace(
        status=torch.where(read_done, t.S_IDLE, sess.status).to(I32),
        op_idx=torch.where(read_done, sess.op_idx + 1, sess.op_idx),
        rd_val=torch.where(read_done[..., None], rd_val, sess.rd_val),
    )

    # --- 3) update issue (put / rmw), local same-key arbitration ----------
    want = (sess.status == t.S_ISSUE) & (kstate == t.VALID) & ~frozen
    win = want & (_reduce_at(K, sess.key, idx, want, "amin", I32_MAX, gk)
                  == idx)

    new_ver = _rows(table.ver, gk) + 1
    flag = torch.where(sess.op == t.OP_WRITE, t.FLAG_WRITE, t.FLAG_RMW)
    new_fc = make_fc(flag, _col(ctl.my_cid)).to(I32)
    old_val = _rows(table.val, gk)  # the RMW read-part: the pre-issue value

    _set_(table.state, sess.key, t.WRITE, win)
    _set_(table.ver, sess.key, new_ver, win)
    _set_(table.fc, sess.key, new_fc, win)
    _set_(table.val, sess.key, sess.val, win)
    _set_(table.inv_step, sess.key, step.expand(n, S), win)
    sess = sess._replace(
        status=torch.where(win, t.S_INFL, sess.status).to(I32),
        ver=torch.where(win, new_ver, sess.ver),
        fc=torch.where(win, new_fc, sess.fc),
        acks=torch.where(win, 0, sess.acks).to(I32),
        superseded=torch.where(win, False, sess.superseded),
        rd_val=torch.where((win & (sess.op == t.OP_RMW))[..., None], old_val,
                           sess.rd_val),
    )

    # --- 4) replay scan ---------------------------------------------------
    # INVALID (1) or TRANS (3): the only states with (s & ~2) == 1
    stuck = (((table.state & ~2) == t.INVALID)
             & (table.inv_step < step - cfg.replay_age))
    cand = _first_true(stuck, RS, K)
    fslot = _first_true(~replay.active, RS, RS)
    assign = (cand < K) & (fslot < RS) & ~frozen
    cc = cand.clamp(0, K - 1)
    replay = replay._replace(
        active=_set(replay.active, fslot, True, assign),
        key=_set(replay.key, fslot, cand, assign),
        ver=_set(replay.ver, fslot, _rows(table.ver, cc), assign),
        fc=_set(replay.fc, fslot, _rows(table.fc, cc), assign),
        val=_set(replay.val, fslot, _rows(table.val, cc), assign),
        acks=_set(replay.acks, fslot, 0, assign),
    )
    _set_(table.state, cand, t.REPLAY, assign)

    # --- 5) outbound INV lanes (sessions ++ replay slots) -------------------
    infl = sess.status == t.S_INFL
    out_inv = st.Invs(
        valid=torch.cat([infl, replay.active], dim=1) & ~frozen,
        key=torch.cat([sess.key, replay.key], dim=1),
        ver=torch.cat([sess.ver, replay.ver], dim=1),
        fc=torch.cat([sess.fc, replay.fc], dim=1),
        epoch=_col(ctl.epoch).expand(n, cfg.n_lanes).contiguous(),
        val=torch.cat([sess.val, replay.val], dim=1),
        alive=~ctl.frozen,
    )

    # --- completions (reads + nops) ---------------------------------------
    code = torch.where(read_done, t.C_READ,
                       torch.where(is_nop, t.C_NOP, t.C_NONE)).to(I32)
    comp = st.Completions(
        code=code, key=sess.key, wval=sess.val, rval=sess.rd_val,
        ver=sess.ver, fc=sess.fc, invoke_step=sess.invoke_step,
        commit_step=step.expand(n, S).contiguous())
    return CoordinateOut(table, sess, replay, out_inv, comp)


# -- apply_inv ------------------------------------------------------------------


class ApplyInvOut(NamedTuple):
    table: st.KeyTable
    sess: st.Sessions
    meta: st.Meta
    out_ack: st.Acks
    comp: st.Completions


class InvWinners(NamedTuple):
    """What ``apply_inv`` writes: for each inbound lane (flattened over
    (R_src, L)) its key, timestamp and value; ``beats_all`` the lanes that
    beat the key's timestamp, ``beats`` the one of them a target keeps
    (the rows the set-scatters write)."""

    key: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    val: torch.Tensor
    ok: torch.Tensor
    beats_all: torch.Tensor
    beats: torch.Tensor
    new_state: torch.Tensor


def inv_winners(cfg: HermesConfig, ctl: st.Ctl, table: st.KeyTable,
                in_inv: st.Invs) -> InvWinners:
    """The two-pass lexicographic max over one round's inbound INVs per
    key (ver, then fc among the max ver) and the lanes that beat the
    table: the rows ``apply_inv`` scatters."""
    K, V = cfg.n_keys, cfg.value_words
    n, R, L = in_inv.valid.shape
    ok = (in_inv.valid & (in_inv.epoch == ctl.epoch[:, None, None])
          & ~ctl.frozen[:, None, None])
    key = in_inv.key.reshape(n, R * L)
    ver = in_inv.ver.reshape(n, R * L)
    fc = in_inv.fc.reshape(n, R * L)
    val = in_inv.val.reshape(n, R * L, V)
    okf = ok.reshape(n, R * L)
    ck = key.clamp(0, K - 1)

    vmax = okf & (ver == _reduce_at(K, key, ver, okf, "amax", I32_MIN, ck))
    winner = vmax & (fc == _reduce_at(K, key, fc, vmax, "amax", I32_MIN, ck))

    beats = winner & ts_gt(ver, fc, _rows(table.ver, ck), _rows(table.fc, ck))
    # Several lanes can beat with one key and timestamp: a write and a
    # replay of it (equal rows), or two writes the joiner minted with one
    # timestamp (ROADMAP C, "a join re-mints a timestamp"; their values
    # differ).  JAX's scatter on the CPU keeps the last such lane;
    # index_put_ on the card keeps any, so each target keeps its last
    # lane here, on every device.
    lane = torch.arange(R * L, dtype=I32, device=key.device).expand(n, R * L)
    own = torch.where(key < 0, key + K, key).clamp(0, K - 1)
    last = _reduce_at(K, key, lane, beats, "amax", I32_MIN, own)
    tstate = _rows(table.state, ck)
    had_pending = (tstate == t.WRITE) | (tstate == t.TRANS)
    new_state = torch.where(had_pending, t.TRANS, t.INVALID).to(I32)
    return InvWinners(key, ver, fc, val, ok, beats, beats & (lane == last),
                      new_state)


def apply_inv(cfg: HermesConfig, ctl: st.Ctl, table: st.KeyTable,
              sess: st.Sessions, meta: st.Meta,
              in_inv: st.Invs) -> ApplyInvOut:
    """The follower's ``apply_inv()`` over the (R_src, L) inbound INV block
    of each replica: a winning INV newer than the key's timestamp applies
    its value and timestamp and moves the key Invalid (Trans where a local
    write was pending); every valid INV is acked.  Also completes pending
    updates a replayer already validated (``pre_committed``) and aborts a
    pending RMW whose key timestamp moved."""
    K, S = cfg.n_keys, cfg.n_sessions
    n, R, L = in_inv.valid.shape
    frozen = _col(ctl.frozen)
    step = _col(ctl.step)

    gk = _gather_idx(sess.key, K)
    pre_infl = sess.status == t.S_INFL
    pre_committed = (pre_infl & (_rows(table.state, gk) == t.VALID)
                     & ts_eq(sess.ver, sess.fc, _rows(table.ver, gk),
                             _rows(table.fc, gk))
                     & ~frozen)

    w = inv_winners(cfg, ctl, table, in_inv)
    _set_(table.state, w.key, w.new_state, w.beats)
    _set_(table.ver, w.key, w.ver, w.beats)
    _set_(table.fc, w.key, w.fc, w.beats)
    _set_(table.val, w.key, w.val, w.beats)
    _set_(table.inv_step, w.key, step.expand(n, R * L), w.beats)

    # --- supersession of local pending updates ----------------------------
    infl = sess.status == t.S_INFL
    moved = (infl & ~ts_eq(sess.ver, sess.fc, _rows(table.ver, gk),
                           _rows(table.fc, gk)) & ~frozen)
    is_rmw = sess.op == t.OP_RMW
    abort = moved & is_rmw & ~pre_committed
    done = abort | pre_committed
    sess = sess._replace(
        superseded=sess.superseded | (moved & (sess.op == t.OP_WRITE)
                                      & ~pre_committed),
        status=torch.where(done, t.S_IDLE, sess.status).to(I32),
        op_idx=torch.where(done, sess.op_idx + 1, sess.op_idx),
    )
    lat = torch.where(pre_committed, step - sess.invoke_step, 0).to(I32)
    meta = meta._replace(
        n_abort=meta.n_abort + _count(abort),
        n_write=meta.n_write + _count(pre_committed & ~is_rmw),
        n_rmw=meta.n_rmw + _count(pre_committed & is_rmw),
        lat_sum=meta.lat_sum + lat.sum(dim=-1, dtype=I32),
        lat_cnt=meta.lat_cnt + _count(pre_committed),
        lat_hist=_hist_add(meta.lat_hist, lat, pre_committed),
    )
    code = torch.where(
        abort, t.C_RMW_ABORT,
        torch.where(pre_committed, torch.where(is_rmw, t.C_RMW, t.C_WRITE),
                    t.C_NONE)).to(I32)
    comp = st.Completions(
        code=code, key=sess.key, wval=sess.val, rval=sess.rd_val,
        ver=sess.ver, fc=sess.fc, invoke_step=sess.invoke_step,
        commit_step=step.expand(n, S).contiguous())

    # --- ACK every valid INV, with the conflict flag ------------------------
    ck = w.key.clamp(0, K - 1)
    ack_ok = ts_eq(w.ver, w.fc, _rows(table.ver, ck),
                   _rows(table.fc, ck)).reshape(n, R, L)
    out_ack = st.Acks(
        valid=w.ok & ~ctl.frozen[:, None, None],
        key=in_inv.key, ver=in_inv.ver, fc=in_inv.fc, ok=ack_ok,
        epoch=ctl.epoch[:, None, None].expand(n, R, L).contiguous())

    # --- heartbeats -------------------------------------------------------
    meta = meta._replace(last_seen=torch.where(
        in_inv.alive & ~frozen, step, meta.last_seen).to(I32))
    return ApplyInvOut(table, sess, meta, out_ack, comp)


# -- collect_acks ----------------------------------------------------------------


class CollectAcksOut(NamedTuple):
    table: st.KeyTable
    sess: st.Sessions
    replay: st.ReplaySlots
    meta: st.Meta
    out_val: st.Vals
    comp: st.Completions


def collect_acks(cfg: HermesConfig, ctl: st.Ctl, table: st.KeyTable,
                 sess: st.Sessions, replay: st.ReplaySlots, meta: st.Meta,
                 in_ack: st.Acks) -> CollectAcksOut:
    """The coordinator's ``poll_acks()`` + commit + ``broadcast_val()``:
    ``in_ack[i, q, l]`` is replica q's ack of replica i's lane l.  A
    pending update commits once its ack bitmap covers every live replica;
    a nacked RMW aborts; replay lanes commit, are superseded or (nacked)
    released.  Commits emit lane-aligned VALs."""
    S, RS, K = cfg.n_sessions, cfg.replay_slots, cfg.n_keys
    n, R = in_ack.valid.shape[:2]
    full = (1 << R) - 1
    bit = (1 << torch.arange(R, dtype=I32, device=in_ack.valid.device)
           )[None, :, None]
    frozen = _col(ctl.frozen)
    live = _col(ctl.live_mask)
    step = _col(ctl.step)

    ok = (in_ack.valid & (in_ack.epoch == ctl.epoch[:, None, None])
          & ~ctl.frozen[:, None, None])
    sess_ack = (ok[:, :, :S]
                & (in_ack.key[:, :, :S] == sess.key[:, None, :])
                & ts_eq(in_ack.ver[:, :, :S], in_ack.fc[:, :, :S],
                        sess.ver[:, None, :], sess.fc[:, None, :]))
    rep_ack = (ok[:, :, S:]
               & (in_ack.key[:, :, S:] == replay.key[:, None, :])
               & ts_eq(in_ack.ver[:, :, S:], in_ack.fc[:, :, S:],
                       replay.ver[:, None, :], replay.fc[:, None, :]))

    infl = sess.status == t.S_INFL
    acks = sess.acks | torch.where(sess_ack, bit, 0).sum(dim=1, dtype=I32)
    acks = torch.where(infl, acks, sess.acks)
    covered = ((acks | ~live) & full) == full
    nacked = (sess_ack & ~in_ack.ok[:, :, :S]).any(dim=1)
    abort = infl & nacked & (sess.op == t.OP_RMW) & ~frozen
    commit = infl & covered & ~frozen & ~abort

    gk = _gather_idx(sess.key, K)
    owns = ts_eq(sess.ver, sess.fc, _rows(table.ver, gk), _rows(table.fc, gk))
    _set_(table.state, sess.key, t.VALID, commit & owns)

    # --- replay lanes -------------------------------------------------------
    racks = torch.where(
        replay.active,
        replay.acks | torch.where(rep_ack, bit, 0).sum(dim=1, dtype=I32),
        replay.acks)
    rcovered = ((racks | ~live) & full) == full
    rk = _gather_idx(replay.key, K)
    rowns = ts_eq(replay.ver, replay.fc, _rows(table.ver, rk),
                  _rows(table.fc, rk))
    rnacked = (rep_ack & ~in_ack.ok[:, :, S:]).any(dim=1)
    rcommit = replay.active & rcovered & ~frozen & ~rnacked
    rsuperseded = replay.active & ~rowns & ~frozen
    rreleased = replay.active & rnacked & ~frozen
    _set_(table.state, replay.key, t.VALID, rcommit & rowns)
    replay = replay._replace(
        acks=racks, active=replay.active & ~rcommit & ~rsuperseded & ~rreleased)

    # --- outbound VALs --------------------------------------------------------
    out_val = st.Vals(
        valid=torch.cat([commit, rcommit & rowns], dim=1) & ~frozen,
        key=torch.cat([sess.key, replay.key], dim=1),
        ver=torch.cat([sess.ver, replay.ver], dim=1),
        fc=torch.cat([sess.fc, replay.fc], dim=1),
        epoch=_col(ctl.epoch).expand(n, cfg.n_lanes).contiguous())

    # --- session completion + stats -----------------------------------------
    is_rmw = sess.op == t.OP_RMW
    code = torch.where(
        abort, t.C_RMW_ABORT,
        torch.where(commit, torch.where(is_rmw, t.C_RMW, t.C_WRITE),
                    t.C_NONE)).to(I32)
    comp = st.Completions(
        code=code, key=sess.key, wval=sess.val, rval=sess.rd_val,
        ver=sess.ver, fc=sess.fc, invoke_step=sess.invoke_step,
        commit_step=step.expand(n, S).contiguous())
    lat = torch.where(commit, step - sess.invoke_step, 0).to(I32)
    meta = meta._replace(
        n_write=meta.n_write + _count(commit & ~is_rmw),
        n_rmw=meta.n_rmw + _count(commit & is_rmw),
        n_abort=meta.n_abort + _count(abort),
        lat_sum=meta.lat_sum + lat.sum(dim=-1, dtype=I32),
        lat_cnt=meta.lat_cnt + _count(commit),
        lat_hist=_hist_add(meta.lat_hist, lat, commit),
    )
    done = commit | abort
    sess = sess._replace(
        acks=acks,
        status=torch.where(done, t.S_IDLE, sess.status).to(I32),
        op_idx=torch.where(done, sess.op_idx + 1, sess.op_idx),
    )
    return CollectAcksOut(table, sess, replay, meta, out_val, comp)


# -- apply_val -------------------------------------------------------------------


def apply_val(cfg: HermesConfig, ctl: st.Ctl, table: st.KeyTable,
              in_val: st.Vals) -> st.KeyTable:
    """The follower's VAL apply: a VAL whose timestamp equals the key's
    current one validates the key."""
    K = cfg.n_keys
    n = in_val.valid.shape[0]
    key = in_val.key.reshape(n, -1)
    ck = key.clamp(0, K - 1)
    ok = (in_val.valid.reshape(n, -1)
          & (in_val.epoch.reshape(n, -1) == _col(ctl.epoch))
          & ~_col(ctl.frozen)
          & ts_eq(in_val.ver.reshape(n, -1), in_val.fc.reshape(n, -1),
                  _rows(table.ver, ck), _rows(table.fc, ck)))
    _set_(table.state, key, t.VALID, ok)
    return table


def merge_completions(*comps: st.Completions) -> st.Completions:
    """At most one completion a session a round (the phases complete
    disjoint sessions); a later phase's completion wins."""
    out = comps[0]
    for c in comps[1:]:
        m = c.code != t.C_NONE
        mv = m[..., None]
        out = st.Completions(
            code=torch.where(m, c.code, out.code),
            key=torch.where(m, c.key, out.key),
            wval=torch.where(mv, c.wval, out.wval),
            rval=torch.where(mv, c.rval, out.rval),
            ver=torch.where(m, c.ver, out.ver),
            fc=torch.where(m, c.fc, out.fc),
            invoke_step=torch.where(m, c.invoke_step, out.invoke_step),
            commit_step=torch.where(m, c.commit_step, out.commit_step),
        )
    return out
