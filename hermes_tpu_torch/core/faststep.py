"""The fast engine — one Hermes protocol round in PyTorch.

Port of ``hermes_tpu/core/faststep.py``: the round (coordinate -> INV ->
apply_inv -> ACK -> collect_acks -> VAL) with packed Lamport timestamps
arbitrated by one scatter-max, lane compaction with rebroadcast backoff,
and the gated stuck-key replay scan, in both of the reference's engines:

* batched (``fast_round_batched``): one packed key-state table shared by
  the R replicas of one device, the ACK bitmap derived from the shared
  verdicts;
* sharded (``fast_round_sharded``): one table copy a replica, the INV
  blocks compacted into wire slots and gathered, each replica
  arbitrating them against its own copy, the ACK verdicts routed back
  and matched, the VAL bits gathered — the reference's shard body run
  over a leading axis of local replicas, its collectives those of a
  replica group (``core/group.py``).

The module docstring and comments of the reference explain the protocol
and the packing; this file keeps its names and layout so the two read
side by side, and notes only where PyTorch needs something the reference
did not.

Where PyTorch differs from JAX (each checked against the reference by
tests/test_torch_faststep.py, round by round, bit for bit):

* **In-place table.**  JAX donates the state tree to the compiled round;
  here the two table arrays (``vpts``, ``bank``) are updated in place by
  their scatters.  Session, replay and Meta leaves are rebuilt by the
  round function; the compiled round (``core/graphs.py``) copies them
  back into the state it was given, so a compiled round's state is the
  same tensors round after round, and its Completions sit in a ring of
  their own.
* **Dropped scatters.**  The reference sends masked rows to an
  out-of-range index with ``mode="drop"``; torch index ops raise on that.
  The table therefore carries ONE extra trailing row, the drop row (row
  K of ``vpts`` and ``bank``): masked rows scatter there, and nothing
  reads it.  Each sharded copy has its own (row ``r*(K+1)+K``), so a
  copy is exactly a batched table; an untrusted wire key at or above K
  is masked out of the scatters (never offset into the next copy) and
  clamped to K-1 of its own copy for the reads.  Scratch scatter targets
  get the same extra slot.
* **Stable sorts.**  ``lax.sort(..., num_keys=1)`` is stable, which gives
  lowest-session-wins; ``torch.sort(stable=True)`` on the key, with the
  other operands gathered through the permutation, is the same.
* **Set-scatters with duplicate indices** (the winner-row write, the
  replay mark) are correct only because every duplicate writes an
  identical row; ``index_put_`` orders duplicates arbitrarily, so the same
  argument carries over unchanged.
* **The gated replay scan.**  The predicate ``step % replay_scan_every ==
  0`` reads the host's step mirror (``FastCtl.host_step``) so the round
  never syncs; the device step (``FastCtl.step``) does the arithmetic.
* **Integer arithmetic.**  int32 tensors as in the reference.  Products
  that may wrap (write uids) are formed in int64 and wrapped to int32
  explicitly; the bank's byte order is defined by arithmetic
  (``_bank_to_i32``), never by a ``view``.

The kernels on this path: ``kernels.stats_block`` (once per round, in
``_collect_acks``) and, with ``cfg.use_mega_round``, the three mega-round
kernels of ``core/megaround.py`` at the reference's three sites —
``mega_replay`` for the gated replay scan (sharded: once a copy, on its
K-row view), ``mega_route`` for the fused sort's route-back scatter,
``mega_apply`` for the arbiter scatter-max and the verdict gather of
``_derived_acks`` (sharded: ``_apply_inv``'s, one launch over the flat
table of every copy).  ``jax.jit`` is a CUDA graph here:
``build_fast_batched``, ``build_fast_sharded`` (on a ``LocalGroup``) and
``build_fast_scan`` return rounds compiled by ``core/graphs.py``, captured
once a variant and replayed on the card (called eagerly on the CPU, with
the same bound state); a ``build_fast_scan`` chunk of rounds is one graph,
the counterpart of ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import graphs, kernels, layouts, megaround
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.workload import ycsb

I32 = torch.int32

PTS_FC_BITS = layouts.PTS_FC_BITS
FC_MASK = layouts.FC_MASK
SST_STEP_SHIFT = layouts.SST.field("step").shift
SST_STATE_MASK = layouts.SST.field("state").mask
I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1

# bank row layout: int32-word indices of [pts | sst | val words]
BANK_PTS = 0
BANK_SST = 1
BANK_VAL = 2

INV_KEY_MASK = layouts.INV_PKF.field("key").mask
INV_FRESH = layouts.INV_PKF.field("fresh").mask
INV_VALID = layouts.INV_PKF.field("valid").mask

FUSED_BAND_SHIFT = layouts.FUSED_KEY.field("band").shift
LANE_CHAIN_MASK = layouts.LANE_WORD.field("chain_rank").mask
LANE_ISSUE_SHIFT = layouts.LANE_WORD.field("issue").shift
LANE_TAKEN_SHIFT = layouts.LANE_WORD.field("taken").shift

ACK_KEY_SHIFT = layouts.ACK_PKF.field("key").shift
ACK_OK_MASK = layouts.ACK_PKF.field("ok").mask
ACK_VALID_MASK = layouts.ACK_PKF.field("valid").mask

META_EPOCH_SHIFT = layouts.BLOCK_META.field("epoch").shift
META_ALIVE_MASK = layouts.BLOCK_META.field("alive").mask


def pack_pts(ver, fc):
    return (ver << PTS_FC_BITS) | fc


def pts_ver(pts):
    return pts >> PTS_FC_BITS


def pts_fc(pts):
    return pts & FC_MASK


def pack_sst(step, state):
    return (step << SST_STEP_SHIFT) | state


def sst_state(sst):
    return sst & SST_STATE_MASK


def sst_step(sst):
    return sst >> SST_STEP_SHIFT


def _full(like, value):
    """An int32 tensor shaped like ``like`` filled with ``value``."""
    return torch.full(like.shape, value, dtype=I32, device=like.device)


def _wrap32(x64):
    """int64 -> int32 with two's-complement wrap (JAX int32 overflow)."""
    return (((x64 + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(I32)


def _rotated(idx, step, n: int):
    """Per-round anti-starvation rotation ``(idx + (step % n)*stride) % n``
    (mod-first, as in the reference, so the product fits int32)."""
    stride = layouts.ROT_STRIDE if n <= layouts.ROT_CAP else 1
    return torch.remainder(idx + torch.remainder(step, n) * stride, n)


# --------------------------------------------------------------------------
# State containers (leading axis = replicas, R)
# --------------------------------------------------------------------------


class FastTable(NamedTuple):
    """Key-state table.  The batched engine holds ONE copy, shared by the
    replicas of the device:

      ``vpts`` (K+1,) int32 — max applied packed ts (the Lamport arbiter);
      ``bank`` (K+1, 4*(2+V)) int8 — the bytes of [pts | sst | val words].

    Row K of both is the drop row (see the module docstring): it absorbs
    masked scatters and is never read.  The sharded engine holds one copy
    a local replica, each with its own drop row: ``vpts``
    ``(n*(K+1),)``, ``bank`` ``(n*(K+1), 4*(2+V))``, replica r's copy the
    rows ``[r*(K+1), (r+1)*(K+1))`` — exactly a batched table, so a
    function written for one table runs unchanged on the view.  The
    layout is never inferred from the shapes: the runtime carries it
    (``FastRuntime.backend``), and ``copies`` views either layout as
    ``(n, K, ...)``.  The properties below read the batched layout.  Both
    arrays are updated in place by the round."""

    vpts: torch.Tensor
    bank: torch.Tensor

    @property
    def sst(self):
        return _bank_to_i32(self.bank[:-1])[:, BANK_SST]

    @property
    def val(self):
        return _bank_to_i32(self.bank[:-1])[:, BANK_VAL:]

    @property
    def row_pts(self):
        return _bank_to_i32(self.bank[:-1])[:, BANK_PTS]


def _bank_to_i32(rows8):
    """int8 byte rows (..., 4*W) -> int32 words (..., W), little-endian
    by arithmetic: the low three bytes as unsigned values plus the top
    byte's signed value times 2^24 (exact in int32, no shift into the sign
    bit)."""
    b = rows8.to(I32)
    u = b & 0xFF
    return ((u[..., 0::4] | (u[..., 1::4] << 8) | (u[..., 2::4] << 16))
            + b[..., 3::4] * (1 << 24))


def _i32_to_bank(rows32):
    """int32 words (..., W) -> int8 byte rows (..., 4*W); inverse of
    _bank_to_i32.  Each byte is recentred to [-128, 127] before the int8
    conversion, so no conversion leaves its range."""
    parts = [(rows32 >> (8 * k)) & 0xFF for k in range(4)]
    b = torch.stack(parts, dim=-1)
    b = (b ^ 0x80) - 0x80
    return b.reshape(rows32.shape[:-1] + (4 * rows32.shape[-1],)).to(torch.int8)


class FastSess(NamedTuple):
    """Client sessions (R, S)."""

    status: torch.Tensor
    op: torch.Tensor
    op_idx: torch.Tensor
    key: torch.Tensor
    val: torch.Tensor  # (R, S, 4V) int8 — values are opaque BYTE payloads
    pts: torch.Tensor  # packed pending-update ts
    acks: torch.Tensor  # gathered-ack replica bitmap
    rd_val: torch.Tensor  # (R, S, 4V) int8
    invoke_step: torch.Tensor
    retries: torch.Tensor
    issue_step: torch.Tensor


class FastReplay(NamedTuple):
    """Replay slots (R, RS): snapshot of a stuck key's last INV."""

    active: torch.Tensor  # bool
    key: torch.Tensor
    pts: torch.Tensor
    val: torch.Tensor  # (R, RS, 4V) int8
    acks: torch.Tensor


class FastInv(NamedTuple):
    """Compacted INV block as one byte tensor ``rows8`` (..., C, 8+4V)
    holding the bytes of [pkf | pts | val] per slot, plus the per-block
    ``meta`` word (epoch << 1) | alive.  The batched round never builds
    it (it applies straight from the lane block); the sharded round
    compacts one a replica (``_compact_out_inv``) and gathers them into
    the source-shaped block ``_apply_inv`` takes."""

    rows8: torch.Tensor
    meta: torch.Tensor

    @property
    def epoch(self):
        return self.meta >> META_EPOCH_SHIFT

    @property
    def alive(self):
        return (self.meta & META_ALIVE_MASK) != 0

    @property
    def pkf(self):
        return _bank_to_i32(self.rows8[..., 0:4])[..., 0]

    @property
    def pts(self):
        return _bank_to_i32(self.rows8[..., 4:8])[..., 0]

    @property
    def val(self):
        return self.rows8[..., 8:]

    @property
    def valid(self):
        return (self.pkf & INV_VALID) != 0

    @property
    def fresh(self):
        return (self.pkf & INV_FRESH) != 0

    @property
    def key(self):
        return self.pkf & INV_KEY_MASK


class LaneBlock(NamedTuple):
    """Per-lane pending-update view (R, L, ...): every session and replay
    slot's (key, ts, value) plus the fresh bit."""

    key: torch.Tensor
    pts: torch.Tensor
    val: torch.Tensor  # (R, L, 4V) int8
    fresh: torch.Tensor  # bool


class FastState(NamedTuple):
    table: FastTable
    sess: FastSess
    replay: FastReplay
    meta: st.Meta


def copies(x, n_keys: int):
    """A table column of either layout, ``(n*(K+1), ...)``, as the view
    ``(n, K, ...)`` of each copy's key rows (the drop rows left out)."""
    return x.view((-1, n_keys + 1) + tuple(x.shape[1:]))[:, :n_keys]


def init_fast_state(cfg: HermesConfig, device: torch.device,
                    n_copies=None) -> FastState:
    """Fresh replicated state on ``device``: all keys Valid at version 0
    with the recognizable initial value (lo=key, hi=-1).  ``n_copies``
    None: the batched layout (one shared table, R replicas); n: the
    sharded layout of n local replicas, one table copy each (the
    reference's ``n_local``)."""
    k, s, rs, v = (cfg.n_keys, cfg.n_sessions, cfg.replay_slots,
                   cfg.value_words)
    r = cfg.n_replicas if n_copies is None else n_copies
    nv = 1 if n_copies is None else n_copies
    rows32 = torch.zeros((nv, k + 1, 2 + v), dtype=I32, device=device)
    rows32[:, :k, BANK_VAL] = torch.arange(k, dtype=I32, device=device)
    rows32[:, :k, BANK_VAL + 1] = -1
    rows32 = rows32.reshape(nv * (k + 1), 2 + v)

    def z(*sh):
        return torch.zeros(sh, dtype=I32, device=device)

    def z8(*sh):
        return torch.zeros(sh, dtype=torch.int8, device=device)

    return FastState(
        table=FastTable(vpts=z(nv * (k + 1)), bank=_i32_to_bank(rows32)),
        sess=FastSess(
            status=z(r, s), op=z(r, s), op_idx=z(r, s), key=z(r, s),
            val=z8(r, s, 4 * v), pts=z(r, s), acks=z(r, s),
            rd_val=z8(r, s, 4 * v), invoke_step=z(r, s), retries=z(r, s),
            issue_step=z(r, s),
        ),
        replay=FastReplay(
            active=torch.zeros((r, rs), dtype=torch.bool, device=device),
            key=z(r, rs), pts=z(r, rs), val=z8(r, rs, 4 * v), acks=z(r, rs),
        ),
        meta=st.init_meta(cfg, device, n_rows=r),
    )


# --------------------------------------------------------------------------
# Flat-index helper (leading replica axis folded in)
# --------------------------------------------------------------------------


def _gkey(rows: int, key, mask=None):
    """Flat index ``replica * (rows // R) + key`` into a flat column of
    ``rows`` entries followed by one drop entry; masked rows get the drop
    index ``rows``."""
    r = key.shape[0]
    per = rows // r
    ridx = torch.arange(r, dtype=I32, device=key.device).reshape(
        (r,) + (1,) * (key.dim() - 1))
    g = ridx * per + key
    if mask is not None:
        g = torch.where(mask, g, rows)
    return g


# --------------------------------------------------------------------------
# The round
# --------------------------------------------------------------------------


class FastCtl(NamedTuple):
    """Per-round control: the device step scalar and its host mirror,
    plus per-replica membership/failure rows on the device.

    ``host_step`` gates the replay scan without a device sync; ``step``
    (a 0-dim int32 tensor) is what the round computes with.  ``quiesce``
    (the version-rebase drain: no new intake or issues) is a host bool."""

    step: torch.Tensor
    host_step: int
    my_cid: torch.Tensor  # (R,)
    epoch: torch.Tensor  # (R,)
    live_mask: torch.Tensor  # (R,)
    frozen: torch.Tensor  # (R,) bool
    quiesce: bool = False


def _run_issue(cfg: HermesConfig, first, in_run, sop, pos):
    """Equal-key-run issue decision over a SORTED axis (the chain
    semantics shared by the fused and split sort paths): the run head
    always issues; with cfg.chain_writes up to chain_writes plain writes
    right behind it join as a chain, and an RMW blocks chaining past it.
    Returns (issue, rank) with rank=None when chaining is off."""
    if not cfg.chain_writes:
        return in_run & first, None
    start = torch.cummax(torch.where(first, pos, -1), dim=1).values
    bad = sop != t.OP_WRITE
    last_bad = torch.cummax(torch.where(bad, pos, -1), dim=1).values
    rank = pos - start
    issue = in_run & (
        first | (~bad & (last_bad < start) & (rank < cfg.chain_writes)))
    return issue, torch.where(issue, rank.clamp(0, cfg.chain_writes - 1), 0)


def _stream_idx(cfg: HermesConfig, op_idx):
    """Stream slot addressed by a session's op counter (wrap vs clip)."""
    G = cfg.ops_per_session
    return (torch.remainder(op_idx, G) if cfg.wrap_stream
            else op_idx.clamp(0, G - 1))


def _write_value(cfg: HermesConfig, my_cid, op_idx):
    """Unique write values (checker witness): words 0/1 = (lo, hi) uid;
    int32 wrap as in the reference, formed in int64."""
    r, s = op_idx.shape
    sess_idx = torch.arange(s, dtype=torch.int64, device=op_idx.device)[None, :]
    lo = _wrap32(op_idx.to(torch.int64) * cfg.n_sessions + sess_idx)
    words = [lo, my_cid[:, None].expand(r, s)]
    for j in range(2, cfg.value_words):
        words.append(_wrap32(lo.to(torch.int64) * -1640531527 + j))
    return torch.stack(words, dim=-1)


def _rows(key, base):
    """Table row of ``key`` in each replica's copy: the key itself in the
    batched layout (``base`` None), ``base + key`` in the sharded one
    (``base`` the (R, 1) first rows of the local copies)."""
    return (key if base is None else key + base).long()


def _replay_scan(cfg: HermesConfig, ctl: FastCtl, table: FastTable,
                 replay: FastReplay, base=None):
    """The stuck-key replay scan (the reference's ``do_scan``): candidate
    stuck rows in ascending row order, each replica's i-th free slot takes
    the i-th candidate, and taken rows are re-stamped REPLAY (in place).
    Batched: one scan of the shared table; sharded (``base``): each
    replica scans its own copy."""
    K, RS = cfg.n_keys, cfg.replay_slots
    R = replay.active.shape[0]
    step, bank = ctl.step, table.bank
    dev = bank.device
    sstK = _bank_to_i32(copies(bank, K)[..., 4 * BANK_SST:
                                        4 * BANK_SST + 4])[..., 0]  # (n, K)
    age = step - sst_step(sstK)
    state = sst_state(sstK)
    stuck = ((state == t.INVALID) | (state == t.TRANS)
             | (state == t.REPLAY)) & (age > cfg.replay_age)
    kiota = torch.arange(K, dtype=I32, device=dev)
    score = torch.where(stuck, -kiota, I32_MIN)
    # top_k VALUES: stuck rows score -row (distinct), the rest I32_MIN, so
    # the value list is the same whatever order ties come out in
    top = torch.topk(score, RS, dim=1).values
    cand_ok1 = top != I32_MIN
    cand1 = torch.remainder(torch.where(cand_ok1, -top, 0), K)
    cand_ok = cand_ok1.expand(R, RS) & ~ctl.frozen[:, None]
    cand = cand1.expand(R, RS)
    free = ~replay.active
    free_rank = torch.cumsum(free.to(I32), dim=1, dtype=I32) - 1
    take = torch.where(free, free_rank, RS)
    tk = take.clamp(max=RS).long()
    pad_ok = torch.cat([cand_ok, torch.zeros((R, 1), dtype=torch.bool,
                                             device=dev)], dim=1)
    pad_cand = torch.cat([cand, torch.zeros((R, 1), dtype=I32, device=dev)],
                         dim=1)
    take_ok = (take < RS) & torch.gather(pad_ok, 1, tk)
    ck = torch.gather(pad_cand, 1, tk)
    crow = _rows(ck, base)
    ckrow8 = bank[crow]  # (R, RS, 4*(2+V)) snapshot byte rows
    ckval8 = ckrow8[..., 4 * BANK_VAL:]
    new_replay = FastReplay(
        active=take_ok | replay.active,
        key=torch.where(take_ok, ck, replay.key),
        pts=torch.where(take_ok, table.vpts[crow], replay.pts),
        val=torch.where(take_ok[..., None], ckval8, replay.val),
        acks=torch.where(take_ok, 0, replay.acks),
    )
    mark_sst = _i32_to_bank(pack_sst(step, t.REPLAY).reshape(1, 1, 1)
                            ).expand(R, RS, 4)
    mark = torch.cat([ckrow8[..., :4 * BANK_SST], mark_sst, ckval8], dim=-1)
    # In place (JAX donates the table).  Live rows are distinct candidates
    # within a replica; across replicas the same candidate row of the one
    # batched table is marked with identical bytes (each sharded replica
    # marks its own copy), so duplicate indices cannot disagree.  Masked
    # rows go to the copy's drop row.  Audited: the analysis cannot prove
    # take-injectivity.
    rows = torch.where(take_ok, crow, _rows(_full(ck, K), base)
                       ).reshape(-1)
    with layouts.audited("replay-mark-dup-oob-dropped"):
        bank.index_put_((rows,), mark.reshape(rows.shape[0], -1))
    return table, new_replay


def _mega_replay_copies(cfg: HermesConfig, step, frozen, table: FastTable,
                        replay: FastReplay) -> FastReplay:
    """The sharded replay scan through ``mega_replay``: replica r's scan
    runs on its own copy's K-row view with its own slots, one launch a
    copy; the new slots are stacked back to (R, RS)."""
    vk, bk = copies(table.vpts, cfg.n_keys), copies(table.bank, cfg.n_keys)
    outs = []
    for r in range(replay.active.shape[0]):
        one = FastReplay(*(x[r:r + 1] for x in replay))
        _bank, new = megaround.mega_replay(cfg, step, frozen[r:r + 1],
                                           vk[r], bk[r], one)
        outs.append(new)
    act, rkey, rpts, racks, rval = (torch.cat(xs) for xs in zip(*outs))
    return FastReplay(active=act, key=rkey, pts=rpts, val=rval, acks=racks)


def _coordinate(cfg: HermesConfig, ctl: FastCtl, fs: FastState, stream,
                base=None):
    """Intake + local reads + update issue + the replay scan (gated) +
    the outbound lane block.  ``base``: None on the batched table, the
    (R, 1) first rows of the local copies on the sharded one."""
    R, S = fs.sess.status.shape
    K, G, RS = cfg.n_keys, cfg.ops_per_session, cfg.replay_slots
    dev = fs.sess.status.device
    table, sess, replay = fs.table, fs.sess, fs.replay
    frozen = ctl.frozen[:, None]
    step = ctl.step
    open_ = ~frozen & (not ctl.quiesce)  # may load / issue new work

    def _intake(sess):
        if cfg.wrap_stream:
            can_load = (sess.status == t.S_IDLE) & open_
        else:
            can_load = (sess.status == t.S_IDLE) & (sess.op_idx < G) & open_
        g = _stream_idx(cfg, sess.op_idx)
        if cfg.device_stream:
            # counter-hash op stream, the formula shared with the host twin
            read_t, rmw_t = ycsb.device_stream_params(cfg)
            u_op, u_rmw, hkey = ycsb.stream_hash(
                cfg, ctl.my_cid[:, None].to(torch.int64),
                torch.arange(S, dtype=torch.int64, device=dev)[None, :],
                sess.op_idx.to(torch.int64) & 0xFFFFFFFF)
            new_op = _full(u_op, t.OP_WRITE)
            new_op = torch.where(u_rmw < rmw_t, t.OP_RMW, new_op)
            new_op = torch.where(u_op < read_t, t.OP_READ, new_op)
            new_key = hkey.to(I32)
        else:
            gi = g.long()[..., None]
            new_op = torch.gather(stream.op, 2, gi)[..., 0]
            new_key = torch.gather(stream.key, 2, gi)[..., 0]
        is_nop = can_load & (new_op == t.OP_NOP)
        loaded = _full(new_op, t.S_ISSUE)
        loaded = torch.where(new_op == t.OP_NOP, t.S_IDLE, loaded)
        loaded = torch.where(new_op == t.OP_READ, t.S_READ, loaded)
        status = torch.where(can_load, loaded, sess.status)
        if not cfg.wrap_stream:
            status = torch.where((status == t.S_IDLE) & (sess.op_idx >= G),
                                 t.S_DONE, status)
        return sess._replace(
            status=status,
            op=torch.where(can_load, new_op, sess.op),
            key=torch.where(can_load, new_key, sess.key),
            invoke_step=torch.where(can_load, step, sess.invoke_step),
            op_idx=torch.where(is_nop, sess.op_idx + 1, sess.op_idx),
        )

    sub_comps = []
    read_extra = torch.zeros((R, S), dtype=I32, device=dev)
    for sub in range(cfg.read_unroll):
        sess = _intake(sess)
        # one bank-row gather serves the Valid check, the read value and
        # the issue path's arbiter ts
        krow8 = table.bank[_rows(sess.key, base)]  # (R, S, 4*(2+V)) int8
        k_valid = (krow8[..., 4 * BANK_SST] & 7) == t.VALID
        rd_val = krow8[..., 4 * BANK_VAL:]
        read_done = (sess.status == t.S_READ) & k_valid & ~frozen
        if sub < cfg.read_unroll - 1:
            sess = sess._replace(
                status=torch.where(read_done, t.S_IDLE, sess.status),
                op_idx=torch.where(read_done, sess.op_idx + 1, sess.op_idx),
                rd_val=torch.where(read_done[..., None], rd_val, sess.rd_val),
            )
            sub_comps.append(st.Completions(
                code=torch.where(read_done, t.C_READ, _full(read_done, t.C_NONE)),
                key=sess.key,
                wval=_bank_to_i32(sess.val),
                rval=_bank_to_i32(sess.rd_val),
                ver=pts_ver(sess.pts),
                fc=pts_fc(sess.pts),
                invoke_step=sess.invoke_step,
                commit_step=step.expand(R, S).contiguous(),
            ))
            read_extra = read_extra + read_done.to(I32)

    sess = sess._replace(
        status=torch.where(read_done, t.S_IDLE, sess.status),
        op_idx=torch.where(read_done, sess.op_idx + 1, sess.op_idx),
    )

    k_vpts = _bank_to_i32(krow8[..., 4 * BANK_PTS: 4 * BANK_PTS + 4])[..., 0]
    # pre-committed: a pending update whose key row is VALID at its own ts
    # was finished by a replayer
    pre_comm = ((sess.status == t.S_INFL) & k_valid
                & (k_vpts == sess.pts) & ~frozen)
    w_loaded = (sess.status == t.S_ISSUE) & (sess.invoke_step == step)
    new_wval = _i32_to_bank(_write_value(cfg, ctl.my_cid, sess.op_idx))
    if stream.uval is not None:
        # client payload bytes (kvs.KVS) after the two uid words
        gw = _stream_idx(cfg, sess.op_idx).long()
        w4 = stream.uval.shape[-1]
        uval = torch.gather(stream.uval, 2,
                            gw[:, :, None, None].expand(R, S, 1, w4))[:, :, 0]
        new_wval = torch.cat([new_wval[..., :8], uval], dim=-1)
    sess = sess._replace(
        val=torch.where(w_loaded[..., None], new_wval, sess.val))

    want = (sess.status == t.S_ISSUE) & k_valid & open_
    idxs = torch.arange(S, dtype=I32, device=dev)[None].expand(R, S)
    chain_rank = torch.zeros((R, S), dtype=I32, device=dev)
    if cfg.use_fused_sort:
        win = None  # resolved by the lane sort below
    elif cfg.arb_mode == "sort":
        # lexicographic (key, session) sort per replica: the first entry of
        # each equal-key run (the lowest wanting session — stable sort)
        # wins; ineligible sessions sort past K
        skey = torch.where(want, sess.key, K)
        sk, perm = torch.sort(skey, dim=1, stable=True)
        so = (torch.gather(torch.where(want, sess.op, 0), 1, perm)
              if cfg.chain_writes else None)
        first = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                           sk[:, 1:] != sk[:, :-1]], dim=1)
        in_run = sk < K
        issue, rank = _run_issue(cfg, first, in_run, so, idxs)
        if cfg.chain_writes:
            packed = torch.where(
                issue, layouts.ARB_WORD.field("win").mask | rank, 0)
        else:
            packed = issue.to(I32)
        # perm is a permutation per replica: unique targets, so the set
        # equals the reference's max onto zeros
        p_flat = torch.zeros((R, S), dtype=I32, device=dev).scatter_(
            1, perm, packed)
        win = want & (p_flat != 0)
        if cfg.chain_writes:
            chain_rank = torch.where(
                win, p_flat & layouts.ARB_WORD.field("chain_rank").mask, 0)
    else:
        # hash-slot race: scatter-min of the session index; colliding
        # sessions defer to the lowest index
        HS = cfg.arb_slots
        h = sess.key & (HS - 1)
        arb = torch.full((R * HS + 1,), I32_MAX, dtype=I32, device=dev)
        arb.scatter_reduce_(0, _gkey(R * HS, h, want).reshape(-1).long(),
                            idxs.reshape(-1), "amin")
        win = want & (arb[_gkey(R * HS, h).long()] == idxs)

    flag = torch.where(sess.op == t.OP_WRITE, t.FLAG_WRITE,
                       _full(sess.op, t.FLAG_RMW))
    fc = (flag << 8) | ctl.my_cid[:, None]

    # --- replay scan, gated on the host step mirror ------------------------
    if ctl.host_step % cfg.replay_scan_every == 0:
        if cfg.use_mega_round and base is None:
            # the scan as one kernel over the table's K rows (the drop row
            # left out): marks in place, new replay leaves
            _bank, (act, rkey, rpts, racks, rval) = megaround.mega_replay(
                cfg, step, ctl.frozen, table.vpts[:K], table.bank[:K],
                replay)
            replay = FastReplay(active=act, key=rkey, pts=rpts, val=rval,
                                acks=racks)
        elif cfg.use_mega_round:
            # sharded: one launch a local copy, on its K-row view
            replay = _mega_replay_copies(cfg, step, ctl.frozen, table,
                                         replay)
        else:
            table, replay = _replay_scan(cfg, ctl, table, replay, base)

    # --- outbound INV compaction --------------------------------------------
    L, C = cfg.n_lanes, cfg.lane_budget
    infl = sess.status == t.S_INFL
    backoff_ok = torch.remainder(step - sess.invoke_step,
                                 cfg.rebroadcast_every) == 0
    waiting = infl & backoff_ok
    lane_idx = torch.arange(L, dtype=I32, device=dev)[None].expand(R, L)
    no_replay = torch.zeros_like(replay.active)
    if cfg.use_fused_sort:
        # fused arbiter + compaction sort: key (band << 29) | sub
        sub_cap = layouts.FUSED_KEY.field("sub").cap
        assert cfg.n_keys <= sub_cap and L <= sub_cap, (
            f"fused sort key overflow: n_keys={cfg.n_keys}, n_lanes={L}")
        lane_key = torch.cat([sess.key, replay.key], dim=1)
        lane_want = torch.cat([want, no_replay], dim=1)
        lane_wait = torch.cat([waiting, replay.active], dim=1) & ~frozen
        band = _full(lane_key, 2)
        band = torch.where(lane_want, 1, band)
        band = torch.where(lane_wait, 0, band)
        rot = _rotated(lane_idx, step, L)
        rkey = _rotated(lane_key, step, cfg.n_keys)
        sub = torch.where(band == 0, rot, torch.where(band == 1, rkey, 0))
        lane_sop = torch.cat([torch.where(want, sess.op, 0),
                              torch.zeros_like(replay.key)], dim=1)
        sp, perm = torch.sort((band << FUSED_BAND_SHIFT) | sub, dim=1,
                              stable=True)
        si = perm.to(I32)
        so = torch.gather(lane_sop, 1, perm)
        sband = sp >> FUSED_BAND_SHIFT
        first = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                           sp[:, 1:] != sp[:, :-1]], dim=1)
        in_run = sband == 1
        pos = lane_idx  # iota along the sorted axis
        issue, rank_word = _run_issue(cfg, first, in_run, so, pos)
        if rank_word is None:
            rank_word = torch.zeros((R, L), dtype=I32, device=dev)
        slot_elig = (sband == 0) | issue
        cum = torch.cumsum(slot_elig.to(I32), dim=1, dtype=I32)  # inclusive
        staken = slot_elig & (cum <= C)
        srank = torch.where(slot_elig, cum - 1, cum[:, -1:] + pos - cum)
        word = ((staken.to(I32) << LANE_TAKEN_SHIFT)
                | (issue.to(I32) << LANE_ISSUE_SHIFT) | rank_word)
        if cfg.use_mega_round:
            # the route-back as one kernel (unique targets: set == max)
            lane_word, slot_lane = megaround.mega_route(cfg, si, word, srank)
        else:
            # ONE scatter into an (R, L+C) target (+1 drop column): the
            # per-lane verdict word through the permutation, and each
            # slot's owning lane id at L+srank.  Targets are unique outside
            # the drop column, so max == set.
            tgt = torch.cat([si, torch.where(srank < C, L + srank, L + C)],
                            dim=1).long()
            flat = torch.zeros((R, L + C + 1), dtype=I32, device=dev)
            flat.scatter_reduce_(1, tgt, torch.cat([word, si], dim=1),
                                 "amax")
            lane_word = flat[:, :L]
            slot_lane = flat[:, L:L + C]
        taken_lane = (lane_word & (1 << LANE_TAKEN_SHIFT)) != 0
        win = want & ((lane_word[:, :S] & (1 << LANE_ISSUE_SHIFT)) != 0)
        if cfg.chain_writes:
            chain_rank = torch.where(win, lane_word[:, :S] & LANE_CHAIN_MASK, 0)
        lane_fresh = torch.cat([win, no_replay], dim=1)
    else:
        sess_elig = (win | waiting) & ~frozen
        fresh_s = win & ~frozen
        lane_elig = torch.cat([sess_elig, replay.active & ~frozen], dim=1)
        lane_fresh = torch.cat([fresh_s, no_replay], dim=1)
        if C == L:
            slot_lane = lane_idx
            taken_lane = lane_elig
        else:
            # single-operand sort of (band | rotation | lane), threshold
            # at the C-th smallest packed value
            lb = max(1, (L - 1).bit_length())  # lane bits
            rb = max(0, 31 - 2 - lb)  # rotation bits
            rot = _rotated(lane_idx, step, L)
            rotp = rot >> max(0, lb - rb)
            band = _full(lane_idx, 2)
            band = torch.where(lane_elig & ~lane_fresh, 0, band)
            band = torch.where(lane_elig & lane_fresh, 1, band)
            packed_own = (((band << min(rb, lb)) | rotp) << lb) | lane_idx
            packed = torch.sort(packed_own, dim=1).values
            slot_lane = packed[:, :C] & ((1 << lb) - 1)
            taken_lane = lane_elig & (packed_own <= packed[:, C - 1: C])
    # The minted ts packs a ver read from the winner-row mirror, whose
    # bound is a protocol invariant (the Meta.max_pts watermark and the
    # rebase), not a config fact: audited, so the analysis reports the
    # assumption instead of an unprovable overflow.
    with layouts.audited("pts-mint-ver-bounded-by-watermark"):
        new_pts = pack_pts(pts_ver(k_vpts) + 1 + chain_rank, fc)

    # fresh issues that won arbitration AND hold a slot happen; the rest
    # revert (stay S_ISSUE) and retry next round
    win_eff = win & taken_lane[:, :S]
    is_rmw_issue = win_eff & (sess.op == t.OP_RMW)
    sess = sess._replace(
        status=torch.where(win_eff, t.S_INFL, sess.status),
        pts=torch.where(win_eff, new_pts, sess.pts),
        acks=torch.where(win_eff, 0, sess.acks),
        rd_val=torch.where((read_done | is_rmw_issue)[..., None], rd_val,
                           sess.rd_val),
    )
    meta = fs.meta
    if cfg.phase_metrics:
        sess = sess._replace(
            issue_step=torch.where(win_eff, step, sess.issue_step))
        meta = meta._replace(
            n_inv=meta.n_inv + taken_lane.sum(dim=1, dtype=I32),
            n_rebcast=meta.n_rebcast
            + (taken_lane & ~lane_fresh).sum(dim=1, dtype=I32),
            replay_peak=torch.maximum(
                meta.replay_peak, replay.active.sum(dim=1, dtype=I32)),
        )

    lanes = LaneBlock(
        key=torch.cat([sess.key, replay.key], dim=1),
        pts=torch.cat([sess.pts, replay.pts], dim=1),
        val=torch.cat([sess.val, replay.val], dim=1),
        fresh=lane_fresh,
    )
    fs = fs._replace(table=table, sess=sess, replay=replay, meta=meta)
    return (fs, lanes, slot_lane, taken_lane, read_done, read_extra,
            sub_comps, pre_comm)


def _apply_inv_arb(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                   inv_src: FastInv):
    """``apply_inv`` over a source-shaped INV block: the vpts scatter-max
    only (verdicts are derived afterwards), plus the heartbeat fold."""
    v_ok = inv_src.valid & (inv_src.epoch == ctl.epoch[0])[..., None]
    table = _ts_scatter_max(fs.table, inv_src.key, inv_src.pts, v_ok)
    return fs._replace(table=table, meta=_apply_inv_meta(ctl, fs.meta,
                                                         inv_src))


def _apply_inv_meta(ctl: FastCtl, meta, inv_src: FastInv):
    """The apply_inv last_seen heartbeat fold."""
    return meta._replace(
        last_seen=torch.where(
            inv_src.alive[None, :] & ~ctl.frozen[:, None], ctl.step,
            meta.last_seen,
        )
    )


def _ts_scatter_max(table: FastTable, keys, pts, mask, drop=None):
    """Scatter-MAX of packed timestamps into vpts for every masked (key,
    ts) row, in place (masked rows land on the drop row ``drop``, by
    default the table's last)."""
    if drop is None:
        drop = table.vpts.shape[0] - 1
    rows = torch.where(mask, keys, drop).reshape(-1).long()
    table.vpts.scatter_reduce_(0, rows, pts.expand(mask.shape).reshape(-1),
                               "amax")
    return table


def _winner_row_scatter(ctl: FastCtl, table: FastTable, keys, pts, vals,
                        win, vbit, fresh, drop=None):
    """The round's single [pts|sst|val] table write, in place: every
    winning row lands with its own ts, VALID if committing, INVALID
    otherwise.  Only FRESH rows (unique per (key, ts)) or committing rows
    (all duplicates produce the identical VALID row) write, so duplicate
    indices agree; the rest land on the drop row ``drop`` (by default the
    table's last).  ``keys``, ``pts``, ``vals`` and ``fresh`` broadcast
    against ``win``/``vbit``."""
    state_new = torch.where(vbit, t.VALID, _full(vbit, t.INVALID))
    head8 = _i32_to_bank(
        torch.stack([pts.expand(vbit.shape),
                     pack_sst(ctl.step, state_new)], dim=-1))
    upd8 = torch.cat([head8, vals.expand(vbit.shape + vals.shape[-1:])],
                     dim=-1)
    write0 = win & (fresh | vbit)
    if drop is None:
        drop = table.bank.shape[0] - 1
    rows = torch.where(write0, keys, drop).reshape(-1).long()
    # audited: injectivity is a protocol invariant, not provable from the
    # config's bounds
    with layouts.audited("winner-row-dup-writes-identical"):
        table.bank.index_put_((rows,), upd8.reshape(rows.shape[0], -1))
    return table


def _apply_inv_lanes(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                     lanes: LaneBlock, taken_lane):
    """Batched ``apply_inv`` straight from the lane block: the arbiter
    scatter-max plus the heartbeat fold.  Returns ``(fs, post_lane)``: on
    the mega path the apply kernel also reads back the settled per-lane
    verdict, so ``_derived_acks`` skips its gather; otherwise None."""
    v_ok = taken_lane & (ctl.epoch == ctl.epoch[0])[:, None]
    table = fs.table
    if cfg.use_mega_round:
        _vpts, post = megaround.mega_apply(cfg, table.vpts[:cfg.n_keys],
                                           lanes.key, lanes.pts, v_ok)
        post_lane = post.reshape(lanes.key.shape)
    else:
        table = _ts_scatter_max(table, lanes.key, lanes.pts, v_ok)
        post_lane = None
    meta = fs.meta._replace(
        last_seen=torch.where(
            ~ctl.frozen[None, :] & ~ctl.frozen[:, None], ctl.step,
            fs.meta.last_seen,
        )
    )
    return fs._replace(table=table, meta=meta), post_lane


def _apply_commit_lanes(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                        lanes: LaneBlock, win_lane, commit_lane):
    """Batched winner table write from the lane block."""
    vbit = commit_lane & (ctl.epoch == ctl.epoch[0])[:, None]
    table = _winner_row_scatter(ctl, fs.table, lanes.key, lanes.pts,
                                lanes.val, win_lane, vbit, lanes.fresh)
    return fs._replace(table=table)


def _derived_acks(ctl: FastCtl, table: FastTable, taken_lane, pend_key,
                  pend_pts, post_lane=None):
    """Lockstep-batched ACK derivation: the gathered-ack bitmap of a
    broadcast lane is the unfrozen-replica mask, and its conflict verdict
    is whether its ts survived the scatter-max (``post_lane``, gathered
    here unless the mega apply kernel delivered it).  Returns (gained,
    nacked, win_lane, post_lane), all (R, L)."""
    R = taken_lane.shape[0]
    ar = torch.arange(R, dtype=I32, device=taken_lane.device)
    abits = torch.where(~ctl.frozen, torch.ones_like(ar) << ar, 0).sum(
        dtype=I32)
    if post_lane is None:
        post_lane = table.vpts[pend_key.long()]  # (R, L) post-scatter arbiter
    survived = post_lane == pend_pts
    gained = torch.where(taken_lane, abits, 0)
    nacked = taken_lane & ~survived & (abits != 0)
    win_lane = taken_lane & survived
    return gained, nacked, win_lane, post_lane


def _collect_acks(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                  gained, nacked, taken_lane, read_done,
                  read_extra, pre_comm, post_lane=None, replay_post=None):
    """Coordinator-side poll_acks + commit + VAL build; completion codes
    and counters through the ``stats_block`` kernel.  The replay slots'
    settled arbiter comes from ``post_lane`` (batched) or ``replay_post``
    (sharded: ``_apply_inv``'s joint gather)."""
    table, sess, replay, meta = fs.table, fs.sess, fs.replay, fs.meta
    R = gained.shape[0]
    Rs = cfg.n_replicas
    S = cfg.n_sessions
    step = ctl.step
    frozen = ctl.frozen[:, None]

    full = (1 << Rs) - 1
    live = ctl.live_mask[:, None]

    infl = sess.status == t.S_INFL
    sacks = torch.where(infl, sess.acks | gained[:, :S], sess.acks)
    covered = ((sacks | ~live) & full) == full
    nack_rmw = (infl & nacked[:, :S] & (sess.op == t.OP_RMW) & ~frozen
                & ~pre_comm)
    if cfg.rmw_retries > 0:
        retry = nack_rmw & (sess.retries < cfg.rmw_retries)
        abort = nack_rmw & ~retry
    else:
        retry = None
        abort = nack_rmw
    commit = ((infl & covered & taken_lane[:, :S] & ~frozen & ~nack_rmw)
              | pre_comm)

    rowns = replay.pts == (post_lane[:, S:] if post_lane is not None
                           else replay_post)

    racks = torch.where(replay.active, replay.acks | gained[:, S:],
                        replay.acks)
    rcovered = ((racks | ~live) & full) == full
    rnack = replay.active & nacked[:, S:] & ~frozen
    rcommit = (replay.active & rcovered & taken_lane[:, S:] & ~frozen
               & ~nacked[:, S:])
    rsuper = replay.active & ~rowns & ~frozen
    replay = replay._replace(
        acks=racks, active=replay.active & ~rcommit & ~rsuper & ~rnack)

    commit_lane = torch.cat([commit, rcommit & rowns], dim=1)

    # --- session completion + stats (the hand-written kernel) -------------
    code, ctr, hist_add = kernels.stats_block(
        step, sess.op, sess.invoke_step, commit, abort, read_done
    )
    comp = st.Completions(
        code=code,
        key=sess.key,
        wval=_bank_to_i32(sess.val),
        rval=_bank_to_i32(sess.rd_val),
        ver=pts_ver(sess.pts),
        fc=pts_fc(sess.pts),
        invoke_step=sess.invoke_step,
        commit_step=step.expand(R, S).contiguous(),
    )
    meta = meta._replace(
        n_read=meta.n_read + ctr[:, kernels.CTR_READ]
        + read_extra.sum(dim=1, dtype=I32),
        n_write=meta.n_write + ctr[:, kernels.CTR_WRITE],
        n_rmw=meta.n_rmw + ctr[:, kernels.CTR_RMW],
        n_abort=meta.n_abort + ctr[:, kernels.CTR_ABORT],
        lat_sum=meta.lat_sum + ctr[:, kernels.CTR_LATSUM],
        lat_cnt=meta.lat_cnt + ctr[:, kernels.CTR_LATCNT],
        lat_hist=meta.lat_hist + hist_add,
        max_pts=torch.maximum(meta.max_pts, sess.pts.amax(dim=1)),
        suspect_age=(step - meta.last_seen).clamp(min=0),
    )
    if cfg.phase_metrics:
        nbin = st.LAT_BINS
        qwait = torch.where(commit, step - sess.issue_step, 0)
        cq = qwait.clamp(0, nbin - 1).long()
        qhist = torch.zeros((R, nbin), dtype=I32, device=code.device)
        qhist.scatter_add_(1, cq, commit.to(I32))
        meta = meta._replace(
            n_nack=meta.n_nack
            + (infl & nacked[:, :S] & ~frozen).sum(dim=1, dtype=I32),
            n_retry=(meta.n_retry + retry.sum(dim=1, dtype=I32))
            if retry is not None else meta.n_retry,
            qwait_sum=meta.qwait_sum + qwait.sum(dim=1, dtype=I32),
            qwait_hist=meta.qwait_hist + qhist,
        )

    done = commit | abort
    status = torch.where(done, t.S_IDLE, sess.status)
    new_retries = sess.retries
    if retry is not None:
        status = torch.where(retry, t.S_ISSUE, status)  # disjoint from done
        new_retries = torch.where(
            done, 0, torch.where(retry, sess.retries + 1, sess.retries))
    sess = sess._replace(
        acks=sacks,
        status=status,
        op_idx=torch.where(done, sess.op_idx + 1, sess.op_idx),
        retries=new_retries,
    )
    fs = fs._replace(table=table, sess=sess, replay=replay, meta=meta)
    return fs, commit_lane, comp


def fast_round_batched(cfg: HermesConfig, ctl: FastCtl, fs: FastState, stream):
    """One protocol round, batched lockstep emulation: the broadcast IS the
    lane block and the ACK bitmap derives from the shared verdicts.
    Updates ``fs.table`` in place and returns (fs, comp); ``comp`` is a
    tuple of per-sub-step Completions when cfg.read_unroll > 1."""
    (fs, lanes, slot_lane, taken_lane, read_done,
     read_extra, sub_comps, pre_comm) = _coordinate(cfg, ctl, fs, stream)
    fs, post_lane = _apply_inv_lanes(cfg, ctl, fs, lanes, taken_lane)
    gained, nacked, win_lane, post_lane = _derived_acks(
        ctl, fs.table, taken_lane, lanes.key, lanes.pts, post_lane)
    fs, commit_lane, comp = _collect_acks(cfg, ctl, fs, gained, nacked,
                                          taken_lane, read_done,
                                          read_extra, pre_comm,
                                          post_lane=post_lane)
    fs = _apply_commit_lanes(cfg, ctl, fs, lanes, win_lane, commit_lane)
    if sub_comps:
        comp = tuple(sub_comps) + (comp,)
    return fs, comp


# --------------------------------------------------------------------------
# The sharded round: one table copy a replica, real INV / ACK / VAL exchange
# --------------------------------------------------------------------------


#: The audit of the sharded round's reads and writes through ``slot_lane``:
#: its C entries are DISTINCT lane ids in [0, n_lanes) per replica (the
#: fused sort's slot rank is a bijection onto the lanes, the split sort's
#: low bits are the lane index, and with C == L it is the lane index), a
#: protocol fact the interval analysis cannot derive.  The reference needs
#: no audit there: its scatter is a max and its index modes clip or drop.
SLOT_LANE_AUDIT = "slot-lane-distinct-lane-ids"


def _copy_base(R: int, K: int, device):
    """(R, 1) first row of each local replica's table copy."""
    return (torch.arange(R, dtype=I32, device=device) * (K + 1))[:, None]


def _compact_out_inv(ctl: FastCtl, lanes: LaneBlock, slot_lane, taken_lane):
    """Lane block -> wire-shaped INV block (the C-slot broadcast batch):
    the [pkf | pts | val] bytes of every lane packed in one tensor, and
    ONE gather of the slots' rows."""
    lane_pkf = (lanes.key
                | torch.where(lanes.fresh, INV_FRESH, 0)
                | torch.where(taken_lane, INV_VALID, 0))
    head8 = _i32_to_bank(torch.stack([lane_pkf, lanes.pts], dim=-1))
    rows8 = torch.cat([head8, lanes.val], dim=-1)  # (R, L, 8+4V)
    idx = slot_lane.long()[..., None].expand(
        slot_lane.shape + rows8.shape[-1:])
    with layouts.audited(SLOT_LANE_AUDIT):
        rows8 = torch.gather(rows8, 1, idx)
    return FastInv(
        rows8=rows8,
        meta=(ctl.epoch << META_EPOCH_SHIFT) | (~ctl.frozen).to(I32),
    )


def _apply_inv(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
               inv_src: FastInv, replay_key, base):
    """Follower-side ``apply_inv`` of every local replica over the
    source-shaped block ``inv_src`` ((Rsrc, C) slots): the scatter-max of
    the slots' packed ts into each replica's own copy, then ONE joint
    gather of the settled arbiter for the slots and the local replay
    keys.  The inbound key is an untrusted wire field: a key >= K drops
    from the scatter (never offset into the next copy) and is clamped to
    K-1 of its own copy for the read.  On the mega path the scatter and
    the gather are one ``mega_apply`` launch over the flat table.
    Returns ``(fs, ack_flags, win0, replay_post)``, the first two (R,
    Rsrc, C)."""
    K = cfg.n_keys
    R = replay_key.shape[0]
    key0 = inv_src.key
    # an inbound ts was minted by its source under the max_pts watermark
    # (``pts-mint-ver-bounded-by-watermark``); its bytes do not show it
    with layouts.audited("wire-pts-minted-under-watermark"):
        pts0 = inv_src.pts
    v_ok = inv_src.valid[None] & (
        inv_src.epoch[None, :] == ctl.epoch[:, None])[..., None]
    in_k = key0 < K
    rkey = base[:, :, None] + key0.clamp(max=K - 1)[None]  # (R, Rsrc, C)
    keys_all = torch.cat([rkey.reshape(R, -1), base + replay_key], dim=1)
    table = fs.table
    if cfg.use_mega_round:
        nrep = replay_key.shape[1]
        pts_all = torch.cat([pts0.reshape(1, -1).expand(R, -1),
                             torch.zeros((R, nrep), dtype=I32,
                                         device=key0.device)], dim=1)
        mask_all = torch.cat([(v_ok & in_k[None]).reshape(R, -1),
                              torch.zeros((R, nrep), dtype=torch.bool,
                                          device=key0.device)], dim=1)
        _vpts, joint = megaround.mega_apply(cfg, table.vpts, keys_all,
                                            pts_all, mask_all)
        joint = joint.reshape(R, -1)
    else:
        table = _ts_scatter_max(table, rkey, pts0[None],
                                v_ok & in_k[None], drop=base[..., None] + K)
        joint = table.vpts[keys_all.long()]
    nslot = key0.numel()
    post0 = joint[:, :nslot].reshape((R,) + key0.shape)
    replay_post = joint[:, nslot:]
    ack_flags = pts0[None] == post0
    win0 = v_ok & ack_flags
    fs = fs._replace(table=table, meta=_apply_inv_meta(ctl, fs.meta,
                                                       inv_src))
    return fs, ack_flags, win0, replay_post


def _wire_acks(cfg: HermesConfig, ctl: FastCtl, inv_src: FastInv,
               ack_flags, out_inv: FastInv, group):
    """Sharded ACK exchange: each local replica packs its verdicts on
    every source's slots, the group routes them back to the sources, and
    each source matches the echoes against the block it actually sent —
    a stale ack never credits a different pending update.  Returns
    (gained_slot, nacked_slot), (R, C)."""
    Rs = inv_src.pkf.shape[0]
    epoch_ok = (inv_src.epoch[None, :] == ctl.epoch[:, None])[..., None]
    ok = inv_src.valid[None] & epoch_ok & ~ctl.frozen[:, None, None]
    pkf = ((inv_src.key[None] << ACK_KEY_SHIFT)
           | (ack_flags.to(I32) << 1) | ok.to(I32))
    ack8 = _i32_to_bank(torch.stack(
        [pkf, inv_src.pts[None].expand(pkf.shape)], dim=-1))
    in8 = group.route_back(ack8)  # (R, Rsrc, C, 8): each acker's echo
    in_pkf = _bank_to_i32(in8[..., 0:4])[..., 0]
    in_pts = _bank_to_i32(in8[..., 4:8])[..., 0]
    matched = (
        out_inv.valid[:, None, :]
        & ((in_pkf & ACK_VALID_MASK) == ACK_VALID_MASK) & epoch_ok
        & ~ctl.frozen[:, None, None]
        & ((in_pkf >> ACK_KEY_SHIFT) == out_inv.key[:, None, :])
        & (in_pts == out_inv.pts[:, None, :])
    )
    aok = (in_pkf & ACK_OK_MASK) == ACK_OK_MASK
    bit = (torch.ones((), dtype=I32, device=pkf.device)
           << torch.arange(Rs, dtype=I32, device=pkf.device))[None, :, None]
    gained_slot = torch.where(matched, bit, 0).sum(dim=1, dtype=I32)
    nacked_slot = (matched & ~aok).any(dim=1)
    return gained_slot, nacked_slot


def _slot_to_lane_acks(cfg: HermesConfig, gained_slot, nacked_slot,
                       slot_lane):
    """Per-slot wire acks back to lanes through ``slot_lane``: ONE scatter
    of the gained bitmap and the nack bit packed in one word (int64 here,
    the reference's uint32: the bitmap can use all 31 mask bits).
    ``slot_lane`` is injective per replica, so the set equals the
    reference's max onto zeros."""
    R = gained_slot.shape[0]
    gshift = layouts.SLOT_ACK.field("gained").shift
    nmask = layouts.SLOT_ACK.field("nacked").mask
    packed = ((gained_slot.to(torch.int64) << gshift)
              | nacked_slot.to(torch.int64))
    with layouts.audited(SLOT_LANE_AUDIT):
        lanes = torch.zeros((R, cfg.n_lanes), dtype=torch.int64,
                            device=packed.device).scatter_(
                                1, slot_lane.long(), packed)
    return (lanes >> gshift).to(I32), (lanes & nmask) != 0


def _apply_commit(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                  inv_src: FastInv, win0, val_bits, val_epochs, base):
    """The round's single table write of every local replica: each
    winning INV slot lands its [pts | sst | val] row in the replica's own
    copy, VALID if its VAL bit says it committed this round, INVALID
    otherwise (the reference's ``_apply_commit``; the duplicate-row
    argument of ``_winner_row_scatter`` holds per copy).  A wire key >= K
    drops."""
    K = cfg.n_keys
    key0 = inv_src.key
    vbit = val_bits[None] & (
        val_epochs[None, :] == ctl.epoch[:, None])[..., None]
    table = _winner_row_scatter(
        ctl, fs.table, base[..., None] + key0[None], inv_src.pts[None],
        inv_src.val[None], win0 & (key0 < K)[None], vbit,
        inv_src.fresh[None], drop=base[..., None] + K)
    return fs._replace(table=table)


def fast_round_sharded(cfg: HermesConfig, ctl: FastCtl, fs: FastState,
                       stream, group):
    """One protocol round of the sharded engine over the local replicas
    (``ctl`` rows and ``fs`` the local ones; ``my_cid`` their global ids):
    the compacted INV blocks all-gathered, each replica arbitrating them
    against its own table copy, the ACK verdicts routed back and matched
    against the block sent, the VAL bits all-gathered.  ``group`` moves
    the blocks (core/group.py).  Updates the table in place and returns
    (fs, comp)."""
    R = fs.sess.status.shape[0]
    base = _copy_base(R, cfg.n_keys, fs.sess.status.device)
    (fs, lanes, slot_lane, taken_lane, read_done,
     read_extra, sub_comps, pre_comm) = _coordinate(cfg, ctl, fs, stream,
                                                    base)
    out_inv = _compact_out_inv(ctl, lanes, slot_lane, taken_lane)
    inv_src = FastInv(rows8=group.gather_src(out_inv.rows8),
                      meta=group.gather_src(out_inv.meta))
    fs, ack_flags, win0, replay_post = _apply_inv(cfg, ctl, fs, inv_src,
                                                  fs.replay.key, base)
    gained_slot, nacked_slot = _wire_acks(cfg, ctl, inv_src, ack_flags,
                                          out_inv, group)
    gained, nacked = _slot_to_lane_acks(cfg, gained_slot, nacked_slot,
                                        slot_lane)
    fs, commit_lane, comp = _collect_acks(cfg, ctl, fs, gained, nacked,
                                          taken_lane, read_done,
                                          read_extra, pre_comm,
                                          replay_post=replay_post)
    # VAL phase: a per-slot commit bit over THIS round's INV slots; the
    # receivers rebuild (key, ts) from the INV block they hold
    with layouts.audited(SLOT_LANE_AUDIT):
        commit_at_slot = torch.gather(commit_lane, 1, slot_lane.long())
    val_bits = group.gather_src(commit_at_slot)
    fs = _apply_commit(cfg, ctl, fs, inv_src, win0, val_bits,
                       inv_src.epoch, base)
    if sub_comps:
        comp = tuple(sub_comps) + (comp,)
    return fs, comp


# --------------------------------------------------------------------------
# Step builders
# --------------------------------------------------------------------------


def prep_stream(stream, device) -> st.OpStream:
    """Place an (R, S, G[, U]) op stream (numpy or tensor leaves) on
    ``device``, converting client payload words to the engine's bytes."""
    def as_i32(a):  # a copy: the caller may rewrite its staging arrays
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=I32, copy=True)
        return torch.tensor(np.asarray(a), dtype=I32, device=device)

    uval = getattr(stream, "uval", None)
    if uval is not None:
        uval = _i32_to_bank(as_i32(uval))
    return st.OpStream(op=as_i32(stream.op), key=as_i32(stream.key), uval=uval)


def copy_stream(dst: st.OpStream, src) -> bool:
    """Write ``src`` (numpy or tensor leaves, as ``prep_stream`` takes)
    into the placed stream ``dst`` in place: the tensors a compiled round
    bound stay its inputs.  False, and nothing written, when a shape or
    the payload's presence differs (place a new stream then)."""
    uval = getattr(src, "uval", None)
    if (tuple(dst.op.shape) != tuple(np.shape(src.op))
            or tuple(dst.key.shape) != tuple(np.shape(src.key))
            or (uval is None) != (dst.uval is None)
            or (uval is not None
                and tuple(dst.uval.shape) != tuple(np.shape(uval))[:-1]
                + (4 * np.shape(uval)[-1],))):
        return False

    def host(a):
        return (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(a, np.int32)))

    dst.op.copy_(host(src.op))
    dst.key.copy_(host(src.key))
    if uval is not None:
        dst.uval.copy_(_i32_to_bank(host(uval).to(dst.uval.device, I32)))
    return True


def make_fast_ctl(cfg: HermesConfig, step: int, device,
                  quiesce: bool = False) -> FastCtl:
    """Round ``step``'s FastCtl with every replica live and unfrozen.  A
    caller that keeps feeding one compiled round passes the same ctl
    again, its step advanced by the round itself (``ctl.step.fill_``
    re-seeds it) and ``host_step`` set with ``_replace``."""
    r = cfg.n_replicas
    return FastCtl(
        step=torch.tensor(step, dtype=I32, device=device),
        host_step=int(step),
        my_cid=torch.arange(r, dtype=I32, device=device),
        epoch=torch.zeros((r,), dtype=I32, device=device),
        live_mask=torch.full((r,), cfg.full_mask, dtype=I32, device=device),
        frozen=torch.zeros((r,), dtype=torch.bool, device=device),
        quiesce=bool(quiesce),
    )


def pending_sessions(status, live_mask, frozen):
    """Sessions not yet S_DONE on live, unfrozen replicas, as a 0-dim
    device tensor (the drain poll reads one scalar)."""
    r = torch.arange(status.shape[0], dtype=I32, device=status.device)
    active = (((live_mask >> r) & 1) == 1) & ~frozen
    undone = (status != t.S_DONE).to(I32)
    return torch.where(active[:, None], undone, 0).sum(dtype=I32)


def build_fast_batched(cfg: HermesConfig, ring: int = 2):
    """The round as a compiled function ``(fs, stream, ctl) -> (fs,
    comp)`` (``graphs.Compiled``: a CUDA graph a variant on the card, the
    reference's ``jax.jit``); ``fs`` is the bound state, updated in place,
    ``comp`` the completions in the next of ``ring`` slots."""

    def step(fs, stream, ctl):
        return fast_round_batched(cfg, ctl, fs, stream)

    return graphs.Compiled(step, cfg.replay_scan_every, ring=ring,
                           name="fast_round_batched")


def build_fast_sharded(cfg: HermesConfig, group, ring: int = 2):
    """The sharded round over ``group``'s local replicas as a compiled
    function ``(fs, stream, ctl) -> (fs, comp)`` (the reference's
    ``build_fast_sharded`` at ``rounds=1``; shard_map has no counterpart:
    the round runs over the leading local-replica axis).  On a
    ``LocalGroup`` it is a CUDA graph a variant on the card; a
    ``DistGroup``'s collectives leave the device, so its round is called
    eagerly, with the same bound state and ring."""
    from hermes_tpu_torch.core.group import LocalGroup

    if cfg.n_replicas % group.world:
        raise ValueError(f"{cfg.n_replicas} replicas do not split over the "
                         f"group's {group.world} ranks")

    def step(fs, stream, ctl):
        return fast_round_sharded(cfg, ctl, fs, stream, group)

    return graphs.Compiled(step, cfg.replay_scan_every, ring=ring,
                           graph=isinstance(group, LocalGroup),
                           name="fast_round_sharded")


def place_fast_sharded(cfg: HermesConfig, group, stream):
    """The sharded state of ``group``'s local replicas on its device, and
    their rows of an (R, S, G[, U]) op stream."""
    n = group.n_local(cfg.n_replicas)
    lo = group.first(cfg.n_replicas)
    local = type(stream)(*(None if x is None else x[lo:lo + n]
                           for x in stream))
    return (init_fast_state(cfg, group.device, n_copies=n),
            prep_stream(local, group.device))


def build_fast_scan(cfg: HermesConfig, rounds: int):
    """``rounds`` rounds a call, completions dropped (the throughput
    loop): the reference's ``lax.scan`` under one ``jax.jit``, here one
    compiled chunk (one CUDA graph a pattern of scan rounds at its
    offsets).  Returns the bound state; the chunk adds ``rounds`` to the
    step it bound."""

    def chunk(fs, stream, ctl):
        for off in range(rounds):
            fs, _comp = fast_round_batched(
                cfg, ctl._replace(step=ctl.step + off,
                                  host_step=ctl.host_step + off), fs, stream)
        return fs

    return graphs.Compiled(chunk, cfg.replay_scan_every, rounds=rounds,
                           comps=False, name="fast_scan")


# --------------------------------------------------------------------------
# Version rebase: restore packed-ts headroom on long runs
# --------------------------------------------------------------------------


def _rebase_core(cfg: HermesConfig, fs: FastState, busy, uniform=None):
    """Reset every ELIGIBLE key (no outstanding ts anywhere — ``busy`` —
    and VALID) to version 1, in place on the table; returns (fs, delta)
    with delta the (K,) per-key version reduction the runtime adds back
    to recorded completions.  Works on the copies view (``copies``): the
    batched table is one copy, the sharded one a copy a local replica,
    where ``uniform`` (the keys whose (pts, VALID) agree on every copy of
    the group) vetoes the rest: a stale copy must not diverge."""
    K = cfg.n_keys
    table, sess, replay = fs.table, fs.sess, fs.replay
    vpts = copies(table.vpts, K)  # (n, K) views
    bank = copies(table.bank, K)
    ver = pts_ver(vpts)
    rows32 = _bank_to_i32(bank)
    state = rows32[..., BANK_SST] & 7
    elig = (busy == 0) & (state == t.VALID) & (ver > 1)
    if uniform is not None:
        elig = elig & uniform
    new_ver = torch.where(elig, 1, ver)
    new_vpts = pack_pts(new_ver, pts_fc(vpts))
    rows32[..., BANK_PTS] = torch.where(elig, new_vpts, rows32[..., BANK_PTS])
    # in place (JAX returns a fresh table)
    vpts.copy_(new_vpts)
    bank.copy_(_i32_to_bank(rows32))

    kept = sess.status == t.S_INFL
    new_sess_pts = torch.where(kept, sess.pts, 0)
    r_pts = torch.where(replay.active, replay.pts, 0)
    new_max = torch.maximum(
        new_vpts.amax(dim=1),
        torch.maximum(new_sess_pts.amax(dim=1), r_pts.amax(dim=1)),
    )
    meta = fs.meta._replace(
        max_pts=new_max.expand(fs.meta.max_pts.shape).contiguous())
    delta = (ver - new_ver)[0]
    return fs._replace(sess=sess._replace(pts=new_sess_pts), meta=meta), delta


def _busy_mask(cfg: HermesConfig, sess: FastSess, replay: FastReplay,
               per_replica: bool = False):
    """(K,) int32: 1 where any session/replay slot holds a minted
    outstanding ts for the key; ``per_replica``: (R, K), each replica's
    own slots."""
    K = cfg.n_keys
    R = sess.key.shape[0]
    n = R if per_replica else 1
    busy = torch.zeros((n * K,), dtype=I32, device=sess.key.device)
    off = (torch.arange(R, dtype=I32, device=sess.key.device)[:, None] * K
           if per_replica else 0)
    infl = (sess.status == t.S_INFL).to(I32).reshape(-1)
    busy.scatter_reduce_(0, (sess.key + off).reshape(-1).long(), infl,
                         "amax")
    ract = replay.active.to(I32).reshape(-1)
    busy.scatter_reduce_(0, (replay.key + off).reshape(-1).long(), ract,
                         "amax")
    return busy.view(n, K) if per_replica else busy


def build_rebase(cfg: HermesConfig, backend: str = "batched", group=None):
    """``fs -> (fs, delta)`` version-rebase pass.  Batched: one shared
    table.  Sharded: ``busy`` summed over the group and the ``uniform``
    veto — every copy's vpts equal (pmax == pmin) and VALID everywhere
    (pmin) — taken over it, so every copy makes the identical decision
    and ``delta`` is the same on every replica."""
    if backend == "batched":
        def rebase(fs):
            return _rebase_core(cfg, fs, _busy_mask(cfg, fs.sess, fs.replay))

        return rebase
    if backend != "sharded":
        raise ValueError(f"unknown backend {backend!r}")
    if group is None:
        raise ValueError("the sharded rebase needs a group")
    K = cfg.n_keys

    def rebase_sharded(fs):
        busy = group.psum(_busy_mask(cfg, fs.sess, fs.replay,
                                     per_replica=True))
        vpts = copies(fs.table.vpts, K)
        valid = ((_bank_to_i32(copies(fs.table.bank, K)[
            ..., 4 * BANK_SST:4 * BANK_SST + 4])[..., 0] & 7)
            == t.VALID).to(I32)
        uniform = ((group.pmax(vpts) == group.pmin(vpts))
                   & (group.pmin(valid) == 1))
        return _rebase_core(cfg, fs, busy, uniform)

    return rebase_sharded
