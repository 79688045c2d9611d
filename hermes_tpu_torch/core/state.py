"""State containers of the fast engine, the phases engine, the runtimes
and the client: the port of ``hermes_tpu/core/state.py``.

NamedTuples of tensors on one explicit device.  All integers are int32
and flags bool, as in the reference.  Both engines keep a leading replica
axis on every leaf (the reference's vmapped layout; ``n_rows`` local
replicas on a rank of a ``DistGroup``), so every ``init_*`` and
``empty_*`` here builds that batched layout.

The phases engine (``core/phases.py``) updates its ``KeyTable`` in place
through masked scatters.  A masked row must leave such a scatter, not
land on a real row (the reference's ``mode="drop"``), so every table leaf
is a view of a buffer one row longer than the view: the masked rows go to
that hidden drop row (``with_drop_row``).  The leaves themselves have the
reference's shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hermes_tpu_torch.config import HermesConfig

LAT_BINS = 64


class Completions(NamedTuple):
    """Per-round, per-session completion records (R, S): the raw material
    of the linearizability history and of the client futures.

    ``code`` types.C_*; C_NONE when the session completed nothing.
    ``wval``/``rval`` (R, S, V) value words written / read; ``ver``/``fc``
    the update's protocol timestamp (the checker's linearization witness);
    ``invoke_step``/``commit_step`` the op's load and completion rounds."""

    code: torch.Tensor
    key: torch.Tensor
    wval: torch.Tensor
    rval: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    invoke_step: torch.Tensor
    commit_step: torch.Tensor


class Meta(NamedTuple):
    """Per-replica observability counters (leading R axis): heartbeat
    ages, completed-op counts, the commit-latency histogram, the packed-ts
    watermark ``max_pts`` (the version-budget guard) and the phase metrics
    (``n_inv`` .. ``qwait_hist``, summed under cfg.phase_metrics).  See
    ``hermes_tpu/core/state.py:Meta`` for each field."""

    last_seen: torch.Tensor
    suspect_age: torch.Tensor
    n_read: torch.Tensor
    n_write: torch.Tensor
    n_rmw: torch.Tensor
    n_abort: torch.Tensor
    lat_sum: torch.Tensor
    lat_cnt: torch.Tensor
    lat_hist: torch.Tensor
    max_pts: torch.Tensor
    n_inv: torch.Tensor
    n_rebcast: torch.Tensor
    n_nack: torch.Tensor
    n_retry: torch.Tensor
    replay_peak: torch.Tensor
    qwait_sum: torch.Tensor
    qwait_hist: torch.Tensor


class OpStream(NamedTuple):
    """Per-session op stream (R, S, G): op codes and keys; the client API
    also supplies payload bytes ``uval`` (R, S, G, 4*(value_words-2)) int8
    (words 0-1 of every value stay the device-derived unique write id).
    The phases engine takes ``uval`` as int32 words (R, S, G,
    value_words-2), the reference's layout."""

    op: torch.Tensor
    key: torch.Tensor
    uval: Optional[torch.Tensor] = None


def init_meta(cfg: HermesConfig, device: torch.device,
              n_rows=None) -> Meta:
    """Zeroed Meta: (R,) counters, (R, R) heartbeat rows and (R,
    LAT_BINS) histograms; ``n_rows`` local replicas instead of R rows
    (the sharded layout on a rank of a DistGroup)."""
    r = cfg.n_replicas if n_rows is None else n_rows

    def z(*sh):
        return torch.zeros(sh, dtype=torch.int32, device=device)

    return Meta(
        last_seen=z(r, cfg.n_replicas), suspect_age=z(r, cfg.n_replicas),
        n_read=z(r), n_write=z(r), n_rmw=z(r), n_abort=z(r),
        lat_sum=z(r), lat_cnt=z(r), lat_hist=z(r, LAT_BINS),
        max_pts=z(r), n_inv=z(r), n_rebcast=z(r), n_nack=z(r),
        n_retry=z(r), replay_peak=z(r), qwait_sum=z(r),
        qwait_hist=z(r, LAT_BINS),
    )


# ---------------------------------------------------------------------------
# The phases engine's state (hermes_tpu/core/state.py:26-163, :262-390)
# ---------------------------------------------------------------------------


class KeyTable(NamedTuple):
    """Per-key replicated state, one copy a replica: ``state`` (R, K)
    types.VALID/INVALID/WRITE/TRANS/REPLAY, the timestamp ``ver``/``fc``
    (R, K), the value words ``val`` (R, K, V) (words 0-1 the unique write
    id) and ``inv_step`` (R, K), the round of the last timestamp change
    (the replay age test).  Every leaf carries a hidden drop row
    (``with_drop_row``)."""

    state: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    val: torch.Tensor
    inv_step: torch.Tensor


class Sessions(NamedTuple):
    """Client sessions (R, S): one op in flight a session, the session
    index also its update's INV lane.  ``status`` types.S_*, the current
    ``op``/``key``/``val`` (R, S, V), the stream cursor ``op_idx``, the
    pending update's ``ver``/``fc`` and gathered-ack bitmap ``acks``,
    ``superseded`` (a pending write lost to a higher-ts INV), the value a
    read observed ``rd_val`` (R, S, V) and the op's load round
    ``invoke_step``."""

    status: torch.Tensor
    op: torch.Tensor
    op_idx: torch.Tensor
    key: torch.Tensor
    val: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    acks: torch.Tensor
    superseded: torch.Tensor
    rd_val: torch.Tensor
    invoke_step: torch.Tensor


class ReplaySlots(NamedTuple):
    """In-flight replays (R, RS): a key stuck Invalid past the age test is
    re-driven with its last INV's timestamp and value, snapshotted here."""

    active: torch.Tensor
    key: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    val: torch.Tensor
    acks: torch.Tensor


class Invs(NamedTuple):
    """INV block.  Outbound (R, L, ...) one lane a session or replay slot;
    inbound (R_dst, R_src, L, ...).  ``alive`` is the heartbeat bit: (R,)
    outbound, (R_dst, R_src) inbound."""

    valid: torch.Tensor
    key: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    epoch: torch.Tensor
    val: torch.Tensor
    alive: torch.Tensor


class Acks(NamedTuple):
    """ACK block.  Outbound (R, R_src, L): ack[a, p, l] answers the INV
    replica a received from p in lane l; inbound (R, R_acker, L) after the
    route-back.  ``ok`` is the conflict flag (the acked ts is still the
    key's maximum at the acker)."""

    valid: torch.Tensor
    key: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    ok: torch.Tensor
    epoch: torch.Tensor


class Vals(NamedTuple):
    """VAL block, lane-aligned with the sender's INV lanes; broadcast."""

    valid: torch.Tensor
    key: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    epoch: torch.Tensor


class Ctl(NamedTuple):
    """Per-replica round control, each (R,): the round ``step``, the
    replica's id ``my_cid``, the membership ``epoch`` and ``live_mask``,
    and ``frozen`` (bool; a frozen replica makes no transition and emits
    nothing)."""

    step: torch.Tensor
    my_cid: torch.Tensor
    epoch: torch.Tensor
    live_mask: torch.Tensor
    frozen: torch.Tensor


class ReplicaState(NamedTuple):
    """Everything the replicas own: tables, sessions, replay slots and
    observability counters, each leaf with the leading replica axis."""

    table: KeyTable
    sess: Sessions
    replay: ReplaySlots
    meta: Meta


def with_drop_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, K, ...) copied into a buffer of R*K + 1 rows and returned
    as the view of its first R*K: the extra row is where the phases
    engine's masked scatters send their masked rows."""
    n, k = x.shape[:2]
    tail = tuple(x.shape[2:])
    buf = torch.zeros((n * k + 1,) + tail, dtype=x.dtype, device=x.device)
    buf[:n * k].copy_(x.reshape((n * k,) + tail))
    return buf[:n * k].view((n, k) + tail)


def init_table(cfg: HermesConfig, device, n_rows=None) -> KeyTable:
    """Every key preloaded Valid at version 0 with the value id (hi=-1,
    lo=key), one copy for each of R (or ``n_rows``) replicas."""
    r = cfg.n_replicas if n_rows is None else n_rows
    k, v = cfg.n_keys, cfg.value_words
    keys = torch.arange(k, dtype=torch.int32, device=device)
    val = torch.zeros((r, k, v), dtype=torch.int32, device=device)
    val[:, :, 0] = keys
    val[:, :, 1] = -1

    def z():
        return torch.zeros((r, k), dtype=torch.int32, device=device)

    return KeyTable(state=with_drop_row(z()), ver=with_drop_row(z()),
                    fc=with_drop_row(z()), val=with_drop_row(val),
                    inv_step=with_drop_row(z()))


def init_sessions(cfg: HermesConfig, device, n_rows=None) -> Sessions:
    r = cfg.n_replicas if n_rows is None else n_rows
    s, v = cfg.n_sessions, cfg.value_words

    def z(*tail, dtype=torch.int32):
        return torch.zeros((r, s) + tail, dtype=dtype, device=device)

    return Sessions(status=z(), op=z(), op_idx=z(), key=z(), val=z(v),
                    ver=z(), fc=z(), acks=z(),
                    superseded=z(dtype=torch.bool), rd_val=z(v),
                    invoke_step=z())


def init_replay(cfg: HermesConfig, device, n_rows=None) -> ReplaySlots:
    r = cfg.n_replicas if n_rows is None else n_rows
    rs, v = cfg.replay_slots, cfg.value_words

    def z(*tail, dtype=torch.int32):
        return torch.zeros((r, rs) + tail, dtype=dtype, device=device)

    return ReplaySlots(active=z(dtype=torch.bool), key=z(), ver=z(), fc=z(),
                       val=z(v), acks=z())


def init_replica_state(cfg: HermesConfig, device,
                       n_rows=None) -> ReplicaState:
    return ReplicaState(table=init_table(cfg, device, n_rows),
                        sess=init_sessions(cfg, device, n_rows),
                        replay=init_replay(cfg, device, n_rows),
                        meta=init_meta(cfg, device, n_rows))


def empty_invs(cfg: HermesConfig, lead=(), device="cpu") -> Invs:
    lead = tuple(lead)
    sh = lead + (cfg.n_lanes,)

    def z(*tail, dtype=torch.int32):
        return torch.zeros(sh + tail, dtype=dtype, device=device)

    return Invs(valid=z(dtype=torch.bool), key=z(), ver=z(), fc=z(),
                epoch=z(), val=z(cfg.value_words),
                alive=torch.zeros(lead, dtype=torch.bool, device=device))


def empty_acks(cfg: HermesConfig, lead=(), device="cpu") -> Acks:
    sh = tuple(lead) + (cfg.n_lanes,)

    def z(dtype=torch.int32):
        return torch.zeros(sh, dtype=dtype, device=device)

    return Acks(valid=z(torch.bool), key=z(), ver=z(), fc=z(),
                ok=z(torch.bool), epoch=z())


def empty_vals(cfg: HermesConfig, lead=(), device="cpu") -> Vals:
    sh = tuple(lead) + (cfg.n_lanes,)

    def z(dtype=torch.int32):
        return torch.zeros(sh, dtype=dtype, device=device)

    return Vals(valid=z(torch.bool), key=z(), ver=z(), fc=z(), epoch=z())
