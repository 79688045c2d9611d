"""Operation-history recording (SURVEY.md §4, §7 hard part 1).

A copy of ``hermes_tpu/checker/history.py``: pure Python over numpy,
fed by the port's harvested completions.

The bulk-synchronous step gives a natural real-time order: within step s the
phase pipeline fixes  commits(s-1)  <  reads(s)  <  commits(s).  We encode it
by doubling: a read completing at step s responds at time 2s; an update
committing at step s responds (and linearizes) at 2s+1; every op's invocation
is 2*load_step.  These are exactly the client-observable invocation/response
times, so checking against them is neither optimistic nor pessimistic.

Write values are unique (uid = (lo, hi) int32 pair derived from
replica/session/op — see phases._write_value); the initial value of key k is
(lo=k, hi=-1) (state.init_table).  Uniqueness is what makes per-key
linearizability checking tractable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import types as t

Uid = Tuple[int, int]  # (lo, hi)

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Op:
    """One client operation in the history."""

    kind: str  # 'r' | 'w' | 'rmw' | 'maybe_w' (incomplete update, may have applied)
    key: int
    inv: float  # invocation time (2 * load_step)
    resp: float  # response time (2s for reads, 2s+1 for commits, inf if incomplete)
    wuid: Optional[Uid] = None  # value written (updates)
    ruid: Optional[Uid] = None  # value observed (reads; RMW read-part)
    ts: Optional[Tuple[int, int]] = None  # protocol (ver, fc) — linearization witness
    replica: int = -1
    session: int = -1


class HistoryRecorder:
    """Accumulates per-step completion records into a flat op history.

    Completions arrive as (R, S) arrays per step (state.Completions).  At end
    of run, ``finalize`` folds in still-pending updates (which may or may not
    have taken effect — the checker treats them as optional writes) from the
    final session state."""

    def __init__(self, cfg: HermesConfig):
        self.cfg = cfg
        self.ops: List[Op] = []
        self.aborted_uids: set = set()
        self._finalized = False

    def record_step(self, comp) -> None:
        code = np.asarray(comp.code)
        if not (code != t.C_NONE).any():
            return
        key = np.asarray(comp.key)
        wval = np.asarray(comp.wval)
        rval = np.asarray(comp.rval)
        ver = np.asarray(comp.ver)
        fc = np.asarray(comp.fc)
        inv = np.asarray(comp.invoke_step)
        cmt = np.asarray(comp.commit_step)
        rr, ss = np.nonzero(code != t.C_NONE)
        for r, s in zip(rr.tolist(), ss.tolist()):
            c = int(code[r, s])
            k = int(key[r, s])
            i2 = 2.0 * inv[r, s]
            ts = (int(ver[r, s]), int(fc[r, s]))
            if c == t.C_READ:
                self.ops.append(
                    Op("r", k, i2, 2.0 * cmt[r, s],
                       ruid=(int(rval[r, s, 0]), int(rval[r, s, 1])), replica=r, session=s)
                )
            elif c == t.C_WRITE:
                self.ops.append(
                    Op("w", k, i2, 2.0 * cmt[r, s] + 1,
                       wuid=(int(wval[r, s, 0]), int(wval[r, s, 1])), ts=ts,
                       replica=r, session=s)
                )
            elif c == t.C_RMW:
                self.ops.append(
                    Op("rmw", k, i2, 2.0 * cmt[r, s] + 1,
                       wuid=(int(wval[r, s, 0]), int(wval[r, s, 1])),
                       ruid=(int(rval[r, s, 0]), int(rval[r, s, 1])), ts=ts,
                       replica=r, session=s)
                )
            elif c == t.C_RMW_ABORT:
                self.aborted_uids.add((int(wval[r, s, 0]), int(wval[r, s, 1])))
            # C_NOP: no effect on the register history

    def fold_pending(self, sess, replica: int = None, mask=None) -> int:
        """Fold in-flight updates of ``sess`` (optionally one replica's
        row, or an ``(R, S)`` slot ``mask``) as ``maybe_w`` ops: an update
        still gathering acks may have been applied at some replica and
        must be allowed — but not required — to linearize.  ``finalize``
        calls this once at end of run; ``chaos.recovery.restart_replica``
        at crash time for the dying replica; the KVS's bounded retry for
        a salvaged slot; a range migration's forced cutover
        (``KVS.salvage_slots``) with the mask of the salvaged slots.
        Returns the number of ops folded."""
        status = np.asarray(sess.status)
        op = np.asarray(sess.op)
        key = np.asarray(sess.key)
        val = np.asarray(sess.val)
        ver = np.asarray(sess.ver)
        fc = np.asarray(sess.fc)
        inv = np.asarray(sess.invoke_step)
        infl = status == t.S_INFL
        if mask is not None:
            infl = infl & np.asarray(mask, bool)
        rr, ss = np.nonzero(infl)
        n = 0
        for r, s in zip(rr.tolist(), ss.tolist()):
            if replica is not None and r != replica:
                continue
            if op[r, s] in (t.OP_WRITE, t.OP_RMW):
                self.ops.append(
                    Op("maybe_w", int(key[r, s]), 2.0 * inv[r, s], INF,
                       wuid=(int(val[r, s, 0]), int(val[r, s, 1])),
                       ts=(int(ver[r, s]), int(fc[r, s])),
                       replica=r, session=s)
                )
                n += 1
        return n

    def record_migration(self, keys, uids, vers, fcs, step: int) -> int:
        """Seed migrated-in keys (``elastic.migrate_range``): each key's
        current value enters this history as a committed write — the
        migration IS a write of the transferred value, linearized strictly
        before any post-flip op (``step`` is the destination round of the
        flip; the synthetic op responds at ``2*(step-1)+1``, ahead of any
        completion of round ``step``).  ``uids`` are the re-minted
        (lo=slot, hi<=-2) migration uids the restored rows now carry, so
        later reads observe exactly this write.  ``migrate_range`` owns
        the precondition: the keys are FRESH here (no prior committed ops
        in this history)."""
        n = 0
        for k, (wlo, whi), ver, fc in zip(keys, uids, vers, fcs):
            self.ops.append(
                Op("w", int(k), 2.0 * (step - 1), 2.0 * (step - 1) + 1,
                   wuid=(int(wlo), int(whi)), ts=(int(ver), int(fc))))
            n += 1
        return n

    def finalize(self, sess=None) -> List[Op]:
        """Fold in incomplete updates from the final session state
        (``fold_pending``).  Idempotent: the fold-in happens once."""
        if sess is not None and not self._finalized:
            self._finalized = True
            self.fold_pending(sess)
        return self.ops

    def by_key(self) -> Dict[int, List[Op]]:
        out: Dict[int, List[Op]] = {}
        for o in self.ops:
            out.setdefault(o.key, []).append(o)
        return out
