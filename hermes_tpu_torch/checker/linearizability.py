"""Per-key linearizability checker (SURVEY.md §4; gate per BASELINE.json:2).

A copy of ``hermes_tpu/checker/linearizability.py`` (pure Python).

A Wing&Gong-style search specialised to registers with unique write values
(the workload guarantees uniqueness; history.py documents the encoding):

  * The history is partitioned by key — a register history is linearizable
    iff each key's sub-history is (locality of linearizability).
  * Per key, DFS over linearization prefixes with memoization on
    (done-set, current-value).  An op may be linearized next iff no undone
    op's response precedes its invocation (real-time), and its value
    constraint holds: reads/RMW-read-parts must observe the current value.
  * Incomplete updates ('maybe_w') may linearize at any point after their
    invocation or be dropped entirely (the coordinator may or may not have
    propagated them before the history ended).
  * Aborted RMWs are no-ops; their uids must never be observed anywhere
    (checked globally first — the write-flag tie-break in the protocol
    guarantees it, see core/types.py).

Complexity is exponential in the worst case (the problem is NP-hard in
general) but with unique values and real-time pruning it is fast on the
histories our runs produce; `max_states` bounds pathological blowup and
turns it into an explicit "undecided" outcome rather than a hang.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from hermes_tpu_torch.checker.history import INF, Op, Uid


class _Budget(Exception):
    pass


@dataclasses.dataclass
class KeyVerdict:
    key: int
    ok: bool
    reason: str = ""
    states_explored: int = 0
    undecided: bool = False


@dataclasses.dataclass
class Verdict:
    ok: bool
    keys_checked: int
    failures: List[KeyVerdict]
    undecided: List[KeyVerdict]

    def __bool__(self) -> bool:
        return self.ok

    def to_dict(self, max_examples: int = 3) -> dict:
        """JSON-friendly summary (artifact scripts); a non-ok verdict always
        carries diagnosable examples — failures or undecided keys."""
        return {
            "verdict_ok": self.ok,
            "keys_checked": self.keys_checked,
            "failures": [repr(f) for f in self.failures[:max_examples]],
            "undecided": [repr(u) for u in self.undecided[:max_examples]],
        }


def check_history(
    ops: Sequence[Op],
    initial_uid_for_key=lambda k: (k, -1),
    aborted_uids: Optional[set] = None,
    max_states: int = 2_000_000,
) -> Verdict:
    """Check a full multi-key history.  Returns an aggregate Verdict."""
    aborted = aborted_uids or set()
    # Global rule: an aborted RMW's value must never be observed.
    for o in ops:
        if o.ruid is not None and o.ruid in aborted:
            return Verdict(
                ok=False,
                keys_checked=0,
                failures=[KeyVerdict(o.key, False, f"aborted RMW value {o.ruid} observed by {o}")],
                undecided=[],
            )

    by_key: Dict[int, List[Op]] = {}
    for o in ops:
        by_key.setdefault(o.key, []).append(o)

    failures, undecided = [], []
    for k, kops in by_key.items():
        v = check_key(k, kops, initial_uid_for_key(k), max_states=max_states)
        if v.undecided:
            undecided.append(v)
        elif not v.ok:
            failures.append(v)
    return Verdict(
        ok=not failures and not undecided,
        keys_checked=len(by_key),
        failures=failures,
        undecided=undecided,
    )


def check_key(key: int, ops: Sequence[Op], initial_uid: Uid, max_states: int = 2_000_000) -> KeyVerdict:
    """Check one key's sub-history.

    Fast path: the protocol's own timestamps are a linearization *witness* —
    updates in (ver, fc) order with each read placed after the update that
    wrote its value.  Verifying a given sequence is O(n log n); if it is
    real-time-feasible the history is linearizable, full stop.  Only when the
    witness fails (which in a correct run should never happen) do we fall
    back to the exact Wing&Gong search, so a checker FAIL is never a false
    alarm from the shortcut."""
    n = len(ops)
    if n == 0:
        return KeyVerdict(key, True)

    wv = _check_witness(key, ops, initial_uid)
    if wv is not None and wv.ok:
        return wv
    exact = _check_key_exact(key, ops, initial_uid, max_states)
    if exact.undecided and wv is not None and not wv.ok:
        # exact search can't decide (too large) but the witness concretely
        # failed — report that failure rather than an empty "undecided"
        return dataclasses.replace(
            wv, reason="witness failed (exact search infeasible): " + wv.reason
        )
    return exact


def _check_witness(key: int, ops: Sequence[Op], initial_uid: Uid) -> Optional[KeyVerdict]:
    """O(n log n) witness check using protocol timestamps.  Returns None when
    inapplicable (some update lacks a ts)."""
    updates = [o for o in ops if o.kind in ("w", "rmw")]
    observed = {o.ruid for o in ops if o.ruid is not None}
    updates += [o for o in ops if o.kind == "maybe_w" and o.wuid in observed]
    if any(o.ts is None for o in updates):
        return None
    ts_list = [o.ts for o in updates]
    if len(set(ts_list)) != len(ts_list):
        return KeyVerdict(key, False, reason="duplicate update timestamps (protocol bug)")
    updates.sort(key=lambda o: o.ts)

    reads_by_uid: dict = {}
    for o in ops:
        if o.kind == "r":
            reads_by_uid.setdefault(o.ruid, []).append(o)
    for rl in reads_by_uid.values():
        rl.sort(key=lambda o: o.inv)

    seq: List[Op] = list(reads_by_uid.get(initial_uid, []))
    cur = initial_uid
    for u in updates:
        if u.kind == "rmw" and u.ruid != cur:
            return KeyVerdict(
                key, False,
                reason=f"witness: RMW {u.wuid} observed {u.ruid} but ts-predecessor value is {cur}",
            )
        seq.append(u)
        cur = u.wuid
        seq.extend(reads_by_uid.get(cur, []))
    known = {initial_uid} | {u.wuid for u in updates}
    for uid, rl in reads_by_uid.items():
        if uid not in known:
            return KeyVerdict(key, False, reason=f"read of unknown value {uid} (op {rl[0]})")

    # greedy feasibility: strictly non-decreasing points p_i in [inv_i, resp_i]
    p = -INF
    for o in seq:
        p = max(p, o.inv)
        if p > o.resp:
            return KeyVerdict(
                key, False,
                reason=f"witness: real-time infeasible at {o} (needed point {p} > resp {o.resp})",
            )
    return KeyVerdict(key, True, states_explored=0)


def _check_key_exact(key: int, ops: Sequence[Op], initial_uid: Uid, max_states: int) -> KeyVerdict:
    """DFS (Wing&Gong) linearizability check of one key's sub-history."""
    n = len(ops)
    if n > 62:
        # bitmask-int done-sets need n <= 62; larger keys rely on the witness
        # path (which has no size limit).  Flag honestly rather than guess.
        return KeyVerdict(key, True, reason=f"exact search skipped: {n} ops > 62", undecided=True)

    inv = [o.inv for o in ops]
    resp = [o.resp for o in ops]
    kind = [o.kind for o in ops]
    wuid = [o.wuid for o in ops]
    ruid = [o.ruid for o in ops]
    required_mask = 0
    for i, o in enumerate(ops):
        if o.kind != "maybe_w":
            required_mask |= 1 << i

    # quick necessary condition: a completed read observing X requires X to be
    # initial or written by some op in the history
    writes_by_uid = {w: i for i, w in enumerate(wuid) if w is not None}
    for i, o in enumerate(ops):
        if o.ruid is not None and o.ruid != initial_uid and o.ruid not in writes_by_uid:
            return KeyVerdict(key, False, f"read of unknown value {o.ruid} (op {o})")

    seen = set()
    states = 0

    def dfs(done: int, cur: Uid) -> bool:
        nonlocal states
        if (done & required_mask) == required_mask:
            return True
        if (done, cur) in seen:
            return False
        states += 1
        if states > max_states:
            raise _Budget()
        seen.add((done, cur))
        # frontier: min response among undone ops — an op can linearize next
        # only if its invocation precedes every undone op's response
        min_resp = INF
        for i in range(n):
            if not done & (1 << i) and resp[i] < min_resp:
                min_resp = resp[i]
        for i in range(n):
            bit = 1 << i
            if done & bit or inv[i] > min_resp:
                continue
            ki = kind[i]
            if ki == "r":
                if ruid[i] == cur and dfs(done | bit, cur):
                    return True
            elif ki == "rmw":
                if ruid[i] == cur and dfs(done | bit, wuid[i]):
                    return True
            else:  # 'w' or 'maybe_w'
                if dfs(done | bit, wuid[i]):
                    return True
        return False

    try:
        ok = dfs(0, initial_uid)
    except _Budget:
        return KeyVerdict(key, True, reason=f"state budget exceeded ({max_states})",
                          states_explored=states, undecided=True)
    if ok:
        return KeyVerdict(key, True, states_explored=states)
    return KeyVerdict(
        key, False,
        reason=f"no linearization exists for {n} ops: {sorted(ops, key=lambda o: o.inv)[:6]}...",
        states_explored=states,
    )


def committed_write_lost(committed_uids, ops: Sequence[Op],
                         aborted_uids: Optional[set] = None) -> List[Uid]:
    """Safety cross-check, structural form of one bug class
    (committed-and-observed write reported aborted): given the write uids
    the CLIENT saw commit (resolved put/rmw futures), return every uid the
    recorded history contradicts — reported aborted, or recorded only as a
    non-committed row (maybe_w/absent counts as lost: the history must
    carry a definite committed write for every client-visible commit).
    Empty list = no committed-and-observed write was ever reported
    lost/aborted — the partition+heal acceptance criterion."""
    aborted = aborted_uids or set()
    definite = {o.wuid for o in ops if o.kind in ("w", "rmw")
                and o.wuid is not None}
    lost = []
    for uid in committed_uids:
        if uid in aborted or uid not in definite:
            lost.append(uid)
    return lost


def stale_read(ops: Sequence[Op], initial_uid_for_key=lambda k: (k, -1)
               ) -> List[dict]:
    """Read-side safety cross-check, structural form of the
    local-read hazard class: a read that returned a value the history
    PROVES was overwritten before the read was even issued.

    The full Wing&Gong search would also reject such a history, but (like
    ``committed_write_lost`` for its bug class) this names the exact
    failure shape the read fast path could introduce — serving stale
    bytes from a row the protocol already superseded — so a violation is
    diagnosed as "stale read", not as an opaque no-linearization-exists.

    Rule: updates linearize in protocol-timestamp order (the witness).
    For a read r observing value v written by committed update u1, if ANY
    committed update u2 on the key has ts(u2) > ts(u1) and responded
    before r was invoked (u2.resp < r.inv), then v was provably no longer
    current at every point in [r.inv, r.resp] — u2 had already linearized
    and only higher-ts updates can follow — so r cannot linearize.
    Reads of the initial value are stale once any committed update
    responded before their invocation.  Incomplete updates (maybe_w)
    never prove staleness (they may linearize arbitrarily late).

    Returns evidence dicts (empty list = clean): one per stale read with
    the read, the value it observed, and the superseding update."""
    by_key: Dict[int, List[Op]] = {}
    for o in ops:
        by_key.setdefault(o.key, []).append(o)
    evidence: List[dict] = []
    for k, kops in by_key.items():
        updates = [o for o in kops if o.kind in ("w", "rmw")
                   and o.ts is not None]
        if not updates:
            continue
        updates.sort(key=lambda o: o.ts)
        ts_of = {u.wuid: i for i, u in enumerate(updates)}
        # sufmin[i] = earliest response among updates ranked > i (the
        # first PROVEN overwrite time of update i's value)
        sufmin = [INF] * (len(updates) + 1)
        for i in range(len(updates) - 1, -1, -1):
            sufmin[i] = min(sufmin[i + 1], updates[i].resp)
        initial = initial_uid_for_key(k)
        for o in kops:
            if o.kind not in ("r", "rmw") or o.ruid is None:
                continue
            if o.ruid == initial:
                overwritten = sufmin[0]
            else:
                rank = ts_of.get(o.ruid)
                if rank is None:
                    continue  # unknown/maybe value: not this check's job
                overwritten = sufmin[rank + 1]
            if overwritten < o.inv:
                cands = (updates if o.ruid == initial
                         else updates[ts_of[o.ruid] + 1:])
                sup = min(cands, key=lambda u: u.resp)
                evidence.append(dict(
                    key=k, read=o, observed=o.ruid,
                    superseded_by=sup.wuid, superseded_resp=sup.resp))
        if len(evidence) >= 64:
            break  # plenty of evidence; keep failure reports bounded
    return evidence


def sample_keys(ops: Sequence[Op], max_keys: int = 512, seed: int = 0) -> List[Op]:
    """Down-sample a huge history to ``max_keys`` keys (bench-scale runs
    check a sample; tests check everything).  Keeps whole per-key
    sub-histories so locality still applies."""
    import random

    keys = sorted({o.key for o in ops})
    if len(keys) <= max_keys:
        return list(ops)
    rnd = random.Random(seed)
    keep = set(rnd.sample(keys, max_keys))
    return [o for o in ops if o.key in keep]
