"""Admission control of the serving front-end.

Three rungs stand between a request and the intake queue, each refusing
LOUDLY (wire.S_RETRY_AFTER with a reason + retry hint) instead of
buffering silently:

  1. the overload ladder — a queue-occupancy staircase that composes
     with the store's quorum-loss degraded mode: rung 1 sheds NEW
     writes (reads still serve — exactly the
     ``min_healthy_for_writes`` policy pulled forward to the front
     door, where refusing is cheaper than admitting a doomed op), rung
     2 additionally sheds non-hot-key reads (the hot set keeps serving:
     under a zipfian storm that preserves the bulk of the offered read
     value at a fraction of the lane cost);
  2. the per-tenant session quota — a cap on client-visible in-flight
     ops, the serving analogue of the reference's per-worker session
     arrays (SURVEY.md §1 L5) — and the bounded intake queue
     (R_QUEUE_FULL);
  3. the per-tenant token bucket — sustained rate + burst, refilled on
     the SERVING clock (virtual in deterministic soaks, monotonic wall
     time on sockets), so one tenant cannot starve the rest.  Charged
     LAST: a quota/queue refusal never burns the tenant's rate budget.
All state is plain floats/ints driven by a caller-supplied ``now``:
given the same arrival schedule the whole admission path replays
byte-identically (the chaos-schedule discipline applied to overload).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from hermes_tpu_torch.serving import wire


class TokenBucket:
    """Deterministic token bucket on a caller-supplied clock."""

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("rate_per_s and burst must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t_last is not None and now > self._t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now if self._t_last is None else max(self._t_last, now)

    def take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def wait_s(self, now: float) -> float:
        """Seconds until one token accrues (the retry_after hint)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


@dataclasses.dataclass
class TenantState:
    """Per-tenant admission + accounting state."""

    bucket: TokenBucket
    inflight: int = 0       # client-visible in-flight ops (quota unit)
    admitted: int = 0
    completed: int = 0      # S_OK + S_RMW_ABORT
    retry_after: int = 0    # all front-door refusals
    shed: int = 0           # refusals by the overload ladder specifically
    deadline: int = 0
    rejected: int = 0       # store-level definitive rejects
    lost: int = 0

    def counters(self) -> dict:
        return dict(admitted=self.admitted, completed=self.completed,
                    retry_after=self.retry_after, shed=self.shed,
                    deadline=self.deadline, rejected=self.rejected,
                    lost=self.lost, inflight=self.inflight)


class AdmissionControl:
    """The front door: ladder + bucket + quota + queue bound.

    ``admit`` returns ``(reason, retry_after_s)`` — reason ``R_NONE``
    means admitted (the caller enqueues and calls ``note_admitted``).
    """

    def __init__(self, scfg):
        self.scfg = scfg
        self.tenants: Dict[int, TenantState] = {}
        hot = getattr(scfg, "hot_key_set", frozenset()) or frozenset()
        # sorted array mirror of the hot set for the batch ladder's
        # vectorized membership test (np.isin wants a sorted haystack)
        self._hot_arr = np.sort(np.fromiter(hot, np.int64, len(hot)))

    def tenant(self, t: int) -> TenantState:
        ts = self.tenants.get(t)
        if ts is None:
            ts = self.tenants[t] = TenantState(TokenBucket(
                self.scfg.tenant_rate_per_s, self.scfg.tenant_burst))
        return ts

    # -- the overload ladder -------------------------------------------------

    def ladder_level(self, queue_len: int, degraded: bool) -> int:
        """Rung for the CURRENT pressure: 2 past the read watermark, 1
        past the write watermark OR while the store is in quorum-loss
        degraded mode (writes cannot commit — refuse at the door rather
        than admit a doomed op), else 0."""
        cap = self.scfg.queue_cap
        if queue_len >= int(cap * self.scfg.shed_read_frac):
            return 2
        if degraded or queue_len >= int(cap * self.scfg.shed_write_frac):
            return 1
        return 0

    def admit(self, kind: str, key: int, tenant: int, now: float,
              queue_len: int, degraded: bool) -> Tuple[int, float]:
        level = self.ladder_level(queue_len, degraded)
        ts = self.tenant(tenant)
        retry_s = self.scfg.retry_after_floor_s
        if level >= 1 and kind != "get":
            ts.shed += 1
            ts.retry_after += 1
            return wire.R_SHED_WRITE, retry_s
        if level >= 2 and kind == "get" \
                and key not in self.scfg.hot_key_set:
            ts.shed += 1
            ts.retry_after += 1
            return wire.R_SHED_READ, retry_s
        if ts.inflight >= self.scfg.tenant_quota:
            ts.retry_after += 1
            return wire.R_QUOTA, retry_s
        if queue_len >= self.scfg.queue_cap:
            ts.retry_after += 1
            return wire.R_QUEUE_FULL, retry_s
        # the bucket is charged LAST: a quota/queue refusal must not also
        # burn the tenant's rate budget, or a backed-up tenant re-emerges
        # from the jam rate-starved by its own refused retries
        if not ts.bucket.take(now):
            ts.retry_after += 1
            return wire.R_RATE, max(retry_s, ts.bucket.wait_s(now))
        return wire.R_NONE, 0.0

    def admit_batch(self, writes: np.ndarray, keys: np.ndarray,
                    tenants: np.ndarray, now: float, queue_len: int,
                    degraded: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Judge a whole columnar batch through the ladder, row-for-row
        EQUIVALENT to calling ``admit`` sequentially over the rows —
        same reasons, same retry hints, same counter and bucket state
        afterwards — in O(segments) numpy passes instead of O(rows)
        Python.

        Returns ``(reasons u8, retry_after_s f64)``; reason ``R_NONE``
        means admitted, and ``note_admitted`` is FOLDED IN for admitted
        rows (the scalar path's separate call) — the caller only
        enqueues them.

        Why segments: within a batch the queue only grows, so the
        ladder level and the queue-full verdict are monotone in the row
        index.  Each iteration judges the remaining rows against the
        CURRENT (level, queue) and commits only the prefix whose
        judgments that state actually covers — the first row whose
        admitted-prefix pushes the queue across the next threshold
        (write watermark, read watermark, or cap) starts a new segment.
        Per tenant the scalar order is preserved exactly: shed ->
        quota -> queue-full -> token bucket charged LAST, with the
        first ``min(quota_room, whole_tokens)`` candidate rows
        admitting and every later row refusing with the same reason
        and hint the scalar loop would give (refused takes consume
        nothing, so one shared hint is exact)."""
        writes = np.asarray(writes, bool)
        keys = np.asarray(keys, np.int64)
        tenants = np.asarray(tenants)
        n = int(writes.shape[0])
        reasons = np.zeros(n, np.uint8)
        waits = np.zeros(n, np.float64)
        if n == 0:
            return reasons, waits
        scfg = self.scfg
        floor = scfg.retry_after_floor_s
        cap = scfg.queue_cap
        wmark = int(cap * scfg.shed_write_frac)
        rmark = int(cap * scfg.shed_read_frac)
        is_hot = (np.isin(keys, self._hot_arr) if self._hot_arr.size
                  else np.zeros(n, bool))

        def peek(bucket) -> float:
            # the refilled token count WITHOUT mutating the bucket: the
            # scalar path only refills when a row actually reaches
            # take(), so the batch must judge on a peek and commit the
            # refill only for tenants whose committed rows got there —
            # or the post-batch bucket state drifts from the scalar's
            if bucket._t_last is not None and now > bucket._t_last:
                return min(bucket.burst,
                           bucket.tokens + (now - bucket._t_last)
                           * bucket.rate)
            return bucket.tokens

        q = int(queue_len)
        i = 0
        while i < n:
            m = n - i
            level = self.ladder_level(q, degraded)
            w = writes[i:n]
            t_seg = tenants[i:n]
            shed_w = w if level >= 1 else np.zeros(m, bool)
            shed_r = (((~w) & ~is_hot[i:n]) if level >= 2
                      else np.zeros(m, bool))
            rsn = np.zeros(m, np.uint8)
            wt = np.zeros(m, np.float64)
            rsn[shed_w] = wire.R_SHED_WRITE
            rsn[shed_r] = wire.R_SHED_READ
            wt[shed_w | shed_r] = floor
            cand = ~(shed_w | shed_r)
            admit = np.zeros(m, bool)
            quota_rooms: Dict[int, int] = {}  # tenants whose rows reach take()
            if q >= cap:
                # terminal segment: nothing can admit, so the queue (and
                # level) are frozen — judge every remaining row now.
                # Scalar order: quota refuses BEFORE queue-full.
                for tt in np.unique(t_seg[cand]).tolist():
                    ts = self.tenant(int(tt))
                    rows = np.nonzero(cand & (t_seg == tt))[0]
                    rsn[rows] = (wire.R_QUOTA
                                 if ts.inflight >= scfg.tenant_quota
                                 else wire.R_QUEUE_FULL)
                    wt[rows] = floor
                cut = m
            else:
                thr = cap
                if level < 2:
                    thr = min(thr, rmark)
                if level < 1:
                    thr = min(thr, wmark)
                for tt in np.unique(t_seg[cand]).tolist():
                    ts = self.tenant(int(tt))
                    rows = np.nonzero(cand & (t_seg == tt))[0]
                    quota_room = max(0, scfg.tenant_quota - ts.inflight)
                    quota_rooms[int(tt)] = quota_room
                    tokens = peek(ts.bucket)
                    rate_room = int(tokens) if tokens >= 1.0 else 0
                    adm = min(quota_room, rate_room)
                    admit[rows[:adm]] = True
                    over = rows[adm:]
                    if over.size:
                        if quota_room <= rate_room:
                            rsn[over] = wire.R_QUOTA
                            wt[over] = floor
                        else:
                            rsn[over] = wire.R_RATE
                            left = tokens - float(rate_room)
                            wt[over] = max(floor,
                                           (1.0 - left) / ts.bucket.rate)
                # commit only the prefix whose judgments saw this queue:
                # cut at the first row whose admitted-prefix crosses thr
                pre = q + np.concatenate(([0], np.cumsum(admit)[:-1]))
                crossed = np.nonzero(pre >= thr)[0]
                cut = int(crossed[0]) if crossed.size else m
            adm_c = admit[:cut]
            rsn_c = rsn[:cut]
            cand_c = cand[:cut]
            for tt in np.unique(t_seg[:cut]).tolist():
                ts = self.tenant(int(tt))
                trows = t_seg[:cut] == tt
                if (cand_c & trows).any() and quota_rooms.get(int(tt), 0):
                    # at least one committed row of this tenant reached
                    # take(): the refill the judgment peeked becomes real
                    ts.bucket._refill(now)
                a = int((adm_c & trows).sum())
                if a:
                    # one exact float subtraction == a sequential takes
                    ts.bucket.tokens -= float(a)
                    ts.admitted += a
                    ts.inflight += a
                r = int((~adm_c & trows).sum())
                ts.retry_after += r
                ts.shed += int((((rsn_c == wire.R_SHED_WRITE)
                                 | (rsn_c == wire.R_SHED_READ))
                                & trows).sum())
            reasons[i: i + cut] = rsn_c
            waits[i: i + cut] = wt[:cut]
            q += int(adm_c.sum())
            i += cut
        return reasons, waits

    def note_admitted(self, tenant: int) -> None:
        ts = self.tenant(tenant)
        ts.admitted += 1
        ts.inflight += 1

    def note_resolved(self, tenant: int, status: int) -> None:
        ts = self.tenant(tenant)
        ts.inflight -= 1
        assert ts.inflight >= 0, "tenant inflight went negative"
        if status in (wire.S_OK, wire.S_RMW_ABORT):
            ts.completed += 1
        elif status == wire.S_DEADLINE:
            ts.deadline += 1
        elif status == wire.S_REJECTED:
            ts.rejected += 1
        elif status == wire.S_LOST:
            ts.lost += 1

    def note_resolved_batch(self, tenants: np.ndarray,
                            statuses: np.ndarray) -> None:
        """Column form of ``note_resolved``: one pass over a pump's
        resolutions, grouped by (tenant, status) — O(unique pairs), not
        O(rows)."""
        pairs = (np.asarray(tenants, np.int64) * 8
                 + np.asarray(statuses, np.int64))  # statuses are < 8
        uniq, cnt = np.unique(pairs, return_counts=True)
        for p, c in zip(uniq.tolist(), cnt.tolist()):
            t, st = p >> 3, p & 7
            ts = self.tenant(t)
            ts.inflight -= c
            assert ts.inflight >= 0, "tenant inflight went negative"
            if st in (wire.S_OK, wire.S_RMW_ABORT):
                ts.completed += c
            elif st == wire.S_DEADLINE:
                ts.deadline += c
            elif st == wire.S_REJECTED:
                ts.rejected += c
            elif st == wire.S_LOST:
                ts.lost += c

    def counters(self) -> dict:
        return {t: ts.counters() for t, ts in sorted(self.tenants.items())}
