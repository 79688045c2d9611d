"""Deterministic adversarial simulation transport: the port of
``hermes_tpu/transport/sim.py`` (host numpy, copied).

A schedule-controlled network: per-(kind, src, dst, step) delay, drop and
duplication, so protocol races (delayed INVs, lost VALs, reordered
ACK/VAL, replica stalls) are explored deterministically and every run is
gated by the linearizability checker.

Each directed edge carries one FIFO channel a message kind.  A send
enqueues zero or more copies (drop = zero, dup = two) with delivery
steps; every block due by the current step is delivered, merged in FIFO
order (later valid lanes overlay earlier ones: lane l always carries the
same session's or slot's current record, the "latest packet wins" of a
real network).  Same-step delivery reproduces the lockstep schedule.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

# schedule(kind, src, dst, step) -> list of delivery steps for this send.
# [step] = lockstep; [] = drop; [step+3] = delay; [step, step+2] = duplicate.
Schedule = Callable[[str, int, int, int], Sequence[int]]


def lockstep_schedule(kind: str, src: int, dst: int, step: int) -> Sequence[int]:
    return [step]


class SimTransport:
    """Host-side adversarial network between vmapped protocol phases.

    ``registry`` (optional ``obs.MetricsRegistry``) makes the
    adversarial schedule itself observable: per-kind send / dropped /
    duplicated / delayed counters plus the in-flight queue gauge, so a chaos
    soak's metrics record says HOW hostile the network actually was, not
    just how the protocol fared under it."""

    def __init__(self, n_replicas: int, schedule: Schedule = lockstep_schedule,
                 registry=None):
        self.r = n_replicas
        self.schedule = schedule
        self.registry = registry
        # (kind, src, dst) -> deque of (deliver_step, block-dict of numpy arrays)
        self.chan: Dict[Tuple[str, int, int], collections.deque] = collections.defaultdict(
            collections.deque
        )

    # -- helpers -----------------------------------------------------------

    def _send(self, kind: str, src: int, dst: int, step: int, block: dict) -> None:
        whens = list(self.schedule(kind, src, dst, step))
        reg = self.registry
        if reg is not None:
            reg.counter(f"net_{kind}_sends").inc()
            if not whens:
                reg.counter(f"net_{kind}_dropped").inc()
            elif len(whens) > 1:
                reg.counter(f"net_{kind}_duplicated").inc(len(whens) - 1)
            late = sum(1 for w in whens if w > step)
            if late:
                reg.counter(f"net_{kind}_delayed").inc(late)
        for when in whens:
            assert when >= step, "cannot deliver into the past"
            self.chan[(kind, src, dst)].append((when, block))

    def _recv(self, kind: str, src: int, dst: int, step: int):
        """Pop and merge every block due by ``step`` (FIFO; later valid lanes
        overlay earlier)."""
        q = self.chan[(kind, src, dst)]
        merged = None
        delivered = 0
        while q and q[0][0] <= step:
            blk = q.popleft()[1]
            delivered += 1
            if merged is None:
                merged = dict(blk)
                continue
            v = blk["valid"]
            for f, arr in blk.items():
                if f == "alive":
                    merged[f] = merged[f] | arr
                elif f == "valid":
                    continue
                elif arr.ndim > v.ndim:  # value words (L, V)
                    merged[f] = np.where(v[..., None], arr, merged[f])
                else:
                    merged[f] = np.where(v, arr, merged[f])
            merged["valid"] = merged["valid"] | v
        if delivered and self.registry is not None:
            self.registry.counter(f"net_{kind}_delivered").inc(delivered)
        return merged

    def _exchange_bcast(self, kind: str, out, step: int):
        """INV/VAL: outbound (R_src, L, ...) broadcast to every dst; inbound
        (R_dst, R_src, L, ...)."""
        fields = {f: np.asarray(v) for f, v in out._asdict().items()}
        r = self.r
        for src in range(r):
            block = {f: v[src] for f, v in fields.items()}
            for dst in range(r):
                self._send(kind, src, dst, step, block)
        inb = {
            f: np.zeros((r,) + v.shape, v.dtype) for f, v in fields.items()
        }
        for dst in range(r):
            for src in range(r):
                got = self._recv(kind, src, dst, step)
                if got is None:
                    continue
                for f in inb:
                    inb[f][dst, src] = got[f]
        return out._replace(**inb)

    def exchange_inv(self, out_inv, step: int):
        return self._exchange_bcast("inv", out_inv, step)

    def exchange_val(self, out_val, step: int):
        return self._exchange_bcast("val", out_val, step)

    def exchange_ack(self, out_ack, step: int):
        """ACK: outbound (R_src, R_dst, L, ...): row p of source q answers
        the INVs q received from p.  Inbound (R_dst, R_src, L, ...)."""
        fields = {f: np.asarray(v) for f, v in out_ack._asdict().items()}
        r = self.r
        for src in range(r):
            for dst in range(r):
                block = {f: v[src, dst] for f, v in fields.items()}
                self._send("ack", src, dst, step, block)
        inb = {
            f: np.zeros((r, r) + v.shape[2:], v.dtype) for f, v in fields.items()
        }
        for dst in range(r):
            for src in range(r):
                got = self._recv("ack", src, dst, step)
                if got is None:
                    continue
                for f in inb:
                    inb[f][dst, src] = got[f]
        return out_ack._replace(**inb)

    def pending(self) -> int:
        n = sum(len(q) for q in self.chan.values())
        if self.registry is not None:
            self.registry.gauge("net_pending_blocks").set(n)
        return n
