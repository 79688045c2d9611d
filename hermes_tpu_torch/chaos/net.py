"""Transport-generic adversarial wire interposer: the port of
``hermes_tpu/chaos/net.py`` (host code over the codec, copied).

``FaultingTransport`` wraps any ``transport.base.HostTransport`` — the
deterministic sim, the zero-delay lockstep loopback, the socket mesh's
``transport.tcp.TcpHostTransport`` — and injects seeded, window-driven
faults per DIRECTED peer pair on the inbound path:

  * ``drop``       — the pair's frame this step never arrives
  * ``delay``      — the frame is held ``param`` steps, FIFO preserved
  * ``dup``        — an extra copy of the frame arrives 1-2 steps later
  * ``reorder``    — frames are held with hash-jittered due steps and
                     released in hash order (cross-step reordering)
  * ``corrupt``    — the frame is serialized (codec.pack), bytes are
                     flipped, and the frame CRC (codec.frame_pack /
                     frame_unpack) DETECTS the damage and downgrades it to
                     a drop — a corrupted frame is NEVER applied.  The red
                     path (``crc=False``) delivers the scrambled bytes
                     instead, proving what the checksum is for.
  * ``partition``  — a sustained directed blackout (all kinds); asymmetric
                     partitions are just windows on one direction.

Receive-side interposition is observationally equivalent to faulting the
wire itself and needs nothing from the inner transport beyond the
exchange calls, so it composes with the sim transport's own schedule,
with the lockstep loopback and, per rank, with a real socket mesh.

Every applied fault lands in ``fault_log`` in deterministic order: the
same seed, config and schedule replay a byte-identical executed fault
log (``fault_log_json``).

Heartbeat ``alive`` bits ride the INV blocks, so a partitioned edge
starves ``last_seen`` at the receiver and the failure detector sees a
partitioned-but-alive replica as stale: it is removed (and fences
itself), keeps its state, and on heal rejoins through the epoch-fenced
join.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from hermes_tpu_torch.transport import codec

# the wire-fault verbs, in match-priority order (partition dominates, dup
# composes with pass-through)
WIRE_OPS = ("partition", "drop", "corrupt", "delay", "reorder", "dup")


def _h(*args) -> int:
    """Deterministic 32-bit hash — the seeded adversary's only randomness
    source, so every decision replays bit-identically."""
    return int.from_bytes(
        hashlib.blake2b(repr(args).encode(), digest_size=4).digest(), "little")


@dataclasses.dataclass(frozen=True)
class WireWindow:
    """One active fault window on directed edges: ``src``/``dst`` of -1
    match any endpoint; the window is active for ``from_step <= step <
    until``; ``param`` is the op's knob (delay steps / reorder spread)."""

    op: str
    src: int
    dst: int
    from_step: int
    until: int
    param: int = 0

    def matches(self, src: int, dst: int, step: int) -> bool:
        return ((self.src < 0 or self.src == src)
                and (self.dst < 0 or self.dst == dst)
                and self.from_step <= step < self.until)


class FaultingTransport:
    """Adversarial interposer over any ``HostTransport`` (module docstring).

    ``inner``      — the wrapped transport (SimTransport,
                     LockstepHostTransport, TcpHostTransport, ...).
    ``local_rank`` — None for in-process transports (inbound blocks carry
                     leading ``(R_dst, R_src)`` axes); the owning rank for
                     per-process transports (inbound ``(R_src, ...)``,
                     dst implicit).
    ``crc``        — frame corrupted payloads through the codec CRC frame
                     (the default; corruption is detected and downgraded
                     to a drop).  False is the RED path: scrambled bytes
                     are delivered into the protocol — exists only so
                     tests can prove the checksum earns its keep.
    ``registry``   — optional obs MetricsRegistry: per-op fault counters
                     (``wire_drop``/``wire_corrupt_dropped``/...) so a
                     soak's metrics record how hostile the wire was.
    """

    def __init__(self, inner, n_replicas: int, seed: int = 0,
                 crc: bool = True, local_rank: Optional[int] = None,
                 registry=None):
        self.inner = inner
        self.r = n_replicas
        self.seed = seed
        self.crc = crc
        self.local_rank = local_rank
        self.registry = registry
        self.windows: List[WireWindow] = []
        # (kind, src, dst) -> list of (due_step, order_key, field dict)
        self._held: Dict[Tuple[str, int, int], List[tuple]] = (
            collections.defaultdict(list))
        self.fault_log: List[dict] = []
        self.counters: collections.Counter = collections.Counter()

    # -- window control ------------------------------------------------------

    def add(self, op: str, src: int, dst: int, from_step: int, until: int,
            param: int = 0) -> WireWindow:
        if op not in WIRE_OPS:
            raise ValueError(
                f"unknown wire fault {op!r} (want one of {', '.join(WIRE_OPS)})")
        w = WireWindow(op, src, dst, from_step, until, param)
        self.windows.append(w)
        return w

    def heal(self, step: int) -> int:
        """Clear every window (held frames still deliver: they are
        in-flight packets, not faults).  Returns the number cleared."""
        n = len(self.windows)
        self.windows.clear()
        if n:
            self._log(step, "heal", -1, -1, "*", cleared=n)
        return n

    def active_windows(self, step: int) -> List[dict]:
        """The live adversary spec at ``step`` — stuck-op diagnostics and
        soak triage read this instead of cross-referencing logs."""
        return [dataclasses.asdict(w) for w in self.windows
                if w.from_step <= step < w.until]

    def pending(self) -> int:
        held = sum(len(v) for v in self._held.values())
        inner_pending = getattr(self.inner, "pending", None)
        return held + (inner_pending() if inner_pending is not None else 0)

    # -- bookkeeping ---------------------------------------------------------

    def _log(self, step: int, op: str, src: int, dst: int, kind: str,
             **extra) -> None:
        self.fault_log.append(
            dict(step=step, op=op, src=src, dst=dst, kind=kind, **extra))
        self.counters[f"wire_{op}"] += 1
        if self.registry is not None:
            self.registry.counter(f"wire_{op}").inc()

    def fault_log_json(self) -> str:
        """Canonical executed fault log (the determinism witness: same
        seed + config + schedule => byte-identical)."""
        return json.dumps(self.fault_log, sort_keys=True,
                          separators=(",", ":"))

    def _match(self, op: str, src: int, dst: int, step: int
               ) -> Optional[WireWindow]:
        for w in self.windows:
            if w.op == op and w.matches(src, dst, step):
                return w
        return None

    # -- the interposition ---------------------------------------------------

    def _corrupt_frame(self, kind: str, src: int, dst: int, step: int,
                       fields: dict) -> Optional[dict]:
        """Serialize the pair's block, flip bytes, and run it through the
        frame checksum.  Returns the (scrambled) field dict if the frame
        survives delivery (crc=False red path), else None (detected ->
        dropped)."""
        tpl = tuple(fields.values())
        payload = codec.pack(tpl)
        frame = codec.frame_pack(payload)
        n = frame.nbytes
        flipped = frame.copy()
        for i in range(3):  # a short burst inside the payload region
            pos = codec.FRAME_OVERHEAD + (
                _h(self.seed, "pos", kind, src, dst, step, i)
                % max(1, n - codec.FRAME_OVERHEAD))
            flipped[pos] ^= 0x5A
        if self.crc:
            try:
                codec.frame_unpack(flipped)
            except codec.FrameCorrupt as e:
                self._log(step, "corrupt", src, dst, kind,
                          outcome="dropped_by_crc", detail=str(e)[:80])
                self.counters["wire_corrupt_dropped"] += 1
                return None
            raise AssertionError(
                "corrupted frame passed its checksum — flip did not land")
        # RED path: no checksum on the wire — the scrambled bytes ARE
        # delivered into the protocol (what CRC-less transports risk)
        scrambled = codec.unpack(
            tpl, flipped[codec.FRAME_OVERHEAD:])
        self._log(step, "corrupt", src, dst, kind, outcome="applied")
        self.counters["wire_corrupt_applied"] += 1
        return dict(zip(fields.keys(), scrambled))

    def _merge(self, blocks: List[dict]) -> Optional[dict]:
        """FIFO overlay merge of frames delivered together (the sim
        transport's latest-packet-wins rule, kind-generic): later valid
        lanes overlay earlier, ``alive`` ORs, ``valid`` unions."""
        merged = None
        for blk in blocks:
            if merged is None:
                merged = dict(blk)
                continue
            v = np.asarray(blk["valid"])
            for f, arr in blk.items():
                if f == "alive":
                    merged[f] = merged[f] | arr
                elif f == "valid":
                    continue
                elif np.asarray(arr).ndim > v.ndim:  # value words (L, V)
                    merged[f] = np.where(v[..., None], arr, merged[f])
                else:
                    merged[f] = np.where(v, arr, merged[f])
            merged["valid"] = merged["valid"] | v
        return merged

    def _fault_pair(self, kind: str, src: int, dst: int, step: int,
                    frame: Optional[dict]) -> Optional[dict]:
        """Apply the active windows to one directed pair's frame; returns
        the merged block to deliver this step (None = nothing arrives)."""
        chan = (kind, src, dst)
        if frame is not None and not (
                np.any(np.asarray(frame["valid"]))
                or np.any(np.asarray(frame.get("alive", False)))):
            # the inner transport delivered nothing for this pair (e.g. the
            # sim schedule dropped it): nothing to fault, nothing to log
            frame = None
        if frame is not None:
            # window priority: partition/drop kill, corrupt mangles,
            # delay/reorder hold; dup composes with whatever survives
            if (self._match("partition", src, dst, step) is not None
                    or self._match("drop", src, dst, step) is not None):
                op = ("partition"
                      if self._match("partition", src, dst, step) is not None
                      else "drop")
                self._log(step, op, src, dst, kind)
                frame = None
            elif self._match("corrupt", src, dst, step) is not None:
                frame = self._corrupt_frame(kind, src, dst, step, frame)
            else:
                w = self._match("delay", src, dst, step)
                if w is not None:
                    due = step + max(1, w.param)
                    # FIFO order key: the send step (delay preserves order)
                    self._held[chan].append((due, step, frame))
                    self._log(step, "delay", src, dst, kind, due=due)
                    frame = None
                else:
                    w = self._match("reorder", src, dst, step)
                    if w is not None:
                        due = step + 1 + (
                            _h(self.seed, "ro", kind, src, dst, step)
                            % max(1, w.param))
                        order = _h(self.seed, "ro2", kind, src, dst, step)
                        self._held[chan].append((due, order, frame))
                        self._log(step, "reorder", src, dst, kind, due=due)
                        frame = None
            if frame is not None and self._match("dup", src, dst, step) is not None:
                due = step + 1 + _h(self.seed, "dup", kind, src, dst, step) % 2
                self._held[chan].append((due, step, dict(frame)))
                self._log(step, "dup", src, dst, kind, due=due)
        # release everything due, in (due, order) order — reorder's hashed
        # order keys scramble delivery relative to send order.  A partition
        # is a SUSTAINED blackout of the edge: frames already in flight
        # (held by delay/reorder/dup) die in it too, they do not tunnel
        # through — without this, a held heartbeat released mid-blackout
        # would refresh the observer and delay detector ejection.
        q = self._held.get(chan)
        due_frames: List[dict] = []
        if q:
            q.sort(key=lambda e: (e[0], e[1]))
            while q and q[0][0] <= step:
                held = q.pop(0)[2]
                if self._match("partition", src, dst, step) is not None:
                    self._log(step, "partition", src, dst, kind,
                              held="dropped_in_blackout")
                    continue
                due_frames.append(held)
        if frame is not None:
            due_frames.append(frame)  # this step's frame arrives last
        if not due_frames:
            return None
        return self._merge(due_frames)

    def _interpose(self, kind: str, inb, step: int):
        """Fault every directed pair slice of the inbound block."""
        # lazily prune windows that can never match again (heal() is
        # otherwise the only pruner — a long run after a short schedule
        # must not keep scanning dead windows)
        if self.windows:
            self.windows = [w for w in self.windows if w.until > step]
        if not self.windows and not any(self._held.values()):
            return inb  # quiet wire: no copies, no per-pair work
        fields = {f: np.array(np.asarray(v))  # own copy: we mutate slices
                  for f, v in inb._asdict().items()}
        r = self.r
        if self.local_rank is None:
            pairs = [((dst, src), src, dst)
                     for dst in range(r) for src in range(r)]
        else:
            pairs = [((src,), src, self.local_rank) for src in range(r)]
        for idx, src, dst in pairs:
            if src == dst:
                continue  # loopback never traverses the faulty fabric
            # copy, not view: a held (delayed/reordered/dup'd) frame must
            # survive this pair's inbound slice being zeroed below
            frame = {f: np.array(v[idx]) for f, v in fields.items()}
            out = self._fault_pair(kind, src, dst, step, frame)
            if out is None:
                for f in fields:  # nothing arrived: zero block (valid=False)
                    fields[f][idx] = np.zeros_like(fields[f][idx])
            else:
                for f in fields:
                    fields[f][idx] = out[f]
        return inb._replace(**fields)

    # -- HostTransport surface ----------------------------------------------

    def exchange_inv(self, out_inv, step: int):
        return self._interpose("inv", self.inner.exchange_inv(out_inv, step),
                               step)

    def exchange_ack(self, out_ack, step: int):
        return self._interpose("ack", self.inner.exchange_ack(out_ack, step),
                               step)

    def exchange_val(self, out_val, step: int):
        return self._interpose("val", self.inner.exchange_val(out_val, step),
                               step)
