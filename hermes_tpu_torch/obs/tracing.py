"""Per-op tracing: a copy of ``hermes_tpu/obs/tracing.py``.

Sampled tracing where the sampling decision and the trace id are SEEDED
HASHES of a monotone submit sequence (pure host integers, no RNG state,
no clock), so a seeded run traces the same ops with the same ids on
every replay and in either package.  A trace id is a nonzero u16 (0 =
not sampled), minted at ``kvs.KVS`` submit and carried on the future
through injection and resolution; it never reaches the device.

Span records ride the ordinary obs JSONL stream (kind ``span_end``):

  * ``op_queue``  — KVS submit -> slot injection (client-queue wait);
  * ``op_rounds`` — injection round -> resolution round (device rounds);
  * ``fe_queue`` / ``fe_resolve`` — the serving front end's spans (its
    port is ROADMAP A13; the names stay so the report reads both).

Round indices ride ``r0``/``r1``.  ``canonical_span_bytes`` is the
replay-gate projection: the span stream minus its wall-clock fields,
serialized canonically, so two runs of one seeded workload, in either
package, compare byte for byte.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

import numpy as np

#: Wire-field capacity: a trace id is a nonzero u16 (wire._REQ's second
#: pad).  0 = not sampled, so ids live in [1, TRACE_ID_MAX].
TRACE_ID_MAX = 0xFFFF

#: Span names of the per-op critical path, in causal order (the report's
#: breakdown iterates this).
OP_SPANS = ("fe_queue", "op_queue", "op_rounds", "fe_resolve")

_MIX = 0x9E3779B97F4A7C15  # splitmix64 increment (golden-ratio odd)


def _splitmix64(x: int) -> int:
    """One splitmix64 scramble round — a well-mixed 64-bit hash of a
    counter, in pure ints (deterministic across platforms/replays)."""
    x = (x + _MIX) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class TraceSampler:
    """Seeded deterministic 1-in-``rate`` sampler.

    ``sample(seq)`` maps a monotone per-submitter sequence number to a
    trace id: 0 (not sampled) for all but ~1/rate of the sequence, a
    nonzero u16 otherwise.  The decision is ``hash(seed, seq) % rate ==
    0`` — a pure function, so the SAME ops are sampled on every replay
    of a seeded run, which is what makes the span log gateable
    byte-for-byte.  ``rate=1`` traces everything; constructing with
    ``rate <= 0`` is refused (0 means "tracing off" and belongs to the
    caller's config, not to a sampler)."""

    def __init__(self, rate: int, seed: int = 0):
        if rate <= 0:
            raise ValueError("sample rate must be >= 1 (one in N ops)")
        self.rate = int(rate)
        self.seed = int(seed)

    def sample(self, seq: int) -> int:
        """Trace id for submit-sequence ``seq``: 0 = not sampled."""
        h = _splitmix64((self.seed * 0x5851F42D4C957F2D + seq)
                        & 0xFFFFFFFFFFFFFFFF)
        if h % self.rate:
            return 0
        # fold the top bits into a nonzero u16 id; collisions across a
        # long run are harmless (spans also carry lane/key identity)
        return (h >> 40) % TRACE_ID_MAX + 1

    def sample_array(self, seqs) -> np.ndarray:
        """Vectorized ``sample`` over a submit-sequence column: one
        splitmix64 pass in uint64 numpy arithmetic, bit-exact with the
        scalar path row for row (tests/test_shm_ipc.py proves it) — the
        columnar front-end's trace mint no longer loops Python per
        unsampled row (round-21)."""
        m64 = np.uint64(0xFFFFFFFFFFFFFFFF)
        with np.errstate(over="ignore"):
            x = (np.uint64((self.seed * 0x5851F42D4C957F2D)
                           & 0xFFFFFFFFFFFFFFFF)
                 + np.asarray(seqs, np.uint64))
            x = x + np.uint64(_MIX)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h = (x ^ (x >> np.uint64(31))) & m64
            ids = (h >> np.uint64(40)) % np.uint64(TRACE_ID_MAX) \
                + np.uint64(1)
        return np.where(h % np.uint64(self.rate), 0,
                        ids).astype(np.uint16)


class OpTracer:
    """Span writer for the per-op phases: one ``span_end`` record per
    closed phase, through the run's ordinary exporter (one shared clock,
    one merged timeline).  All methods are cheap host dict writes and
    are only reached for SAMPLED ops — unsampled ops never touch this
    object, and callers keep their own ``obs is None`` fast path."""

    def __init__(self, obs):
        self.obs = obs

    def span(self, name: str, trace: int, r0: int, r1: int,
             dur_s: Optional[float] = None, **tags) -> None:
        rec = {"name": name, "trace": int(trace),
               "dur_s": round(dur_s, 6) if dur_s is not None else None,
               "r0": int(r0), "r1": int(r1), **tags}
        if rec["dur_s"] is None:
            del rec["dur_s"]
        self.obs.exporter.write(rec, kind="span_end")


# -- replay-gate projection ---------------------------------------------------

#: Fields a span record may legitimately vary in between replays: the
#: shared-clock stamp and the measured wall duration.  Everything else
#: is identity and must replay byte-identically.
WALL_FIELDS = ("t", "dur_s")


def canonical_span_bytes(records: Iterable[dict],
                         names: Iterable[str] = OP_SPANS) -> bytes:
    """The determinism witness of a traced run: the op-span stream with
    wall-clock fields stripped, canonically serialized (sorted keys, one
    JSON object per line).  Same seed + same workload => byte-identical,
    on either engine — the property tests/test_tracing.py gates."""
    want = frozenset(names)
    out: List[str] = []
    for r in records:
        if r.get("kind") == "span_end" and r.get("name") in want:
            out.append(json.dumps(
                {k: v for k, v in r.items() if k not in WALL_FIELDS},
                sort_keys=True))
    return ("\n".join(out) + "\n").encode() if out else b""
