"""Declared bit layouts of every hand-packed word in the fast engine.

A copy of ``hermes_tpu/core/layouts.py``: the port keeps its own table so
that it imports nothing of the JAX package, and the tests hold the two
tables equal field by field.  The engine (``core/faststep.py``), the config
validation and the ``stats_block`` kernel derive every shift and mask from
these declarations.  ``audited``/``unaudited`` are the reference's audit
scopes: they mark the ops an analysis trace records inside them
(``hermes_tpu_torch/analysis/graph.py``) and do nothing outside one.

Every layout targets a 32-bit word.  ``word_bits=31`` means the sign bit
must stay clear (the word is compared or max-scattered as a SIGNED int32 —
e.g. the packed timestamp, whose integer compare must equal the
lexicographic (ver, fc) compare); ``word_bits=32`` marks unsigned words
that may use all 32 bits.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple


class Field(NamedTuple):
    """One bitfield: ``bits`` wide starting at ``shift``."""

    name: str
    shift: int
    bits: int

    @property
    def mask(self) -> int:
        """Word mask selecting this field's bits."""
        return ((1 << self.bits) - 1) << self.shift

    @property
    def cap(self) -> int:
        """Exclusive upper bound on the field's (unshifted) value."""
        return 1 << self.bits


class Layout(NamedTuple):
    """A packed word: named disjoint fields in a 31/32-bit budget."""

    name: str
    doc: str
    fields: Tuple[Field, ...]
    word_bits: int = 31  # 31 = signed int32, sign bit must stay clear

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"layout {self.name!r} has no field {name!r}")

    def validate(self) -> None:
        used = 0
        for f in self.fields:
            if f.shift < 0 or f.bits <= 0:
                raise ValueError(f"{self.name}.{f.name}: bad shift/bits")
            if f.shift + f.bits > self.word_bits:
                raise ValueError(
                    f"{self.name}.{f.name}: bits [{f.shift}, "
                    f"{f.shift + f.bits}) exceed the {self.word_bits}-bit "
                    f"word budget")
            if used & f.mask:
                raise ValueError(f"{self.name}.{f.name}: overlaps a "
                                 f"previously declared field")
            used |= f.mask


#: Packed Lamport timestamp: integer compare == lexicographic (ver, flag,
#: cid) compare, which turns per-key conflict resolution into one
#: scatter-max.  The ver field spans 21 bits but the enforced version
#: budget is 2^20 (config.max_key_versions): one spare bit of headroom.
PTS = Layout("pts", "packed Lamport timestamp (ver | flag | cid)", (
    Field("cid", 0, 8),     # replica id (tie-break; n_replicas <= 31)
    Field("flag", 8, 2),    # write-kind flag (types.FLAG_WRITE beats RMW)
    Field("ver", 10, 21),   # key version; budget 2^20 (one headroom bit)
))

#: Packed per-key state+age word: the state machine word and the replay-age
#: step stamp travel in one scatter (2^28 rounds before the age compare
#: would wrap).
SST = Layout("sst", "packed key state + last-change step", (
    Field("state", 0, 3),   # types.VALID..REPLAY (5 states)
    Field("step", 3, 28),   # last-change step (replay age origin)
))

#: INV wire-header word (FastInv.pkf): key + fresh/valid bits in one word.
INV_PKF = Layout("inv_pkf", "INV header (valid | fresh | key)", (
    Field("key", 0, 29),    # bounds n_keys (config validation)
    Field("fresh", 29, 1),  # first broadcast of this ts (unique (key, ts))
    Field("valid", 30, 1),  # slot holds a live INV
))

#: ACK wire-header word: the echoed key plus the conflict verdict and
#: validity bits (the sharded engine's wire; declared for parity).
ACK_PKF = Layout("ack_pkf", "ACK header (key | ok | valid)", (
    Field("valid", 0, 1),   # acker saw a live INV in this slot
    Field("ok", 1, 1),      # conflict flag (False = the RMW nack)
    Field("key", 2, 29),    # echoed key (same capacity as inv_pkf.key)
))

#: Fused arbiter+compaction sort key (faststep._coordinate): band 0 =
#: waiting/replay (sub = rotation index over lanes), band 1 = fresh issue
#: runs (sub = per-round ROTATED key), band 2 = ineligible.
FUSED_KEY = Layout("fused_key", "fused lane-sort key (band | sub)", (
    Field("sub", 0, 29),    # rotated key (band 1) / rotation index (band 0)
    Field("band", 29, 2),   # 0 waiting/replay, 1 fresh runs, 2 ineligible
))

#: Per-lane verdict word routed back through the fused sort's one
#: permutation scatter: chain rank + issue/taken bits (bits 16-19 spare).
LANE_WORD = Layout("lane_word", "fused-path per-lane verdict", (
    Field("chain_rank", 0, 16),  # rank within an equal-key run (chaining)
    Field("issue", 20, 1),       # won arbitration this round
    Field("taken", 21, 1),       # holds a compaction slot this round
))

#: Split sort-arbiter win word: same chain-rank field, win bit at the same
#: position as lane_word.issue.
ARB_WORD = Layout("arb_word", "split sort-arbiter win verdict", (
    Field("chain_rank", 0, 16),
    Field("win", 20, 1),
))

#: Sharded slot->lane ack routing word (uint32): declared for parity.
SLOT_ACK = Layout("slot_ack", "sharded per-slot ack word (uint32)", (
    Field("nacked", 0, 1),
    Field("gained", 1, 31),  # replica bitmap of acks gained this round
), word_bits=32)

#: Per-block wire scalars (FastInv.meta): epoch + alive in one word.
BLOCK_META = Layout("block_meta", "INV block scalars (epoch | alive)", (
    Field("alive", 0, 1),
    Field("epoch", 1, 30),
))

#: Value-heap extent reference word (``heap/core.py``; the config
#: validation of max_value_bytes/heap_bytes reads its budgets).
HEAP_REF = Layout("heap_ref", "value-heap extent ref (gran | len)", (
    Field("len", 0, 12),    # extent byte length; bounds max_value_bytes
    Field("gran", 12, 19),  # granule index; bounds heap_bytes/HEAP_GRANULE
))

#: Value-heap allocation granule (bytes).
HEAP_GRANULE = 16


class RowTable(NamedTuple):
    """A packed row layout: named rows inside a fixed-width minor axis
    (the stats kernel's ``(R, width)`` counter block)."""

    name: str
    doc: str
    rows: Tuple[str, ...]
    width: int

    def row(self, name: str) -> int:
        try:
            return self.rows.index(name)
        except ValueError:
            raise KeyError(f"row table {self.name!r} has no row {name!r}")

    def validate(self) -> None:
        if len(set(self.rows)) != len(self.rows):
            raise ValueError(f"{self.name}: duplicate row names")
        if len(self.rows) > self.width:
            raise ValueError(
                f"{self.name}: {len(self.rows)} rows exceed the declared "
                f"width {self.width}")


#: Counter rows of the stats_block kernel's packed (R, width) output; rows
#: beyond the declared ones are zero padding.
STATS_CTR = RowTable("stats_ctr", "stats_block packed counter rows", (
    "read", "write", "rmw", "abort", "lat_sum", "lat_cnt",
), width=8)

ALL = (PTS, SST, INV_PKF, ACK_PKF, FUSED_KEY, LANE_WORD, ARB_WORD,
       SLOT_ACK, BLOCK_META, HEAP_REF)
for _l in ALL:
    _l.validate()
STATS_CTR.validate()

# cross-layout consistency: the ACK echoes the INV's key verbatim
assert ACK_PKF.field("key").bits == INV_PKF.field("key").bits

# --------------------------------------------------------------------------
# Derived budgets (the constants the runtime + config consume)
# --------------------------------------------------------------------------

#: fc = (flag << 8) | cid — the low-word of the packed ts.
PTS_FC_BITS = PTS.field("ver").shift
FC_MASK = PTS.field("flag").mask | PTS.field("cid").mask
assert FC_MASK == (1 << PTS_FC_BITS) - 1

#: Enforced version budget: one headroom bit under the declared ver field.
MAX_KEY_VERSIONS = 1 << (PTS.field("ver").bits - 1)

MAX_STEPS = SST.field("step").cap

MAX_VALUE_BYTES = HEAP_REF.field("len").cap - 1
MAX_HEAP_BYTES = HEAP_GRANULE * HEAP_REF.field("gran").cap

#: Anti-starvation rotation stride and the domain bound that keeps
#: ``(step % n) * ROT_STRIDE + n`` inside int32.
ROT_STRIDE = 127
ROT_CAP = (1 << 31) // (ROT_STRIDE + 1)


# --------------------------------------------------------------------------
# Audit annotations (consumed by hermes_tpu_torch/analysis)
# --------------------------------------------------------------------------

AUDIT_PREFIX = "hermes_audit"

#: the open audit scopes' tags, innermost last, while an analysis trace
#: records (``analysis/graph.py`` sets a list); None outside a trace
_AUDITS: Optional[List[str]] = None
_NO_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def _scope(tag: str):
    _AUDITS.append(tag)
    try:
        yield
    finally:
        _AUDITS.pop()


def audited(tag: str):
    """Audit annotation: marks the ops made inside the scope as REVIEWED
    exceptions to a static-analysis rule, with ``tag`` naming the
    invariant that justifies them (e.g. a set-scatter whose duplicate
    indices provably write identical rows).  While an analysis trace
    records, every graph node made in the scope carries the tag, and the
    analysis downgrades its findings there to ``info`` with the tag in the
    record, so every suppression stays visible.  Outside a trace the scope
    does nothing and makes no op."""
    if not tag or any(c in tag for c in "[]"):
        raise ValueError("audit tag must be a non-empty string without "
                         "square brackets")
    if _AUDITS is None:
        return _NO_SCOPE
    return _scope(tag)


def current_audit() -> Optional[str]:
    """The innermost open audit tag of the trace in progress, if any."""
    return _AUDITS[-1] if _AUDITS else None


@contextlib.contextmanager
def unaudited():
    """Test hook: a no-op scope with the same surface as ``audited()``;
    monkeypatching ``audited`` to this must make the analysis flag the
    previously audited sites (the mutation test of the audits)."""
    yield
