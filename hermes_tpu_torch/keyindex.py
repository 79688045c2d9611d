"""Sparse 64-bit client keys -> dense table slots: the port's copy of
``hermes_tpu/keyindex.py`` (``KeyspaceFull``, ``_splitmix64``,
``KeyIndex``, ``RangeRouter``).

Host code, numpy only: the index lives on the host because the client
path injects ops into the device stream there, which is exactly where a
sparse key must become a slot.  Open addressing with linear probing over
a power-of-two bucket array (capacity >= 2x n_keys), splitmix64 hash.
The index is EXACT: keys are never deleted, a lookup stops at the first
empty bucket, and inserting more than ``n_keys`` distinct keys raises
``KeyspaceFull`` (atomically for a bulk batch).  ``tests/
test_torch_keyindex.py`` holds it slot for slot against the reference.
"""

from __future__ import annotations

import numpy as np


_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)  # reserved bucket sentinel


class KeyspaceFull(RuntimeError):
    """More distinct keys inserted than the dense table has slots."""


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the 64-bit analog of the stream hash's
    avalanche; vectorized over uint64 arrays (wraparound intended)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class KeyIndex:
    """Exact sparse->dense key index (open addressing, linear probing).

    ``get_slots(keys, insert=...)`` is numpy-vectorized end to end: lookups
    run as probe *rounds* over the still-unresolved elements (each round is
    one gather + compares over the whole pending set), and inserts place all
    new keys via first-wins claim rounds — so bulk-loading ~1M keys takes
    seconds, not minutes, and sparse-key mode can back stream-scale runs
    (round-2 verdict item 5).  Slots are allocated densely in
    first-occurrence order (0, 1, 2, ...), so the device table never sees a
    hole and batch semantics match one-at-a-time insertion.

    Bulk-insert atomicity: if a batch would exceed ``n_keys`` distinct keys,
    ``KeyspaceFull`` is raised *before* any mutation (no partial insert) —
    stricter than one-at-a-time calls, which insert up to the budget first.
    """

    def __init__(self, n_keys: int):
        self.n_keys = n_keys
        cap = 1
        while cap < 2 * n_keys:
            cap *= 2
        self._cap = cap
        self._mask = np.uint64(cap - 1)
        self._bucket_key = np.full(cap, _EMPTY, np.uint64)
        self._bucket_slot = np.zeros(cap, np.int32)
        self._rev = np.zeros(n_keys, np.uint64)  # slot -> client key
        self.n_used = 0

    # -- vectorized probe ---------------------------------------------------

    def _lookup(self, flat: np.ndarray):
        """Vectorized lookup of ``flat`` (1-D uint64): returns (slots int32
        with -1 for absent, absent_idx int64 positions into ``flat``).
        Probe rounds: each iteration gathers the current bucket of every
        still-pending element and resolves hits (key match) and misses
        (empty bucket); the rest advance one bucket.  Buckets never empty
        out (no delete), so a miss is definitive."""
        out = np.full(flat.shape[0], -1, np.int32)
        idx = np.arange(flat.shape[0], dtype=np.int64)
        pos = (_splitmix64(flat) & self._mask).astype(np.int64)
        absent = []
        while idx.size:
            k = self._bucket_key[pos]
            hit = k == flat[idx]
            empty = k == _EMPTY
            if hit.any():
                out[idx[hit]] = self._bucket_slot[pos[hit]]
            if empty.any():
                absent.append(idx[empty])
            cont = ~(hit | empty)
            idx = idx[cont]
            pos = (pos[cont] + 1) & np.int64(self._mask)
        absent_idx = (np.concatenate(absent) if absent
                      else np.empty(0, np.int64))
        return out, absent_idx

    def _insert_new(self, new_keys: np.ndarray, new_slots: np.ndarray):
        """Place distinct absent ``new_keys`` (pre-assigned ``new_slots``)
        into buckets via first-wins claim rounds.  A key claims the first
        empty bucket on its probe path; when several keys target the same
        empty bucket in one round, the lowest-indexed wins and the rest
        advance.  Every bucket a key passes was occupied when passed (wins
        happen before losers advance), so the linear-probing reachability
        invariant — no empty gap between a key's home and its bucket —
        holds exactly as it does for sequential insertion."""
        pend = np.arange(new_keys.shape[0], dtype=np.int64)
        pos = (_splitmix64(new_keys) & self._mask).astype(np.int64)
        while pend.size:
            empty = self._bucket_key[pos] == _EMPTY
            claimed = np.zeros(pend.size, bool)
            if empty.any():
                cand = np.flatnonzero(empty)
                _, first = np.unique(pos[cand], return_index=True)
                w = cand[first]  # first-wins per target bucket
                self._bucket_key[pos[w]] = new_keys[pend[w]]
                self._bucket_slot[pos[w]] = new_slots[pend[w]]
                claimed[w] = True
            cont = ~claimed
            pend = pend[cont]
            pos = (pos[cont] + 1) & np.int64(self._mask)

    # -- public API ---------------------------------------------------------

    def get_slots(self, keys, insert: bool = True) -> np.ndarray:
        """Dense slots for a batch of 64-bit client keys (int32 array,
        -1 marks absent keys when ``insert=False``)."""
        shape = np.shape(keys)
        flat = np.atleast_1d(np.asarray(keys, np.uint64)).ravel()
        if flat.size and (flat == _EMPTY).any():
            raise ValueError("key 0xFFFF...FF is reserved")
        out, absent_idx = self._lookup(flat)
        if insert and absent_idx.size:
            ak = flat[absent_idx]
            uk, inv = np.unique(ak, return_inverse=True)
            # first-occurrence order in the batch defines slot order (the
            # same slots one-at-a-time insertion would hand out)
            first_pos = np.full(uk.shape[0], flat.shape[0], np.int64)
            np.minimum.at(first_pos, inv, absent_idx)
            order = np.argsort(first_pos, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(order.shape[0])
            if self.n_used + uk.shape[0] > self.n_keys:
                raise KeyspaceFull(
                    f"{self.n_used} distinct keys present + "
                    f"{uk.shape[0]} new in batch; dense table holds "
                    f"n_keys={self.n_keys} — size n_keys to the working "
                    f"set (the index is exact, not lossy; nothing from "
                    f"this batch was inserted)"
                )
            uslots = (self.n_used + rank).astype(np.int32)
            self._rev[uslots] = uk
            self._insert_new(uk, uslots)
            self.n_used += int(uk.shape[0])
            out[absent_idx] = uslots[inv]
        return out.reshape(shape) if shape else out[0]

    def slot(self, key: int, insert: bool = True) -> int:
        return int(self.get_slots(np.uint64(key), insert=insert))

    def key_of(self, slot: int) -> int:
        """Client key stored at a dense slot (inverse mapping)."""
        if not (0 <= slot < self.n_used):
            raise KeyError(f"slot {slot} unallocated")
        return int(self._rev[slot])

    def __len__(self) -> int:
        return self.n_used

    def __contains__(self, key: int) -> bool:
        return self.slot(key, insert=False) >= 0


class RangeRouter:
    """Key-range -> group routing table with an atomic flip (the elastic
    range migration, ``elastic/migrate.py``).

    Routes the dense slot space ``[0, n_keys)`` to group ids.  A live
    key-range migration drives it through three states per range:

      1. ``begin_drain(lo, hi)`` — the range still belongs to its owner but
         accepts no NEW ops (the owning KVS rejects them loudly,
         kind='rejected'); in-flight ops drain;
      2. ``flip(lo, hi, new_group)`` — ownership moves and the drain clears
         in ONE host-side state update, so no lookup can ever observe the
         half-flipped state (new owner while still draining, or old owner
         already released);
      3. (abort path) ``release(lo, hi)`` — clear the drain without moving
         ownership.

    Lookups are exact at range boundaries by construction: ``owner``/
    ``draining`` index a dense per-slot array, so ``lo`` is in the range
    and ``hi`` is not — there is no interval arithmetic to get off by one.
    """

    def __init__(self, n_keys: int, default_group: int = 0):
        self.n_keys = n_keys
        self._owner = np.full(n_keys, default_group, np.int32)
        self._drain = np.zeros(n_keys, bool)

    def _check_range(self, lo: int, hi: int) -> None:
        if not (0 <= lo < hi <= self.n_keys):
            raise ValueError(
                f"range [{lo}, {hi}) outside the slot space "
                f"[0, {self.n_keys})")

    # -- lookups (vectorized; scalars accepted) -----------------------------

    def owner(self, slot) -> np.ndarray:
        """Group id owning each slot (int32, shape of ``slot``)."""
        return self._owner[np.asarray(slot)]

    def draining(self, slot) -> np.ndarray:
        """True where a migration has fenced the slot (reject-new)."""
        return self._drain[np.asarray(slot)]

    def routable(self, slot, group: int) -> np.ndarray:
        """True where ``group`` may accept a new op for the slot: it owns
        the slot AND no drain is in progress."""
        s = np.asarray(slot)
        return (self._owner[s] == group) & ~self._drain[s]

    def owned_ranges(self):
        """The routing table as maximal contiguous ``(lo, hi, group)``
        runs — the human/report form of the dense per-slot array (fleet
        summaries, boundary tests).  Exact by construction: derived from
        the same array lookups consult."""
        out = []
        if self.n_keys == 0:
            return out
        edges = np.flatnonzero(np.diff(self._owner)) + 1
        lo = 0
        for hi in list(edges) + [self.n_keys]:
            out.append((int(lo), int(hi), int(self._owner[lo])))
            lo = hi
        return out

    # -- migration state machine --------------------------------------------

    def assign(self, lo: int, hi: int, group: int) -> None:
        """Initial ownership assignment (fleet construction): like
        ``flip`` but refuses to touch a draining slot — assignment is a
        build-time act, never a way around an in-flight migration."""
        self._check_range(lo, hi)
        if self._drain[lo:hi].any():
            raise RuntimeError(
                f"assign [{lo}, {hi}) overlaps a draining range; finish "
                "or release the migration first")
        self._owner[lo:hi] = group

    def begin_drain(self, lo: int, hi: int) -> None:
        self._check_range(lo, hi)
        self._drain[lo:hi] = True

    def flip(self, lo: int, hi: int, new_group: int) -> None:
        """Atomic cutover: ownership and drain state change in one host
        update — the migration's linearization point for routing."""
        self._check_range(lo, hi)
        self._owner[lo:hi] = new_group
        self._drain[lo:hi] = False

    def release(self, lo: int, hi: int) -> None:
        """Abort a drain: the range stays with its current owner."""
        self._check_range(lo, hi)
        self._drain[lo:hi] = False
