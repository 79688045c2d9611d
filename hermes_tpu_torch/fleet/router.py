"""Fleet-level key routing, the port of ``hermes_tpu/fleet/router.py``
(host numpy, copied).

The fleet keyspace ``[0, total_keys)`` is partitioned across G groups;
``FleetRouter`` answers, per fleet key, *which group serves it* and *which
dense slot it occupies there* — the two lookups every routed session and
every batched fan-out needs.  It composes two dense per-slot arrays:

  * ownership + drain state ride ``keyindex.RangeRouter`` unchanged — the
    migration state machine (begin_drain → flip | release) with
    its boundary-exact semantics (``lo`` in, ``hi`` out, no interval
    arithmetic to get off by one) and its one-host-update atomic flip;
  * ``_local`` maps each fleet key to its dense slot in the owning group.
    At construction that is the affine ``k - lo_g``; a cross-group
    migration replaces the migrated keys' entries with the destination
    slots the transfer actually allocated (``Fleet.migrate`` threads the
    ``migrate_range`` summary through ``flip(..., dest_slots=...)``), so
    the map stays exact across arbitrary move histories.

The (owner, local) pair must stay INJECTIVE — two fleet keys aliasing one
(group, slot) would merge their histories and corrupt both keys' witness
order.  ``check_injective`` proves it from the live arrays; the fleet
verification harness (fleet.core.verify_fleet) runs it after every drill.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from hermes_tpu_torch.keyindex import RangeRouter


class FleetRouter:
    """Fleet key -> (owning group, local dense slot), with the migration
    drain/flip state machine of ``keyindex.RangeRouter`` underneath."""

    def __init__(self, total_keys: int,
                 ranges: Sequence[Tuple[int, int]] = ()):
        self.total_keys = total_keys
        self.rr = RangeRouter(total_keys, default_group=0)
        self._local = np.zeros(total_keys, np.int32)
        for g, (lo, hi) in enumerate(ranges):
            self.rr.assign(lo, hi, g)
            self._local[lo:hi] = np.arange(hi - lo, dtype=np.int32)

    @classmethod
    def from_config(cls, fcfg) -> "FleetRouter":
        return cls(fcfg.total_keys,
                   [fcfg.group_range(g) for g in range(fcfg.groups)])

    # -- lookups (vectorized; scalars accepted) -----------------------------

    def _check(self, keys: np.ndarray) -> None:
        if keys.size and not ((keys >= 0) & (keys < self.total_keys)).all():
            bad = keys[(keys < 0) | (keys >= self.total_keys)]
            raise ValueError(
                f"fleet key(s) {bad[:4].tolist()} outside "
                f"[0, {self.total_keys})")

    def locate(self, keys):
        """(group ids, local dense slots) for fleet keys (shape of
        ``keys``; scalars in, scalars out)."""
        shape = np.shape(keys)
        k = np.atleast_1d(np.asarray(keys, np.int64))
        self._check(k)
        g, s = self.rr.owner(k), self._local[k]
        if shape:
            return g, s
        return int(g[0]), int(s[0])

    def owner(self, keys):
        shape = np.shape(keys)
        k = np.atleast_1d(np.asarray(keys, np.int64))
        self._check(k)
        g = self.rr.owner(k)
        return g if shape else int(g[0])

    def draining(self, keys):
        shape = np.shape(keys)
        k = np.atleast_1d(np.asarray(keys, np.int64))
        self._check(k)
        d = self.rr.draining(k)
        return d if shape else bool(d[0])

    def owned_ranges(self):
        return self.rr.owned_ranges()

    def check_injective(self) -> None:
        """Prove no two fleet keys alias one (group, slot) — the routing
        half of the fleet witness-aliasing invariant (module docstring).
        Raises with the first aliased pair."""
        pair = (self.rr._owner.astype(np.int64) * (2 ** 32)
                + self._local.astype(np.int64))
        uniq, first, counts = np.unique(pair, return_index=True,
                                        return_counts=True)
        dup = counts > 1
        if dup.any():
            w = int(uniq[dup][0])
            ks = np.flatnonzero(pair == w)[:2]
            raise AssertionError(
                f"fleet keys {ks.tolist()} alias (group {w >> 32}, "
                f"slot {w & 0xFFFFFFFF}): their histories would merge")

    # -- migration state machine (fleet coordinates) ------------------------

    def begin_drain(self, lo: int, hi: int) -> None:
        self.rr.begin_drain(lo, hi)

    def release(self, lo: int, hi: int) -> None:
        self.rr.release(lo, hi)

    def flip(self, lo: int, hi: int, new_group: int,
             dest_slots: Optional[np.ndarray] = None) -> None:
        """Atomic cutover: ownership, drain state, AND the local-slot map
        change in one host-side update (``dest_slots[i]`` is the
        destination slot of fleet key ``lo + i`` — the transfer's actual
        allocation; required, because the affine guess would alias the
        destination's own range)."""
        if dest_slots is None:
            raise ValueError(
                "flip needs the transfer's dest_slots: the destination "
                "chose the slots, the router only records them")
        dest_slots = np.asarray(dest_slots, np.int32)
        if dest_slots.shape != (hi - lo,):
            raise ValueError(
                f"dest_slots must map every key of [{lo}, {hi}) "
                f"(got shape {dest_slots.shape})")
        self.rr.flip(lo, hi, new_group)
        self._local[lo:hi] = dest_slots
