"""Bounded windowed time-series store: a copy of
``hermes_tpu/obs/series.py``.

A ``Series`` is a bounded ring of (x, v) samples where ``x`` is a
DETERMINISTIC run coordinate (protocol round index, poll sequence, never
wall time), so a seeded run's series are a pure function of the run.
Feeding is two deque appends; eviction is O(1).  Queries are windowed:

  * ``window(last_n)``       — the most recent samples;
  * ``rate(last_n)``         — dv/dx over the window (for cumulative
    counters: the per-round commit rate);
  * ``percentile(q, last_n)`` — nearest-rank percentile of the window's
    values.

``MetricsRegistry.series`` gives get-or-create access, and
``Observability.series_snapshot`` exports every series as one
``kind="series"`` JSONL record.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple


class Series:
    """One named bounded ring of (x, v) samples, x non-decreasing."""

    def __init__(self, name: str, capacity: int = 1024, help: str = ""):
        if capacity < 2:
            raise ValueError("series capacity must be >= 2 (rate needs "
                             "two samples)")
        self.name = name
        self.help = help
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)

    def append(self, x, v) -> None:
        """Record value ``v`` at run coordinate ``x`` (round index, poll
        sequence — a deterministic clock, not wall time).  ``x`` must be
        non-decreasing; regressions raise (a series fed from two
        unsynchronized clocks is a bug, not data)."""
        if self._ring and x < self._ring[-1][0]:
            raise ValueError(
                f"series {self.name!r}: x went backwards "
                f"({x} < {self._ring[-1][0]}) — feed one monotone run "
                "coordinate per series")
        self._ring.append((x, v))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def last(self) -> Optional[Tuple]:
        return self._ring[-1] if self._ring else None

    def window(self, last_n: Optional[int] = None) -> List[Tuple]:
        """The most recent ``last_n`` samples (all retained when None)."""
        if last_n is None or last_n >= len(self._ring):
            return list(self._ring)
        return [self._ring[i]
                for i in range(len(self._ring) - last_n, len(self._ring))]

    def values(self, last_n: Optional[int] = None) -> List:
        return [v for _x, v in self.window(last_n)]

    def rate(self, last_n: Optional[int] = None) -> Optional[float]:
        """dv/dx across the window — the per-round rate when ``v`` is a
        cumulative counter and ``x`` a round index.  None until two
        samples exist or while the window spans zero x."""
        w = self.window(last_n)
        if len(w) < 2:
            return None
        (x0, v0), (x1, v1) = w[0], w[-1]
        dx = x1 - x0
        if dx <= 0:
            return None
        return (v1 - v0) / dx

    def percentile(self, q: float, last_n: Optional[int] = None):
        """Nearest-rank percentile of the window's values (None when
        empty) — the p99-vs-deadline query, over history instead of one
        histogram snapshot."""
        # lazy: stats.py itself imports obs.metrics, which imports us
        from hermes_tpu_torch.stats import percentile_nearest_rank

        return percentile_nearest_rank(sorted(self.values(last_n)), q)

    def snapshot(self) -> dict:
        """JSON-ready view: parallel x/v arrays (full retained window)."""
        return dict(x=[x for x, _v in self._ring],
                    v=[v for _x, v in self._ring])
