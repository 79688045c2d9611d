"""Host-side metrics registry + exporters: a copy of
``hermes_tpu/obs/metrics.py``.

  * ``MetricsRegistry`` — counters, gauges, histograms and bounded series
    by name (get-or-create; one name, one metric);
  * ``JsonlExporter``   — one JSON object per line; stamped records carry
    ``t`` (monotonic seconds since the exporter's birth) and ``kind``;
  * ``BufferExporter``  — the same surface, records kept in memory;
  * ``prometheus_text`` — a Prometheus text-exposition snapshot;
  * ``render_report``   — the human renderer lives in ``report.py``.

Metric values are plain host numbers: a device counter enters the
registry only after its readback (``set_total``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Dict, List, Optional, Union

import numpy as np

from hermes_tpu_torch.obs.series import Series


class Counter:
    """Monotone counter.  ``inc`` for host events; ``set_total`` for
    device-derived cumulative totals (Meta columns are absolute sums)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set_total(self, total: Union[int, float]) -> None:
        self.value = total


class Gauge:
    """Point-in-time value (watermarks, rates, config echoes)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v: Union[int, float]) -> None:
        self.value = v


class Histogram:
    """Fixed-bin histogram over non-negative integer observations (bin i
    counts value i; the last bin clips) — the same shape as the device
    latency histograms (state.LAT_BINS), so a device hist drops in via
    ``set_counts``."""

    def __init__(self, name: str, bins: int = 64, help: str = ""):
        self.name = name
        self.help = help
        self.counts = np.zeros(bins, np.int64)

    def observe(self, v: int, n: int = 1) -> None:
        self.counts[min(max(int(v), 0), len(self.counts) - 1)] += n

    def set_counts(self, counts) -> None:
        c = np.asarray(counts, np.int64)
        if c.shape != self.counts.shape:
            raise ValueError(
                f"histogram {self.name}: expected {self.counts.shape[0]} "
                f"bins, got {c.shape}")
        self.counts = c.copy()

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> Optional[int]:
        return percentile_from_counts(self.counts, q)


def percentile_from_counts(counts: np.ndarray, q: float) -> Optional[int]:
    """q in [0, 1]; bin index of the q-quantile, or None when empty (an
    empty histogram has no percentile — never a sentinel that poisons
    downstream JSON)."""
    cum = np.asarray(counts).cumsum()
    if cum[-1] == 0:
        return None
    return int((cum >= q * cum[-1]).argmax())


class MetricsRegistry:
    """Named metric registry with get-or-create accessors.  A name maps to
    exactly one metric object for the registry's lifetime; asking for the
    same name with a different type is a bug and raises.

    The name->metric MAP is lock-guarded (round-20): serving-tier threads
    get-or-create concurrently, and an unlocked dict insert during a
    snapshot iteration raises RuntimeError (or mints two objects for one
    name).  Metric VALUES stay lock-free by design — int adds under the
    GIL, the zero-device-cost contract above."""

    def __init__(self):
        # a PLAIN threading.Lock, NEVER concurrency.make_lock: the
        # registry is the sink the lock sanitizer itself feeds
        # (lockgraph.ObsLock reports hold-time series INTO a registry);
        # instrumenting this lock would recurse the sanitizer into its
        # own sink and self-deadlock.  See concurrency.REGISTRY's
        # MetricsRegistry entry.
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram,
                                       Series]] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not {cls.__name__}")
            return m

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def _items(self) -> list:
        """Sorted (name, metric) snapshot — iteration currency for the
        exporters, so a concurrent get-or-create never invalidates it."""
        with self._lock:
            return sorted(self._metrics.items())

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, bins: int = 64, help: str = "") -> Histogram:
        return self._get(name, Histogram, bins=bins, help=help)

    def series(self, name: str, capacity: int = 1024,
               help: str = "") -> Series:
        """Bounded windowed time series (obs/series.py) under the same
        one-name-one-metric discipline.  ``capacity`` only applies at
        creation; later calls return the existing ring unchanged."""
        return self._get(name, Series, capacity=capacity, help=help)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    def snapshot(self) -> dict:
        """Flat JSON-ready view: scalars verbatim; histograms as counts plus
        derived p50/p99 (None-omitted, matching stats.summarize)."""
        out: dict = {}
        for name, m in self._items():
            if isinstance(m, Series):
                continue  # full history exports via series_snapshot()
            if isinstance(m, Histogram):
                out[name] = m.counts.tolist()
                for q, tag in ((0.5, "p50"), (0.99, "p99")):
                    p = m.percentile(q)
                    if p is not None:
                        out[f"{name}_{tag}"] = p
            else:
                out[name] = m.value
        return out

    def series_snapshot(self) -> dict:
        """JSON-ready view of every time series: name -> parallel x/v
        arrays (the ``kind="series"`` record Observability exports)."""
        return {name: m.snapshot()
                for name, m in self._items()
                if isinstance(m, Series)}


def prometheus_text(reg: MetricsRegistry) -> str:
    """Prometheus text-exposition snapshot (counters/gauges as samples,
    histograms as cumulative ``_bucket`` series + ``_count``)."""
    lines: List[str] = []
    for name, m in reg._items():
        if isinstance(m, Series):
            continue  # rings have no Prometheus shape; JSONL-only
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        if isinstance(m, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {m.value}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {m.value}")
        else:
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for i, c in enumerate(m.counts.tolist()):
                cum += c
                lines.append(f'{name}_bucket{{le="{i}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_count {cum}")
    return "\n".join(lines) + "\n"


class JsonlExporter:
    """One JSON object per line.

    ``stamp=True``: every record is emitted as ``{"t": <monotonic seconds
    since exporter birth>, "kind": <tag>, ...}`` — the obs run-log schema
    (every record has ``t`` and ``kind``; ``t`` is non-decreasing because
    the clock is monotonic and records are written in call order).

    ``stamp=False``: the record is serialized verbatim, preserving key
    order — byte-compatible with the legacy ``print(json.dumps(...))``
    contract lines of bench.py / scripts/rebase_soak.py.
    """

    def __init__(self, fp: IO[str], stamp: bool = True):
        self.fp = fp
        self.stamp = stamp
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def write(self, record: dict, kind: str = "metrics") -> None:
        if self.stamp:
            record = {"t": round(self.now(), 6), "kind": kind, **record}
        self.fp.write(json.dumps(record) + "\n")
        self.fp.flush()


class BufferExporter:
    """In-memory exporter (tests, report post-processing): same write()
    surface as JsonlExporter(stamp=True), records kept as dicts."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.records: List[dict] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def write(self, record: dict, kind: str = "metrics") -> None:
        self.records.append({"t": round(self.now(), 6), "kind": kind,
                             **record})
