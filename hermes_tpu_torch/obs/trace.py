"""Structured event-timeline tracing: a copy of ``hermes_tpu/obs/trace.py``.

Trace records ride the same JSONL stream as interval metrics (one shared
monotonic clock, ``metrics.JsonlExporter``), so a fault-injection run
yields ONE causally ordered file: span begin/end around host operations
(step dispatch, completion readback, rebase, drain, heap GC, WAL sync),
point events for membership and failure injection and checker verdicts,
interleaved with the interval throughput records.

Record kinds:
  * ``event``      — point event: {"t", "kind": "event", "name", ...fields}
  * ``span_begin`` — {"t", "kind": "span_begin", "name", ...fields}
  * ``span_end``   — {"t", "kind": "span_end", "name", "dur_s", ...fields}

Spans are two records so the stream stays strictly append-ordered: ``t``
is non-decreasing across ALL kinds.
"""

from __future__ import annotations

import contextlib
import time


class Tracer:
    """Thin writer over an exporter (metrics.JsonlExporter /
    BufferExporter).  All methods are cheap host-side dict writes; callers
    on hot paths should keep their own ``if obs is None`` fast path."""

    def __init__(self, exporter):
        self.exporter = exporter

    def event(self, name: str, **fields) -> None:
        self.exporter.write({"name": name, **fields}, kind="event")

    def span_begin(self, name: str, **fields) -> float:
        self.exporter.write({"name": name, **fields}, kind="span_begin")
        return time.perf_counter()

    def span_end(self, name: str, t_begin: float, **fields) -> None:
        self.exporter.write(
            {"name": name,
             "dur_s": round(time.perf_counter() - t_begin, 6), **fields},
            kind="span_end")

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        t0 = self.span_begin(name, **fields)
        try:
            yield
        finally:
            self.span_end(name, t0)
