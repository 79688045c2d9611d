"""hermes_tpu_torch.obs: the port's observability, a copy of the host
modules of ``hermes_tpu/obs``; ``profile.py`` is the port's own op census
(what one real round dispatches, in place of the reference's count of a
lowered program).

  1. **Device-side phase metrics**: the Meta columns the round sums per
     step (``core/state.Meta``), read by ``stats.summarize``.
  2. **Host-side registry + exporters**: ``MetricsRegistry`` (counter,
     gauge, histogram, series) with JSONL, Prometheus-text and human-report
     exporters (``metrics.py``, ``report.py``).
  3. **Event-timeline tracing**: span and point records on the same
     monotonic clock as the interval metrics (``trace.py``), per-op spans
     of sampled client ops (``tracing.py``), and the crash flight
     recorder (``flightrec.py``).

``runtime.FastRuntime`` feeds the registry when an obs context is
attached: ``host_work_s`` / ``device_wait_s`` split every ``step_once``
between host work and time blocked in the completion readback, the
``pipeline_depth`` gauge and series track the in-flight ring, and the
``ctl_upload`` event counts control-row uploads (none in a steady-state
round).

``Observability`` is the facade the runtime attaches
(``FastRuntime.attach_obs``): one registry, one exporter (file or in
memory), one tracer, one clock, one flight recorder.  Everything here is
host code: nothing touches a tensor.
"""

from __future__ import annotations

from typing import IO, Optional

from hermes_tpu_torch.obs.flightrec import FlightRecorder
from hermes_tpu_torch.obs.metrics import (
    BufferExporter,
    Counter,
    Gauge,
    Histogram,
    JsonlExporter,
    MetricsRegistry,
    percentile_from_counts,
    prometheus_text,
)
from hermes_tpu_torch.obs.series import Series
from hermes_tpu_torch.obs.trace import Tracer
from hermes_tpu_torch.obs.tracing import (
    OP_SPANS,
    OpTracer,
    TraceSampler,
    canonical_span_bytes,
)

__all__ = [
    "BufferExporter", "Counter", "FlightRecorder", "Gauge", "Histogram",
    "JsonlExporter", "MetricsRegistry", "OP_SPANS", "Observability",
    "OpTracer", "Series", "TraceSampler", "Tracer", "canonical_span_bytes",
    "percentile_from_counts", "prometheus_text",
]


class Observability:
    """One obs context for a run: registry + exporter + tracer on a shared
    monotonic clock.

    ``path``/``fp`` select a JSONL file sink; with neither, records buffer
    in memory (``.records`` — tests and post-hoc report rendering).
    ``trace_steps`` additionally emits per-step dispatch/readback spans —
    off by default (two records per protocol step is run-log noise at
    bench scale; faults, intervals, drains and rebases are always traced).

    Round-18: every context also carries an always-on ``FlightRecorder``
    — the exporter tees each stamped record into the recorder's bounded
    ring, so any run with obs attached has a post-mortem black box at
    the cost of one deque append per record.  Dumps are opt-in (a
    ``flight_dir`` here, or HERMES_FLIGHT_DIR in the environment — see
    obs/flightrec.py); ``flight_dump`` is the trigger entry point the
    runtime checker and the KVS watchdog call.
    """

    def __init__(self, path: Optional[str] = None, fp: Optional[IO[str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 trace_steps: bool = False,
                 flight: Optional[FlightRecorder] = None,
                 flight_dir: Optional[str] = None):
        self.registry = registry or MetricsRegistry()
        self._own_fp = None
        if fp is None and path is not None:
            fp = self._own_fp = open(path, "w")
        self.exporter = JsonlExporter(fp) if fp is not None else BufferExporter()
        self.tracer = Tracer(self.exporter)
        self.trace_steps = trace_steps
        self.flight = flight or FlightRecorder(dump_dir=flight_dir)
        if flight is not None and flight_dir is not None:
            self.flight.dump_dir = flight_dir
        # tee: the recorder's ring sees the same stamped records the sink
        # does, without disturbing the exporter's type (tests isinstance
        # on BufferExporter) or its byte output
        inner_write = self.exporter.write

        def _tee_write(record: dict, kind: str = "metrics",
                       _inner=inner_write) -> None:
            self.flight.record({"t": round(self.exporter.now(), 6),
                                "kind": kind, **record})
            _inner(record, kind=kind)

        self.exporter.write = _tee_write

    @property
    def records(self):
        """Buffered records (in-memory sink only)."""
        if not isinstance(self.exporter, BufferExporter):
            raise AttributeError(
                "records buffer only exists for the in-memory sink; "
                "read the JSONL file back via obs.report.load_records")
        return self.exporter.records

    def interval(self, record: dict) -> None:
        """Write one interval-metrics record (cumulative counters at a
        reporting boundary; obs/report.py derives per-interval rates)."""
        self.exporter.write(record, kind="metrics")

    def summary(self, record: dict) -> None:
        self.exporter.write(record, kind="summary")

    def registry_snapshot(self) -> None:
        """Flush the host registry's current values as one record."""
        self.exporter.write(self.registry.snapshot(), kind="registry")

    def series_snapshot(self) -> None:
        """Flush every time series as one ``kind="series"`` record
        (name -> parallel x/v arrays) — no-op when no series exist."""
        snap = self.registry.series_snapshot()
        if snap:
            self.exporter.write(snap, kind="series")

    def flight_dump(self, reason: str, extra: Optional[dict] = None):
        """Trigger the flight recorder: dump one checksummed archive into
        the configured dump dir (ctor ``flight_dir`` or HERMES_FLIGHT_DIR)
        and return its path, or None when no dir is configured."""
        return self.flight.auto_dump(reason, extra)

    def close(self) -> None:
        if isinstance(self.exporter, JsonlExporter):
            try:
                self.exporter.fp.flush()
            except ValueError:
                pass  # already closed
        if self._own_fp is not None:
            self._own_fp.close()
            self._own_fp = None
