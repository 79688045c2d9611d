"""hermes_tpu_torch.elastic: elastic operations, the port of
``hermes_tpu/elastic``.

  * Live group resize -- ``FastRuntime.shrink`` / ``grow`` and the KVS's
    client-aware versions (``kvs.KVS.shrink`` / ``grow``): fence + remove
    with the pipeline flushed and queued client traffic rejected loudly;
    value sync through the join's copy transfer; an administrative
    removal logged as ``shrink`` by the failure detector.
  * Drills (``drill.py``) -- ``run_rolling_restart`` (every replica
    crash-restarted in sequence under load) and ``rolling_resize`` (every
    replica shrunk and grown back in sequence under a ``submit_drill_mix``
    standing load), the worst window's throughput dip measured by
    ``RateSampler``.

Not ported yet: live key-range migration (``migrate_range``) and the
migration drill (``migration_drill``), ROADMAP A11b.
"""

from hermes_tpu_torch.elastic.drill import (
    RateSampler,
    rolling_resize,
    run_rolling_restart,
    submit_drill_mix,
)

__all__ = ["RateSampler", "rolling_resize", "run_rolling_restart",
           "submit_drill_mix"]
