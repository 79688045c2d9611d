"""hermes_tpu_torch.elastic: elastic operations, the port of
``hermes_tpu/elastic``.

  * Live group resize -- ``FastRuntime.shrink`` / ``grow`` and the KVS's
    client-aware versions (``kvs.KVS.shrink`` / ``grow``): fence + remove
    with the pipeline flushed and queued client traffic rejected loudly;
    value sync through the join's copy transfer; an administrative
    removal logged as ``shrink`` by the failure detector.
  * Live key-range migration (``migrate.py``) -- ``migrate_range``:
    fence, drain, snapshot (a scope-tagged range archive,
    ``snapshot.save_range``), transfer (uids re-minted into the migration
    namespace, the destination's history seeded through
    ``recorder.record_migration``), atomic routing flip
    (``keyindex.RangeRouter``) and release, with ops caught by a forced
    cutover salvaged as ``maybe_w``, never dropped.
  * Drills (``drill.py``) -- ``run_rolling_restart`` (every replica
    crash-restarted in sequence under load), ``rolling_resize`` (every
    replica shrunk and grown back in sequence under a ``submit_drill_mix``
    standing load), the worst window's throughput dip measured by
    ``RateSampler``, and ``migration_drill`` (two stores and a router,
    the middle third moved under a standing mix, both checkers gating).
"""

from hermes_tpu_torch.elastic.drill import (
    RateSampler,
    migration_drill,
    rolling_resize,
    run_rolling_restart,
    submit_drill_mix,
)
from hermes_tpu_torch.elastic.migrate import migrate_range

__all__ = ["RateSampler", "migrate_range", "migration_drill",
           "rolling_resize", "run_rolling_restart", "submit_drill_mix"]
