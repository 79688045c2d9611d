"""Stats: the summary record of a run, read off the device Meta counters.

Port of ``hermes_tpu/stats.py`` (``summarize``, ``percentile_from_hist``,
``percentile_nearest_rank``), in numpy; ``percentile_from_counts`` lives
in ``obs/metrics.py``, as in the reference.  ``summarize`` accepts a Meta
of tensors on any device or of numpy arrays.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from hermes_tpu_torch.obs.metrics import percentile_from_counts


def percentile_nearest_rank(sorted_vals, q: float):
    """Nearest-rank percentile (the ceil(q*n)-th order statistic) of an
    already-sorted sequence; None on an empty sequence."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           max(0, math.ceil(q * len(sorted_vals)) - 1))]


def percentile_from_hist(hist: np.ndarray, q: float) -> Optional[int]:
    """q in [0,1]; histogram bins are latency-in-steps (last bin = clip).
    Returns None on an empty histogram."""
    return percentile_from_counts(hist, q)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(meta, wall_s: Optional[float] = None, steps: Optional[int] = None,
              hists: bool = False) -> dict:
    """One metrics record from a batched Meta: op totals, commit-latency
    percentiles (omitted when empty), the phase metrics when recorded,
    and rates when ``wall_s`` is given."""
    m = type(meta)(*(_host(x) for x in meta))

    def tot(field):
        return int(getattr(m, field).sum())

    def hist_of(field):
        h = getattr(m, field)
        return h.sum(axis=0) if h.ndim > 1 else h

    hist = hist_of("lat_hist")
    commits = tot("n_write") + tot("n_rmw")
    out = dict(
        n_read=tot("n_read"),
        n_write=tot("n_write"),
        n_rmw=tot("n_rmw"),
        n_abort=tot("n_abort"),
        commits=commits,
        mean_commit_steps=float(m.lat_sum.sum()) / max(1, tot("lat_cnt")),
    )
    for q, tag in ((0.5, "p50"), (0.99, "p99")):
        p = percentile_from_hist(hist, q)
        if p is not None:
            out[f"{tag}_commit_steps"] = p
    qhist = hist_of("qwait_hist")
    if tot("n_inv"):
        out.update(
            n_inv=tot("n_inv"),
            n_rebcast=tot("n_rebcast"),
            n_nack=tot("n_nack"),
            n_retry=tot("n_retry"),
            replay_peak=int(m.replay_peak.max()),
        )
        for q, tag in ((0.5, "p50"), (0.99, "p99")):
            p = percentile_from_hist(qhist, q)
            if p is not None:
                out[f"{tag}_qwait_steps"] = p
    if wall_s:
        out["wall_s"] = round(wall_s, 4)
        out["writes_per_sec"] = round(commits / wall_s, 1)
        out["ops_per_sec"] = round((commits + out["n_read"]) / wall_s, 1)
    if steps:
        out["steps"] = steps
        if wall_s:
            out["step_us"] = round(wall_s / steps * 1e6, 1)
    if hists:
        out["lat_hist"] = hist.astype(int).tolist()
        out["qwait_hist"] = qhist.astype(int).tolist()
    return out
