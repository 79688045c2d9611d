"""State containers shared by the fast engine, the runtime and the client.

Port of ``hermes_tpu/core/state.py``'s ``OpStream``, ``Completions`` and
``Meta``: NamedTuples of tensors on one explicit device.  All integers are
int32, as in the reference.  The fast engine keeps a leading replica axis
R on every leaf, so ``init_meta`` builds the batched (R, ...) layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hermes_tpu_torch.config import HermesConfig

LAT_BINS = 64


class Completions(NamedTuple):
    """Per-round, per-session completion records (R, S): the raw material
    of the linearizability history and of the client futures.

    ``code`` types.C_*; C_NONE when the session completed nothing.
    ``wval``/``rval`` (R, S, V) value words written / read; ``ver``/``fc``
    the update's protocol timestamp (the checker's linearization witness);
    ``invoke_step``/``commit_step`` the op's load and completion rounds."""

    code: torch.Tensor
    key: torch.Tensor
    wval: torch.Tensor
    rval: torch.Tensor
    ver: torch.Tensor
    fc: torch.Tensor
    invoke_step: torch.Tensor
    commit_step: torch.Tensor


class Meta(NamedTuple):
    """Per-replica observability counters (leading R axis): heartbeat
    ages, completed-op counts, the commit-latency histogram, the packed-ts
    watermark ``max_pts`` (the version-budget guard) and the phase metrics
    (``n_inv`` .. ``qwait_hist``, summed under cfg.phase_metrics).  See
    ``hermes_tpu/core/state.py:Meta`` for each field."""

    last_seen: torch.Tensor
    suspect_age: torch.Tensor
    n_read: torch.Tensor
    n_write: torch.Tensor
    n_rmw: torch.Tensor
    n_abort: torch.Tensor
    lat_sum: torch.Tensor
    lat_cnt: torch.Tensor
    lat_hist: torch.Tensor
    max_pts: torch.Tensor
    n_inv: torch.Tensor
    n_rebcast: torch.Tensor
    n_nack: torch.Tensor
    n_retry: torch.Tensor
    replay_peak: torch.Tensor
    qwait_sum: torch.Tensor
    qwait_hist: torch.Tensor


class OpStream(NamedTuple):
    """Per-session op stream (R, S, G): op codes and keys; the client API
    also supplies payload bytes ``uval`` (R, S, G, 4*(value_words-2)) int8
    (words 0-1 of every value stay the device-derived unique write id)."""

    op: torch.Tensor
    key: torch.Tensor
    uval: Optional[torch.Tensor] = None


def init_meta(cfg: HermesConfig, device: torch.device) -> Meta:
    """Zeroed batched Meta: (R,) counters, (R, R) heartbeat rows and
    (R, LAT_BINS) histograms."""
    r = cfg.n_replicas

    def z(*sh):
        return torch.zeros(sh, dtype=torch.int32, device=device)

    return Meta(
        last_seen=z(r, r), suspect_age=z(r, r),
        n_read=z(r), n_write=z(r), n_rmw=z(r), n_abort=z(r),
        lat_sum=z(r), lat_cnt=z(r), lat_hist=z(r, LAT_BINS),
        max_pts=z(r), n_inv=z(r), n_rebcast=z(r), n_nack=z(r),
        n_retry=z(r), replay_peak=z(r), qwait_sum=z(r),
        qwait_hist=z(r, LAT_BINS),
    )
