"""The local-read path: port of ``hermes_tpu/core/readpath.py``.

Hermes serves reads LOCALLY: any healthy replica answers a Valid key
from its own table, with no protocol round.  This module answers a whole
batch of keys against the resident ``FastState`` table, outside the
round:

* a multi-get is ONE row gather, ``bank.index_select`` of the slots
  clamped to ``[0, K)`` (an untrusted index never gathers out of bounds,
  and never reaches the drop row K);
* a range scan is a slice of contiguous rows, no gather at all.

On the sharded engine each replica owns a table copy of K+1 rows, and the
serving replica's copy answers: its rows start at ``replica * (K+1)``
(the reference's ``replica * K`` plus the drop rows before it).

The row layout ``[pts | sst | val]`` puts the Valid check, the value
words and the packed timestamp the read-your-writes fence compares in one
row, so one gather answers all three.  The rows are decoded to int32
words by arithmetic (``faststep._bank_to_i32``) on the device and copied
to the host once a dispatch.

The answer per key is ``(valid, val, pts)``: ``valid`` is True only for
``types.VALID`` (Invalid/Write/Trans/Replay keys are declined and the
client layer, ``kvs.KVS.multi_get``, sends them through the round path);
``val`` the row's value words (words 0-1 are the write uid, the
linearizability witness); ``pts`` the row's packed (ver << 10 | fc).

Why a between-rounds read of a VALID row is linearizable: the round's
winner-row scatter writes ts, state and value together at commit, and
later rounds only replace a row with a strictly higher-ts row.  The host
reads ``rt.fs``, the table after the last DISPATCHED round; on the card
the gather is queued on the current stream behind that round, so it sees
exactly what the next round's reads would see.  ``checker.
linearizability.stale_read`` checks the property on recorded histories.

Where the port differs: PyTorch compiles nothing, so there are no batch
buckets to pad to; a multi-get gathers exactly its ``n`` rows.
``batch_bucket`` stays as the reference defines it, for callers that
size their batches by it.  ``read_census``/``scan_census`` run one
dispatch under the op census (``obs/profile.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import types as t

# the reference's smallest compiled batch bucket
MIN_BATCH = 256


def batch_bucket(n: int) -> int:
    """The reference's compiled batch shape for a client batch of ``n``
    keys: the power of two >= n, at least ``MIN_BATCH``."""
    b = MIN_BATCH
    while b < n:
        b <<= 1
    return b


class ReadAnswer(NamedTuple):
    """Host answer of one read dispatch (numpy columns)."""

    valid: np.ndarray  # (n,) bool: state == VALID at the serving replica
    val: np.ndarray    # (n, V) int32 value words (0-1 = write uid)
    pts: np.ndarray    # (n,) int32 packed row timestamp (RYW fence input)


def _answer_rows(rows8: torch.Tensor) -> ReadAnswer:
    """[pts | sst | val] byte rows on the device -> a host ReadAnswer:
    decoded to words on the device, one copy to the host."""
    rows32 = fst._bank_to_i32(rows8).cpu().numpy()
    return ReadAnswer(
        valid=fst.sst_state(rows32[:, fst.BANK_SST]) == t.VALID,
        val=rows32[:, fst.BANK_VAL:],
        pts=rows32[:, fst.BANK_PTS],
    )


def build_multi_get(cfg: HermesConfig):
    """The batched multi-get: ``fn(table, slots, copy=0) -> ReadAnswer``
    for an (n,) vector of dense slots (numpy or a tensor), clamped to
    ``[0, n_keys)`` on the device before the one gather.  ``copy`` is the
    index of a copy held by the table (``copy * (K+1)`` its first row):
    0 on the batched table, which every replica shares."""
    k = cfg.n_keys

    def mget(table: fst.FastTable, slots, copy: int = 0) -> ReadAnswer:
        bank = table.bank
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(bank.device)
        idx = idx.clamp(0, k - 1) + copy * (k + 1)
        return _answer_rows(bank.index_select(0, idx))

    return mget


def build_scan(cfg: HermesConfig):
    """The range scan: ``fn(table, lo, hi, copy=0) -> ReadAnswer`` over
    the contiguous rows ``[lo, hi)`` of the table's copy ``copy`` (a
    slice; a drop row is never in range)."""
    k = cfg.n_keys

    def scan(table: fst.FastTable, lo: int, hi: int,
             copy: int = 0) -> ReadAnswer:
        if not (0 <= lo < hi <= k):
            raise ValueError(f"scan range [{lo}, {hi}) outside [0, {k})")
        off = copy * (k + 1)
        return _answer_rows(table.bank[off + lo:off + hi])

    return scan


def _census_table(cfg: HermesConfig, backend: str, device):
    from hermes_tpu_torch import device as device_lib

    n = cfg.n_replicas if backend == "sharded" else None
    return fst.init_fast_state(cfg, device_lib.resolve(device),
                               n_copies=n).table


def read_census(cfg: HermesConfig, backend: str = "batched",
                batch: int = 4096, device="cuda") -> dict:
    """The op census of ONE multi-get dispatch of ``batch`` keys on a
    fresh table (``obs/profile.py``; the ``read_path`` budget)."""
    from hermes_tpu_torch.obs.profile import count_ops

    table = _census_table(cfg, backend, device)
    fn = build_multi_get(cfg)
    slots = np.arange(batch, dtype=np.int64) % cfg.n_keys
    return count_ops(lambda mode: fn(table, slots))


def scan_census(cfg: HermesConfig, backend: str = "batched",
                size: int = 4096, device="cuda") -> dict:
    """The census of one range-scan dispatch of ``size`` rows (the
    ``read_scan`` budget)."""
    from hermes_tpu_torch.obs.profile import count_ops

    table = _census_table(cfg, backend, device)
    fn = build_scan(cfg)
    return count_ops(lambda mode: fn(table, 0, min(size, cfg.n_keys)))


class LocalReader:
    """Host-side driver of the read dispatches over one FastRuntime.

    Local reads may be served only by a HEALTHY replica (live and
    unfrozen: a fenced replica must not serve reads).  On the sharded
    engine the serving replica's own copy answers: the first healthy
    one, or the one a call names.  Each method returns a ReadAnswer for
    the whole request, or ``None`` when no replica may serve (a named
    replica that is not healthy cannot; callers then send everything
    through the round path).  ``dispatches`` and ``keys_served`` count as
    the reference's do: one a call, ``n`` keys a call."""

    def __init__(self, rt):
        self.rt = rt
        self.cfg = rt.cfg
        self._mget = build_multi_get(rt.cfg)
        self._scan = build_scan(rt.cfg)
        self.dispatches = 0
        self.keys_served = 0

    def _serving_replica(self, replica=None) -> Optional[int]:
        healthy = self.rt.healthy_replicas()
        if replica is not None:
            return replica if replica in healthy else None
        return healthy[0] if healthy else None

    def multi_get(self, slots, replica=None) -> Optional[ReadAnswer]:
        """One read dispatch for an (n,) int array of dense slots."""
        rep = self._serving_replica(replica)
        if rep is None:
            return None
        slots = np.asarray(slots, np.int32)
        ans = self._mget(self.rt.fs.table, slots, self.rt.copy_index(rep))
        self.dispatches += 1
        self.keys_served += slots.shape[0]
        return ans

    def scan(self, lo: int, hi: int, replica=None) -> Optional[ReadAnswer]:
        """One scan dispatch over dense slots [lo, hi)."""
        if not (0 <= lo < hi <= self.cfg.n_keys):
            raise ValueError(f"scan range [{lo}, {hi}) outside "
                             f"[0, {self.cfg.n_keys})")
        rep = self._serving_replica(replica)
        if rep is None:
            return None
        ans = self._scan(self.rt.fs.table, lo, hi, self.rt.copy_index(rep))
        self.dispatches += 1
        self.keys_served += hi - lo
        return ans
