"""Run loop of the fast engine: the step loop, failure injection, the
completion pipeline, version rebase and history recording.

Port of ``hermes_tpu/runtime.py:FastRuntime``, both backends:

* ``batched`` — the R replicas share one lockstep table copy on one
  device (``device=``, default the card);
* ``sharded`` — one table copy a replica, the INV / ACK / VAL blocks
  moving through a replica group (``group=``, ``core/group.py``): a
  ``LocalGroup`` holds every replica in this process (the card's path,
  and the default), a ``DistGroup`` R/W replicas on each rank of a
  ``torch.distributed`` group, whose rows of the state this runtime then
  holds (``n_copies`` of them; recording is single-process only).

The round counter lives on the device and is bumped there, so the
steady-state round uploads no control data.  Membership rows are
uploaded only when a freeze/thaw/remove/join dirties them; on the
sharded backend they are the local replicas' rows.

Completions of a round are device tensors until harvested.  At
``cfg.pipeline_depth >= 2`` a dispatched round's completions start an
asynchronous copy to pinned host memory right after the round is
enqueued, and the harvest later waits only for that copy — so the host's
recording and matching of round k overlap the card running round k+1.

The value heap's GC rides every version rebase through ``rebase_hook``
(installed by ``kvs.KVS``), and ``healthy_replicas`` names the replicas
that may serve local reads (``core/readpath.py``).

Observability (``attach_obs``, the ``obs`` package): freeze, thaw,
remove, join and control uploads are point events on the run's timeline;
drains and rebases are spans, and with ``obs.trace_steps`` so are every
round's dispatch and readback; the registry gets ``host_work_s`` /
``device_wait_s``, the pipeline-depth gauge and the pipeline-depth,
max-version and commits series; a red checker verdict dumps the flight
recorder.  The write-ahead log (``attach_wal``, the ``wal`` package) taps
the harvest: every committed write is appended after the version
re-anchor, from the numpy copy the harvest already holds, so the log's
flusher thread never touches a tensor.  Everything is a no-op while
nothing is attached.

The failure detector (``attach_membership``, ``membership.py``) reads
each round's ``Meta.suspect_age`` off the harvest: the round enqueues its
age columns beside its completions, and on the card at depth >= 2 they
ride the same pinned copy and event (``_HostFetch``), so detection adds
no synchronous fetch.  ``shrink`` / ``grow`` resize the live group under
traffic (fence + remove; join with the donor's copy transferred).

In a fleet (``fleet/``) ``fleet_group`` labels the runtime: every trace
event it emits carries ``group``, so one shared obs sink stays
attributable per group (``rt.group`` is the replica group, a different
thing).

Not ported yet: the reference ``Runtime`` (A12).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from hermes_tpu_torch import device as device_lib
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.checker.fast import ArrayRecorder, check_arrays
from hermes_tpu_torch.checker.history import HistoryRecorder
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.workload import ycsb


def _is_multi(comp) -> bool:
    """True for the per-sub-step tuple a read_unroll > 1 round returns."""
    return isinstance(comp, tuple) and not isinstance(comp, st.Completions)


def _subs(comp):
    return comp if _is_multi(comp) else (comp,)


class _HostFetch:
    """An in-flight device->host copy of one round's completions (and,
    with a detector attached, its suspect-age columns): the copies are
    enqueued (pinned, non-blocking) right behind the round under one
    event, and ``wait`` blocks only until they land."""

    def __init__(self, comp, ages=None):
        self._comp = tuple(type(c)(*(x.to("cpu", non_blocking=True)
                                     for x in c)) for c in _subs(comp))
        self._multi = _is_multi(comp)
        self._ages = (None if ages is None
                      else ages.to("cpu", non_blocking=True))
        self._event = torch.cuda.Event()
        self._event.record()
        self._landed = False

    def _land(self):
        if not self._landed:
            self._event.synchronize()
            self._landed = True

    def wait(self):
        self._land()
        out = tuple(type(c)(*(x.numpy() for x in c)) for c in self._comp)
        return out if self._multi else out[0]

    def ages(self) -> np.ndarray:
        self._land()  # a no-op once the round's completions were harvested
        return self._ages.numpy()


def _ages_to_host(handle) -> np.ndarray:
    """One ring entry's suspect-age columns as numpy."""
    if isinstance(handle, _HostFetch):
        return handle.ages()
    return handle.cpu().numpy()


def _to_host(comp):
    """Completions (or a tuple of them) as numpy leaves."""
    if isinstance(comp, _HostFetch):
        return comp.wait()
    out = tuple(type(c)(*(x.cpu().numpy() for x in c)) for c in _subs(comp))
    return out if _is_multi(comp) else out[0]


def _sum_meta_counters(m) -> dict:
    """``counters()`` body: sums of the host-resident Meta columns."""
    return dict(
        n_read=m.n_read.sum(),
        n_write=m.n_write.sum(),
        n_rmw=m.n_rmw.sum(),
        n_abort=m.n_abort.sum(),
        lat_sum=m.lat_sum.sum(),
        lat_cnt=m.lat_cnt.sum(),
        lat_hist=m.lat_hist.sum(axis=0),
    )


def meta_to_numpy(meta: st.Meta) -> st.Meta:
    return st.Meta(*(x.cpu().numpy() for x in meta))


class FastRuntime:
    """Runs the fast round: the same membership / failure-injection /
    history-recording surface as the reference, over a FastState of
    tensors on ``device`` (batched) or on the group's device (sharded;
    ``group`` None: a ``LocalGroup`` on ``device``).

    ``record``: False | True (Python Op recorder) | "array" (columnar
    recorder + native witness checker, for bench-scale histories)."""

    def __init__(self, cfg: HermesConfig, backend: str = "batched",
                 record=False, stream: Optional[st.OpStream] = None,
                 device="cuda", group=None):
        if backend not in ("batched", "sharded"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "batched" and group is not None:
            raise ValueError("a replica group is for the sharded backend")
        if backend == "sharded" and group is None:
            group = LocalGroup(device)
        self.group = group
        self.device = (group.device if group is not None
                       else device_lib.resolve(device))
        self.cfg = cfg
        self.backend = backend
        r = cfg.n_replicas
        # table copies held here, the first local replica's id and the
        # local replicas' rows of the host control arrays
        self.n_copies = 1 if group is None else group.n_local(r)
        self._first = 0 if group is None else group.first(r)
        self._rows = slice(self._first, self._first + (
            r if group is None else self.n_copies))
        if record and group is not None and group.world > 1:
            raise ValueError("history recording is single-process only "
                             "(a DistGroup holds some replicas' rows)")
        if cfg.device_stream:
            if stream is not None:
                raise ValueError(
                    "device_stream generates ops on device; a caller-supplied "
                    "op stream would be silently ignored")
            raw = ycsb.stub_stream(cfg)
        else:
            raw = stream if stream is not None else ycsb.make_streams(cfg)
        if group is None:
            self.fs = fst.init_fast_state(cfg, self.device)
            self.stream = fst.prep_stream(raw, self.device)
            self._step = fst.build_fast_batched(cfg)
        else:
            self.fs, self.stream = fst.place_fast_sharded(cfg, group, raw)
            self._step = fst.build_fast_sharded(cfg, group)

        self.step_idx = 0  # also seeds the device-resident round counter
        self.epoch = np.zeros((r,), np.int32)
        self.live = np.full((r,), cfg.full_mask, np.int32)
        self.frozen = np.zeros((r,), bool)
        self._ctl_dev = None
        self._ctl_dirty = True
        # in-flight completions of dispatched-but-unharvested rounds, FIFO
        self._ring: collections.deque = collections.deque()
        # a client layer that defers its own completion handling (kvs.KVS)
        # installs hooks here: comp_flush forces its deferred round out at
        # rebase/drain boundaries, comp_sink steps through it during the
        # rebase quiesce drain
        self.comp_flush = None
        self.comp_sink = None
        # called at the end of every rebase_versions, while the store is
        # quiesced, drained and flushed (the value heap's GC, kvs.KVS)
        self.rebase_hook = None
        self.quiesce = False
        self.rebases = 0
        self.prerebase_peaks: list = []
        self._ver_base = None  # np.int64 (K,), allocated on first rebase
        self._rebase_fn = None
        self._in_rebase = False
        self._next_rebase_at = 0
        # completion fetch per round; a telemetry-only run sets False
        # and polls counters() alone
        self.fetch_completions = True
        # the failure detector (attach_membership) and its input: each
        # dispatched round's suspect-age columns, FIFO beside the
        # completion ring, and the last harvested (round, ages).  The
        # round builds Meta.suspect_age anew every round and nothing
        # writes it in place, so an entry holds the round's own tensor
        self.membership = None
        self._age_ring: collections.deque = collections.deque()
        self.harvested_ages = None
        # the obs context and the WAL tap (attach_obs / attach_wal)
        self.obs = None
        self.wal = None
        self._wal_heap = None
        self.wal_last_lsn = 0
        self._devwait_s = 0.0
        # the fleet group this runtime serves (None outside a fleet)
        self.fleet_group = None
        if record == "array":
            self.recorder = ArrayRecorder(cfg)
        else:
            self.recorder = HistoryRecorder(cfg) if record else None

    # -- observability and the WAL tap ---------------------------------------

    def attach_obs(self, obs):
        """Install the run's Observability context (a late attach still
        feeds an attached WAL's fsync-latency and dirty-window series)."""
        self.obs = obs
        if self.wal is not None:
            self.wal.obs = obs
        return obs

    def attach_wal(self, wal, heap=None):
        """Install the write-ahead log tap: every committed write
        ``harvest_comp`` surfaces is appended to ``wal`` (with its extent
        bytes read from ``heap`` in heap mode)."""
        self.wal = wal
        self._wal_heap = heap
        if wal.obs is None and self.obs is not None:
            wal.obs = self.obs
        return wal

    def _trace(self, name: str, **fields) -> None:
        if self.obs is not None:
            if self.fleet_group is not None and "group" not in fields:
                fields["group"] = self.fleet_group
            self.obs.tracer.event(name, step=self.step_idx, **fields)

    # -- device-resident control --------------------------------------------

    @property
    def step_idx(self) -> int:
        return self._step_idx

    @step_idx.setter
    def step_idx(self, v: int) -> None:
        # external assignment re-seeds the device counter; the per-round
        # increment bypasses this (dispatch_round)
        self._step_idx = int(v)
        self._step_dev = torch.tensor(self._step_idx, dtype=torch.int32,
                                      device=self.device)

    def _ctl(self) -> fst.FastCtl:
        """Per-round FastCtl: the membership rows are re-uploaded only when
        a hook dirtied them; the step rides the device-side increment and
        its host mirror gates the replay scan."""
        if self._ctl_dirty:
            # the local replicas' rows (all R but on a DistGroup rank)
            dev, rows = self.device, self._rows
            self._ctl_dev = fst.FastCtl(
                step=self._step_dev,
                host_step=self._step_idx,
                my_cid=torch.arange(rows.start, rows.stop, dtype=torch.int32,
                                    device=dev),
                epoch=torch.as_tensor(self.epoch[rows]).to(dev),
                live_mask=torch.as_tensor(self.live[rows]).to(dev),
                frozen=torch.as_tensor(self.frozen[rows]).to(dev),
            )
            self._ctl_dirty = False
            self._trace("ctl_upload", epoch=int(self.epoch[0]),
                        live_mask=int(self.live[0]))
        return self._ctl_dev._replace(step=self._step_dev,
                                      host_step=self._step_idx,
                                      quiesce=self.quiesce)

    # -- membership / failure injection ---------------------------------------

    def freeze(self, replica: int) -> None:
        """Failure injection: the replica stops processing and emitting."""
        self.frozen[replica] = True
        self._ctl_dirty = True
        self._trace("freeze", replica=replica)

    def thaw(self, replica: int) -> None:
        self.frozen[replica] = False
        self._ctl_dirty = True
        self._trace("thaw", replica=replica)

    def set_live(self, mask: int) -> None:
        """Membership change: new live bitmap, epoch bump everywhere."""
        self.live[:] = mask
        self.epoch += 1
        self._ctl_dirty = True

    def remove(self, replica: int) -> None:
        """Remove from membership AND fence (a removed replica must stop
        serving reads at once)."""
        self.frozen[replica] = True
        self.set_live(int(self.live[0]) & ~(1 << replica))
        self._trace("remove", replica=replica, live_mask=int(self.live[0]))

    def join(self, replica: int, from_replica: int) -> None:
        """Re-admit ``replica``.  The batched table is shared by every
        replica, so it already holds the joiner's state: no transfer.  On
        the sharded backend the donor's copy is transferred into the
        joiner's, its in-flight coordination states (WRITE, TRANS,
        REPLAY) folded to INVALID and every row's step set to this round
        (the live coordinator's VAL or the replay scan re-validates
        them)."""
        if self.backend == "sharded":
            self._transfer_copy(replica, from_replica)
        self.frozen[replica] = False
        self.set_live(int(self.live[0]) | (1 << replica))
        self._trace("join", replica=replica, from_replica=from_replica,
                    live_mask=int(self.live[0]))
        if self.membership is not None:
            self.membership.note_join(self, replica)

    def attach_membership(self, service) -> None:
        """Attach the failure detector (``membership.MembershipService``):
        it polls every harvested round's ages and removes a replica no
        live peer has heard from past the lease.  One process only: a
        ``DistGroup`` rank holds some replicas' rows."""
        if self.group is not None and self.group.world > 1:
            raise ValueError("the failure detector is single-process only "
                             "(a DistGroup rank holds some replicas' rows)")
        self.membership = service

    # -- live resize -------------------------------------------------------------

    def shrink(self, replica: int) -> None:
        """Resize out: fence + remove ``replica`` from every quorum, after
        harvesting every completion of the old membership.  An attached
        detector logs it as ``shrink``, not as its own ``remove``."""
        if not (int(self.live[0]) >> replica) & 1:
            raise ValueError(f"replica {replica} is not live")
        self.flush_pipeline()
        self.remove(replica)
        if self.membership is not None:
            self.membership.note_shrink(self, replica)
        self._trace("shrink", replica=replica, live_mask=int(self.live[0]))

    def grow(self, replica: int, from_replica: Optional[int] = None) -> None:
        """Resize in: re-admit ``replica`` through the join (its copy
        value-synced from ``from_replica``, default the lowest live,
        unfrozen replica)."""
        if (int(self.live[0]) >> replica) & 1 and not self.frozen[replica]:
            raise ValueError(f"replica {replica} is already live")
        if from_replica is None:
            cands = [d for d in self.healthy_replicas() if d != replica]
            if not cands:
                raise RuntimeError("grow needs a live unfrozen donor; "
                                   "none left")
            from_replica = cands[0]
        self.flush_pipeline()
        self.join(replica, from_replica)
        self._trace("grow", replica=replica, donor=from_replica,
                    live_mask=int(self.live[0]))

    def _transfer_copy(self, replica: int, from_replica: int) -> None:
        K = self.cfg.n_keys
        vk = fst.copies(self.fs.table.vpts, K)
        bk = fst.copies(self.fs.table.bank, K)
        d_vpts = self.group.fetch_row(vk, from_replica)
        rows = fst._bank_to_i32(self.group.fetch_row(bk, from_replica))
        state = fst.sst_state(rows[:, fst.BANK_SST])
        folded = torch.where(
            (state == t.WRITE) | (state == t.TRANS) | (state == t.REPLAY),
            t.INVALID, state)
        rows[:, fst.BANK_SST] = fst.pack_sst(self._step_idx, folded)
        j = replica - self._first
        if 0 <= j < self.n_copies:
            vk[j].copy_(d_vpts)
            bk[j].copy_(fst._i32_to_bank(rows))

    def copy_index(self, replica: int) -> int:
        """The index in this runtime's table of ``replica``'s copy: 0 on
        the batched table every replica shares; raises for a replica whose
        copy another rank holds."""
        j = 0 if self.backend == "batched" else replica - self._first
        if not 0 <= j < self.n_copies:
            raise ValueError(f"replica {replica}'s copy is not held here")
        return j

    def copy_of(self, replica: int):
        """``(vpts (K,), bank (K, 4(2+V)))``: views of ``replica``'s table
        copy (the shared table on the batched backend)."""
        K, j = self.cfg.n_keys, self.copy_index(replica)
        return (fst.copies(self.fs.table.vpts, K)[j],
                fst.copies(self.fs.table.bank, K)[j])

    def _psum(self, per_replica):
        """Sum of (n_copies,)-row per-replica counts over every replica
        (a device scalar)."""
        if self.group is None or self.group.world == 1:
            return per_replica.sum()
        return self.group.psum(per_replica.reshape(-1, 1))[0, 0]

    def healthy_replicas(self) -> list:
        """Replicas that are live AND unfrozen: the set that can serve
        and ack right now."""
        live = int(self.live[0])
        return [r for r in range(self.cfg.n_replicas)
                if (live >> r) & 1 and not self.frozen[r]]

    # -- stepping ---------------------------------------------------------------

    def dispatch_round(self):
        """Enqueue one protocol round without syncing; returns the round's
        device-side Completions."""
        obs = self.obs
        trace = obs is not None and obs.trace_steps
        if trace:
            td = obs.tracer.span_begin("step_dispatch", step=self.step_idx)
        self.fs, comp = self._step(self.fs, self.stream, self._ctl())
        self._step_dev = fst.bump_step(self._step_dev)
        if trace:
            obs.tracer.span_end("step_dispatch", td)
        self._step_idx += 1
        if self.membership is not None:
            if self.fetch_completions or self.recorder is not None:
                # the detector's input rides the harvest of this round
                self._age_ring.append(
                    (self._step_idx - 1, self.fs.meta.suspect_age))
            else:
                # a run that never harvests: the synchronous poll
                self.membership.poll(self)
        return comp

    def harvest_comp(self, comp, round_idx: Optional[int] = None):
        """Fetch one dispatched round's completions (device tensors or an
        in-flight host fetch), re-anchor rebased versions and feed the
        recorder and the WAL.  Callers harvest in round order."""
        obs = self.obs
        trace = obs is not None and obs.trace_steps
        if trace:
            tr = obs.tracer.span_begin("readback", step=self.step_idx,
                                       round=round_idx)
        t0 = time.perf_counter() if obs is not None else 0.0
        comp_np = _to_host(comp)
        if obs is not None:
            dt = time.perf_counter() - t0
            self._devwait_s += dt
            obs.registry.counter("device_wait_s").inc(dt)
        if trace:
            obs.tracer.span_end("readback", tr)
        ring = self._age_ring
        if ring and (round_idx is None or ring[0][0] <= round_idx):
            # the freshest age entry of a round at or before this one: its
            # work completed with it, so reading it stalls nothing
            age_round, handle = ring.popleft()
            while ring and (round_idx is None or ring[0][0] <= round_idx):
                age_round, handle = ring.popleft()
            self.harvested_ages = (age_round, _ages_to_host(handle))
            if self.membership is not None:
                self.membership.poll(self)
        if self._ver_base is not None:
            # re-anchor post-rebase versions into the global version space
            fix = lambda c: c._replace(
                ver=np.asarray(c.ver).astype(np.int64)
                + self._ver_base[np.asarray(c.key)])
            comp_np = (tuple(fix(c) for c in comp_np) if _is_multi(comp_np)
                       else fix(comp_np))
        if self.recorder is not None:
            for c in _subs(comp_np):
                self.recorder.record_step(c)
        if self.wal is not None:
            # after the re-anchor above: the log carries globally monotone
            # versions (replay subtracts the target's own ver_base)
            for c in _subs(comp_np):
                lsn = self.wal.append_comp(c, heap=self._wal_heap,
                                           round_idx=round_idx)
                if lsn is not None:
                    self.wal_last_lsn = lsn
            self.wal.kick()
        return comp_np

    def _harvest_one(self):
        idx, comp = self._ring.popleft()
        return self.harvest_comp(comp, round_idx=idx)

    def flush_pipeline(self) -> int:
        """Harvest every in-flight completion in round order (the ring
        plus a client layer's deferred round); returns the ring rounds
        drained."""
        n = len(self._ring)
        while self._ring:
            self._harvest_one()
        if self.comp_flush is not None:
            self.comp_flush()
        return n

    def step_once(self):
        """One protocol round.  At ``cfg.pipeline_depth == 1`` its host
        Completions are fetched and returned; at depth >= 2 the OLDEST
        in-flight round is harvested once the ring is full (None while it
        fills).  ``fetch_completions=False`` runs never sync."""
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        self._devwait_s = 0.0
        comp = self.dispatch_round()
        out = None
        if self.fetch_completions or self.recorder is not None:
            k = self.step_idx - 1
            if self.cfg.pipeline_depth > 1 and self.device.type == "cuda":
                ring = self._age_ring
                ages = ring[-1][1] if ring and ring[-1][0] == k else None
                comp = _HostFetch(comp, ages)
                if ages is not None:
                    # the ages land with the completions, one event
                    ring[-1] = (k, comp)
            self._ring.append((k, comp))
            if len(self._ring) >= self.cfg.pipeline_depth:
                out = self._harvest_one()
        if obs is not None:
            reg = obs.registry
            reg.counter("host_work_s").inc(
                time.perf_counter() - t0 - self._devwait_s)
            reg.gauge("pipeline_depth").set(len(self._ring))
            reg.series("pipeline_depth_series").append(
                self.step_idx, len(self._ring))
        return out

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step_once()

    # -- version rebase -------------------------------------------------------

    def _inflight_count(self) -> int:
        if self.group is not None and self.group.world > 1:
            per = ((self.fs.sess.status == t.S_INFL).sum(1)
                   + self.fs.replay.active.sum(1))
            return int(self._psum(per))
        s = (self.fs.sess.status == t.S_INFL).sum()
        return int(s + self.fs.replay.active.sum())

    def rebase_versions(self, quiesce: bool = True,
                        max_quiesce_rounds: int = 256) -> int:
        """Restore packed-ts headroom by resetting quiesced keys to version
        1 (faststep.build_rebase), after draining in-flight writes with
        new intake paused.  Recorded histories stay checkable: the per-key
        deltas accumulate in ``_ver_base`` and are added back to every
        later completion.  Returns the number of keys rebased."""
        if self.obs is not None:
            with self.obs.tracer.span("rebase_versions", step=self.step_idx):
                return self._rebase_versions(quiesce, max_quiesce_rounds)
        return self._rebase_versions(quiesce, max_quiesce_rounds)

    def _rebase_versions(self, quiesce: bool, max_quiesce_rounds: int) -> int:
        if quiesce:
            prev = self.quiesce
            self.quiesce = True
            step = self.comp_sink or self.step_once
            try:
                for _ in range(max_quiesce_rounds):
                    if self._inflight_count() == 0:
                        break
                    step()
            finally:
                self.quiesce = prev
        # in-flight completions belong to the pre-rebase version era
        self.flush_pipeline()
        if self._rebase_fn is None:
            self._rebase_fn = fst.build_rebase(self.cfg, backend=self.backend,
                                               group=self.group)
        self.fs, delta = self._rebase_fn(self.fs)
        delta = delta.cpu().numpy().astype(np.int64)
        n = int(np.count_nonzero(delta))
        if n:
            if self._ver_base is None:
                self._ver_base = np.zeros(self.cfg.n_keys, np.int64)
            self._ver_base += delta
            self.rebases += 1
        if self.rebase_hook is not None:
            self.rebase_hook()
        return n

    def drain(self, max_steps: int = 10_000) -> bool:
        """Step until every session on a live, unfrozen replica finished
        its stream (one device scalar per poll); False if max_steps ran
        out first."""
        if self.obs is not None:
            with self.obs.tracer.span("drain", step=self.step_idx):
                return self._drain(max_steps)
        return self._drain(max_steps)

    def _drain(self, max_steps: int) -> bool:
        ok = False
        for _ in range(max_steps):
            ctl = self._ctl()
            pend = fst.pending_sessions(self.fs.sess.status, ctl.live_mask,
                                        ctl.frozen)
            undone = int(self._psum(pend.reshape(1)))
            if undone == 0:
                ok = True
                break
            self.step_once()
        self.flush_pipeline()
        return ok

    # -- observability ----------------------------------------------------------

    def _global_meta(self) -> st.Meta:
        """Every replica's Meta rows (gathered over a DistGroup)."""
        meta = self.fs.meta
        if self.group is not None and self.group.world > 1:
            meta = st.Meta(*(self.group.gather_src(x) for x in meta))
        return meta

    def counters(self) -> dict:
        m = meta_to_numpy(self._global_meta())
        max_ver = self._check_version_headroom(m)
        out = _sum_meta_counters(m)
        out["max_ver"] = max_ver
        if self.obs is not None:
            # the version watermark and cumulative commits keyed by the
            # poll's round, and one Meta summary into the flight ring
            reg = self.obs.registry
            reg.series("max_ver_series").append(self.step_idx, max_ver)
            reg.series("commits_series").append(
                self.step_idx, int(out["n_write"]) + int(out["n_rmw"]))
            self.obs.flight.note_meta(dict(
                step=self.step_idx,
                **{k: (v.tolist() if isinstance(v, np.ndarray) else int(v))
                   for k, v in out.items()}))
        return out

    def _check_version_headroom(self, m) -> int:
        """Packed-ts overflow guard: past ``cfg.rebase_fraction`` of the
        version budget a counter poll triggers a quiesce+rebase (with
        cfg.auto_rebase); reaching the budget itself raises.  Returns the
        high-water version."""
        max_ver = int(np.asarray(m.max_pts).max()) >> fst.PTS_FC_BITS
        soft = int(self.cfg.rebase_fraction * self.cfg.max_key_versions)
        if (self.cfg.auto_rebase and not self._in_rebase
                and max_ver >= max(soft, self._next_rebase_at)):
            self._in_rebase = True
            self.prerebase_peaks.append(max_ver)
            try:
                self.rebase_versions()
            finally:
                self._in_rebase = False
            max_ver = (int(self._global_meta().max_pts.max())
                       >> fst.PTS_FC_BITS)
            # back off when a key can't be reclaimed: re-pay the drain only
            # once the watermark has grown meaningfully again
            self._next_rebase_at = max_ver + max(
                1, self.cfg.max_key_versions // 64)
        if max_ver >= self.cfg.max_key_versions:
            raise RuntimeError(
                f"packed-timestamp overflow: a key reached version "
                f"{max_ver} >= max_key_versions={self.cfg.max_key_versions};"
                f" the int32 packed ts cannot represent further versions of "
                f"this key — auto-rebase could not reclaim it "
                f"(busy/unquiesceable key)"
            )
        return max_ver

    def _sess_view(self):
        """Host view of the sessions for the recorders' end-of-run fold:
        value WORDS (the device holds bytes) and re-anchored versions."""
        sess = self.fs.sess
        val32 = fst._bank_to_i32(sess.val).cpu().numpy()
        key = sess.key.cpu().numpy()
        ver = fst.pts_ver(sess.pts).cpu().numpy().astype(np.int64)
        if self._ver_base is not None:
            ver = ver + self._ver_base[key]
        return type("SessView", (), dict(
            status=sess.status.cpu().numpy(), op=sess.op.cpu().numpy(),
            key=key, val=val32, ver=ver,
            fc=fst.pts_fc(sess.pts).cpu().numpy(),
            invoke_step=sess.invoke_step.cpu().numpy(),
        ))

    def history_ops(self):
        if self.recorder is None:
            raise RuntimeError("construct FastRuntime(record=True)")
        self.flush_pipeline()
        rec = self.recorder.finalize(self._sess_view())
        return rec.to_ops() if isinstance(rec, ArrayRecorder) else rec

    def check(self, max_keys: Optional[int] = None) -> lin.Verdict:
        """Finalize the history and run the linearizability gate."""
        if self.recorder is None:
            raise RuntimeError("construct FastRuntime(record=True)")
        self.flush_pipeline()
        if isinstance(self.recorder, ArrayRecorder):
            self.recorder.finalize(self._sess_view())
            v = check_arrays(self.recorder, max_keys=max_keys)
        else:
            ops = self.history_ops()
            if max_keys is not None:
                ops = lin.sample_keys(ops, max_keys=max_keys)
            v = lin.check_history(ops,
                                  aborted_uids=self.recorder.aborted_uids)
        self._trace("checker_verdict", ok=v.ok, keys_checked=v.keys_checked)
        if not v.ok and self.obs is not None:
            # checker red: dump the black box while the run's last records
            # are still in the ring
            self.obs.flight_dump("checker_red",
                                 extra=dict(keys_checked=v.keys_checked))
        return v
