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

The round is compiled (``core/graphs.py``, the reference's ``jax.jit``):
its first call binds the runtime's state, op stream, control rows and
round counter, and on the card each later round is one CUDA graph replay
that also advances the counter on the device, so the steady-state round
uploads no control data.  Membership rows are copied into the bound
control rows (through a pinned staging buffer on the card) only when a
freeze/thaw/remove/join dirties them; on the sharded backend they are
the local replicas' rows.  Whatever replaces ``rt.fs`` or ``rt.stream``
with tensors of the same shapes is copied in at the next round; a new
shape drops the graphs and the next round captures again.

Completions of a round sit in the compiled round's ring of
``max(pipeline_depth, 1) + 1`` slots until harvested (a harvest of a
slot a later round overwrote raises).  At
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

``Runtime`` is the port of the reference's ``Runtime``: the phases engine
(``core/phases.py``, ``core/step.py``) on three backends, ``batched`` (R
replicas in one process), ``sharded`` (the blocks through a replica
group, ``core/group.py``) and ``sim`` (the blocks through a host
transport, ``transport/``: the deterministic ``SimTransport`` by default,
any ``HostTransport`` such as ``chaos.net.FaultingTransport`` on
request).  It shares the freeze/thaw/remove/join surface, the obs hooks
(``_ObsHooks``) and the live resize (``_ElasticResize``) with
``FastRuntime``.  Its round keeps the host out of the way on the
``batched`` and ``sharded`` backends: nothing in ``step_once`` waits for
the device unless completions are recorded or a detector is attached.
The ``sim`` backend copies each round's INV, ACK and VAL blocks to the
host and back, as the reference's does.
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
from hermes_tpu_torch.core import step as step_lib
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.workload import ycsb


def _is_multi(comp) -> bool:
    """True for the per-sub-step tuple a read_unroll > 1 round returns."""
    return isinstance(comp, tuple) and not isinstance(comp, st.Completions)


def _subs(comp):
    return comp if _is_multi(comp) else (comp,)


def host_copies(xs, non_blocking: bool = False) -> list:
    """Host copies of tensors ``xs``: ONE copy of the buffer they all view
    when they cover most of it (a compiled round's ring slot), else one
    each; a CPU tensor is copied too (a ring slot is written again)."""
    base = xs[0]._base
    if (base is not None and all(x._base is base for x in xs)
            and 2 * sum(x.numel() for x in xs) >= base.numel()):
        hb = (base.clone() if base.device.type == "cpu"
              else base.to("cpu", non_blocking=non_blocking))
        off = base.storage_offset()
        return [hb.as_strided(x.shape, x.stride(), x.storage_offset() - off)
                for x in xs]
    return [x.clone() if x.device.type == "cpu"
            else x.to("cpu", non_blocking=non_blocking) for x in xs]


class _HostFetch:
    """An in-flight device->host copy of one round's completions (and,
    with a detector attached, its suspect-age columns): one copy of the
    ring slot they sit in, enqueued (pinned, non-blocking) right behind
    the round under one event; ``wait`` blocks only until it lands."""

    def __init__(self, comp, ages=None):
        subs = _subs(comp)
        leaves = [x for c in subs for x in c]
        host = host_copies(leaves + ([] if ages is None else [ages]),
                            non_blocking=True)
        it = iter(host)
        self._comp = tuple(type(c)(*(next(it) for _ in c)) for c in subs)
        self._multi = _is_multi(comp)
        self._ages = None if ages is None else next(it)
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
    return host_copies([handle])[0].numpy()


def _to_host(comp):
    """Completions (or a tuple of them) as numpy leaves (copies)."""
    if isinstance(comp, _HostFetch):
        return comp.wait()
    subs = _subs(comp)
    it = iter(host_copies([x for c in subs for x in c]))
    out = tuple(type(c)(*(next(it).numpy() for _ in c)) for c in subs)
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


class _ObsHooks:
    """The obs and WAL hooks both runtimes share: ``attach_obs`` installs
    the run's Observability context, ``attach_wal`` the write-ahead log
    tap (fed only by the fast engine's harvest), ``_trace`` emits a point
    event (labelled with ``fleet_group`` in a fleet) and
    ``healthy_replicas`` names the live, unfrozen replicas.  Everything is
    a no-op while nothing is attached."""

    obs = None
    wal = None
    _wal_heap = None
    wal_last_lsn = 0
    # the fleet group this runtime serves (None outside a fleet)
    fleet_group = None

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

    def healthy_replicas(self) -> list:
        """Replicas that are live AND unfrozen: the set that can serve
        and ack right now."""
        live = int(self.live[0])
        return [r for r in range(self.cfg.n_replicas)
                if (live >> r) & 1 and not self.frozen[r]]


class _ElasticResize:
    """Live group resize shared by both runtimes: ``shrink`` fences and
    removes a replica, ``grow`` re-admits one through the join with a
    donor's copy; both harvest the completion pipeline first (where the
    runtime has one) and land on the obs timeline."""

    def shrink(self, replica: int) -> None:
        """Resize out: fence + remove ``replica`` from every quorum, after
        harvesting every completion of the old membership.  An attached
        detector logs it as ``shrink``, not as its own ``remove``."""
        if not (int(self.live[0]) >> replica) & 1:
            raise ValueError(f"replica {replica} is not live")
        if hasattr(self, "flush_pipeline"):
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
        if hasattr(self, "flush_pipeline"):
            self.flush_pipeline()
        self.join(replica, from_replica)
        self._trace("grow", replica=replica, donor=from_replica,
                    live_mask=int(self.live[0]))


def _prep_phases_stream(raw, device) -> st.OpStream:
    """An op stream (numpy or tensors, (R, S, G)) as int32 tensors on
    ``device`` (``uval`` as int32 words)."""
    def t32(x):
        return None if x is None else torch.tensor(
            np.asarray(x.cpu() if torch.is_tensor(x) else x),
            dtype=torch.int32, device=device)
    return st.OpStream(op=t32(raw.op), key=t32(raw.key),
                       uval=t32(getattr(raw, "uval", None)))


def _block_to_host(block):
    """One exchange block (a NamedTuple of tensors) as numpy copies."""
    return type(block)(*(x.cpu().numpy().copy() for x in block))


class Runtime(_ObsHooks, _ElasticResize):
    """Runs the reference's phases engine (module docstring).

    ``backend``: ``batched`` (all R replicas on ``device``), ``sharded``
    (the blocks through ``group``, default a ``LocalGroup`` on
    ``device``; a ``DistGroup`` rank holds its R/W replicas) or ``sim``
    (the blocks through ``transport``, default a ``SimTransport(R)``).
    ``record``: False | True (the Python op recorder) | "array" (the
    columnar recorder and the native witness checker, for large
    histories)."""

    def __init__(self, cfg: HermesConfig, backend: str = "batched",
                 transport=None, record=False,
                 stream: Optional[st.OpStream] = None, device="cuda",
                 group=None):
        if backend not in ("batched", "sharded", "sim"):
            raise ValueError(f"unknown backend {backend!r}")
        if group is not None and backend != "sharded":
            raise ValueError("a replica group is for the sharded backend")
        if transport is not None and backend != "sim":
            raise ValueError("a host transport is for the sim backend")
        if backend == "sharded" and group is None:
            group = LocalGroup(device)
        self.cfg = cfg
        self.backend = backend
        self.group = group
        self.device = (group.device if group is not None
                       else device_lib.resolve(device))
        r = cfg.n_replicas
        self.n_copies = r if group is None else group.n_local(r)
        self._first = 0 if group is None else group.first(r)
        self._rows = slice(self._first, self._first + self.n_copies)
        if record and group is not None and group.world > 1:
            raise ValueError("history recording is single-process only "
                             "(a DistGroup holds some replicas' rows)")
        raw = stream if stream is not None else ycsb.make_streams(cfg)
        self.rs = st.init_replica_state(cfg, self.device, self.n_copies)
        full = _prep_phases_stream(raw, "cpu")
        self.stream = st.OpStream(*(
            None if x is None else x[self._rows].to(self.device).contiguous()
            for x in full))

        self.step_idx = 0
        self.epoch = np.zeros((r,), np.int32)
        self.live = np.full((r,), cfg.full_mask, np.int32)
        self.frozen = np.zeros((r,), bool)
        # the membership rows on the device, re-uploaded only when a
        # freeze/thaw/set_live/remove/join dirtied them
        self._ctl_dev = None
        self._ctl_dirty = True
        if record == "array":
            self.recorder = ArrayRecorder(cfg)
        else:
            self.recorder = HistoryRecorder(cfg) if record else None
        self.membership = None
        if backend == "batched":
            self._step = step_lib.build_step_batched(cfg)
        elif backend == "sharded":
            self._step = step_lib.build_step_sharded(cfg, group)
        else:
            from hermes_tpu_torch.transport.sim import SimTransport

            self._step = None
            self.transport = (transport if transport is not None
                              else SimTransport(r))
            self._ph = step_lib.phase_fns(cfg)

    # -- control -------------------------------------------------------------

    def _ctl(self):
        """The round's StepCtl: the cached membership rows (the local
        replicas'; copied, never aliased to the host arrays) and this
        round's step."""
        if self._ctl_dirty:
            dev, rows = self.device, self._rows
            self._ctl_dev = step_lib.StepCtl(
                step=0,
                epoch=torch.tensor(self.epoch[rows], device=dev),
                live_mask=torch.tensor(self.live[rows], device=dev),
                frozen=torch.tensor(self.frozen[rows], device=dev))
            self._ctl_dirty = False
            self._trace("ctl_upload", epoch=int(self.epoch[0]),
                        live_mask=int(self.live[0]))
        return self._ctl_dev._replace(step=self.step_idx)

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
        """Re-admit ``replica`` with the donor's table: its WRITE, TRANS
        and REPLAY keys (the donor's own coordination) enter as INVALID,
        every row's step is this round (the live coordinator's VAL or the
        replay scan validates them)."""
        tbl = self.rs.table
        donor = self._donor_rows(from_replica)
        state = donor[0]
        folded = torch.where(
            (state == t.WRITE) | (state == t.TRANS) | (state == t.REPLAY),
            t.INVALID, state).to(torch.int32)
        j = replica - self._first
        if 0 <= j < self.n_copies:
            tbl.state[j].copy_(folded)
            tbl.ver[j].copy_(donor[1])
            tbl.fc[j].copy_(donor[2])
            tbl.val[j].copy_(donor[3])
            tbl.inv_step[j].fill_(self.step_idx)
        self.frozen[replica] = False
        self.set_live(int(self.live[0]) | (1 << replica))
        self._trace("join", replica=replica, from_replica=from_replica,
                    live_mask=int(self.live[0]))
        if self.membership is not None:
            self.membership.note_join(self, replica)

    def _donor_rows(self, replica: int):
        """(state, ver, fc, val) of ``replica``'s table (fetched from its
        rank on a DistGroup), as copies."""
        tbl = self.rs.table
        fields = (tbl.state, tbl.ver, tbl.fc, tbl.val)
        if self.group is not None and self.group.world > 1:
            return [self.group.fetch_row(x, replica) for x in fields]
        return [x[replica - self._first].clone() for x in fields]

    def attach_membership(self, service) -> None:
        """Attach the failure detector (``membership.MembershipService``):
        it polls ``meta.last_seen`` after every round.  One process only."""
        if self.group is not None and self.group.world > 1:
            raise ValueError("the failure detector is single-process only "
                             "(a DistGroup rank holds some replicas' rows)")
        self.membership = service

    # -- stepping -------------------------------------------------------------

    def step_once(self) -> None:
        ctl = self._ctl()
        obs = self.obs
        trace = obs is not None and obs.trace_steps
        if trace:
            td = obs.tracer.span_begin("step_dispatch", step=self.step_idx)
        if self._step is not None:
            self.rs, comp = self._step(self.rs, self.stream, ctl)
        else:
            self.rs, comp = self._host_step(ctl)
        if trace:
            obs.tracer.span_end("step_dispatch", td)
        if self.recorder is not None:
            if trace:
                tr = obs.tracer.span_begin("readback", step=self.step_idx)
            comp_np = st.Completions(*(x.cpu().numpy() for x in comp))
            if trace:
                obs.tracer.span_end("readback", tr)
            self.recorder.record_step(comp_np)
        self.step_idx += 1
        if self.membership is not None:
            self.membership.poll(self)

    def _host_step(self, ctl):
        """One round through ``step._step_core`` with the exchanges made
        by the host transport: each block copied to the host, exchanged,
        and the inbound block copied back."""
        step = self.step_idx
        dev = self.device

        def to_dev(block):
            # torch.tensor makes every bool byte 0 or 1 (a CRC-less wire
            # can deliver others)
            return type(block)(*(torch.tensor(np.asarray(x), device=dev)
                                 for x in block))

        def ex(fn):
            return lambda blk: to_dev(fn(_block_to_host(blk), step))

        tr = self.transport
        return step_lib._step_core(self.cfg, self._ph, ex(tr.exchange_inv),
                                   ex(tr.exchange_ack), ex(tr.exchange_val),
                                   self.rs, self.stream,
                                   step_lib._per_replica_ctl(self.cfg, ctl))

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step_once()

    def _psum(self, x):
        """Sum of a device scalar over every rank of the group."""
        if self.group is None or self.group.world == 1:
            return x
        return self.group.psum(x.reshape(1, 1))[0, 0]

    def pending_sessions(self):
        """Sessions not yet S_DONE on live, unfrozen replicas (a device
        scalar, summed over the group's ranks)."""
        ctl = self._ctl()
        ids = torch.arange(self._first, self._first + self.n_copies,
                           dtype=torch.int32, device=self.device)
        active = (((ctl.live_mask >> ids) & 1) == 1) & ~ctl.frozen
        undone = (self.rs.sess.status != t.S_DONE).to(torch.int32)
        return self._psum(torch.where(active[:, None], undone, 0).sum(
            dtype=torch.int32))

    def drain(self, max_steps: int = 10_000) -> bool:
        """Step until every session on a live, unfrozen replica finished
        its stream and the network is empty; False if max_steps ran out
        first."""
        if self.obs is not None:
            with self.obs.tracer.span("drain", step=self.step_idx):
                return self._drain(max_steps)
        return self._drain(max_steps)

    def _drain(self, max_steps: int) -> bool:
        for _ in range(max_steps):
            undone = int(self.pending_sessions())
            net = getattr(self, "transport", None)
            net_empty = net.pending() == 0 if net is not None else True
            if undone == 0 and net_empty:
                return True
            self.step_once()
        return False

    # -- observability ----------------------------------------------------------

    def _global_meta(self) -> st.Meta:
        meta = self.rs.meta
        if self.group is not None and self.group.world > 1:
            meta = st.Meta(*(self.group.gather_src(x) for x in meta))
        return meta

    def counters(self) -> dict:
        return _sum_meta_counters(meta_to_numpy(self._global_meta()))

    def _sess_view(self) -> st.Sessions:
        return st.Sessions(*(x.cpu().numpy() for x in self.rs.sess))

    def history_ops(self):
        if self.recorder is None:
            raise RuntimeError("construct Runtime(record=True)")
        rec = self.recorder.finalize(self._sess_view())
        return rec.to_ops() if isinstance(rec, ArrayRecorder) else rec

    def check(self, max_keys: Optional[int] = None) -> lin.Verdict:
        """Finalize the history and run the linearizability gate."""
        if self.recorder is None:
            raise RuntimeError("construct Runtime(record=True)")
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
            self.obs.flight_dump("checker_red",
                                 extra=dict(keys_checked=v.keys_checked))
        return v


class FastRuntime(_ObsHooks, _ElasticResize):
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
        # the compiled round; its ring outlives every unharvested round
        ring = max(cfg.pipeline_depth, 1) + 1
        if group is None:
            self.fs = fst.init_fast_state(cfg, self.device)
            self.stream = fst.prep_stream(raw, self.device)
            self._step = fst.build_fast_batched(cfg, ring=ring)
        else:
            self.fs, self.stream = fst.place_fast_sharded(cfg, group, raw)
            self._step = fst.build_fast_sharded(cfg, group, ring=ring)

        self.step_idx = 0  # also seeds the device-resident round counter
        self.epoch = np.zeros((r,), np.int32)
        self.live = np.full((r,), cfg.full_mask, np.int32)
        self.frozen = np.zeros((r,), bool)
        self._ctl_dev = None
        self._ctl_dirty = True
        self._ctl_rows = None  # the bound (epoch, live, frozen) rows
        self._ctl_stage = None  # their pinned staging rows (the card)
        self._ctl_event = None  # the last upload out of them
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

    # -- device-resident control --------------------------------------------

    @property
    def step_idx(self) -> int:
        return self._step_idx

    @step_idx.setter
    def step_idx(self, v: int) -> None:
        # external assignment re-seeds the device counter in place (the
        # compiled round bound it); the per-round increment is the
        # round's own (dispatch_round)
        self._step_idx = int(v)
        dev_step = getattr(self, "_step_dev", None)
        if dev_step is None:
            self._step_dev = torch.tensor(self._step_idx, dtype=torch.int32,
                                          device=self.device)
        else:
            dev_step.fill_(self._step_idx)

    def _ctl(self) -> fst.FastCtl:
        """Per-round FastCtl over the same device rows every round: the
        membership rows are copied in only when a hook dirtied them; the
        step rides the round's own increment and its host mirror gates
        the replay scan."""
        if self._ctl_dirty:
            self._upload_ctl()
            self._ctl_dirty = False
            self._trace("ctl_upload", epoch=int(self.epoch[0]),
                        live_mask=int(self.live[0]))
        return self._ctl_dev._replace(step=self._step_dev,
                                      host_step=self._step_idx,
                                      quiesce=self.quiesce)

    def _upload_ctl(self) -> None:
        """Copy the local replicas' (epoch, live, frozen) rows into the
        device rows the compiled round bound: on the card through a
        pinned staging buffer, the previous upload waited for first."""
        dev, rows = self.device, self._rows
        host = np.stack([self.epoch[rows], self.live[rows],
                         self.frozen[rows].astype(np.int32)])
        n = host.shape[1]
        if self._ctl_dev is None or self._ctl_dev.frozen.shape[0] != n:
            dev_rows = torch.empty((3, n), dtype=torch.int32, device=dev)
            self._ctl_dev = fst.FastCtl(
                step=self._step_dev, host_step=self._step_idx,
                my_cid=torch.arange(rows.start, rows.stop, dtype=torch.int32,
                                    device=dev),
                epoch=dev_rows[0], live_mask=dev_rows[1],
                frozen=torch.empty((n,), dtype=torch.bool, device=dev))
            self._ctl_rows = dev_rows
            if dev.type == "cuda":
                self._ctl_stage = torch.empty((3, n), dtype=torch.int32,
                                              pin_memory=True)
                self._ctl_event = None
        if dev.type == "cuda":
            if self._ctl_event is not None:
                self._ctl_event.synchronize()  # the last copy left it
            self._ctl_stage.numpy()[:] = host
            self._ctl_rows.copy_(self._ctl_stage, non_blocking=True)
            self._ctl_event = torch.cuda.Event()
            self._ctl_event.record()
        else:
            self._ctl_rows.copy_(torch.from_numpy(host))
        self._ctl_dev.frozen.copy_(self._ctl_rows[2])

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

    # -- stepping ---------------------------------------------------------------

    def dispatch_round(self):
        """Enqueue one protocol round without syncing; returns the round's
        device-side Completions."""
        obs = self.obs
        trace = obs is not None and obs.trace_steps
        if trace:
            td = obs.tracer.span_begin("step_dispatch", step=self.step_idx)
        # one replay on the card; the round advances the bound step
        self.fs, comp = self._step(self.fs, self.stream, self._ctl())
        self._step_dev = self._step.step
        if trace:
            obs.tracer.span_end("step_dispatch", td)
        self._step_idx += 1
        if self.membership is not None:
            if self.fetch_completions or self.recorder is not None:
                # the detector's input rides the harvest of this round: its
                # ages sit in the round's ring slot beside the completions
                self._age_ring.append((self._step_idx - 1, self._step.ages))
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
        if round_idx is not None and self._step.stale(comp, round_idx):
            raise RuntimeError(
                f"the completions of round {round_idx} were overwritten by "
                f"a later round: harvest within {self._step.ring_size} "
                "rounds of the dispatch")
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
