"""Run loop of the batched fast engine: the step loop, failure injection,
the completion pipeline, version rebase and history recording.

Port of ``hermes_tpu/runtime.py:FastRuntime`` (batched backend).  The
state lives on one device (``device=``, default the card); the round
counter lives there too and is bumped on the device, so the steady-state
round uploads no control data.  Membership rows are uploaded only when a
freeze/thaw/remove/join dirties them.

Completions of a round are device tensors until harvested.  At
``cfg.pipeline_depth >= 2`` a dispatched round's completions start an
asynchronous copy to pinned host memory right after the round is
enqueued, and the harvest later waits only for that copy — so the host's
recording and matching of round k overlap the card running round k+1.

Out of scope for now (ROADMAP A4): the observability, WAL and membership
service hooks, live resize, the sharded backend and the reference
``Runtime``.
"""

from __future__ import annotations

import collections
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
from hermes_tpu_torch.core import types as t
from hermes_tpu_torch.workload import ycsb


def _is_multi(comp) -> bool:
    """True for the per-sub-step tuple a read_unroll > 1 round returns."""
    return isinstance(comp, tuple) and not isinstance(comp, st.Completions)


def _subs(comp):
    return comp if _is_multi(comp) else (comp,)


class _HostFetch:
    """An in-flight device->host copy of one round's completions: the
    copies are enqueued (pinned, non-blocking) right behind the round, and
    ``wait`` blocks only until they land."""

    def __init__(self, comp):
        self._comp = tuple(type(c)(*(x.to("cpu", non_blocking=True)
                                     for x in c)) for c in _subs(comp))
        self._multi = _is_multi(comp)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self):
        self._event.synchronize()
        out = tuple(type(c)(*(x.numpy() for x in c)) for c in self._comp)
        return out if self._multi else out[0]


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
    """Runs the batched fast round: the same membership /
    failure-injection / history-recording surface as the reference, over a
    FastState of tensors on ``device``.

    ``record``: False | True (Python Op recorder) | "array" (columnar
    recorder + native witness checker, for bench-scale histories)."""

    def __init__(self, cfg: HermesConfig, backend: str = "batched",
                 record=False, stream: Optional[st.OpStream] = None,
                 device="cuda"):
        if backend != "batched":
            raise NotImplementedError(
                f"backend {backend!r}: the port has the batched engine only "
                "(the sharded engine is ROADMAP A10)")
        self.device = device_lib.resolve(device)
        self.cfg = cfg
        self.backend = backend
        r = cfg.n_replicas
        self.fs = fst.init_fast_state(cfg, self.device)
        if cfg.device_stream:
            if stream is not None:
                raise ValueError(
                    "device_stream generates ops on device; a caller-supplied "
                    "op stream would be silently ignored")
            raw = ycsb.stub_stream(cfg)
        else:
            raw = stream if stream is not None else ycsb.make_streams(cfg)
        self.stream = fst.prep_stream(raw, self.device)

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
        if record == "array":
            self.recorder = ArrayRecorder(cfg)
        else:
            self.recorder = HistoryRecorder(cfg) if record else None
        self._step = fst.build_fast_batched(cfg)

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
            dev, r = self.device, self.cfg.n_replicas
            self._ctl_dev = fst.FastCtl(
                step=self._step_dev,
                host_step=self._step_idx,
                my_cid=torch.arange(r, dtype=torch.int32, device=dev),
                epoch=torch.as_tensor(self.epoch).to(dev),
                live_mask=torch.as_tensor(self.live).to(dev),
                frozen=torch.as_tensor(self.frozen).to(dev),
            )
            self._ctl_dirty = False
        return self._ctl_dev._replace(step=self._step_dev,
                                      host_step=self._step_idx,
                                      quiesce=self.quiesce)

    # -- membership / failure injection ---------------------------------------

    def freeze(self, replica: int) -> None:
        """Failure injection: the replica stops processing and emitting."""
        self.frozen[replica] = True
        self._ctl_dirty = True

    def thaw(self, replica: int) -> None:
        self.frozen[replica] = False
        self._ctl_dirty = True

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

    def join(self, replica: int, from_replica: int) -> None:
        """Re-admit ``replica``.  The batched table is shared by every
        replica, so it already holds the joiner's state: no transfer."""
        self.frozen[replica] = False
        self.set_live(int(self.live[0]) | (1 << replica))

    # -- stepping ---------------------------------------------------------------

    def dispatch_round(self):
        """Enqueue one protocol round without syncing; returns the round's
        device-side Completions."""
        self.fs, comp = self._step(self.fs, self.stream, self._ctl())
        self._step_dev = fst.bump_step(self._step_dev)
        self._step_idx += 1
        return comp

    def harvest_comp(self, comp, round_idx: Optional[int] = None):
        """Fetch one dispatched round's completions (device tensors or an
        in-flight host fetch), re-anchor rebased versions and feed the
        recorder.  Callers harvest in round order."""
        comp_np = _to_host(comp)
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
        comp = self.dispatch_round()
        out = None
        if self.fetch_completions or self.recorder is not None:
            if self.cfg.pipeline_depth > 1 and self.device.type == "cuda":
                comp = _HostFetch(comp)
            self._ring.append((self.step_idx - 1, comp))
            if len(self._ring) >= self.cfg.pipeline_depth:
                out = self._harvest_one()
        return out

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step_once()

    # -- version rebase -------------------------------------------------------

    def _inflight_count(self) -> int:
        s = (self.fs.sess.status == t.S_INFL).sum()
        return int(s + self.fs.replay.active.sum())

    def rebase_versions(self, quiesce: bool = True,
                        max_quiesce_rounds: int = 256) -> int:
        """Restore packed-ts headroom by resetting quiesced keys to version
        1 (faststep.build_rebase), after draining in-flight writes with
        new intake paused.  Recorded histories stay checkable: the per-key
        deltas accumulate in ``_ver_base`` and are added back to every
        later completion.  Returns the number of keys rebased."""
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
            self._rebase_fn = fst.build_rebase(self.cfg, backend=self.backend)
        self.fs, delta = self._rebase_fn(self.fs)
        delta = delta.cpu().numpy().astype(np.int64)
        n = int(np.count_nonzero(delta))
        if n:
            if self._ver_base is None:
                self._ver_base = np.zeros(self.cfg.n_keys, np.int64)
            self._ver_base += delta
            self.rebases += 1
        return n

    def drain(self, max_steps: int = 10_000) -> bool:
        """Step until every session on a live, unfrozen replica finished
        its stream (one device scalar per poll); False if max_steps ran
        out first."""
        ok = False
        for _ in range(max_steps):
            ctl = self._ctl()
            undone = int(fst.pending_sessions(
                self.fs.sess.status, ctl.live_mask, ctl.frozen))
            if undone == 0:
                ok = True
                break
            self.step_once()
        self.flush_pipeline()
        return ok

    # -- observability ----------------------------------------------------------

    def counters(self) -> dict:
        m = meta_to_numpy(self.fs.meta)
        max_ver = self._check_version_headroom(m)
        out = _sum_meta_counters(m)
        out["max_ver"] = max_ver
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
            max_ver = int(self.fs.meta.max_pts.max()) >> fst.PTS_FC_BITS
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
            return check_arrays(self.recorder, max_keys=max_keys)
        ops = self.history_ops()
        if max_keys is not None:
            ops = lin.sample_keys(ops, max_keys=max_keys)
        return lin.check_history(ops, aborted_uids=self.recorder.aborted_uids)
