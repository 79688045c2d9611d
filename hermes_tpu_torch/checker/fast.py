"""Array-based history recording + native witness checking.

A copy of ``hermes_tpu/checker/fast.py`` over the port's own copy of the
C++ witness core (``hermes_tpu_torch/native/checker_core.cpp``), built with
``g++`` at first use into the ignored build directory (``build.py``):

  * ``ArrayRecorder`` — drop-in for checker.history.HistoryRecorder that
    stores completions as packed numpy columns (vectorized per step).
  * ``check_arrays`` — runs the O(n log n) timestamp-witness check in the
    C++ core over all keys at once; only keys the witness cannot certify
    fall back to the exact Python search (checker/linearizability.py), so
    verdicts are identical to the pure Python path — FAILs are always
    confirmed by the exact checker.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from hermes_tpu_torch import build
from hermes_tpu_torch.checker import linearizability as lin
from hermes_tpu_torch.checker.history import INF, Op
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import types as t

_SRC = build.PKG / "native" / "checker_core.cpp"

_I64_MIN = np.iinfo(np.int64).min
_I64_MAX = np.iinfo(np.int64).max

# kind codes shared with the C++ core
K_READ, K_WRITE, K_RMW, K_MAYBE_W = 0, 1, 2, 3


def default_record(check: bool = True):
    """The recorder kind a checked run should use: ``"array"`` (columnar
    recorder + the native witness) when ``g++`` is available, the
    pure-Python recorder (``True``) otherwise, ``False`` when not
    checking."""
    import shutil

    return ("array" if shutil.which("g++") else True) if check else False


_lib = None


def _core():
    global _lib
    if _lib is None:
        lib = build.load_cxx(_SRC)
        lib.hc_check_witness.restype = ctypes.c_int64
        lib.hc_check_witness.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def _pack_uid(lo, hi):
    return (hi.astype(np.int64) & 0xFFFFFFFF) << 32 | (lo.astype(np.int64) & 0xFFFFFFFF)


class ArrayRecorder:
    """Columnar history recorder (same surface as HistoryRecorder)."""

    def __init__(self, cfg: HermesConfig):
        self.cfg = cfg
        self._chunks: List[dict] = []
        self.aborted_uids: set = set()
        self._finalized = False

    def record_step(self, comp) -> None:
        code = np.asarray(comp.code)
        sel = code != t.C_NONE
        if not sel.any():
            return
        wval = np.asarray(comp.wval)[sel]
        rval = np.asarray(comp.rval)[sel]
        c = code[sel]
        chunk = dict(
            code=c.astype(np.int32),
            key=np.asarray(comp.key)[sel].astype(np.int32),
            wlo=wval[:, 0].astype(np.int32), whi=wval[:, 1].astype(np.int32),
            rlo=rval[:, 0].astype(np.int32), rhi=rval[:, 1].astype(np.int32),
            ver=np.asarray(comp.ver)[sel].astype(np.int64),
            fc=np.asarray(comp.fc)[sel].astype(np.int64),
            inv=np.asarray(comp.invoke_step)[sel].astype(np.int64),
            cmt=np.asarray(comp.commit_step)[sel].astype(np.int64),
        )
        ab = chunk["code"] == t.C_RMW_ABORT
        if ab.any():
            self.aborted_uids.update(
                zip(chunk["wlo"][ab].tolist(), chunk["whi"][ab].tolist())
            )
        self._chunks.append(chunk)

    def fold_pending(self, sess, replica: int = None, mask=None) -> int:
        """Fold in-flight updates (optionally one replica's row, or an
        ``(R, S)`` slot ``mask``) in as maybe_w rows (they may or may not
        have taken effect; the checker lets them linearize optionally).
        Called by ``finalize`` at end of run, by
        ``chaos.recovery.restart_replica`` at crash time, by the KVS's
        bounded retry for a salvaged slot and by a range migration's
        forced cutover (``KVS.salvage_slots``) for the salvaged slots."""
        status = np.asarray(sess.status)
        op = np.asarray(sess.op)
        sel = (status == t.S_INFL) & ((op == t.OP_WRITE) | (op == t.OP_RMW))
        if replica is not None:
            keep = np.zeros_like(sel)
            keep[replica] = True
            sel = sel & keep
        if mask is not None:
            sel = sel & np.asarray(mask, bool)
        if sel.any():
            val = np.asarray(sess.val)[sel]
            self._chunks.append(dict(
                code=np.full(sel.sum(), -1, np.int32),  # -1 = maybe_w
                key=np.asarray(sess.key)[sel].astype(np.int32),
                wlo=val[:, 0].astype(np.int32), whi=val[:, 1].astype(np.int32),
                rlo=np.zeros(sel.sum(), np.int32), rhi=np.zeros(sel.sum(), np.int32),
                ver=np.asarray(sess.ver)[sel].astype(np.int64),
                fc=np.asarray(sess.fc)[sel].astype(np.int64),
                inv=np.asarray(sess.invoke_step)[sel].astype(np.int64),
                cmt=np.full(sel.sum(), -1, np.int64),
            ))
        return int(sel.sum())

    def record_migration(self, keys, uids, vers, fcs, step: int) -> int:
        """Seed migrated-in keys as committed writes (the semantics of
        ``HistoryRecorder.record_migration``): one columnar chunk,
        responding at ``2*(step-1)+1``, strictly before any post-flip
        completion."""
        keys = np.asarray(keys, np.int32)
        uids = np.asarray(uids, np.int32).reshape(-1, 2)
        n = keys.shape[0]
        if n == 0:
            return 0
        self._chunks.append(dict(
            code=np.full(n, t.C_WRITE, np.int32),
            key=keys,
            wlo=uids[:, 0], whi=uids[:, 1],
            rlo=np.zeros(n, np.int32), rhi=np.zeros(n, np.int32),
            ver=np.asarray(vers, np.int64),
            fc=np.asarray(fcs, np.int64),
            inv=np.full(n, step - 1, np.int64),
            cmt=np.full(n, step - 1, np.int64),
        ))
        return n

    def finalize(self, sess=None) -> "ArrayRecorder":
        """Fold still-in-flight updates in as maybe_w rows (fold_pending);
        idempotent — the end-of-run fold happens once."""
        if sess is not None and not self._finalized:
            self._finalized = True
            self.fold_pending(sess)
        return self

    # -- packed views --------------------------------------------------------

    @property
    def n_recorded(self) -> int:
        """Raw completion rows recorded so far (pre-finalize; includes NOP
        and aborted-RMW rows that columns() drops)."""
        return sum(c["code"].shape[0] for c in self._chunks)

    def columns(self) -> dict:
        if not self._chunks:
            return {k: np.zeros(0, np.int64) for k in
                    ("kind", "key", "inv", "resp", "wuid", "ruid", "ts")}
        cat = {f: np.concatenate([c[f] for c in self._chunks])
               for f in self._chunks[0]}
        code = cat["code"]
        keep = code != t.C_NOP
        code, cat = code[keep], {f: v[keep] for f, v in cat.items()}
        # drop aborted-RMW completion rows (no-ops; the global aborted-value
        # rule is enforced in check_arrays)
        keep = code != t.C_RMW_ABORT
        code, cat = code[keep], {f: v[keep] for f, v in cat.items()}

        kind = np.full(code.shape, K_MAYBE_W, np.int8)
        kind[code == t.C_READ] = K_READ
        kind[code == t.C_WRITE] = K_WRITE
        kind[code == t.C_RMW] = K_RMW

        inv = 2 * cat["inv"]
        resp = np.where(code == t.C_READ, 2 * cat["cmt"], 2 * cat["cmt"] + 1)
        resp = np.where(code == -1, _I64_MAX, resp)

        wuid = _pack_uid(cat["wlo"], cat["whi"])
        ruid = np.where(
            (kind == K_READ) | (kind == K_RMW),
            _pack_uid(cat["rlo"], cat["rhi"]), _I64_MIN,
        )
        ts = np.where(kind != K_READ, (cat["ver"] << 32) | cat["fc"], _I64_MIN)
        return dict(kind=kind, key=cat["key"], inv=inv, resp=resp,
                    wuid=wuid, ruid=ruid, ts=ts)

    def to_ops(self, cols: Optional[dict] = None,
               only_keys: Optional[set] = None) -> List[Op]:
        """Materialize (a subset of) the history as checker Op objects."""
        c = cols or self.columns()
        ops = []
        for i in range(len(c["kind"])):
            k = int(c["key"][i])
            if only_keys is not None and k not in only_keys:
                continue
            kind = {K_READ: "r", K_WRITE: "w", K_RMW: "rmw", K_MAYBE_W: "maybe_w"}[
                int(c["kind"][i])]
            wuid = ruid = None
            if kind != "r":
                w = int(c["wuid"][i])
                wuid = (_s32(w & 0xFFFFFFFF), _s32((w >> 32) & 0xFFFFFFFF))
            if int(c["ruid"][i]) != _I64_MIN:
                r = int(c["ruid"][i])
                ruid = (_s32(r & 0xFFFFFFFF), _s32((r >> 32) & 0xFFFFFFFF))
            ts = None
            if int(c["ts"][i]) != _I64_MIN:
                ts = (int(c["ts"][i]) >> 32, int(c["ts"][i]) & 0xFFFFFFFF)
            resp = float("inf") if c["resp"][i] == _I64_MAX else float(c["resp"][i])
            ops.append(Op(kind, k, float(c["inv"][i]), resp, wuid=wuid,
                          ruid=ruid, ts=ts))
        return ops


def _s32(x: int) -> int:
    return x - (1 << 32) if x >= (1 << 31) else x


def check_arrays(rec: ArrayRecorder, max_keys: Optional[int] = None,
                 seed: int = 0) -> lin.Verdict:
    """Native witness over every key; exact Python search on suspects."""
    cols = rec.columns()
    n = len(cols["kind"])

    # global rule: an aborted RMW's value must never be observed
    if rec.aborted_uids:
        ab = np.array([_pack_uid(np.int32(lo), np.int32(hi))
                       for lo, hi in rec.aborted_uids], np.int64)
        bad = np.isin(cols["ruid"], ab) & (cols["ruid"] != _I64_MIN)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            return lin.Verdict(ok=False, keys_checked=0, failures=[
                lin.KeyVerdict(int(cols["key"][i]), False,
                               "aborted RMW value observed")], undecided=[])

    if max_keys is not None:
        keys = np.unique(cols["key"])
        if len(keys) > max_keys:
            import random

            keep = np.array(sorted(random.Random(seed).sample(
                keys.tolist(), max_keys)), np.int32)
            sel = np.isin(cols["key"], keep)
            cols = {f: v[sel] for f, v in cols.items()}
            n = len(cols["kind"])

    n_keys = len(np.unique(cols["key"])) if n else 0
    if n == 0:
        return lin.Verdict(ok=True, keys_checked=0, failures=[], undecided=[])

    lib = _core()
    max_out = n_keys + 1
    out = np.zeros(max_out, np.int32)
    ns = lib.hc_check_witness(
        n,
        np.ascontiguousarray(cols["key"], np.int32),
        np.ascontiguousarray(cols["kind"], np.int8),
        np.ascontiguousarray(cols["inv"], np.int64),
        np.ascontiguousarray(cols["resp"], np.int64),
        np.ascontiguousarray(cols["wuid"], np.int64),
        np.ascontiguousarray(cols["ruid"], np.int64),
        np.ascontiguousarray(cols["ts"], np.int64),
        out, max_out,
    )
    if ns < 0:
        raise RuntimeError("hc_check_witness: invalid arguments")
    suspects = set(out[: min(ns, max_out)].tolist())

    failures, undecided = [], []
    if suspects:
        ops = rec.to_ops(cols, only_keys=suspects)
        by_key = {}
        for o in ops:
            by_key.setdefault(o.key, []).append(o)
        for k, kops in by_key.items():
            v = lin.check_key(k, kops, (k, -1))
            if v.undecided:
                undecided.append(v)
            elif not v.ok:
                failures.append(v)
    return lin.Verdict(ok=not failures and not undecided, keys_checked=n_keys,
                       failures=failures, undecided=undecided)
