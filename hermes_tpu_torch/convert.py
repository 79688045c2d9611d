"""State carried across packages: the fast engine's state as numpy.

``fast_state_from_numpy`` builds the port's ``FastState`` on a device from
any tree with the reference's field names and numpy leaves — a
``hermes_tpu`` ``FastState`` after ``jax.device_get``, or what
``fast_state_to_numpy`` returned.  ``fast_state_to_numpy`` is its
inverse: the port's state as numpy, in the reference's shapes (the
port's table drop row is cut off on the way out and re-added zeroed on
the way in).  The sharded layout (``n_copies`` table copies, the
reference's ``(n*K,)`` rows) converts the same way, each copy's own drop
row cut and re-added.  Together they start both packages from the same
mid-run state.  ``meta_from_numpy`` converts the Meta alone; an op stream with
numpy leaves goes through ``core.faststep.prep_stream``.
"""

from __future__ import annotations

import numpy as np
import torch

from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core import state as st


def _t(a, device, dtype=None):
    """A fresh tensor copy: the round updates the table in place, so it
    must never share memory with the caller's arrays."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def meta_from_numpy(meta, device) -> st.Meta:
    return st.Meta(*(_t(getattr(meta, f), device, torch.int32)
                     for f in st.Meta._fields))


def _add_drop_rows(a, n: int):
    """(n*K, ...) -> (n*(K+1), ...): a zero row after each copy."""
    c = a.reshape((n, -1) + a.shape[1:])
    z = np.zeros((n, 1) + a.shape[1:], a.dtype)
    return np.concatenate([c, z], axis=1).reshape((-1,) + a.shape[1:])


def fast_state_from_numpy(cfg: HermesConfig, tree, device,
                          n_copies: int = 1) -> fst.FastState:
    """The port's FastState on ``device`` from a numpy tree with the
    reference's field names: table.vpts (n*K,) and table.bank (n*K,
    4*(2+V)) for ``n_copies`` table copies (1: the batched layout)."""
    vpts = np.asarray(tree.table.vpts, np.int32)
    bank = np.asarray(tree.table.bank, np.int8)
    rows = n_copies * cfg.n_keys
    if vpts.shape != (rows,) or bank.shape[0] != rows:
        raise ValueError(
            f"table shapes {vpts.shape}/{bank.shape} do not match "
            f"{n_copies} table cop{'y' if n_copies == 1 else 'ies'} of "
            f"n_keys={cfg.n_keys}")
    vpts = _add_drop_rows(vpts, n_copies)
    bank = _add_drop_rows(bank, n_copies)
    sess = fst.FastSess(*(
        _t(getattr(tree.sess, f), device,
           torch.int8 if f in ("val", "rd_val") else torch.int32)
        for f in fst.FastSess._fields))
    rp = tree.replay
    replay = fst.FastReplay(
        active=_t(rp.active, device, torch.bool),
        key=_t(rp.key, device, torch.int32),
        pts=_t(rp.pts, device, torch.int32),
        val=_t(rp.val, device, torch.int8),
        acks=_t(rp.acks, device, torch.int32),
    )
    return fst.FastState(
        table=fst.FastTable(vpts=_t(vpts, device), bank=_t(bank, device)),
        sess=sess, replay=replay, meta=meta_from_numpy(tree.meta, device))


def fast_state_to_numpy(fs: fst.FastState, n_copies: int = 1
                        ) -> fst.FastState:
    """The port's state as a FastState of numpy copies in the reference's
    shapes (each of the ``n_copies`` copies' drop row removed)."""
    h = lambda x: x.cpu().numpy().copy()
    cut = lambda x: h(x.view((n_copies, -1) + tuple(x.shape[1:]))[:, :-1]
                      ).reshape((-1,) + tuple(x.shape[1:]))
    return fst.FastState(
        table=fst.FastTable(vpts=cut(fs.table.vpts),
                            bank=cut(fs.table.bank)),
        sess=fst.FastSess(*(h(x) for x in fs.sess)),
        replay=fst.FastReplay(*(h(x) for x in fs.replay)),
        meta=st.Meta(*(h(x) for x in fs.meta)),
    )
