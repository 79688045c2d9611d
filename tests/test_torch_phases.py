"""Each phase of the port's reference engine (``hermes_tpu_torch/core/
phases.py``) against ``hermes_tpu/core/phases.py`` (vmapped over the
replicas) on the same inputs, bit for bit (tolerance 0: the state is
integer).

* Seeded mid-run states: a contended RMW/Zipfian run with a replica
  frozen and another removed, stopped at several rounds; from each,
  coordinate -> apply_inv -> collect_acks -> apply_val one phase at a
  time, every output compared, then seeded random INV / ACK / VAL blocks
  against the same tables.
* Hostile keys off the wire and in the op stream: negative keys in
  ``[-K, 0)`` (JAX counts them from the end before ``mode="drop"``),
  below ``-K`` and at or past ``K`` (dropped from scatters, clamped in
  gathers).
* The helpers where JAX and torch part: ``_first_true`` against
  ``jnp.nonzero(size=, fill_value=)``, the masked set-scatters against
  ``.at[]`` with ``mode="drop"``, and ``_reduce_at`` against the
  reference's K-wide min / max arbiters read back at the lanes' keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_refpair import assert_blocks_equal, pair

CFG_KW = dict(n_replicas=4, n_keys=24, n_sessions=6, replay_slots=4,
              ops_per_session=24, replay_age=3,
              workload=dict(read_frac=0.3, rmw_frac=0.5,
                            distribution="zipfian", zipf_theta=0.99,
                            seed=71))


def _mid_run(stop):
    """The reference runtime after ``stop`` rounds of a contended run with
    replica 1 frozen from round 3 and replica 3 removed at round 6."""
    from hermes_tpu.runtime import Runtime as JR

    jc, pc = pair(**CFG_KW)
    a = JR(jc, backend="batched")
    for s in range(stop):
        if s == 3:
            a.freeze(1)
        if s == 6:
            a.remove(3)
        a.step_once()
    return jc, pc, a


def _ctls(jc, pc, a):
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch.core import step as step_lib

    jctl = jstep._per_replica_ctl(jc, a._ctl())
    pctl = step_lib._per_replica_ctl(pc, step_lib.StepCtl(
        step=torch.tensor(a.step_idx, dtype=torch.int32),
        epoch=torch.tensor(a.epoch),
        live_mask=torch.tensor(a.live), frozen=torch.tensor(a.frozen)))
    return jctl, pctl


def _port(x, like=None):
    """A reference block / tree (numpy or jax) as tensors (bools kept)."""
    return type(x)(*(torch.tensor(np.asarray(v)) for v in x))


def _table(pc, jtable):
    from hermes_tpu_torch.core import state as st

    return st.KeyTable(*(st.with_drop_row(torch.tensor(np.asarray(v)))
                         for v in jtable))


def _eq_tree(a, b, where):
    """Compare reference and port outputs: NamedTuples of NamedTuples or
    of arrays."""
    if hasattr(a, "_fields") and a and hasattr(a[0], "_fields"):
        for f in a._fields:
            _eq_tree(getattr(a, f), getattr(b, f), f"{where}.{f}")
    else:
        assert_blocks_equal(jax.device_get(a), b, where)


def _rand_inv(rng, cfg, R, hostile=False, table_ver=None, epoch=0):
    """A seeded inbound INV block (R_dst, R_src, L): random lanes valid,
    keys in range (or hostile), timestamps around the tables'."""
    from hermes_tpu.core import state as jst

    L, K, V = cfg.n_lanes, cfg.n_keys, cfg.value_words
    blk = jax.device_get(jst.empty_invs(cfg, lead=(R, R)))
    key = rng.integers(0, K, (R, R, L))
    if hostile:
        bad = np.array([-1, -K, -K + 1, -K - 1, -K - 7, K, K + 3,
                        2 ** 31 - 1, -(2 ** 31)])
        pick = rng.random((R, R, L)) < 0.35
        key = np.where(pick, bad[rng.integers(0, len(bad), (R, R, L))], key)
    base = 0 if table_ver is None else int(np.asarray(table_ver).max())
    ver = rng.integers(0, base + 3, (R, R, L))
    if hostile:
        # the hostile lanes carry the highest timestamps and the others
        # beat every table row: a hostile key that reaches a scatter
        # (in JAX: one in [-K, 0), at K + key) shows on the table
        ver = np.where(pick, base + 10, rng.integers(base + 1, base + 3,
                                                     (R, R, L)))
    return blk._replace(
        valid=rng.random((R, R, L)) < 0.7,
        key=key.astype(np.int32),
        ver=ver.astype(np.int32),
        fc=((rng.integers(0, 2, (R, R, L)) << 8)
            | rng.integers(0, R, (R, R, L))).astype(np.int32),
        epoch=np.where(rng.random((R, R, L)) < 0.95, epoch, epoch + 1
                       ).astype(np.int32),
        val=rng.integers(-(2 ** 31), 2 ** 31, (R, R, L, V)).astype(np.int32),
        alive=rng.random((R, R)) < 0.8)


@pytest.mark.parametrize("stop", [4, 9, 15, 22])
def test_torch_phases_one_by_one_from_mid_run_state(stop):
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch.core import phases
    from hermes_tpu_torch.core import step as step_lib

    jc, pc, a = _mid_run(stop)
    jctl, pctl = _ctls(jc, pc, a)
    rs = jax.device_get(a.rs)
    if stop >= 9:  # the frozen replica's keys are being replayed
        assert np.asarray(rs.replay.active).any()
    ph = jstep.vmapped_phases(jc)
    stream = jax.tree.map(jnp.asarray, a.stream)
    pstream = type(a.stream)(
        op=torch.tensor(np.asarray(a.stream.op)),
        key=torch.tensor(np.asarray(a.stream.key)), uval=None)

    c = ph["coordinate"](jctl, rs.table, rs.sess, rs.replay, stream)
    pc_ = phases.coordinate(pc, pctl, _table(pc, rs.table), _port(rs.sess),
                            _port(rs.replay), pstream)
    _eq_tree(c, pc_, "coordinate")

    in_inv = jstep.lockstep_bcast(c.out_inv)
    a_ = ph["apply_inv"](jctl, c.table, c.sess, rs.meta, in_inv)
    pa = phases.apply_inv(pc, pctl, pc_.table, pc_.sess, _port(rs.meta),
                          step_lib.lockstep_bcast(pc_.out_inv))
    _eq_tree(a_, pa, "apply_inv")

    in_ack = jstep.lockstep_route_back(a_.out_ack)
    k = ph["collect_acks"](jctl, a_.table, a_.sess, c.replay, a_.meta, in_ack)
    pk = phases.collect_acks(pc, pctl, pa.table, pa.sess, pc_.replay, pa.meta,
                             step_lib.lockstep_route_back(pa.out_ack))
    _eq_tree(k, pk, "collect_acks")

    tv = ph["apply_val"](jctl, k.table, jstep.lockstep_bcast(k.out_val))
    pv = phases.apply_val(pc, pctl, pk.table,
                          step_lib.lockstep_bcast(pk.out_val))
    _eq_tree(tv, pv, "apply_val")

    m = phases.merge_completions(pc_.comp, pa.comp, pk.comp)
    from hermes_tpu.core import phases as jphases

    _eq_tree(jphases.merge_completions(c.comp, a_.comp, k.comp), m, "merge")


@pytest.mark.parametrize("hostile", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_phases_random_blocks_against_mid_run_tables(seed, hostile):
    """apply_inv, collect_acks and apply_val fed seeded random blocks (and
    hostile keys off the wire) against a mid-run state."""
    from hermes_tpu.core import step as jstep
    from hermes_tpu_torch.core import phases

    jc, pc, a = _mid_run(8 + seed)
    jctl, pctl = _ctls(jc, pc, a)
    rs = jax.device_get(a.rs)
    ph = jstep.vmapped_phases(jc)
    rng = np.random.default_rng(100 + seed)
    R, S, L = jc.n_replicas, jc.n_sessions, jc.n_lanes

    inv = _rand_inv(rng, jc, R, hostile, rs.table.ver, int(a.epoch[0]))
    want = ph["apply_inv"](jctl, rs.table, rs.sess, rs.meta,
                           jax.tree.map(jnp.asarray, inv))
    got = phases.apply_inv(pc, pctl, _table(pc, rs.table), _port(rs.sess),
                           _port(rs.meta), _port(inv))
    _eq_tree(want, got, "apply_inv")
    applied = np.asarray(want.table.ver) != np.asarray(rs.table.ver)
    assert applied.any(), "no INV of the block applied: a vacuous drive"

    # acks: echo the sessions' and replay slots' own (key, ts) on some
    # lanes (so quorums form), random or hostile elsewhere
    from hermes_tpu.core import state as jst

    ack = jax.device_get(jst.empty_acks(jc, lead=(R, R)))
    own_key = np.concatenate([rs.sess.key, rs.replay.key], 1)[:, None]
    own_ver = np.concatenate([rs.sess.ver, rs.replay.ver], 1)[:, None]
    own_fc = np.concatenate([rs.sess.fc, rs.replay.fc], 1)[:, None]
    echo = rng.random((R, R, L)) < 0.7
    rk = inv.key[:, :, :L]
    ack = ack._replace(
        valid=rng.random((R, R, L)) < 0.8,
        key=np.where(echo, own_key, rk).astype(np.int32),
        ver=np.where(echo, own_ver, inv.ver).astype(np.int32),
        fc=np.where(echo, own_fc, inv.fc).astype(np.int32),
        ok=rng.random((R, R, L)) < 0.85,
        epoch=np.where(rng.random((R, R, L)) < 0.95, a.epoch[0], 9
                       ).astype(np.int32))
    want = ph["collect_acks"](jctl, rs.table, rs.sess, rs.replay, rs.meta,
                              jax.tree.map(jnp.asarray, ack))
    got = phases.collect_acks(pc, pctl, _table(pc, rs.table), _port(rs.sess),
                              _port(rs.replay), _port(rs.meta), _port(ack))
    _eq_tree(want, got, "collect_acks")

    val = jax.device_get(jst.empty_vals(jc, lead=(R, R)))
    tk = rng.integers(0, jc.n_keys, (R, R, L))
    tver = np.take_along_axis(rs.table.ver, tk.reshape(R, -1), 1).reshape(
        R, R, L)
    tfc = np.take_along_axis(rs.table.fc, tk.reshape(R, -1), 1).reshape(
        R, R, L)
    key = np.where(rng.random((R, R, L)) < 0.3, inv.key, tk) if hostile \
        else tk
    val = val._replace(valid=rng.random((R, R, L)) < 0.8,
                       key=key.astype(np.int32), ver=tver.astype(np.int32),
                       fc=tfc.astype(np.int32),
                       epoch=np.full((R, R, L), a.epoch[0], np.int32))
    want = ph["apply_val"](jctl, rs.table, jax.tree.map(jnp.asarray, val))
    got = phases.apply_val(pc, pctl, _table(pc, rs.table), _port(val))
    _eq_tree(want, got, "apply_val")


def test_torch_coordinate_hostile_stream_keys():
    """Op-stream keys outside [0, K): JAX clamps the gathers (a negative
    key first counts from the end) and drops or re-targets the scatters;
    the port's coordinate must leave the same tables, sessions, replay
    slots and INV lanes."""
    from hermes_tpu.core import step as jstep
    from hermes_tpu.core import state as jst
    from hermes_tpu_torch.core import phases

    jc, pc, a = _mid_run(5)
    jctl, pctl = _ctls(jc, pc, a)
    rs = jax.device_get(a.rs)
    K = jc.n_keys
    rng = np.random.default_rng(7)
    op = np.asarray(a.stream.op).copy()
    op[op == 1] = 2  # more issues, fewer reads
    bad = np.array([-1, -3, -K, -K - 1, K, K + 9], np.int32)
    key = np.asarray(a.stream.key).copy()
    pick = rng.random(key.shape) < 0.5
    key = np.where(pick, bad[rng.integers(0, len(bad), key.shape)], key)
    stream = jst.OpStream(op=jnp.asarray(op), key=jnp.asarray(key))
    # idle every session so it loads from the hostile stream this round
    sess = rs.sess._replace(status=np.zeros_like(rs.sess.status))
    want = jstep.vmapped_phases(jc)["coordinate"](jctl, rs.table, sess,
                                                  rs.replay, stream)
    got = phases.coordinate(
        pc, pctl, _table(pc, rs.table), _port(sess), _port(rs.replay),
        type(a.stream)(op=torch.tensor(op), key=torch.tensor(key),
                       uval=None))
    _eq_tree(want, got, "coordinate")


@pytest.mark.parametrize("seed", range(4))
def test_torch_first_true_matches_nonzero_with_size(seed):
    from hermes_tpu_torch.core.phases import _first_true

    rng = np.random.default_rng(seed)
    for n, m, size, p in ((3, 50, 8, 0.1), (2, 7, 8, 0.5), (4, 64, 4, 0.9),
                          (2, 33, 5, 0.0), (1, 12, 12, 1.0)):
        x = rng.random((n, m)) < p
        for fill in (m, size, -1):
            want = np.stack([np.asarray(jnp.nonzero(jnp.asarray(r),
                                                    size=size,
                                                    fill_value=fill)[0])
                             for r in x])
            got = _first_true(torch.tensor(x), size, fill).numpy()
            np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", range(3))
def test_torch_masked_scatters_match_jax_drop_mode(seed):
    """``_set_`` (a table leaf with its drop row) and ``_set`` (a small
    block) against JAX's ``.at[]`` with ``mode="drop"``, and
    ``_reduce_at`` against the reference's ``_minscatter`` /
    ``_maxscatter`` read back at every key: masked rows, negative
    indices in [-K, 0), indices below -K and at or past K.  The set
    scatters' unmasked targets are distinct, as the phases make them;
    the arbiters take duplicates."""
    from hermes_tpu_torch.core import phases
    from hermes_tpu_torch.core import state as st

    rng = np.random.default_rng(seed)
    n, K, M, V = 3, 16, 10, 3
    bad = np.array([-1, -K, -K - 1, K, K + 4])
    arr = rng.integers(-50, 50, (n, K, V)).astype(np.int32)
    idx = np.stack([rng.permutation(np.concatenate([np.arange(K), bad]))[:M]
                    for _ in range(n)]).astype(np.int32)
    # distinct after JAX's wrap of [-K, 0): keep one of each wrapped pair
    for r in range(n):
        seen = set()
        for j in range(M):
            w = idx[r, j] + K if -K <= idx[r, j] < 0 else idx[r, j]
            if w in seen:
                idx[r, j] = K + 100
            seen.add(w)
    mask = rng.random((n, M)) < 0.7
    val = rng.integers(-50, 50, (n, M, V)).astype(np.int32)

    def jset(a, i, v, m):
        return jax.vmap(lambda a, i, v, m: a.at[jnp.where(m, i, a.shape[0])]
                        .set(v, mode="drop"))(a, i, v, m)

    want = np.asarray(jset(jnp.asarray(arr), jnp.asarray(idx),
                           jnp.asarray(val), jnp.asarray(mask)))
    t = st.with_drop_row(torch.tensor(arr))
    phases._set_(t, torch.tensor(idx), torch.tensor(val), torch.tensor(mask))
    np.testing.assert_array_equal(want, t.numpy())
    got = phases._set(torch.tensor(arr), torch.tensor(idx),
                      torch.tensor(val), torch.tensor(mask))
    np.testing.assert_array_equal(want, got.numpy())

    from hermes_tpu.core import phases as jphases

    v1 = rng.integers(-1000, 1000, (n, M)).astype(np.int32)
    didx = rng.choice(np.concatenate([np.arange(K), bad]), (n, M)
                      ).astype(np.int32)  # duplicates welcome
    # read back at every key and at the clipped hostile ones, the way the
    # phases read the arbiters (jnp.clip and JAX's gather index)
    at = np.concatenate([np.tile(np.arange(K), (n, 1)),
                         np.clip(didx, 0, K - 1),
                         np.where(didx < 0, didx + K, didx).clip(0, K - 1)],
                        1).astype(np.int32)
    for jf, how, fill in ((jphases._minscatter, "amin", phases.I32_MAX),
                          (jphases._maxscatter, "amax", phases.I32_MIN)):
        full = np.asarray(jax.vmap(lambda i, v, m: jf(K, i, v, m))(
            jnp.asarray(didx), jnp.asarray(v1), jnp.asarray(mask)))
        want = np.take_along_axis(full, at, 1)
        got = phases._reduce_at(K, torch.tensor(didx), torch.tensor(v1),
                                torch.tensor(mask), how, fill,
                                torch.tensor(at))
        np.testing.assert_array_equal(want, got.numpy())


def test_torch_timestamps_match_reference():
    from hermes_tpu.core import timestamps as jts
    from hermes_tpu_torch.core import timestamps as pts

    rng = np.random.default_rng(3)
    va, vb = (rng.integers(0, 4, 200).astype(np.int32) for _ in range(2))
    fa, fb = (rng.integers(0, 600, 200).astype(np.int32) for _ in range(2))
    for name in ("ts_gt", "ts_eq"):
        want = np.asarray(getattr(jts, name)(*(jnp.asarray(x)
                                                for x in (va, fa, vb, fb))))
        got = getattr(pts, name)(*(torch.tensor(x) for x in (va, fa, vb, fb)))
        np.testing.assert_array_equal(want, got.numpy())
    flag = rng.integers(0, 2, 50).astype(np.int32)
    cid = rng.integers(0, 255, 50).astype(np.int32)
    fc = pts.make_fc(torch.tensor(flag), torch.tensor(cid))
    np.testing.assert_array_equal(
        np.asarray(jts.make_fc(jnp.asarray(flag), jnp.asarray(cid))),
        fc.numpy())
    np.testing.assert_array_equal(pts.fc_cid(fc).numpy(), cid)


def test_torch_replica_state_converts_both_ways():
    """``convert.replica_state_from_numpy`` / ``_to_numpy`` round trip a
    reference mid-run state, the table leaves with their drop rows."""
    from hermes_tpu_torch import convert
    from hermes_tpu_torch.core import phases

    jc, pc, a = _mid_run(7)
    rs = jax.device_get(a.rs)
    port = convert.replica_state_from_numpy(pc, rs, "cpu")
    for leaf in port.table:
        phases._with_drop(leaf)  # raises without the drop row
    back = convert.replica_state_to_numpy(port)
    from torch_refpair import assert_states_equal

    assert_states_equal(rs, back, "round trip")
    with pytest.raises(ValueError, match="drop row"):
        phases._with_drop(torch.zeros((2, 4), dtype=torch.int32))
