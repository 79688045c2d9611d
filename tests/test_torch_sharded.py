"""The port's sharded engine (hermes_tpu_torch/core/faststep.py
``fast_round_sharded``, ``FastRuntime(backend="sharded")`` on a
``LocalGroup``) against the JAX sharded engine (``FastRuntime(backend=
"sharded", mesh=...)`` over the eight CPU devices tests/conftest.py
forces), round by round.

After every round: every replica's table copy (vpts and bank bytes, in
the reference's ``(R*K,)`` rows — the port's per-copy drop rows cut),
sessions, replay slots, Meta and the Completions are equal.  Tolerance:
exact (all state is integer).  Without faults every copy is identical,
so a read of the wrong copy would pass unseen: every drive here has a
window where the copies differ, and asserts that they did.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hermes_tpu.config import HermesConfig as RefConfig, WorkloadConfig as RefWL
from hermes_tpu.core import faststep as ref_fst
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import convert
from hermes_tpu_torch.config import HermesConfig
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.core.group import LocalGroup
from hermes_tpu_torch.runtime import FastRuntime

torch.set_num_threads(1)
CPU = torch.device("cpu")


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("replica",))


def port_cfg(rc):
    return HermesConfig(**dataclasses.asdict(rc))


def assert_state_equal(ref_fs, fs, n, what):
    """Every leaf of the reference's sharded FastState equal to the
    port's, the port's table in the reference's (n*K,) rows."""
    ref = jax.device_get(ref_fs)
    got = convert.fast_state_to_numpy(fs, n_copies=n)
    for part in ("table", "sess", "replay", "meta"):
        a, b = getattr(ref, part), getattr(got, part)
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.shape == y.shape, f"{what} {part}.{f} shape"
            if not np.array_equal(x, y):
                bad = np.argwhere(x != y)
                raise AssertionError(f"{what} {part}.{f}: {len(bad)} differ, "
                                     f"first at {bad[0].tolist()}")


def assert_comp_equal(rc, pc, what):
    if rc is None:
        assert pc is None, what
        return
    rc = rc if isinstance(rc, tuple) and not hasattr(rc, "_fields") else (rc,)
    pc = pc if isinstance(pc, tuple) and not hasattr(pc, "_fields") else (pc,)
    assert len(rc) == len(pc), what
    for a, b in zip(rc, pc):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"{what} comp.{f}")


def copies_differ(rt) -> bool:
    K = rt.cfg.n_keys
    v = fst.copies(rt.fs.table.bank, K)
    return not bool((v == v[0]).all())


class Pair:
    """The same sharded run in both packages, stepped together."""

    def __init__(self, rc, record=True):
        self.rc, self.pc = rc, port_cfg(rc)
        self.n = rc.n_replicas
        self.ref = RefRuntime(rc, backend="sharded", mesh=mesh_of(self.n),
                              record=record)
        self.rt = FastRuntime(self.pc, backend="sharded",
                              group=LocalGroup(CPU), record=record)
        self.differed = False
        self.check_state("init")

    def check_state(self, what):
        assert_state_equal(self.ref.fs, self.rt.fs, self.n, what)

    def both(self, name, *args):
        jax.block_until_ready(self.ref.fs)  # host rows are rewritten next
        out = getattr(self.ref, name)(*args), getattr(self.rt, name)(*args)
        self.check_state(f"after {name}{args}")
        return out

    def step(self, s):
        rcomp = self.ref.step_once()
        pcomp = self.rt.step_once()
        self.check_state(f"round {s}")
        assert_comp_equal(rcomp, pcomp, f"round {s}")
        self.differed |= copies_differ(self.rt)

    def drain(self, s, limit=400):
        """Step both, round by round, until every live unfrozen session
        finished its stream and nothing is in flight; returns the round."""
        rt = self.rt
        while rt._inflight_count() or int(fst.pending_sessions(
                rt.fs.sess.status, rt._ctl().live_mask, rt._ctl().frozen)):
            self.step(s)
            s += 1
            assert s < limit, "the drive did not drain"
        return s


VARIANTS = {
    "plain": dict(n_replicas=8, n_keys=64, n_sessions=4, replay_slots=4,
                  ops_per_session=8, replay_age=3, replay_scan_every=2,
                  workload=RefWL(read_frac=0.5, rmw_frac=0.3, seed=37)),
    "chained": dict(n_replicas=8, n_keys=32, n_sessions=6, replay_slots=4,
                    ops_per_session=8, arb_mode="sort", chain_writes=4,
                    replay_age=3, replay_scan_every=2,
                    workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=41)),
    "tiebreak": dict(n_replicas=8, n_keys=8, n_sessions=8, replay_slots=4,
                     ops_per_session=10, arb_mode="sort", chain_writes=2,
                     lane_budget_cfg=6, rebroadcast_every=2, replay_age=3,
                     replay_scan_every=2,
                     workload=RefWL(read_frac=0.2, rmw_frac=0.2, seed=47)),
    "mega": dict(n_replicas=8, n_keys=32, n_sessions=6, replay_slots=4,
                 ops_per_session=8, arb_mode="sort", chain_writes=2,
                 replay_age=3, replay_scan_every=2, rebroadcast_every=2,
                 mega_round=True,
                 workload=RefWL(read_frac=0.3, rmw_frac=0.2, seed=7)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_torch_sharded_round_identical_to_reference(variant):
    """The three variants of tests/test_faststep.py's sharded test and the
    mega round, through a freeze window: replica 3 frozen for rounds
    4-13 misses the writes of the others, its copy goes stale and the
    replay scan takes its stuck keys; after the thaw everything drains.
    Round by round equal, the copies differ in the window, the port's
    history checks."""
    p = Pair(RefConfig(**VARIANTS[variant]))
    for s in range(30):
        if s == 4:
            p.both("freeze", 3)
        if s == 14:
            p.both("thaw", 3)
        p.step(s)
    assert p.differed, "the copies never differed: the drive is vacuous"
    assert int(p.rt.fs.meta.replay_peak.max()) > 0
    p.drain(30)
    ca, cb = p.ref.counters(), p.rt.counters()
    for k in ("n_read", "n_write", "n_rmw", "n_abort"):
        assert int(ca[k]) == int(cb[k]), k
    assert p.rt.check().ok


def test_torch_sharded_remove_join_identical_to_reference():
    """Replica 2 freezes: its peers' writes stall on its ack and the
    replay scan re-stamps the stuck keys REPLAY in every copy but its own
    (a frozen replica still applies inbound INVs, so that is how copies
    part in this model).  remove(2) bumps the epoch and the stalled writes
    commit without it; join(2, from_replica=0) transfers replica 0's copy
    with REPLAY folded to INVALID and every row re-stamped at the join's
    step.  Equal round by round and after each membership call, and the
    copies differ both before and after the join."""
    rc = RefConfig(n_replicas=4, n_keys=64, n_sessions=6, replay_slots=8,
                   ops_per_session=12, replay_age=2, replay_scan_every=2,
                   arb_mode="sort", chain_writes=2,
                   workload=RefWL(read_frac=0.3, seed=36))
    p = Pair(rc)
    for s in range(40):
        if s == 2:
            p.both("freeze", 2)
        if s == 10:
            assert p.differed, "the frozen copy never parted from the others"
            p.both("remove", 2)
        if s == 20:
            p.both("join", 2, 0)
            assert copies_differ(p.rt), "the join re-stamped nothing"
        p.step(s)
    p.drain(40, limit=1500)
    assert p.rt.check().ok


def test_torch_sharded_rebase_vetoed_by_stale_copy():
    """The rebase's uniformity veto over the group
    (tests/test_faststep.py::test_sharded_rebase_nonuniform_keys_vetoed):
    after a drain, copy 7 of the hottest key is made stale in both
    packages (a frozen replica still applies inbound INVs, so the stall
    model cannot part the copies' versions by itself); ``rebase_versions``
    must veto that key on every copy and rebase the agreed ones, with the
    same state and per-key deltas as the reference."""
    rc = RefConfig(n_replicas=8, n_keys=64, n_sessions=4, replay_slots=4,
                   ops_per_session=8,
                   workload=RefWL(read_frac=0.2, seed=25))
    p = Pair(rc, record=False)
    p.drain(0, limit=300)
    K = rc.n_keys
    pre = fst.pts_ver(fst.copies(p.rt.fs.table.vpts, K)).clone()
    hot = int(torch.argmax(pre[0]))
    assert int(pre[0, hot]) > 1
    stale = int(fst.pack_pts(1, 3))
    vref = np.asarray(jax.device_get(p.ref.fs.table.vpts)).copy()
    vref[7 * K + hot] = stale
    from jax.sharding import NamedSharding, PartitionSpec as P
    p.ref.fs = p.ref.fs._replace(table=p.ref.fs.table._replace(
        vpts=jax.device_put(jnp.asarray(vref),
                            NamedSharding(p.ref.mesh, P("replica")))))
    fst.copies(p.rt.fs.table.vpts, K)[7, hot] = stale
    assert int((fst.copies(p.rt.fs.table.vpts, K)
                != fst.copies(p.rt.fs.table.vpts, K)[0]).sum()) == 1
    n_ref = p.ref.rebase_versions(max_quiesce_rounds=8)
    n = p.rt.rebase_versions(max_quiesce_rounds=8)
    assert n == n_ref and n > 0
    p.check_state("rebased")
    np.testing.assert_array_equal(np.asarray(p.ref._ver_base),
                                  p.rt._ver_base)
    ver = fst.pts_ver(fst.copies(p.rt.fs.table.vpts, K))
    assert int(ver[0, hot]) == int(pre[0, hot])  # vetoed everywhere
    assert int(ver[7, hot]) == 1  # the stale copy as made
    agreed = pre[0] > 1
    agreed[hot] = False
    assert bool(agreed.any()) and bool((ver[0][agreed] == 1).all())


def _part_copy_3(p, keys, step):
    """Make replica 3's copy of ``keys`` differ in both packages: each row
    INVALID since ``step`` (stuck for the replay scan) with its vpts
    raised past every other copy's (a verdict no other copy gives)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    K = p.pc.n_keys
    jax.block_until_ready(p.ref.fs)
    vref = np.asarray(jax.device_get(p.ref.fs.table.vpts)).copy()
    bref = np.asarray(jax.device_get(p.ref.fs.table.bank)).copy()
    vk = fst.copies(p.rt.fs.table.vpts, K)
    bk = fst.copies(p.rt.fs.table.bank, K)
    for k in keys:
        pts = int(vk[3, k]) + (5 << fst.PTS_FC_BITS)
        rows32 = fst._bank_to_i32(bk[3, k])
        rows32[fst.BANK_PTS] = pts
        rows32[fst.BANK_SST] = int(fst.pack_sst(step, 1))  # INVALID
        row8 = fst._i32_to_bank(rows32[None])[0]
        vk[3, k], bk[3, k] = pts, row8
        vref[3 * K + k], bref[3 * K + k] = pts, row8.numpy()
    sh = NamedSharding(p.ref.mesh, P("replica"))
    p.ref.fs = p.ref.fs._replace(table=p.ref.fs.table._replace(
        vpts=jax.device_put(jnp.asarray(vref), sh),
        bank=jax.device_put(jnp.asarray(bref), sh)))
    p.check_state("copy 3 parted")


def test_torch_sharded_parted_copy_identical_to_reference():
    """Rows that differ in one copy only (INVALID and ahead in replica 3's
    copy, made by hand in both packages as the reference's own veto test
    makes its stale copy): replica 3's reads of them stall while the other
    replicas read theirs, its replay scan takes them while the others' do
    not, and its verdicts on INVs of those keys differ from the other
    copies'.  Round by round equal: every per-copy row offset (the
    coordinate reads, the replay scan, the apply's joint gather, the
    winner write) is exercised where the copies disagree."""
    import dataclasses as dc

    from hermes_tpu_torch.core import types as t

    assert t.INVALID == 1
    rc = dc.replace(RefConfig(**VARIANTS["chained"]), replay_age=2,
                    ops_per_session=16)
    p = Pair(rc, record=False)
    for s in range(4):
        p.step(s)
    _part_copy_3(p, keys=range(0, p.pc.n_keys, 3), step=1)
    for s in range(4, 24):
        p.step(s)
    assert int(p.rt.fs.replay.active[3].sum()) > 0 or int(
        p.rt.fs.meta.replay_peak[3]) > 0


def test_torch_sharded_equals_batched_after_healthy_drain():
    """Without faults the sharded engine converges to the batched one: the
    same issued timestamps, and every drained copy equal to the batched
    table (tests/test_faststep.py::test_sharded_matches_batched)."""
    cfg = port_cfg(RefConfig(**VARIANTS["chained"]))
    a = FastRuntime(cfg, backend="batched", device="cpu", record=True)
    b = FastRuntime(cfg, backend="sharded", group=LocalGroup(CPU))
    assert a.drain(300) and b.drain(300)
    torch.testing.assert_close(a.fs.sess.pts, b.fs.sess.pts, rtol=0, atol=0)
    K = cfg.n_keys
    bank_b = fst.copies(b.fs.table.bank, K)
    for r in range(cfg.n_replicas):
        assert torch.equal(bank_b[r], a.fs.table.bank[:K]), r
        assert torch.equal(fst.copies(b.fs.table.vpts, K)[r],
                           a.fs.table.vpts[:K]), r
    ca, cb = a.counters(), b.counters()
    for k in ("n_read", "n_write", "n_rmw", "n_abort"):
        assert ca[k] == cb[k], k
    assert int(ca["n_write"] + ca["n_rmw"]) > 0
    assert a.check().ok


def _hostile_block(rc, K, seed):
    """An INV block of 3 sources x 4 slots whose only valid slots carry
    the wire keys ``K + 5`` (above the table, with the newer ts) and
    ``K - 1``, and whose other slots are invalid; returned in both
    packages."""
    rng = np.random.default_rng(seed)
    R, C, V = 3, 4, rc.value_words
    key = rng.integers(0, K, (R, C), dtype=np.int32)
    valid = np.zeros((R, C), bool)
    key[0, 1], valid[0, 1] = K + 5, True
    key[2, 3], valid[2, 3] = K - 1, True
    pts = np.full((R, C), (7 << 10) | (1 << 8) | 1, np.int32)
    pts[0, 1] = (9 << 10) | (1 << 8)  # newer: it would win K-1 if it landed
    pkf = (key | np.where(valid, fst.INV_VALID | fst.INV_FRESH, 0)
           ).astype(np.int32)
    head = np.asarray(ref_fst._i32_to_bank(jnp.asarray(
        np.stack([pkf, pts], axis=-1))))
    val = rng.integers(-128, 128, (R, C, 4 * V), dtype=np.int8)
    rows8 = np.concatenate([head, val], axis=-1)
    meta = np.array([1, 1, 1], np.int32)  # epoch 0, alive
    bits = np.ones((R, C), bool)
    return (ref_fst.FastInv(rows8=jnp.asarray(rows8), meta=jnp.asarray(meta)),
            fst.FastInv(rows8=torch.from_numpy(rows8),
                        meta=torch.from_numpy(meta)), bits)


@pytest.mark.parametrize("mega", [False, True], ids=["scatter", "mega"])
def test_torch_sharded_hostile_wire_key_drops_in_its_own_copy(mega,
                                                              monkeypatch):
    """A valid INV slot whose wire key is at or above K drops from every
    copy's scatter (never offset into the next copy) and reads K-1 of its
    own copy; the legal slot lands.  Per copy equal to the reference's
    ``_apply_inv`` / ``_apply_commit`` on that copy; the rows next to
    each copy boundary and every drop row are untouched.  Both branches
    of ``_apply_inv``: the scatter-max and gather, and the one
    ``mega_apply`` launch over the flat table with its own mask."""
    rc = RefConfig(n_replicas=3, n_keys=16, n_sessions=4, replay_slots=2,
                   ops_per_session=4, arb_mode="sort", mega_round=mega)
    pc = port_cfg(rc)
    assert pc.use_mega_round == mega and rc.use_mega_round == mega
    calls = []
    apply = fst.megaround.mega_apply
    monkeypatch.setattr(fst.megaround, "mega_apply",
                        lambda *a, **kw: calls.append(1) or apply(*a, **kw))
    K, R = rc.n_keys, 3
    ref_inv, inv, bits = _hostile_block(rc, K, seed=5)
    fs = fst.init_fast_state(pc, CPU, n_copies=R)
    before = fs.table.bank.clone(), fs.table.vpts.clone()
    base = fst._copy_base(R, K, CPU)
    ctl = fst.make_fast_ctl(pc, 9, CPU)
    fs, ack, win0, _rp = fst._apply_inv(pc, ctl, fs, inv, fs.replay.key,
                                        base)
    fs = fst._apply_commit(pc, ctl, fs, inv, win0, torch.from_numpy(bits),
                           inv.epoch, base)
    ref0 = ref_fst.init_fast_state(rc, n_local=1)
    rctl = ref_fst.make_fast_ctl(rc, 9)
    rctl = rctl._replace(my_cid=rctl.my_cid[:1], epoch=rctl.epoch[:1],
                         live_mask=rctl.live_mask[:1],
                         frozen=rctl.frozen[:1])
    one = lambda tree: jax.tree.map(lambda x: x[:1], tree)
    ref0 = ref0._replace(sess=one(ref0.sess), replay=one(ref0.replay),
                         meta=one(ref0.meta))
    rfs, rack, rwin0, _ = ref_fst._apply_inv(rc, rctl, ref0, ref_inv,
                                             ref0.replay.key)
    rfs = ref_fst._apply_commit(rc, rctl, rfs, ref_inv, rwin0,
                                jnp.asarray(bits), ref_inv.epoch)
    assert len(calls) == int(mega)
    want_v = np.asarray(rfs.table.vpts)
    want_b = np.asarray(rfs.table.bank)
    for r in range(R):
        np.testing.assert_array_equal(fst.copies(fs.table.vpts, K)[r].numpy(),
                                      want_v)
        np.testing.assert_array_equal(fst.copies(fs.table.bank, K)[r].numpy(),
                                      want_b)
        np.testing.assert_array_equal(ack[r].numpy(), np.asarray(rack))
    # the legal slot landed in every copy; of the key rows only K-1
    # changed (the hostile key reached no row: row 0 of the next copy is
    # as it was; masked rows land on each copy's own drop row)
    assert int(fst.copies(fs.table.vpts, K)[1, K - 1]) == int(inv.pts[2, 3])
    for col, old in ((fs.table.bank, before[0]), (fs.table.vpts, before[1])):
        changed = (fst.copies(col, K) != fst.copies(old, K))
        if changed.dim() == 3:
            changed = changed.any(dim=2)
        assert torch.nonzero(changed).tolist() == [[r, K - 1]
                                                  for r in range(R)]
