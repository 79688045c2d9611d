"""The port's wire adversary (``hermes_tpu_torch/chaos/net.py``), its
block codec (``transport/codec.py``) and the ``ChaosRunner``'s wire and
legacy net carriers, against the JAX package's, bit for bit.

* The codec's block layer: ``pack`` of seeded Invs / Acks / Vals blocks
  gives the reference's bytes, ``unpack`` gives the blocks back, sizes
  agree.
* The interposer pair by pair (directed drop and partition, delay,
  duplicate, corrupt under CRC and without it, held frames dying in a
  blackout), each inbound block and fault log equal to the reference's.
* The sim engine under the wire matrix of
  ``tests/test_netchaos.py::test_sim_engine_wire_matrix_checked``: every
  round's state equal, ``fault_log_json`` byte-identical, the checker
  green, nothing applied past the CRC.
* ``crc=False``, the red path: scrambled frames (hostile keys among them)
  enter the protocol in both packages; every round's tables and
  completions stay equal.  XLA keeps a scrambled bool byte as it is and
  its operations disagree on it, torch makes it 0 or 1, so the reference
  side of this drive gets its bool fields made 0/1 on entry.
* The ``ChaosRunner`` on the sim engine: a partition/heal cycle through
  the detector, the legacy ``net_*`` verbs carried by the interposer or by
  a ``NetChaos`` installed as the ``SimTransport`` schedule, a seeded
  random schedule with wire verbs (executed logs byte-identical), and the
  refusals with the reference's own messages.
"""

import numpy as np
import pytest

from torch_refpair import (assert_ops_equal, assert_states_equal,
                           drain_both, lockstep, pair, port_state, ref_state,
                           tap)


def _cfg_sim(**kw):
    base = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=8,
                ops_per_session=10, replay_age=5,
                workload=dict(read_frac=0.5, rmw_frac=0.3, seed=5))
    base.update(kw)
    return pair(**base)


def _np(block):
    return type(block)(*(np.asarray(x) for x in block))


def _rand_block(kind, pc, rng, lead):
    from hermes_tpu_torch.core import state as st

    empty = {"inv": st.empty_invs, "ack": st.empty_acks,
             "val": st.empty_vals}[kind](pc, lead=lead)
    out = []
    for x in empty:
        x = x.numpy()
        if x.dtype == np.bool_:
            out.append(rng.random(x.shape) < 0.5)
        else:
            out.append(rng.integers(-(2 ** 31), 2 ** 31, x.shape)
                       .astype(np.int32))
    return type(empty)(*out)


@pytest.mark.parametrize("kind", ["inv", "ack", "val"])
def test_torch_codec_block_pack_matches_reference_bytes(kind):
    from hermes_tpu.core import state as jst
    from hermes_tpu.transport import codec as jcodec
    from hermes_tpu_torch.transport import codec

    jc, pc = _cfg_sim()
    rng = np.random.default_rng(len(kind))
    for lead in ((), (3,)):
        blk = _rand_block(kind, pc, rng, lead)
        jblk = type({"inv": jst.empty_invs(jc), "ack": jst.empty_acks(jc),
                     "val": jst.empty_vals(jc)}[kind])(*blk)
        raw = codec.pack(blk)
        np.testing.assert_array_equal(raw, jcodec.pack(jblk))
        assert codec.block_nbytes(blk) == jcodec.block_nbytes(jblk)
        assert codec.frame_nbytes(blk) == jcodec.frame_nbytes(jblk)
        back = codec.unpack(blk, raw)
        for x, y in zip(blk, back):
            np.testing.assert_array_equal(x, y)
        framed = codec.frame_pack(raw)
        np.testing.assert_array_equal(framed, jcodec.frame_pack(raw))
        np.testing.assert_array_equal(codec.frame_unpack(framed), raw)
        with pytest.raises(ValueError, match="wire size"):
            codec.unpack(blk, raw[:-1])
    st = codec.stack([blk, blk])
    assert st[0].shape == (2,) + blk[0].shape


def _inv_block(cfg, key=7, lead=3, torch_side=False):
    if torch_side:
        from hermes_tpu_torch.core import state as st

        out = _np(st.empty_invs(cfg, lead=(lead,)))
    else:
        import jax

        from hermes_tpu.core import state as jst

        out = jax.device_get(jst.empty_invs(cfg, lead=(lead,)))
    return out._replace(valid=np.ones_like(np.asarray(out.valid)),
                        key=np.full_like(np.asarray(out.key), key),
                        alive=np.ones_like(np.asarray(out.alive)))


def _both(seed=1, crc=True):
    from hermes_tpu.chaos.net import FaultingTransport as JF
    from hermes_tpu.transport.base import LockstepHostTransport as JL
    from hermes_tpu_torch.chaos.net import FaultingTransport as PF
    from hermes_tpu_torch.transport.base import LockstepHostTransport as PL

    return (JF(JL(), 3, seed=seed, crc=crc), PF(PL(), 3, seed=seed, crc=crc))


def _same(jw, pw, calls):
    """Apply the same exchange calls to both interposers; every inbound
    block, the counters and the fault log must agree."""
    for kind, blk, step in calls:
        a = getattr(jw, f"exchange_{kind}")(blk[0], step)
        b = getattr(pw, f"exchange_{kind}")(blk[1], step)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert jw.pending() == pw.pending()
    assert dict(jw.counters) == dict(pw.counters)
    assert jw.fault_log_json() == pw.fault_log_json()
    return b


def test_torch_wire_pairs_match_reference():
    jc, pc = _cfg_sim()
    blk = (_inv_block(jc), _inv_block(pc, torch_side=True))
    empty = (_inv_block(jc)._replace(valid=np.zeros((3, pc.n_lanes), bool),
                                     alive=np.zeros(3, bool)),) * 2
    # directed drop and partition
    jw, pw = _both()
    for w in (jw, pw):
        w.add("drop", 0, 2, 0, 10)
        w.add("partition", 1, -1, 0, 10)
    inb = _same(jw, pw, [("inv", blk, 0)])
    assert not np.asarray(inb.valid)[2, 0].any()
    assert not np.asarray(inb.valid)[0, 1].any()
    # delay holds and redelivers
    jw, pw = _both()
    for w in (jw, pw):
        w.add("delay", 0, 1, 0, 1, param=3)
    inb = _same(jw, pw, [("inv", blk, 0), ("val", empty, 3),
                         ("inv", empty, 3)])
    assert np.asarray(inb.valid)[1, 0].any()
    # dup, then corrupt under CRC and without it
    jw, pw = _both(seed=2)
    for w in (jw, pw):
        w.add("dup", 0, 1, 0, 4)
    _same(jw, pw, [("inv", blk, 0), ("inv", empty, 1), ("inv", empty, 2)])
    for crc in (True, False):
        jw, pw = _both(seed=3, crc=crc)
        for w in (jw, pw):
            w.add("corrupt", 0, 1, 0, 4)
        _same(jw, pw, [("inv", blk, s) for s in range(3)])
        assert pw.counters.get("wire_corrupt_applied", 0) == (0 if crc else 3)
    # held frames die in a blackout
    jw, pw = _both()
    for w in (jw, pw):
        w.add("delay", 0, 1, 0, 1, param=3)
        w.add("partition", 0, 1, 2, 10)
    _same(jw, pw, [("inv", blk, 0), ("inv", empty, 3)])
    assert pw.pending() == 0
    assert any(f.get("held") == "dropped_in_blackout" for f in pw.fault_log)
    with pytest.raises(ValueError, match="unknown wire fault"):
        pw.add("bogus", 0, 1, 0, 1)


WIRE_MATRIX = (("drop", 0, 2, 2, 12, 0), ("delay", 1, -1, 4, 16, 2),
               ("dup", 2, -1, 6, 14, 0), ("reorder", 0, 1, 3, 18, 3),
               ("corrupt", 2, 0, 5, 15, 0))


def _wired_pair(jc, pc, seed, windows=WIRE_MATRIX, crc=True, canon=False):
    """Both packages' sim runtimes, each over FaultingTransport(
    SimTransport) with the same windows."""
    from hermes_tpu.chaos.net import FaultingTransport as JF
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu.transport.sim import SimTransport as JS
    from hermes_tpu_torch.chaos.net import FaultingTransport as PF
    from hermes_tpu_torch.runtime import Runtime as PR
    from hermes_tpu_torch.transport.sim import SimTransport as PS

    R = jc.n_replicas
    jw = JF(JS(R), R, seed=seed, crc=crc)
    pw = PF(PS(R), R, seed=seed, crc=crc)
    for w in (jw, pw):
        for op, src, dst, lo, hi, param in windows:
            w.add(op, src, dst, lo, hi, param)
    a = JR(jc, backend="sim", record=True,
           transport=_Canonical(jw) if canon else jw)
    b = PR(pc, backend="sim", record=True, transport=_Spy(pw), device="cpu")
    return jw, pw, a, b


class _Canonical:
    """The reference's inbound blocks with every bool byte made 0/1 (what
    torch does to the port's on entry)."""

    def __init__(self, inner):
        self.inner = inner

    def _fix(self, blk):
        return blk._replace(**{
            f: (np.asarray(v).view(np.uint8) != 0
                if np.asarray(v).dtype == np.bool_ else v)
            for f, v in blk._asdict().items()})

    def exchange_inv(self, out, step):
        return self._fix(self.inner.exchange_inv(out, step))

    def exchange_ack(self, out, step):
        return self._fix(self.inner.exchange_ack(out, step))

    def exchange_val(self, out, step):
        return self._fix(self.inner.exchange_val(out, step))

    def pending(self):
        return self.inner.pending()


class _Spy(_Canonical):
    """Records the range of the keys that arrive in valid lanes."""

    def __init__(self, inner):
        super().__init__(inner)
        self.keys = []

    def _fix(self, blk):
        v = np.asarray(blk.valid).view(np.uint8) != 0
        self.keys.extend(np.asarray(blk.key)[v].tolist())
        return blk


def test_torch_sim_engine_wire_matrix_checked():
    jc, pc = _cfg_sim()
    jw, pw, a, b = _wired_pair(jc, pc, seed=7)
    comps = (tap(a), tap(b))
    lockstep(20, a, b, comps=comps)
    drain_both(a, b, comps)
    assert_states_equal(ref_state(a), port_state(b), "drained")
    assert jw.fault_log_json() == pw.fault_log_json()
    assert_ops_equal(a.history_ops(), b.history_ops())
    assert a.check().ok
    v = b.check()
    assert v.ok, (v.failures[:2], v.undecided[:2])
    c = pw.counters
    for op in ("drop", "delay", "dup", "reorder", "corrupt"):
        assert c.get(f"wire_{op}", 0) > 0, dict(c)
    assert c["wire_corrupt_dropped"] == c["wire_corrupt"]
    assert c.get("wire_corrupt_applied", 0) == 0


def test_torch_crc_off_red_path_hostile_keys_match_reference():
    """Without the CRC the scrambled frames are applied: keys off the wire
    go negative or past K.  Both packages must still agree every round
    (the protocol's answer to garbage is not checked here: it is the red
    path)."""
    jc, pc = _cfg_sim(n_keys=32, ops_per_session=16)
    windows = (("corrupt", 0, 1, 1, 30, 0), ("corrupt", 2, -1, 3, 30, 0),
               ("corrupt", 1, 2, 2, 30, 0))
    jw, pw, a, b = _wired_pair(jc, pc, seed=11, windows=windows, crc=False,
                               canon=True)
    comps = (tap(a), tap(b))
    lockstep(36, a, b, comps=comps)
    assert jw.fault_log_json() == pw.fault_log_json()
    assert pw.counters["wire_corrupt_applied"] > 0
    keys = np.array(b.transport.keys)
    assert ((keys < 0) | (keys >= pc.n_keys)).any(), "no hostile key arrived"


def test_torch_partition_heal_cycle_through_chaos_runner():
    from hermes_tpu import chaos as jchaos
    from hermes_tpu.membership import MembershipService as JM
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.membership import MembershipService as PM

    jc, pc = _cfg_sim(n_replicas=4, n_sessions=4, ops_per_session=12,
                      lease_steps=5)
    jw, pw, a, b = _wired_pair(jc, pc, seed=5, windows=())
    a.attach_membership(JM(jc, confirm_steps=2))
    b.attach_membership(PM(pc, confirm_steps=2))
    text = "@5 partition 2 until=30\n@34 heal\n"
    ra = jchaos.ChaosRunner(a, jchaos.Schedule.parse(text), wire=jw)
    rb = chaos.ChaosRunner(b, chaos.Schedule.parse(text), wire=pw)
    res_a = ra.run(60, check=True)
    res_b = rb.run(60, check=True)
    assert res_b["drained"] and res_b["checked_ok"], res_b
    assert ra.log_json() == rb.log_json()
    assert jw.fault_log_json() == pw.fault_log_json()
    assert_states_equal(ref_state(a), port_state(b), "healed")
    kinds = [(e.kind, e.replica) for e in b.membership.events]
    assert kinds == [(e.kind, e.replica) for e in a.membership.events]
    assert ("remove", 2) in kinds and ("join", 2) in kinds, kinds
    assert res_a["checked_ok"]


@pytest.mark.parametrize("carrier", ["wire", "net"])
def test_torch_legacy_net_verbs_carried(carrier):
    """net_drop / net_delay / net_dup on the sim engine: through the
    interposer (``wire=``) or a NetChaos installed as the SimTransport's
    schedule (``net=``)."""
    from hermes_tpu import chaos as jchaos
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu.transport.sim import SimTransport as JS
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.runtime import Runtime as PR
    from hermes_tpu_torch.transport.sim import SimTransport as PS

    jc, pc = _cfg_sim()
    text = ("@2 net_drop 0 dst=2 until=12\n@4 net_delay 1 dst=0 until=14 "
            "skew=2\n@5 net_dup 2 until=15\n")
    if carrier == "wire":
        jw, pw, a, b = _wired_pair(jc, pc, seed=4, windows=())
        kw_a, kw_b = dict(wire=jw), dict(wire=pw)
    else:
        jn, pn = jchaos.NetChaos(), chaos.NetChaos()
        a = JR(jc, backend="sim", record=True, transport=JS(3, jn))
        b = PR(pc, backend="sim", record=True, transport=PS(3, pn),
               device="cpu")
        kw_a, kw_b = dict(net=jn), dict(net=pn)
    ra = jchaos.ChaosRunner(a, jchaos.Schedule.parse(text), **kw_a)
    rb = chaos.ChaosRunner(b, chaos.Schedule.parse(text), **kw_b)
    res_a, res_b = ra.run(30, check=True), rb.run(30, check=True)
    assert res_b["drained"] and res_b["checked_ok"], res_b
    assert res_a["checked_ok"]
    assert ra.log_json() == rb.log_json()
    assert_states_equal(ref_state(a), port_state(b), "after")
    assert_ops_equal(a.history_ops(), b.history_ops())
    if carrier == "wire":
        assert pw.counters["wire_drop"] > 0
        assert jw.fault_log_json() == pw.fault_log_json()


def test_torch_random_wire_schedule_replays_byte_identically():
    """A seeded ``Schedule.random`` with wire and partition verbs (and the
    crash-restarts the phases runtime skips) through ``wire=`` on the sim
    engine: executed logs, fault logs and tables equal to the
    reference's."""
    from hermes_tpu import chaos as jchaos
    from hermes_tpu.membership import MembershipService as JM
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.membership import MembershipService as PM

    jc, pc = _cfg_sim(n_replicas=4, ops_per_session=16, lease_steps=6)
    spec = dict(p_wire=0.15, p_partition=0.03, p_crash=0.05)
    js = jchaos.Schedule.random(jc, 9, 40, spec=jchaos.ChaosSpec(**spec))
    ps = chaos.Schedule.random(pc, 9, 40, spec=chaos.ChaosSpec(**spec))
    assert js.format() == ps.format()
    kinds = {e.kind for e in ps}
    assert kinds & set(chaos.schedule.WIRE_EVENTS), kinds
    jw, pw, a, b = _wired_pair(jc, pc, seed=9, windows=())
    a.attach_membership(JM(jc, confirm_steps=2))
    b.attach_membership(PM(pc, confirm_steps=2))
    ra = jchaos.ChaosRunner(a, js, spec=jchaos.ChaosSpec(**spec), wire=jw)
    rb = chaos.ChaosRunner(b, ps, spec=chaos.ChaosSpec(**spec), wire=pw)
    res_a, res_b = ra.run(40, check=True), rb.run(40, check=True)
    assert ra.log_json() == rb.log_json()
    assert jw.fault_log_json() == pw.fault_log_json()
    assert_states_equal(ref_state(a), port_state(b), "after")
    assert res_b["drained"] and res_b["checked_ok"], res_b
    assert res_a["checked_ok"]


def test_torch_runner_refusals_match_reference_messages():
    """Schedule verbs without a carrier are refused at construction with
    the reference's messages: wire verbs without ``wire=``, legacy net_*
    without ``net=``/``wire=``, overload without a load shaper, powercut
    without a kill carrier; with their carriers the wire verbs are
    accepted."""
    from hermes_tpu import chaos as jchaos
    from hermes_tpu.runtime import Runtime as JR
    from hermes_tpu.transport.sim import SimTransport as JS
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.runtime import Runtime as PR
    from hermes_tpu_torch.transport.sim import SimTransport as PS

    jc, pc = _cfg_sim()
    texts = ("@4 netdrop 0 dst=2 until=24\n",
             "@4 net_drop 0 dst=2 until=24\n",
             "@4 overload x=3 until=9\n",
             "@4 powercut\n",
             "@4 partition 1 until=20\n")
    for text in texts:
        msgs = []
        for mod, rt in ((jchaos, JR(jc, backend="sim", transport=JS(3))),
                        (chaos, PR(pc, backend="sim", transport=PS(3),
                                   device="cpu"))):
            with pytest.raises(ValueError) as e:
                mod.ChaosRunner(rt, mod.Schedule.parse(text))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], text
        assert "SimTransport" in msgs[1] or "carrier" in msgs[1] \
            or "shaper" in msgs[1]
    _jw, pw, _a, b = _wired_pair(jc, pc, seed=1, windows=())
    for text in (texts[0], texts[1], texts[4]):
        chaos.ChaosRunner(b, chaos.Schedule.parse(text), wire=pw)
    with pytest.raises(ValueError, match="load shaper"):
        chaos.ChaosRunner(b, chaos.Schedule.parse(texts[2]), wire=pw)
    with pytest.raises(ValueError, match="kill"):
        chaos.ChaosRunner(b, chaos.Schedule.parse(texts[3]), wire=pw)
