"""The netchaos gate, the port's ``scripts/check_netchaos.py``: the wire
adversary, the CRC'd frame and partition tolerance hold their contracts.

  1. ``check_wire_matrix`` -- a seeded program of drop, duplicate,
     reorder, delay, corrupt and asymmetric-partition windows
     (``chaos.FaultingTransport``) with freezes, on the phases engine's
     ``sim`` backend with the failure detector attached, over a
     ``SimTransport`` and over a ``LockstepHostTransport``: the checker
     green, every fault class fired, the partitioned replica ejected and
     rejoined, and no corrupted frame applied (the CRC made each a drop);
  2. ``check_determinism`` -- the same seed and config replay the runner's
     log, the wire's fault log and the final state byte for byte;
  3. ``check_crc_red`` -- ``codec.frame_unpack`` refuses a flipped byte;
     through the interposer a corrupted frame arrives as a drop with the
     CRC and as scrambled bytes without it;
  4. ``check_partition_fast`` -- a KVS at depth 2 on both fast engines
     under a partition and heal with the detector attached: every future
     resolves (bounded retry re-routes ops wedged on the ejected
     replica), the checker passes, no ``membership_fetch``, and
     ``committed_write_lost == []``.

    python -m hermes_tpu_torch.checks.netchaos [--device cpu] [--out FILE]
"""

from __future__ import annotations

import sys

from hermes_tpu_torch import checks

SEED = 31
STEPS = 80


def _wire_cfg():
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=4, n_keys=64, n_sessions=4, replay_slots=8,
        ops_per_session=16, replay_age=5, lease_steps=6,
        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=SEED),
    )


WIRE_SCHEDULE = """
    @4  netdrop 0 dst=2 until=24
    @6  netdelay 1 skew=2 until=30
    @8  netdup 2 until=26
    @10 netreorder 3 dst=0 skew=3 until=32
    @12 netcorrupt 1 dst=3 until=28
    @16 partition 2 until=40        # asymmetric: 2's outbound goes dark
    @20 freeze 3
    @28 thaw 3
    @44 heal
"""


def _run_wire(inner_kind: str, device="cuda"):
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.runtime import Runtime
    from hermes_tpu_torch.transport.base import LockstepHostTransport
    from hermes_tpu_torch.transport.sim import SimTransport

    cfg = _wire_cfg()
    inner = (SimTransport(cfg.n_replicas) if inner_kind == "sim"
             else LockstepHostTransport())
    wire = chaos.FaultingTransport(inner, cfg.n_replicas, seed=SEED)
    rt = Runtime(cfg, backend="sim", record=True, transport=wire,
                 device=device)
    rt.attach_membership(MembershipService(cfg, confirm_steps=2))
    runner = chaos.ChaosRunner(rt, chaos.Schedule.parse(WIRE_SCHEDULE),
                               wire=wire)
    res = runner.run(64, check=True)
    return rt, wire, runner, res


def check_wire_matrix(report: dict, device="cuda") -> None:
    for inner_kind in ("sim", "lockstep"):
        rt, wire, runner, res = _run_wire(inner_kind, device)
        assert res["drained"], f"{inner_kind}: did not drain"
        assert res["checked_ok"], (
            f"{inner_kind}: checker FAIL {res['check_failures']}")
        c = wire.counters
        for op in ("drop", "delay", "dup", "reorder", "partition"):
            assert c.get(f"wire_{op}", 0) > 0, (
                f"{inner_kind}: fault class {op} never fired ({dict(c)})")
        assert c.get("wire_corrupt", 0) > 0, f"{inner_kind}: no corruption"
        assert c.get("wire_corrupt_dropped", 0) == c["wire_corrupt"], (
            f"{inner_kind}: corrupt frames not all dropped ({dict(c)})")
        assert c.get("wire_corrupt_applied", 0) == 0, (
            f"{inner_kind}: a corrupted frame was APPLIED")
        mem = [(e.kind, e.replica) for e in rt.membership.events]
        assert ("remove", 2) in mem and ("join", 2) in mem, (
            f"{inner_kind}: partitioned replica not ejected+rejoined {mem}")
        report[f"wire_{inner_kind}"] = dict(
            events=len(runner.log), faults=dict(c),
            membership=[f"{k}:{r}" for k, r in mem], checked_ok=True)


def check_determinism(report: dict, device="cuda") -> None:
    logs, states = [], []
    for _ in range(2):
        rt, wire, runner, res = _run_wire("sim", device)
        assert res["checked_ok"]
        logs.append(runner.log_json() + "\n" + wire.fault_log_json())
        states.append(checks.phases_leaves(rt))
    assert logs[0] == logs[1], "executed fault logs differ across replays"
    assert checks.leaves_equal(*states), "final states differ across replays"
    report["deterministic_replay"] = True


def _inv_block(cfg):
    """An outbound INV block of every replica: all lanes valid, key 7."""
    import numpy as np

    from hermes_tpu_torch.core import state as st

    out = st.empty_invs(cfg, lead=(cfg.n_replicas,))
    out = out._replace(**{f: v.numpy() for f, v in out._asdict().items()})
    return out._replace(valid=np.ones_like(out.valid),
                        key=np.full_like(out.key, 7),
                        alive=np.ones_like(out.alive))


def check_crc_red(report: dict, device="cuda") -> None:
    import numpy as np

    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.transport import codec
    from hermes_tpu_torch.transport.base import LockstepHostTransport

    # codec level: a flipped payload byte must be REJECTED
    payload = np.arange(256, dtype=np.uint8)
    frame = codec.frame_pack(payload)
    assert np.array_equal(codec.frame_unpack(frame), payload)
    torn = frame.copy()
    torn[codec.FRAME_OVERHEAD + 40] ^= 0x01
    try:
        codec.frame_unpack(torn)
        raise AssertionError("corrupted frame passed the checksum")
    except codec.FrameCorrupt:
        pass

    # interposer level: with the CRC the corrupted pair frame is never
    # applied (a zero block); without it the scramble reaches the protocol
    cfg = _wire_cfg()
    out = _inv_block(cfg)
    clean = {f: np.asarray(v)[1, 0]  # dst=1, src=0 pair, unfaulted
             for f, v in LockstepHostTransport().exchange_inv(
                 out, 0)._asdict().items()}
    delivered = {}
    for crc in (True, False):
        wire = chaos.FaultingTransport(LockstepHostTransport(),
                                       cfg.n_replicas, seed=3, crc=crc)
        wire.add("corrupt", 0, 1, 0, 10)
        inb = wire.exchange_inv(out, step=0)
        delivered[crc] = {f: np.asarray(v)[1, 0]
                          for f, v in inb._asdict().items()}
        if crc:
            assert wire.counters["wire_corrupt_dropped"] > 0
        else:
            assert wire.counters["wire_corrupt_applied"] > 0
    for f, v in delivered[True].items():
        assert (v == 0).all(), (
            f"CRC on: corrupted frame must arrive as a DROP (zero block); "
            f"field {f} leaked through")
    assert any(not np.array_equal(delivered[False][f], clean[f])
               for f in clean), (
        "crc=False run should show the scramble reaching the protocol")
    report["crc_red_test"] = True


def _partition_cfg():
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(
        n_replicas=5, n_keys=64, n_sessions=4, replay_slots=6,
        value_words=4, ops_per_session=1, lease_steps=5,
        pipeline_depth=2, op_timeout_rounds=6, op_retry_limit=2,
        rebroadcast_every=2, replay_scan_every=4,
        workload=WorkloadConfig(seed=SEED))


def _run_partition(backend, device="cuda"):
    from hermes_tpu_torch import chaos
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.obs import Observability

    cfg = _partition_cfg()
    kvs = KVS(cfg, backend=backend, record=True, device=device)
    obs = kvs.rt.attach_obs(Observability())
    kvs.rt.attach_membership(MembershipService(cfg, confirm_steps=2))
    sched = chaos.Schedule.parse(
        "@4 partition 1 until=60\n@14 freeze 3\n@24 thaw 3\n@62 heal\n")
    runner = chaos.ChaosRunner(kvs, sched)
    futs = []

    def on_step(step):
        if step % 3 == 0 and step < 55:
            r = (step // 3) % cfg.n_replicas
            futs.append(kvs.put(r, (step // 15) % cfg.n_sessions,
                                (7 * step) % cfg.n_keys, [step + 1]))

    runner.on_step = on_step
    res = runner.run(110, check=True)
    return kvs, obs, runner, res, futs


def check_partition_fast(report: dict, device="cuda") -> None:
    from hermes_tpu_torch.checker import linearizability as lin

    for backend in ("batched", "sharded"):
        kvs, obs, runner, res, futs = _run_partition(backend, device)
        assert res["drained"], f"{backend}: did not drain"
        assert res["checked_ok"], (
            f"{backend}: checker FAIL {res['check_failures']}")
        unresolved = [f for f in futs if not f.done()]
        assert not unresolved, (
            f"{backend}: {len(unresolved)} futures stranded by the adversary")
        mem = [(e.kind, e.replica) for e in kvs.rt.membership.events]
        assert ("remove", 1) in mem and ("join", 1) in mem, (
            f"{backend}: partitioned replica not ejected+rejoined {mem}")
        assert kvs.retried_ops > 0, (
            f"{backend}: no bounded retry fired (stuck={len(kvs.stuck_ops)})")
        ev = [r.get("name") for r in obs.records if r.get("kind") == "event"]
        assert ev.count("membership_fetch") == 0, (
            f"{backend}: detector fetched on the dispatch path")
        committed = [f.result().uid for f in futs
                     if f.result().kind == "put"]
        lost = lin.committed_write_lost(
            committed, kvs.rt.history_ops(), kvs.rt.recorder.aborted_uids)
        assert not lost, (
            f"{backend}: committed-and-observed writes reported "
            f"lost/aborted across partition+heal: {lost}")
        kinds: dict = {}
        for f in futs:
            kinds[f.result().kind] = kinds.get(f.result().kind, 0) + 1
        report[f"partition_{backend}"] = dict(
            ops=len(futs), kinds=kinds, retried=kvs.retried_ops,
            stuck=len(kvs.stuck_ops), committed=len(committed),
            membership=[f"{k}:{r}" for k, r in mem],
            membership_fetches=0, checked_ok=True)


LEGS = (check_wire_matrix, check_determinism, check_crc_red,
        check_partition_fast)


def main(argv=None) -> int:
    return checks.run_legs("netchaos", LEGS, argv, "netchaos", __doc__)


if __name__ == "__main__":
    sys.exit(main())
