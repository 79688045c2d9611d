"""The port's TCP transport (``hermes_tpu_torch/transport/tcp.py`` over
``native/tcp_transport.cpp``, built with ``g++ -pthread`` into
``_build/``) and its multi-process driver (``distributed.py``).

* The frame path without sockets: a stub mesh echoes the frames, one
  peer's corrupted; the corrupted frame is dropped (a zero block,
  counted), the clean ones round-trip, and every inbound block equals the
  reference transport's on the same stub.
* Three processes, one replica each, on the CPU over loopback TCP (free
  ports of their own, away from the reference tests' 29630-29722): the
  combined history linearizes, the ranks' tables agree, every session
  ends S_DONE, no clean frame fails its CRC, and the ranks' tables,
  histories and counters equal the JAX package's three-process run on the
  same arguments.
* The same three processes with the wire adversary's corruption windows:
  every corrupted frame is dropped by the CRC, and the run stays green.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_refpair import assert_ops_equal, free_base_port, pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubMesh:
    """Loopback exchanger standing in for the socket mesh: echoes each
    outbound slice back, one byte flipped in the listed peers' slices."""

    registry = None

    def __init__(self, flip_peers=()):
        self.flip_peers = set(flip_peers)

    def exchange(self, out_slices):
        inb = np.array(out_slices)
        for p in self.flip_peers:
            inb[p, inb.shape[1] // 2] ^= 0xFF
        return inb


def test_torch_tcp_frame_corrupt_drops_without_sockets():
    import jax

    from hermes_tpu.core import state as jst
    from hermes_tpu.transport.tcp import TcpHostTransport as JT
    from hermes_tpu_torch.core import state as st
    from hermes_tpu_torch.transport.tcp import TcpHostTransport as PT

    jc, pc = pair(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=4,
                  ops_per_session=4)
    out = st.empty_invs(pc)
    out = out._replace(valid=out.valid | True, key=out.key + 5,
                       alive=out.alive | True)
    jout = jax.device_get(jst.empty_invs(jc))._replace(
        valid=out.valid.numpy(), key=out.key.numpy(),
        alive=out.alive.numpy())
    ack = st.empty_acks(pc, lead=(3,))
    ack = ack._replace(valid=ack.valid | True, key=ack.key + 3)
    jack = jax.device_get(jst.empty_acks(jc, lead=(3,)))._replace(
        valid=ack.valid.numpy(), key=ack.key.numpy())
    for flips in ((), (0,), (0, 2)):
        p = PT(pc, my_rank=1, n_ranks=3, mesh=_StubMesh(flips))
        j = JT(jc, my_rank=1, n_ranks=3, mesh=_StubMesh(flips))
        for name, blk, jblk in (("inv", out, jout), ("ack", ack, jack),
                                ("val", st.empty_vals(pc),
                                 jax.device_get(jst.empty_vals(jc)))):
            got = getattr(p, f"exchange_{name}")(blk, step=0)
            want = getattr(j, f"exchange_{name}")(jblk, step=0)
            for x, y in zip(want, got):
                np.testing.assert_array_equal(np.asarray(x), y)
        assert p.corrupt_dropped == j.corrupt_dropped == 3 * len(flips)
        inb = p.exchange_inv(out, step=1)
        for peer in range(3):
            assert inb.valid[peer].all() == (peer not in flips)


def run_ranks(module, tmp_path, tag, n, steps, extra=(), env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    port = free_base_port(n)
    outs = [tmp_path / f"{tag}{r}.pkl" for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--rank", str(r), "--n-ranks", str(n),
         "--steps", str(steps), "--base-port", str(port), "--out",
         str(outs[r]), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(n)]
    for p in procs:
        _out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
    return outs


def test_torch_three_process_tcp_run_equals_reference(tmp_path):
    from hermes_tpu.distributed import combine_and_check as jcombine
    from hermes_tpu_torch.distributed import combine_and_check

    n, steps = 3, 60
    outs = run_ranks("hermes_tpu_torch.distributed", tmp_path, "port", n,
                     steps, extra=("--device", "cpu"))
    verdict, results = combine_and_check(outs)
    assert verdict.ok, (verdict.failures[:2], verdict.undecided[:2])
    for r in results[1:]:
        np.testing.assert_array_equal(results[0]["table_ver"], r["table_ver"])
        np.testing.assert_array_equal(results[0]["table_val"], r["table_val"])
    for r in results:
        assert (r["sess_status"] == 4).all()
        assert r["corrupt_dropped"] == 0
        assert r["device"] == "cpu" and r["rounds_per_s"] > 0
    assert sum(sum(r["counters"].values()) for r in results) == n * 8 * 24

    jouts = run_ranks("hermes_tpu.distributed", tmp_path, "ref", n, steps)
    jverdict, jresults = jcombine(jouts)
    assert jverdict.ok
    for want, got in zip(jresults, results):
        assert want["rank"] == got["rank"]
        for k in ("table_state", "table_ver", "table_fc", "table_val",
                  "sess_status"):
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
        assert want["counters"] == got["counters"]
        assert want["aborted"] == got["aborted"]
        assert_ops_equal(want["ops"], got["ops"])


def test_torch_tcp_wire_corruption_end_to_end(tmp_path):
    """The wire adversary over the real socket transport: every rank runs
    the same seeded corrupt and drop windows; each corrupted frame is
    dropped by the CRC, the run stays green and converges."""
    from hermes_tpu_torch.distributed import combine_and_check

    faults = "corrupt:0:1:4:16;drop:2:0:6:12"
    outs = run_ranks("hermes_tpu_torch.distributed", tmp_path, "w", 3, 80,
                     extra=("--device", "cpu", "--wire-seed", "5",
                            "--wire-faults", faults))
    verdict, results = combine_and_check(outs)
    assert verdict.ok, (verdict.failures[:2], verdict.undecided[:2])
    by_rank = {r["rank"]: r for r in results}
    w1 = by_rank[1]["wire"]["counters"]
    assert w1.get("wire_corrupt", 0) > 0, w1
    assert w1.get("wire_corrupt_dropped", 0) == w1["wire_corrupt"], w1
    assert w1.get("wire_corrupt_applied", 0) == 0, w1
    assert by_rank[0]["wire"]["counters"].get("wire_drop", 0) > 0
    for r in results[1:]:
        np.testing.assert_array_equal(results[0]["table_ver"], r["table_ver"])
        np.testing.assert_array_equal(results[0]["table_val"], r["table_val"])


def test_torch_parse_wire_faults_and_fleet_ports():
    from hermes_tpu import distributed as jd
    from hermes_tpu_torch import distributed as pd

    spec = "corrupt:0:1:4:16; drop:2:-1:6:12:3;"
    assert pd.parse_wire_faults(spec) == jd.parse_wire_faults(spec)
    with pytest.raises(ValueError, match="bad wire fault"):
        pd.parse_wire_faults("drop:1:2")
    for g in range(3):
        assert pd.fleet_base_port(29500, g, 3) == jd.fleet_base_port(
            29500, g, 3)
    with pytest.raises(ValueError):
        pd.fleet_base_port(29500, -1, 3)


def test_torch_rdma_stub_raises():
    from hermes_tpu_torch.transport.rdma import RdmaMesh

    with pytest.raises(NotImplementedError, match="RDMA NIC"):
        RdmaMesh(0, 2)


def test_torch_chip_smoke_phases_engine_rehearsal():
    """``chip_smoke.run_phases_engine`` (the smoke's phases 19-22 and
    phases-graph) on the CPU at scale 0.01: the card's device and the
    profiler stubbed, the graphed-against-eager pairs, the compiled
    chunks, the CPU reference child, the sharded and sim-wire drives and
    six TCP processes real; every comparison equal and no hand kernel
    launched."""
    import contextlib
    import time
    from types import SimpleNamespace

    import torch

    import chip_smoke as cs
    from hermes_tpu_torch import chaos, config
    from hermes_tpu_torch.chaos.net import FaultingTransport
    from hermes_tpu_torch.core import kernels, megaround, types
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.distributed import combine_and_check
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.runtime import Runtime
    from hermes_tpu_torch.transport.sim import SimTransport

    def busy(torch, run, label, rts=()):
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        return dict(busy_s=wall / 2, wall_s=wall, busy_by="queued",
                    launches=1, top=[])

    def no_launch_calls(run):
        run()
        return {}

    counters = {"stats_block": kernels.stats_block,
                "mega_route": megaround.mega_route,
                "mega_apply": megaround.mega_apply,
                "mega_replay": megaround.mega_replay}
    ph = SimpleNamespace(
        cfg=lambda n: cs.baseline_cfg(config, n, 0.01), scale=0.01,
        device="cpu", root=REPO, Runtime=Runtime, LocalGroup=LocalGroup,
        types=types, sync=lambda: None, reset_peak_memory=lambda: None,
        peak_memory=lambda: 0, device_busy=busy,
        sync_check=contextlib.nullcontext,
        queued_s=lambda call, **kw: None, launch_calls=no_launch_calls,
        FaultingTransport=FaultingTransport, SimTransport=SimTransport,
        chaos=chaos, MembershipService=MembershipService,
        combine_and_check=combine_and_check)
    out = cs.run_phases_engine(torch, ph, counters, "cpu")
    assert not any(out["launches"].values())
    assert {r["identical"] and r["scan_equal"] for r in
            out["graph"].values()} == {True}
    assert out["tcp"]["clean"]["all_sessions_done"]
    assert out["sim_wire"]["chaos_check_ok"]
