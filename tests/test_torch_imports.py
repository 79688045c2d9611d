"""Import boundary of the port: hermes_tpu_torch imports torch, never jax
and nothing of hermes_tpu (a module named ``hermes_tpu`` or starting with
``hermes_tpu.`` — not the string prefix, which the port's own name has).
Checked in a fresh interpreter that runs one round, one KVS put/get, a
multi-get and a scan, a heap put on a sparse key with its GC, one
cell of the table-step probe and the kernel matrix (the analysis
sub-package, its fixtures and its command line), and a durable, observed
KVS (obs/, wal/, snapshot.py, chaos/, concurrency.py: a traced put under
the WAL, a snapshot, a replica restart, a whole-store recovery and the
report renderer), the sharded engine (core/group.py, launch.py: a
sharded KVS put/get on a LocalGroup and a launch run), and the failure
detector, fault schedules and elastic drills (membership.py,
chaos/schedule.py, elastic/: a seeded chaos run with the detector, a
degraded-mode shed, a rolling restart and a rolling resize), and the
range migration and the fleet (elastic/migrate.py, the range archives,
fleet/, launch.run_fleet: a migration between two KVSs, a fleet put/get
with a cross-group move and its checks, a sharded fleet run), and the
reference phases engine (core/timestamps.py, core/phases.py,
core/step.py, runtime.Runtime on its three backends, transport/ base,
sim, tcp, rdma and the codec's block layer, chaos/net.py and a wired
ChaosRunner, distributed.py's helpers), and the serving front end
(serving/, transport/shm.py, workload/openloop.py: an open-loop soak
under an overload storm, a columnar soak, an shm soak and a TCP round
trip), and the census, the acceptance scenarios, the entry points and the
host lock analysis (obs/profile.py, acceptance.py, graft.py, probe.py,
gates.py, analysis/hostlint.py and lockgraph.py: a sharded round's
census, config 4 drained and checked, the entry round, the package's
lint, an instrumented lock), and the static round analysis
(analysis/graph.py, interp.py, passes.py, engines.py, gate.py,
heap.analyze_gather: a mega config's four programs and the extent
gather analyzed) on the CPU.  The TCP run's
child processes (``python -m hermes_tpu_torch.distributed``) are probed
after a real two-rank run over loopback."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import sys
import torch
torch.set_num_threads(1)
import hermes_tpu_torch
from hermes_tpu_torch import HermesConfig, KVS
from hermes_tpu_torch.core import faststep as fst
from hermes_tpu_torch.workload import ycsb
cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=2,
                   ops_per_session=4, value_words=4)
fs = fst.init_fast_state(cfg, "cpu")
fs, comp = fst.fast_round_batched(cfg, fst.make_fast_ctl(cfg, 0, "cpu"), fs,
                                  fst.prep_stream(ycsb.make_streams(cfg), "cpu"))
kvs = KVS(cfg, device="cpu")
p = kvs.put(0, 0, 5, [1, 2])
assert kvs.run_until([p])
g = kvs.get(1, 0, 5)
assert kvs.run_until([g]) and g.result().value == [1, 2]
res = kvs.multi_get([5, 6])
assert res.local.all() and res.value[0].tolist() == [1, 2]
assert kvs.scan(0, 8).all_done()
hk = KVS(HermesConfig(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=2,
                      value_words=3, max_value_bytes=64, heap_bytes=1 << 12),
         sparse_keys=True, device="cpu")
p = hk.put(0, 0, 2**63 + 1, b"bytes")
assert hk.run_until([p]) and hk.multi_get([2**63 + 1]).data == [b"bytes"]
assert hk.heap_gc()["live_bytes"] == 5
from hermes_tpu_torch.transport import codec
from hermes_tpu_torch.workload import openloop
assert len(openloop.make_mix(openloop.MixSpec(value_bytes=64), 64, 8, 1)) == 5
from hermes_tpu_torch import table_probe
assert table_probe.cell("serial", 64, 256, "cpu")["calls"] == 4
from hermes_tpu_torch import analysis
from hermes_tpu_torch.analysis import __main__ as analysis_cli
from hermes_tpu_torch.analysis import fixture_kernels
assert len(analysis.run_kernel_matrix(n_draws=1, device="cpu")) == 9
assert analysis_cli.main(["--kernels", "--json", "--draws", "1",
                          "--device", "cpu"]) == 0
assert int(fixture_kernels.fx_loop_inc(torch.zeros(4, dtype=torch.int32))[0]) == 10
import tempfile
from hermes_tpu_torch import concurrency, snapshot
from hermes_tpu_torch.chaos import recover_store, restart_replica
from hermes_tpu_torch.obs import Observability, canonical_span_bytes
from hermes_tpu_torch.obs import report
from hermes_tpu_torch.wal import crashdrive, replay
assert concurrency.make_lock("X.y").acquire(blocking=False)
d = tempfile.mkdtemp()
wcfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=2,
                    value_words=4, wal_dir=d + "/wal", trace_sample=1,
                    op_timeout_rounds=8, op_retry_limit=1)
wk = KVS(wcfg, device="cpu")
obs = wk.rt.attach_obs(Observability(trace_steps=True))
p = wk.put(0, 0, 5, [1, 2])
assert wk.run_until([p]) and p.result().durability == "commit"
assert canonical_span_bytes(obs.records)
snapshot.save(d + "/s.npz", wk)
assert restart_replica(wk, 1, snapshot_path=d + "/s.npz")["source"] == "snapshot"
wk.wal.sync()
wk.wal.close()
rk, summary = recover_store(wcfg, device="cpu")
assert summary["applied"] == 1 and len(crashdrive.log_ops(
    replay.read_records(d + "/wal")["records"])) == 1
assert "obs report" in report.render_report(obs.records)
rk.wal.close()
from hermes_tpu_torch import launch
from hermes_tpu_torch.core import group
sk = KVS(cfg, backend="sharded", device="cpu")
p = sk.put(0, 0, 9, [3, 4])
assert sk.run_until([p])
g = sk.get(2, 0, 9)
assert sk.run_until([g]) and g.result().value == [3, 4]
assert group.replica_devices(3, "cpu") == [torch.device("cpu")] * 3
lrt = launch.run(cfg, 4, device="cpu")
assert lrt.n_copies == 3 and lrt.step_idx == 4
from hermes_tpu_torch import chaos, elastic
from hermes_tpu_torch.membership import MembershipService
from hermes_tpu_torch.runtime import FastRuntime
ccfg = HermesConfig(n_replicas=4, n_keys=64, n_sessions=4, replay_slots=4,
                    ops_per_session=8, value_words=4, lease_steps=4,
                    pipeline_depth=2, min_healthy_for_writes=3)
crt = FastRuntime(ccfg, record=True, device="cpu")
crt.attach_membership(MembershipService(ccfg, confirm_steps=1))
res = chaos.ChaosRunner(crt, chaos.Schedule.random(ccfg, 3, 30, chaos.ChaosSpec(
    p_freeze=0.2, p_crash=0.1))).run(30, check=True)
assert res["drained"] and res["checked_ok"]
assert elastic.run_rolling_restart(FastRuntime(ccfg, device="cpu"),
                                   spacing=4)["restarts"] == 4
dk = KVS(ccfg, device="cpu")
dk.freeze(1)
dk.freeze(2)
assert dk.put(0, 0, 1, [1, 2]).result().kind == "rejected"
dk.rt.thaw(1)
dk.rt.thaw(2)
assert elastic.rolling_resize(dk, hold_steps=2)["resizes"] == 4
from hermes_tpu_torch import fleet
from hermes_tpu_torch.config import FleetConfig
ms = KVS(cfg, record=True, device="cpu")
md = KVS(cfg, record=True, device="cpu")
assert ms.run_until([ms.put(0, 0, k, [k, 1]) for k in range(8, 12)])
mres = elastic.migrate_range(ms, md, 8, 12)
g = md.get(0, 0, 9)
assert mres["rows"] == 4 and md.run_until([g]) and g.result().value == [9, 1]
assert ms.get(0, 0, 9).result().kind == "rejected"
assert ms.rt.check().ok and md.rt.check().ok
fcfg = FleetConfig(groups=2, base=HermesConfig(
    n_replicas=3, n_keys=48, n_sessions=4, replay_slots=2, value_words=4),
    ranges=((0, 32), (32, 64)))
fl = fleet.Fleet(fcfg, record=True, device="cpu")
assert fl.run_until([fl.put(0, k, [k, 2]) for k in (3, 40)])
assert fl.migrate(40, 44, 0)["dst_group"] == 0
g = fl.get(0, 40)
assert fl.run_until([g]) and g.result().value == [40, 2]
assert fl.check()["ok"] and fleet.verify_fleet(fl)["migration_uids"] == 4
frts = launch.run_fleet(FleetConfig(groups=2, base=cfg), 3, device="cpu")
assert [r.fleet_group for r in frts] == [0, 1] and frts[1].step_idx == 3
from hermes_tpu_torch.runtime import Runtime
from hermes_tpu_torch.core import phases, step as step_lib, timestamps
from hermes_tpu_torch.transport import base, codec as tcodec, rdma, sim, tcp
from hermes_tpu_torch.chaos.net import FaultingTransport
from hermes_tpu_torch import distributed
pcfg = HermesConfig(n_replicas=3, n_keys=32, n_sessions=4, replay_slots=2,
                    ops_per_session=6, lease_steps=4)
for be in ("batched", "sharded", "sim"):
    prt = Runtime(pcfg, backend=be, record=True, device="cpu")
    assert prt.drain(200) and prt.check().ok
wire = FaultingTransport(sim.SimTransport(3), 3, seed=1)
wire.add("corrupt", 0, 1, 0, 6)
wrt = Runtime(pcfg, backend="sim", record=True, transport=wire, device="cpu")
wres = chaos.ChaosRunner(wrt, chaos.Schedule.parse("@1 netdrop 0 dst=2 until=5\n"),
                         wire=wire).run(8, check=True)
assert wres["drained"] and wres["checked_ok"] and wire.counters["wire_drop"]
class _Echo:
    registry = None
    def exchange(self, out):
        return out.copy()
tt = tcp.TcpHostTransport(pcfg, 0, 3, mesh=_Echo())
inv = phases.st.empty_invs(pcfg)
got = tt.exchange_inv(inv, 0)
assert got.valid.shape == (3, pcfg.n_lanes) and tt.corrupt_dropped == 0
raw = tcodec.pack(got)
assert tcodec.unpack(got, raw).key.shape == got.key.shape
assert distributed.parse_wire_faults("drop:0:1:2:3") == [("drop", 0, 1, 2, 3, 0)]
assert timestamps.ts_gt(2, 0, 1, 5)
from hermes_tpu_torch import serving
from hermes_tpu_torch.serving import bench as sbench, ipc, soak
from hermes_tpu_torch.transport import shm
scfg = serving.ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e4)
scv = KVS(HermesConfig(n_replicas=3, n_keys=64, n_sessions=4, value_words=6),
          record="array", device="cpu")
arr = openloop.ShapedArrivals(4000.0, 40, 3)
srun = chaos.ChaosRunner(scv, chaos.Schedule.overload_storm(3, 20), load=arr)
sres = serving.run_open_loop(scv, scfg, openloop.MixSpec(), 4000.0, 40, 3,
                             20_000, chaos_runner=srun, arrivals=arr)
assert sres["sent"] == 40 and scv.rt.check().ok
cres = soak.run_columnar_soak(KVS(HermesConfig(n_replicas=3, n_keys=64,
                                               n_sessions=4, value_words=6),
                                  device="cpu"), scfg, openloop.MixSpec(),
                              4000.0, 40, 3, 20_000)
assert sum(cres["statuses"].values()) == 40
assert ipc.run_shm_soak(n_workers=2, ops_per_worker=32, batch=16,
                        device="cpu")["ok"]
tfe = serving.Frontend(KVS(HermesConfig(n_replicas=3, n_keys=64, n_sessions=4,
                                        value_words=6), device="cpu"), scfg)
tsrv = serving.TcpRpcServer(tfe)
tcl = serving.RpcClient(tsrv.addr, tfe.u)
assert tcl.call("put", 3, value=[1]).status == serving.wire.S_OK
tcl.close()
tsrv.close()
assert sbench.host_cfg("latency").n_replicas == 4
from hermes_tpu_torch import acceptance, gates, graft, probe
from hermes_tpu_torch.analysis import hostlint, lockgraph
from hermes_tpu_torch.obs import profile as prof
from hermes_tpu_torch.config import bench_cfg
cen = prof.op_census(bench_cfg("a", over=dict(n_keys=1 << 10, n_sessions=64,
                                              replay_slots=8)),
                     "sharded", device="cpu")
assert cen["collective_total"] == 4 and cen["kernel:stats_block"] == 1
ac, av = acceptance.run_config(4, scale=0.004, device="cpu")
assert ac["failure_detected"] and av.ok
gfn, gargs = graft.entry("cpu")
gfn(*gargs)
assert probe.probe_backend(1.0, device="cpu") == (True, "cpu")
assert hostlint.key_counts(hostlint.lint_package()["findings"]) == {}
with lockgraph.ObsLock("probe.A"):
    pass
assert gates.GATES
from hermes_tpu_torch.analysis import engines, gate, graph, interp, passes
from hermes_tpu_torch.heap import core as heap_core
areps = analysis.analyze_config(HermesConfig(n_replicas=3, n_keys=64,
                                             n_sessions=4, replay_slots=2,
                                             arb_mode="sort", mega_round=True),
                                device="cpu")
assert len(areps) == 4 and not [f for r in areps for f in r["findings"]
                                if f.severity in analysis.GATING]
assert areps[0]["kernels"]["mega_route"] == 1 and gate.gate_configs()
assert not heap_core.analyze_gather(HermesConfig(
    n_replicas=3, n_keys=64, n_sessions=4, value_words=3,
    max_value_bytes=64, heap_bytes=1 << 12), batch=8, device="cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "hermes_tpu" or m.startswith("hermes_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_torch_serving_modules_are_in_the_scan():
    """The serving slice's modules exist where the import scan reads
    them."""
    for rel in ("serving/__init__.py", "serving/wire.py",
                "serving/admission.py", "serving/server.py",
                "serving/rpc.py", "serving/soak.py", "serving/ipc.py",
                "serving/bench.py", "transport/shm.py",
                "workload/openloop.py"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


SHM_WORKER = r"""
import sys
import hermes_tpu_torch
import hermes_tpu_torch.serving.ipc as ipc
import hermes_tpu_torch.transport.shm as shm
from hermes_tpu_torch.serving import wire
req, rsp = ipc.create_ring_pair(4, 2, 8, 0)
req.close()
rsp.close()
assert ipc.shm_worker_main and wire.req_nbytes(4)
print("TORCH", sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch.")))
"""


def test_torch_shm_worker_import_chain_loads_no_torch():
    """A fresh interpreter that imports what an shm front-end worker runs
    (``serving.ipc``, ``transport.shm``, the wire) loads no ``torch``:
    only the store process touches the card."""
    r = subprocess.run([sys.executable, "-c", SHM_WORKER], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TORCH []" in r.stdout, r.stdout


SHM_WORKER_LOCKLINT = r"""
import sys
import hermes_tpu_torch.serving.ipc as ipc
from hermes_tpu_torch import concurrency
from hermes_tpu_torch.analysis import lockgraph
lk = concurrency.make_lock("ShmWorker._ring_lock")
assert isinstance(lk, lockgraph.ObsLock)
with lk:
    pass
assert lockgraph.global_graph().report()["locks"]
req, rsp = ipc.create_ring_pair(4, 2, 8, 0)
req.close()
rsp.close()
print("TORCH", sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch.")))
"""


def test_torch_shm_worker_under_locklint_loads_no_torch():
    """With ``HERMES_LOCKLINT=1`` an shm front-end worker's locks are
    ObsLocks (concurrency.py, analysis/lockgraph.py), and it still loads
    no ``torch``."""
    import os

    env = dict(os.environ, HERMES_LOCKLINT="1")
    r = subprocess.run([sys.executable, "-c", SHM_WORKER_LOCKLINT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TORCH []" in r.stdout, r.stdout


def test_torch_round_analysis_modules_are_in_the_scan():
    """The static round analysis's modules exist where the import scan
    reads them, beside its empty baseline."""
    for rel in ("analysis/graph.py", "analysis/interp.py",
                "analysis/passes.py", "analysis/engines.py",
                "analysis/gate.py", "analysis/analysis_baseline.json"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


ANALYSIS_ALONE = r"""
import sys
import hermes_tpu_torch.analysis as ana
assert "analyze_config" in ana.__all__ and "lint_package" in dir(ana)
from hermes_tpu_torch.analysis import lockgraph
print("TORCH", sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch.")))
"""


def test_torch_analysis_package_alone_loads_no_torch():
    """Importing ``hermes_tpu_torch.analysis`` (its exports resolve
    lazily) and its lock graph loads no ``torch``: the shm workers load
    ``lockgraph`` through this package."""
    r = subprocess.run([sys.executable, "-c", ANALYSIS_ALONE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TORCH []" in r.stdout, r.stdout


def test_torch_census_and_entry_modules_are_in_the_scan():
    for rel in ("obs/profile.py", "obs/op_budget.json", "acceptance.py",
                "graft.py", "probe.py", "gates.py", "analysis/hostlint.py",
                "analysis/lockgraph.py", "analysis/hostlint_baseline.json"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


def test_torch_port_imports_neither_jax_nor_reference():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_torch_port_sources_name_no_reference_import():
    """No module of the port (nor chip_smoke.py) has an import statement
    naming jax or hermes_tpu — including lazy imports a run might not
    reach."""
    import ast

    files = sorted((ROOT / "hermes_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "hermes_tpu"), (f, n)


def test_torch_failure_and_elastic_modules_are_in_the_scan():
    """The slice's new modules exist where the import scan above reads
    them."""
    for rel in ("membership.py", "chaos/schedule.py", "elastic/__init__.py",
                "elastic/drill.py", "elastic/migrate.py", "fleet/__init__.py",
                "fleet/router.py", "fleet/core.py", "fleet/chaos.py",
                "fleet/bench.py"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


def test_torch_card_only_tools_name_the_card_without_one():
    """``host_clock.py`` and ``python -m hermes_tpu_torch.profiling``
    measure on the card only: without one they exit non-zero and say so."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cmd in (["hermes_tpu_torch/host_clock.py", "--root", "."],
                ["-m", "hermes_tpu_torch.profiling"]):
        r = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "needs a CUDA card" in r.stderr, r


def test_torch_phases_engine_modules_are_in_the_scan():
    """The reference engine's modules exist where the import scan reads
    them, and the TCP library's source is in the package."""
    for rel in ("core/timestamps.py", "core/phases.py", "core/step.py",
                "transport/base.py", "transport/sim.py", "transport/tcp.py",
                "transport/rdma.py", "transport/codec.py", "chaos/net.py",
                "distributed.py", "native/tcp_transport.cpp"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


CHILD = r"""
import runpy, sys
sys.argv = ["hermes_tpu_torch.distributed"] + sys.argv[1:]
runpy.run_module("hermes_tpu_torch.distributed", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "hermes_tpu" or m.startswith("hermes_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_torch_distributed_children_import_neither_jax_nor_reference(
        tmp_path):
    """Two ranks of ``python -m hermes_tpu_torch.distributed`` over
    loopback TCP, each probed after its run."""
    from torch_refpair import free_base_port

    port = free_base_port(2)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, "--rank", str(r), "--n-ranks", "2",
         "--steps", "6", "--base-port", str(port), "--device", "cpu",
         "--out", str(tmp_path / f"r{r}.pkl")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, out + err
        assert "LEAKED []" in out


def test_torch_gate_modules_are_in_the_scan():
    """The nine gates' modules exist where the source scan above reads
    them."""
    for rel in ("checks/__init__.py", "checks/obs_overhead.py",
                "checks/pipeline.py", "checks/chaos.py", "checks/elastic.py",
                "checks/netchaos.py", "checks/fleet.py", "checks/serving.py",
                "checks/heap.py", "checks/durability.py",
                "checks/durability_soak.py"):
        assert (ROOT / "hermes_tpu_torch" / rel).is_file(), rel


CHECKS = r"""
import sys
import torch
torch.set_num_threads(1)
from hermes_tpu_torch import gates
from hermes_tpu_torch.checks import (chaos, durability, durability_soak,
                                     elastic, fleet, heap, netchaos,
                                     obs_overhead, pipeline, serving)
rep = {}
pipeline.check_ctl_uploads(rep, device="cpu")
chaos.check_torn_snapshot(rep, device="cpu")
netchaos.check_crc_red(rep, device="cpu")
heap.check_torn_snapshot(rep, device="cpu")
fleet.check_replay(rep, device="cpu")
serving.check_overload_storm(rep, device="cpu")
assert len(rep) == 9 and all(rep.values()), rep
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "hermes_tpu" or m.startswith("hermes_tpu."))
print("LEAKED", bad)
"""


def test_torch_gate_modules_import_neither_jax_nor_reference():
    """``hermes_tpu_torch/checks/`` and the runner, imported and six of
    their legs run in a fresh interpreter, load nothing of jax or of the
    JAX package."""
    r = subprocess.run([sys.executable, "-c", CHECKS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout
