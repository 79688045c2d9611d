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
with a cross-group move and its checks, a sharded fleet run) on the
CPU."""

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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "hermes_tpu" or m.startswith("hermes_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


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
