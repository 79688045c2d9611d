"""Import boundary of the port: hermes_tpu_torch imports torch, never jax
and nothing of hermes_tpu (a module named ``hermes_tpu`` or starting with
``hermes_tpu.`` — not the string prefix, which the port's own name has).
Checked in a fresh interpreter that runs one round and one KVS put/get
on the CPU."""

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
