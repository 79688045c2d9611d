"""The port's CLI (``python -m hermes_tpu_torch``) against the reference's
default fast-backend drive (``hermes_tpu/cli.py``: a batched FastRuntime
drained to the end of its streams, then the summary record).

The port's run goes through the package's ``__main__`` in a fresh
interpreter on the CPU; its summary record must equal the reference's
(exact equality on every counter — only the wall-clock fields differ),
and its checker verdict must be PASS."""

import ast
import os
import pathlib
import subprocess
import sys

from hermes_tpu import stats as ref_stats
from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the fields of the summary record that depend on the wall clock
WALL_FIELDS = ("wall_s", "writes_per_sec", "ops_per_sec", "step_us")


def test_torch_cli_check_drive_matches_reference_summary():
    argv = ["--replicas", "3", "--keys", "64", "--sessions", "8",
            "--replay-slots", "4", "--ops-per-session", "12",
            "--arb-mode", "sort", "--chain-writes", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, "--device", "cpu",
         "--check"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 2, r.stdout
    got = ast.literal_eval(lines[0])
    assert lines[1].startswith("linearizability: PASS")

    ref = RefRuntime(RefConfig(n_replicas=3, n_keys=64, n_sessions=8,
                               replay_slots=4, ops_per_session=12,
                               arb_mode="sort", chain_writes=2))
    assert ref.drain()
    want = ref_stats.summarize(ref.fs.meta, None, ref.step_idx)
    assert {k: v for k, v in got.items() if k not in WALL_FIELDS} == want
    assert got["n_read"] + got["n_write"] + got["n_rmw"] == 3 * 8 * 12


def test_torch_cli_defaults_to_the_card_and_refuses_bad_flags():
    assert cli.build_parser().parse_args([]).device == "cuda"
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu",
         "--chain-writes", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 2 and "--arb-mode sort" in r.stderr
