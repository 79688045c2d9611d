"""The port's CLI (``python -m hermes_tpu_torch``) against the reference's
default fast-backend drive (``hermes_tpu/cli.py``: a batched FastRuntime
drained to the end of its streams, then the summary record), and its two
client drives, ``--reads`` and ``--value-bytes``, against the reference
CLI's on the same arguments (every count equal: ops, reads, writes, local
and fallback reads, byte-exactness, heap stats; wall times are not
compared).

The port's run goes through the package's ``__main__`` in a fresh
interpreter on the CPU; its summary record must equal the reference's
(exact equality on every counter — only the wall-clock fields differ),
and its checker verdict must be PASS."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from hermes_tpu import stats as ref_stats
from hermes_tpu.config import HermesConfig as RefConfig
from hermes_tpu.runtime import FastRuntime as RefRuntime
from hermes_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent

# the fields of the summary record that depend on the wall clock
WALL_FIELDS = ("wall_s", "writes_per_sec", "ops_per_sec", "step_us")


def _check_drive(extra_argv, backend="batched", **extra_cfg):
    """Run the port's CLI check drive on the CPU and the reference's
    FastRuntime on the same config and backend: equal summaries, checker
    PASS."""
    argv = ["--replicas", "3", "--keys", "64", "--sessions", "8",
            "--replay-slots", "4", "--ops-per-session", "12",
            "--arb-mode", "sort", "--chain-writes", "2", *extra_argv]
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

    mesh = None
    if backend == "sharded":
        import jax
        import numpy as np
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:3]), ("replica",))
    ref = RefRuntime(RefConfig(n_replicas=3, n_keys=64, n_sessions=8,
                               replay_slots=4, ops_per_session=12,
                               arb_mode="sort", chain_writes=2, **extra_cfg),
                     backend=backend, mesh=mesh)
    assert ref.drain()
    want = ref_stats.summarize(ref.fs.meta, None, ref.step_idx)
    assert {k: v for k, v in got.items() if k not in WALL_FIELDS} == want
    assert got["n_read"] + got["n_write"] + got["n_rmw"] == 3 * 8 * 12


def test_torch_cli_check_drive_matches_reference_summary():
    _check_drive([])


def test_torch_cli_mega_round_check_drive_matches_reference_summary():
    _check_drive(["--mega-round"], mega_round=True)


@pytest.mark.parametrize("extra", [[], ["--mega-round"]])
def test_torch_cli_sharded_check_drive_matches_reference_summary(extra):
    """``--backend fast-sharded``: the sharded engine on a LocalGroup,
    against the reference's sharded FastRuntime over three CPU devices."""
    _check_drive(["--backend", "fast-sharded", *extra], backend="sharded",
                 mega_round=bool(extra))


def test_torch_cli_defaults_to_the_card_and_refuses_bad_flags():
    assert cli.build_parser().parse_args([]).device == "cuda"
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu",
         "--chain-writes", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 2 and "--arb-mode sort" in r.stderr


def test_torch_cli_refuses_mega_round_without_sort_arbiter():
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu",
         "--mega-round"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 2 and "--mega-round needs --arb-mode sort" in r.stderr


# -- the client drives: --reads and --value-bytes ------------------------------

# fields of the drives' summary lines that depend on the wall clock
DRIVE_WALL_FIELDS = ("wall_s", "reads_per_sec", "writes_per_sec",
                     "put_gb_per_sec")


def _drive_summaries(capsys, argv, port_extra=()):
    """The port's drive (a fresh interpreter, CPU) and the reference
    CLI's (in-process) on the same arguments, the port's with
    ``port_extra`` added: both JSON summaries."""
    import json

    from hermes_tpu import cli as ref_cli

    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, *port_extra,
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    capsys.readouterr()
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    strip = lambda d: {k: (v if k != "dip" else {
        dk: dv for dk, dv in v.items() if dk not in DIP_WALL})
        for k, v in d.items() if k not in DRIVE_WALL_FIELDS}
    assert strip(got) == strip(want)
    return got


BASE = ["--replicas", "3", "--keys", "512", "--sessions", "16",
        "--replay-slots", "8", "--value-words", "6", "--check"]


# the reference runs its client drives on the batched engine only; the
# port's sharded engine (--backend fast-sharded) must give the same counts
# on these healthy drives, where every copy stays in lockstep
SHARDED = ("--backend", "fast-sharded")


@pytest.mark.parametrize("extra", [[], ["--read-latest", "--seed", "5"],
                                   ["--distribution", "zipfian",
                                    "--read-frac", "0.6"]])
def test_torch_cli_reads_drive_matches_reference_counts(capsys, extra):
    _reads_drive(capsys, extra)


def test_torch_cli_sharded_reads_drive_matches_reference_counts(capsys):
    _reads_drive(capsys, [], SHARDED)


def _reads_drive(capsys, extra, port_extra=()):
    got = _drive_summaries(capsys, BASE + ["--reads", "3000", *extra],
                           port_extra)
    assert got["ok"] and got["checked_ok"] and got["stale_read"] == []
    assert got["reads"] + got["writes"] == got["ops"] == 3000
    assert got["local_reads"] + got["fallback_reads"] >= got["reads"]


@pytest.mark.parametrize("extra", [["--value-bytes", "256"],
                                   ["--value-bytes", "1024", "--seed", "9"]])
def test_torch_cli_values_drive_matches_reference_counts(capsys, extra):
    _values_drive(capsys, extra)


def test_torch_cli_sharded_values_drive_matches_reference_counts(capsys):
    _values_drive(capsys, ["--value-bytes", "256"], SHARDED)


def _values_drive(capsys, extra, port_extra=()):
    got = _drive_summaries(capsys, BASE + ["--values-ops", "600", *extra],
                           port_extra)
    assert got["ok"] and got["byte_exact"] and got["checked_ok"]
    assert got["heap"]["appends"] == 600 and got["heap"]["gc_runs"] >= 1
    assert got["post_gc_util"] >= got["util_floor"]


@pytest.mark.parametrize("argv,msg", [
    (["--reads", "0"], "positive op count"),
    (["--reads", "10", "--read-frac", "1.5"], "--read-frac"),
    (["--reads", "10", "--value-words", "2"], "--value-words >= 3"),
    (["--reads", "10", "--value-bytes", "64", "--value-words", "4"],
     "separate drives"),
    (["--value-bytes", "0", "--value-words", "4"], "positive byte cap"),
    (["--value-bytes", "64", "--values-ops", "0", "--value-words", "4"],
     "positive op count"),
    (["--value-bytes", "64"], "--value-words >= 3"),
])
def test_torch_cli_drives_refuse_bad_flags(argv, msg):
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and msg in r.stderr, r.stderr


# -- the chaos drive, the detector and the drills ------------------------------

CHAOS = ["--replicas", "5", "--keys", "96", "--sessions", "6",
         "--replay-slots", "6", "--ops-per-session", "24", "--steps", "120",
         "--check"]


def _summary_pair(capsys, argv):
    """The port's default drive (a fresh interpreter, CPU) and the
    reference CLI's (in-process) on the same arguments: both summary
    records and the port's stderr."""
    from hermes_tpu import cli as ref_cli

    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[1].startswith("linearizability: PASS"), r.stdout
    got = ast.literal_eval(lines[0])
    capsys.readouterr()
    assert ref_cli.main(argv) == 0
    out = capsys.readouterr()
    want = ast.literal_eval(out.out.splitlines()[0])
    strip = lambda d: {k: v for k, v in d.items() if k not in WALL_FIELDS}
    assert strip(got) == strip(want)
    chaos_line = [ln for ln in r.stderr.splitlines() if ln.startswith("chaos:")]
    assert chaos_line == [ln for ln in out.err.splitlines()
                          if ln.startswith("chaos:")]
    return got, chaos_line


@pytest.mark.parametrize("backend", ["fast", "fast-sharded"])
def test_torch_cli_chaos_drive_matches_reference_summary(capsys, backend):
    """``--chaos SEED --detect CONFIRM``: the seeded schedule with the
    detector attached; the summary record (every counter) and the
    runner's line equal the reference CLI's."""
    got, line = _summary_pair(capsys, CHAOS + ["--chaos", "23", "--detect",
                                               "3", "--backend", backend])
    assert "lost_ops=6, drained=True" in line[0]
    assert got["commits"] > 0


def test_torch_cli_chaos_schedule_file_matches_reference_summary(capsys,
                                                                 tmp_path):
    path = tmp_path / "sched.txt"
    path.write_text("@3 freeze 1\n@10 partition 2 until=30\n"
                    "@20 crash_restart 0\n@40 thaw 1\n@50 heal\n")
    _, line = _summary_pair(capsys, CHAOS + ["--chaos-schedule", str(path),
                                             "--detect", "2"])
    assert line and "drained=True" in line[0]


# fields of the drills' JSON lines that depend on the wall clock
DIP_WALL = ("worst_window", "clean_rate", "dip_pct")


@pytest.mark.parametrize("argv", [
    ["--replicas", "4", "--keys", "96", "--sessions", "4",
     "--ops-per-session", "48", "--drill", "rolling", "--detect", "2"],
    ["--replicas", "4", "--keys", "64", "--sessions", "4", "--value-words",
     "6", "--drill", "resize", "--degraded-floor", "2"],
])
def test_torch_cli_drills_match_reference(capsys, argv):
    got = _drive_summaries(capsys, argv + ["--check"])
    assert got["ok"] and got["checked_ok"]
    assert got.get("restarts", got.get("resizes")) == 4


@pytest.mark.parametrize("argv,msg", [
    (["--drill", "migrate"], "--value-words >= 3"),
    (["--chaos", "1", "--chaos-schedule", "x", "--steps", "5"],
     "mutually exclusive"),
    (["--chaos", "1"], "--steps > 0"),
    (["--chaos", "1", "--steps", "9", "--freeze", "1:2:3"],
     "mutually exclusive"),
    (["--drill", "resize"], "--value-words >= 3"),
    (["--drill", "rolling", "--freeze", "1:2:3", "--steps", "9"],
     "mutually exclusive"),
    (["--drill", "rolling", "--reads", "10", "--value-words", "4"],
     "separate drives"),
])
def test_torch_cli_chaos_and_drill_refuse_bad_flags(argv, msg):
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and msg in r.stderr, r.stderr
