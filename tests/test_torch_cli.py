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


PHASES = ["--replicas", "3", "--keys", "96", "--sessions", "6",
          "--replay-slots", "6", "--ops-per-session", "16", "--check"]


@pytest.mark.parametrize("argv", [
    ["--backend", "batched"],
    ["--backend", "sharded"],
    ["--backend", "sim"],
    ["--backend", "sim", "--steps", "40", "--freeze", "2:5:12",
     "--detect", "3", "--distribution", "zipfian"],
    ["--backend", "batched", "--steps", "30", "--freeze", "1:4:20",
     "--report-every", "10"],
])
def test_torch_cli_phases_backends_match_reference_summary(capsys, argv):
    """``--backend batched|sharded|sim``: the reference phases engine
    (``runtime.Runtime``) drained or stepped, with freeze windows and the
    detector; the summary record equals the reference CLI's."""
    got, _ = _summary_pair(capsys, PHASES + argv)
    assert got["n_read"] > 0 and got["commits"] > 0


def test_torch_cli_phases_backend_metrics_out(tmp_path):
    """``--metrics-out`` on a phases backend: the run log carries the
    freeze window's events, the interval records and the summary."""
    import json

    path = tmp_path / "run.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *PHASES, "--backend",
         "sim", "--steps", "24", "--freeze", "1:3:9", "--report-every", "8",
         "--metrics-out", str(path), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    names = {rec.get("name") for rec in recs}
    assert {"freeze", "thaw", "ctl_upload"} <= names, names
    assert any(rec.get("kind") == "summary" for rec in recs)


@pytest.mark.parametrize("argv,msg", [
    (["--backend", "sim", "--chaos", "1", "--steps", "9"],
     "drive the fast runtimes"),
    (["--backend", "batched", "--drill", "rolling"],
     "drive the fast runtimes"),
    (["--backend", "sharded", "--reads", "10", "--value-words", "4"],
     "through the KVS facade"),
    (["--backend", "sim", "--wal-dir", "x"], "has no WAL tap"),
    (["--backend", "batched", "--arb-mode", "sort"],
     "only affect the fast backends"),
])
def test_torch_cli_phases_backends_refuse_fast_only_flags(argv, msg):
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and msg in r.stderr, r.stderr


def test_torch_cli_wal_dir_logs_the_fast_drive(capsys, tmp_path):
    """``--wal-dir`` on the fast drive: the log's record count equals the
    reference CLI's on the same arguments, and the summary is unchanged."""
    argv = ["--replicas", "3", "--keys", "64", "--sessions", "6",
            "--ops-per-session", "12", "--check"]
    got, _ = _summary_pair(capsys, argv)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, "--wal-dir",
         str(tmp_path / "port"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    strip = lambda d: {k: v for k, v in d.items() if k not in WALL_FIELDS}
    assert strip(ast.literal_eval(r.stdout.splitlines()[0])) == strip(got)
    from hermes_tpu import cli as ref_cli

    capsys.readouterr()
    assert ref_cli.main(argv + ["--wal-dir", str(tmp_path / "ref")]) == 0
    want = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("wal:")]
    line = [ln for ln in r.stderr.splitlines() if ln.startswith("wal:")]
    assert line and want
    assert line[0].split(",")[0] == want[0].split(",")[0]
    assert int(line[0].split()[1]) == got["commits"]


# -- the serving drives: --serve and --bench-latency ---------------------------

SERVE = ["--replicas", "3", "--keys", "64", "--sessions", "4",
         "--replay-slots", "6", "--value-words", "6", "--serve", "300",
         "--check"]


@pytest.mark.parametrize("extra", [
    [],
    ["--serve-rate", "20000", "--serve-deadline-us", "3000", "--seed", "4"],
    ["--trace-sample", "4", "--distribution", "zipfian"],
])
def test_torch_cli_serve_drive_matches_reference(capsys, extra):
    """``--serve N --check``: the open-loop soak through the loopback RPC
    path; every count, the virtual-clock percentiles and the response
    log's sha equal the reference CLI's on the same arguments."""
    got = _drive_summaries(capsys, SERVE + extra)
    assert got["ok"] and got["checked_ok"]
    assert sum(got["statuses"].values()) == got["ops_offered"] == 300


def test_torch_cli_serve_drive_logs_and_traces(capsys, tmp_path):
    """``--serve`` with ``--metrics-out``: the same summary as without it
    and the fe_queue/fe_resolve spans in the run log; with ``--wal-dir``
    (``wal_sync=commit``: a write answers once durable, so its rounds
    follow the flusher's clock and the bytes are not compared) the
    checker passes and the log holds the committed writes."""
    import json

    got = _drive_summaries(capsys, SERVE + ["--trace-sample", "2"])
    path = tmp_path / "run.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    lines = []
    for extra in (["--metrics-out", str(path)],
                  ["--wal-dir", str(tmp_path / "w")]):
        r = subprocess.run(
            [sys.executable, "-m", "hermes_tpu_torch", *SERVE,
             "--trace-sample", "2", *extra, "--device", "cpu"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        lines.append(json.loads(r.stdout.strip().splitlines()[-1]))
    assert {k: v for k, v in lines[0].items()
            if k not in DRIVE_WALL_FIELDS} == got
    names = {json.loads(ln).get("name") for ln in path.read_text().splitlines()}
    assert {"fe_queue", "fe_resolve", "op_rounds"} <= names, names
    assert lines[1]["ok"] and lines[1]["checked_ok"]
    assert sum(lines[1]["statuses"].values()) == 300
    assert any((tmp_path / "w").iterdir())


@pytest.mark.parametrize("argv", [
    ["--serve", "0", "--value-words", "6"],
    ["--serve", "5", "--bench-latency", "--value-words", "6"],
    ["--serve", "5"],
    ["--serve", "5", "--value-words", "6", "--drill", "rolling"],
    ["--serve", "5", "--value-words", "6", "--chaos", "1", "--steps", "9"],
    ["--bench-latency", "--drill", "rolling"],
    ["--bench-latency", "--fleet-groups", "2", "--value-words", "6"],
    ["--bench-latency", "--freeze", "1:2:3", "--steps", "9"],
])
def test_torch_cli_serving_refusals_match_reference(capsys, argv):
    """The serving drives' refusals: the port's error line is the
    reference CLI's, word for word."""
    from hermes_tpu import cli as ref_cli

    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    capsys.readouterr()
    with pytest.raises(SystemExit) as ei:
        ref_cli.main(argv)
    assert ei.value.code == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert r.returncode == 2
    got = r.stderr.strip().splitlines()[-1]
    assert got.replace("hermes_tpu_torch", "hermes_tpu") == want, (got, want)


@pytest.mark.parametrize("argv,msg", [
    (["--serve", "5", "--value-words", "6", "--backend", "fast-sharded"],
     "--serve drives the fast batched backend"),
    (["--serve", "5", "--value-words", "6", "--backend", "sim"],
     "--serve drives the fast batched backend"),
    (["--analyze", "findings.jsonl", "--backend", "sim"],
     "--analyze traces the fast round"),
])
def test_torch_cli_serving_refuses_what_is_not_its_own(argv, msg):
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and msg in r.stderr, r.stderr


def test_torch_cli_bench_latency_answers_every_op():
    """``--bench-latency`` on the CPU: a real localhost TcpRpcServer, every
    request answered, no error in the cell."""
    import json

    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--bench-latency",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    cell = json.loads(r.stdout.strip().splitlines()[-1])
    assert cell["error"] is None and cell["answered"] == cell["ops"] == 64
    assert cell["p50_us"] > 0 and cell["capacity_probe_ops_per_sec"] > 0
    assert r.returncode == (0 if cell["ok"] else 1)


# -- the acceptance drive, the census output, the run flags and locklint -------

def test_torch_cli_acceptance_prints_the_reference_lines(capsys):
    """``--acceptance all --scale 0.01``: one ``config N: PASS {...}``
    line a config, the reference CLI's lines word for word."""
    from hermes_tpu import cli as ref_cli

    argv = ["--acceptance", "all", "--scale", "0.01"]
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    capsys.readouterr()
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert r.stdout.splitlines() == want
    assert [ln.split(":")[0] for ln in want] == [f"config {n}"
                                                 for n in range(1, 6)]


RUN_FLAGS = ["--replicas", "3", "--keys", "64", "--sessions", "8",
             "--replay-slots", "4", "--ops-per-session", "12",
             "--arb-mode", "sort", "--chain-writes", "2", "--check"]


@pytest.mark.parametrize("extra", [
    ["--lane-budget", "6", "--rmw-retries", "2"],
    ["--pipeline-depth", "2", "--check-keys", "16", "--no-auto-rebase"],
    ["--wrap-stream", "--steps", "40", "--op-timeout", "8",
     "--op-retries", "1"],
])
def test_torch_cli_run_flags_match_reference_summary(capsys, extra):
    """The ported run flags build the reference's config: the drive's
    summary record (every counter) equals the reference CLI's."""
    _summary_pair(capsys, RUN_FLAGS + extra)


@pytest.mark.parametrize("argv", [
    ["--profile-out", "p.jsonl", "--backend", "sim"],
    ["--profile-out", "p.jsonl", "--acceptance", "1"],
    ["--pipeline-depth", "0"],
    ["--pipeline-depth", "2", "--backend", "batched"],
    ["--rmw-retries", "2", "--backend", "sim"],
    ["--no-auto-rebase", "--backend", "sharded"],
    ["--drill", "rolling", "--acceptance", "1"],
])
def test_torch_cli_run_flag_refusals_match_reference(capsys, argv):
    from hermes_tpu import cli as ref_cli

    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    capsys.readouterr()
    with pytest.raises(SystemExit) as ei:
        ref_cli.main(argv)
    assert ei.value.code == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert r.returncode == 2
    got = r.stderr.strip().splitlines()[-1]
    assert got.replace("hermes_tpu_torch", "hermes_tpu") == want, (got, want)


@pytest.mark.parametrize("argv,msg", [
    (["--no-donate"], "has no copying round"),
    (["--profile", "d", "--acceptance", "1"], "--profile traces the run"),
    (["--acceptance", "1", "--reads", "8", "--value-words", "6"],
     "drop --acceptance"),
])
def test_torch_cli_refuses_what_the_port_does_not_carry(argv, msg):
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--device", "cpu", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and msg in r.stderr, r.stderr


def test_torch_cli_profile_outputs(tmp_path, capsys):
    """``--profile-out`` writes the run config's census as the reference's
    record (same keys and kinds); ``--profile`` a torch.profiler trace;
    ``--metrics-jsonl`` the legacy interval records."""
    import json

    from hermes_tpu import cli as ref_cli

    port_out, ref_out = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    argv = RUN_FLAGS[:-1] + ["--steps", "6", "--report-every", "3"]
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", *argv, "--device", "cpu",
         "--profile-out", str(port_out), "--profile", str(tmp_path / "tr"),
         "--metrics-jsonl", str(tmp_path / "m.jsonl")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert ref_cli.main(argv + ["--profile-out", str(ref_out)]) == 0
    capsys.readouterr()
    (got,) = [json.loads(x) for x in port_out.read_text().splitlines()]
    (want,) = [json.loads(x) for x in ref_out.read_text().splitlines()]
    assert sorted(got) == sorted(want)
    assert (got["kind"], got["record"], got["backend"]) == (
        want["kind"], want["record"], want["backend"])
    assert got["census"]["kernel:stats_block"] == 1
    assert got["modeled_sparse_ms"] is None
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    recs = [json.loads(x) for x in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["metrics"] * 3


def test_torch_cli_serve_drive_under_locklint(capsys):
    """``--serve N --locklint``: the drive under the lock sanitizer, its
    report in the summary, no cycle."""
    import json

    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch", "--value-words", "6",
         "--keys", "256", "--sessions", "8", "--serve", "200", "--locklint",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["locklint"]["cycles"] == []
