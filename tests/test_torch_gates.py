"""The port's gate runner (``hermes_tpu_torch/gates.py``) on stub gates:
serial runs, the summary under ``--out`` only, the process-group kill on
a timeout, the flight dumps of a failed gate, and the refusal beside a
pytest of this checkout (and only of this checkout)."""

import json
import os
import subprocess
import sys
import time

import pytest

from hermes_tpu_torch import gates

OK = ("-c", "import json; print(json.dumps({'ok': True, 'n': 3}))")
FAIL = ("-c", "import sys; print('no json here'); sys.exit(1)")


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state not in ("Z", "X")


def _summary_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_torch_gates_run_serially_and_write_the_summary_under_out(
        tmp_path, capsys):
    root_summary = os.path.join(gates.ROOT, "GATES_SUMMARY.json")
    before = (open(root_summary, "rb").read()
              if os.path.exists(root_summary) else None)
    rc = gates.main(["--force", "--out", str(tmp_path)],
                    gates=(("first", OK), ("second", FAIL)))
    assert rc == 1
    line = _summary_line(capsys)
    assert line["ok"] is False and line["out"] == str(tmp_path)
    assert line["gates"]["first"]["ok"] and not line["gates"]["second"]["ok"]
    doc = json.loads((tmp_path / "gates_summary.json").read_text())
    assert [r["gate"] for r in doc["results"]] == ["first", "second"]
    assert doc["results"][0]["report"] == {"ok": True, "n": 3}
    assert doc["results"][1]["report"] == {"stdout_tail": ["no json here"]}
    assert doc["results"][1]["rc"] == 1
    after = (open(root_summary, "rb").read()
             if os.path.exists(root_summary) else None)
    assert after == before  # the reference's artifact is never written


def test_torch_gates_only_selects_and_refuses_unknown_names(tmp_path,
                                                            capsys):
    rc = gates.main(["--force", "--only", "second", "--out", str(tmp_path)],
                    gates=(("first", FAIL), ("second", OK)))
    assert rc == 0
    assert list(_summary_line(capsys)["gates"]) == ["second"]
    with pytest.raises(SystemExit):
        gates.main(["--force", "--only", "nope"], gates=(("first", OK),))


def test_torch_gates_timeout_kills_the_whole_process_group(tmp_path,
                                                           capsys):
    pidfile = tmp_path / "grandchild.pid"
    wedged = ("-c", "import subprocess, sys, time; "
              "p = subprocess.Popen([sys.executable, '-c', "
              "'import time; time.sleep(120)']); "
              f"open({str(pidfile)!r}, 'w').write(str(p.pid)); "
              "time.sleep(120)")
    t0 = time.perf_counter()
    rc = gates.main(["--force", "--timeout", "3", "--out", str(tmp_path)],
                    gates=(("wedged", wedged),))
    assert rc == 1 and time.perf_counter() - t0 < 60
    line = _summary_line(capsys)
    assert line["gates"]["wedged"] == dict(ok=False, seconds=line["gates"][
        "wedged"]["seconds"], timed_out=True)
    doc = json.loads((tmp_path / "gates_summary.json").read_text())
    assert doc["results"][0]["rc"] == -9
    pid = int(pidfile.read_text())
    deadline = time.time() + 10
    while _alive(pid) and time.time() < deadline:
        time.sleep(0.1)
    assert not _alive(pid), "the gate's grandchild outlived the timeout"


def test_torch_gates_a_failed_gate_carries_its_flight_dumps(tmp_path,
                                                           capsys):
    dumping = ("-c", "import os, sys; d = os.environ['HERMES_FLIGHT_DIR']; "
               "open(os.path.join(d, 'flight_1.json'), 'w').write('{}'); "
               "sys.exit(3)")
    rc = gates.main(["--force", "--out", str(tmp_path)],
                    gates=(("dumping", dumping), ("fine", OK)))
    assert rc == 1
    line = _summary_line(capsys)
    want = [str(tmp_path / "flight_dumps" / "flight_1.json")]
    assert line["gates"]["dumping"]["flight_dumps"] == want
    assert "flight_dumps" not in line["gates"]["fine"]


def test_torch_gates_refuse_beside_a_pytest_unless_forced(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setattr(gates, "pytest_running", lambda: ["4242"])
    rc = gates.main(["--out", str(tmp_path)], gates=(("first", OK),))
    assert rc == 2
    line = _summary_line(capsys)
    assert line["ok"] is False and "4242" in line["error"]
    assert not (tmp_path / "gates_summary.json").exists()
    assert gates.main(["--force", "--out", str(tmp_path)],
                      gates=(("first", OK),)) == 0
    assert (tmp_path / "gates_summary.json").exists()


@pytest.mark.parametrize("in_checkout", [True, False])
def test_torch_gates_pytest_scan_is_this_checkouts(in_checkout):
    """A process with "pytest" on its command line counts only when its
    working directory lies in the checkout."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)", "pytest"],
        cwd=gates.ROOT if in_checkout else os.path.dirname(gates.ROOT))
    try:
        time.sleep(0.2)
        assert (str(proc.pid) in gates.pytest_running()) is in_checkout
    finally:
        proc.kill()
        proc.wait()


def test_torch_gates_pytest_scan_skips_a_shell_that_names_pytest():
    """A shell whose ``-c`` script mentions pytest (``cd X && python3
    chip_smoke.py; python -m pytest ...``) runs no pytest itself."""
    proc = subprocess.Popen(
        ["bash", "-c", "sleep 60; echo python -m pytest tests/x.py"],
        cwd=gates.ROOT)
    try:
        time.sleep(0.2)
        assert str(proc.pid) not in gates.pytest_running()
    finally:
        proc.kill()
        proc.wait()
    assert gates._runs_pytest([b"/usr/bin/python3", b"-m", b"pytest"])
    assert gates._runs_pytest([b"/venv/bin/py.test", b"tests"])


# -- the gates themselves ------------------------------------------------------

PORTED = ("census", "obs-overhead", "analysis", "pipeline", "chaos",
          "elastic", "netchaos", "fleet", "serving", "heap", "hostlint",
          "durability", "acceptance")


def _reference_runner():
    from torch_gatepair import load_script

    return load_script("run_gates")


def test_torch_gates_list_the_eleven_in_the_references_order():
    """The reference's twelve gates in its order (since the fleet and
    serving gates were ported: all of them), then the port's own
    acceptance gate."""
    ref = _reference_runner()
    names = tuple(g[0] for g in gates.GATES)
    assert names == PORTED
    assert names[:-1] == tuple(n for n, _ in ref.GATES)
    for name, argv in gates.GATES:
        assert "--device" not in argv, name  # the runner adds it


#: reports of the gates whose cells the summary carries, with the fields
#: the reference's ``_gate_cells`` reads, and one field it leaves out
CELL_REPORTS = {
    "serving": dict(
        ok=True, columnar_floor=dict(
            ops_per_sec=21000.5, required_ops_per_sec=17590.0,
            scalar_baseline_ops_per_sec=351.8, speedup_vs_scalar=59.7,
            current_scalar_ops_per_sec=1935.8,
            speedup_vs_current_scalar=10.8, seconds=0.3),
        one_store_floor=dict(ops_per_sec=97599.2,
                             loopback_ops_per_sec=25113.5,
                             speedup_vs_loopback=3.89, required_speedup=2.0,
                             workers=2, statuses={"ok": 9}),
        shm_replay_identical=True,
        one_store_topology=dict(kill_survived=3, kill_eof=1, workers=2)),
    "hostlint": dict(ok=True, legs=dict(
        static=dict(ok=True, seconds=1.5, findings=0),
        locklint=dict(ok=True, seconds=4.25), note="not a leg")),
    "durability": dict(
        ok=True,
        kill_batched=dict(committed_write_lost=[], committed_witnessed=640,
                          recovery_s=0.5),
        kill_sharded=dict(committed_write_lost=[[1, 2]],
                          committed_witnessed=512, recovery_s=0.75),
        wal_overhead=dict(on_vs_off=0.91, wal_on=dict(writes_per_s=100.0),
                          wal_off=dict(writes_per_s=110.0))),
    "fleet": dict(ok=True, scaleout=dict(scaleout_x=3.9)),
}


def test_torch_gates_summary_carries_the_references_cells(tmp_path, capsys,
                                                          monkeypatch):
    """The port's runner on stub gates printing these reports: its
    summary's ``gates`` block, but for the seconds, equals what the
    reference's runner (its ``_gate_cells``) writes for the same results
    (the reference run with its root in tmp_path)."""
    stubs = tuple((name, ("-c", f"print({json.dumps(rep)!r})"))
                  for name, rep in CELL_REPORTS.items())
    assert gates.main(["--force", "--out", str(tmp_path / "port")],
                      gates=stubs) == 0
    got = _summary_line(capsys)["gates"]
    ref = _reference_runner()
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    monkeypatch.setattr(ref, "REPO", str(ref_dir))
    monkeypatch.setattr(ref, "GATES", tuple((n, n) for n in CELL_REPORTS))
    monkeypatch.setattr(ref, "pytest_running", lambda: [])
    monkeypatch.setattr(ref, "run_gate", lambda name, *a: dict(
        gate=name, ok=True, rc=0, seconds=1.0, report=CELL_REPORTS[name]))
    monkeypatch.setattr(sys, "argv", ["run_gates.py"])
    assert ref.main() == 0
    want = json.loads((ref_dir / "GATES_SUMMARY.json").read_text())["gates"]
    assert sorted(got) == sorted(want) == sorted(CELL_REPORTS)
    for name in want:
        assert {k: v for k, v in got[name].items() if k != "seconds"} == \
            {k: v for k, v in want[name].items() if k != "seconds"}, name
    assert got["serving"]["one_store_kill_leg"] == dict(survived=3, eof=1)
    assert got["durability"]["kill_sharded"]["lost"] == 1
    assert set(got["hostlint"]["legs"]) == {"static", "locklint"}
    assert set(got["fleet"]) == {"ok", "seconds"}
    for name in CELL_REPORTS:  # a report without cells adds none
        assert gates.gate_cells(dict(gate=name, report=None)) == {}


ARGV = ("-c", "import json, sys; print(json.dumps({'argv': sys.argv[1:]}))")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_torch_gates_pass_the_device_to_every_gate(tmp_path, capsys,
                                                    device):
    flags = ["--force", "--out", str(tmp_path)]
    if device:
        flags += ["--device", device]
    rc = gates.main(flags, gates=(("one", ARGV), ("two", ARGV)))
    assert rc == 0
    assert _summary_line(capsys)["device"] == (device or "cuda")
    doc = json.loads((tmp_path / "gates_summary.json").read_text())
    for r in doc["results"]:
        assert r["report"]["argv"] == ["--device", device or "cuda"]


def test_torch_gates_real_run_writes_no_reference_artifact(tmp_path,
                                                          capsys):
    from torch_gatepair import artifacts

    before = artifacts()
    rc = gates.main(["--device", "cpu", "--force", "--only",
                     "pipeline,obs-overhead", "--out", str(tmp_path)])
    assert rc == 0, capsys.readouterr()
    assert artifacts() == before
    line = _summary_line(capsys)
    assert list(line["gates"]) == ["obs-overhead", "pipeline"]
    doc = json.loads((tmp_path / "gates_summary.json").read_text())
    assert all(r["report"]["device"] == "cpu" for r in doc["results"])
    assert sorted(os.listdir(tmp_path)) == ["flight_dumps",
                                           "gates_summary.json"]


def test_torch_chip_smoke_gates_rehearsal(capsys):
    """``chip_smoke.phase_gates`` on the CPU with one gate and the
    obs-overhead timing at the gate shape, at the smoke's reps (on the
    card: the nine gates, the bench shape, no ``--force``)."""
    from types import SimpleNamespace

    import torch

    import chip_smoke as cs

    gt = SimpleNamespace(device="cpu", root=gates.ROOT, gates=("pipeline",),
                         obs_shape="gate", runner_args=("--force",))
    total = cs.phase_gates(torch, gt, "cpu")
    assert total["stats_block"] == 0  # a wrapper counts CUDA launches only
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [d["phase"] for d in lines] == ["gates", "obs-overhead-bench"]
    assert lines[0]["gates"]["pipeline"]["ok"]
    assert lines[1]["shape"] == "gate"
    assert len(lines[1]["times_on"]) == cs.OBS_BENCH_REPS == 5
    assert set(cs.GATES_PORTED) < set(PORTED)


def test_torch_chip_smoke_gate_floors_hold_the_bars():
    """``chip_smoke.gate_floors`` reads the serving floors from the
    summary's cells and the fleet's ``scaleout_x`` from its report, and
    names each cell under its bar."""
    import chip_smoke as cs

    def summary(col, ratio, scaleout):
        cells = gates.gate_cells(dict(gate="serving", report=dict(
            CELL_REPORTS["serving"],
            columnar_floor=dict(CELL_REPORTS["serving"]["columnar_floor"],
                                ops_per_sec=col),
            one_store_floor=dict(CELL_REPORTS["serving"]["one_store_floor"],
                                 speedup_vs_loopback=ratio))))
        fleet = dict(ok=True, scaleout=dict(
            scaleout_x=scaleout, aggregate_writes_per_sec=4.0,
            concurrent=dict(writes_per_sec=1.5)))
        return dict(gates=dict(serving=dict(ok=True, **cells),
                               fleet=dict(ok=True)),
                    results=[dict(gate="serving", report={}),
                             dict(gate="fleet", report=fleet)])

    floors, missed = cs.gate_floors(summary(21000.5, 3.89, 3.9))
    assert missed is None
    assert floors["columnar_floor_ops_per_s"] == 21000.5
    assert floors["one_store_ratio"] == 3.89 and floors["scaleout_x"] == 3.9
    assert floors["one_store_kill_leg"] == dict(survived=3, eof=1)
    _, missed = cs.gate_floors(summary(17000.0, 1.9, 2.5))
    assert "columnar floor" in missed and "one-store floor" in missed
    assert "scaleout_x 2.5" in missed
    assert cs.gate_floors(dict(gates={}, results=[])) == ({}, None)
