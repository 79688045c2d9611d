"""The port's gate runner: the counterpart of ``scripts/run_gates.py``.

    python -m hermes_tpu_torch.gates [--device cuda|cpu]
        [--only census,hostlint] [--force] [--timeout S] [--out DIR]

Gates, the reference's twelve in its order and then the port's own
``acceptance``, each a process of its own on ``--device`` (default the
card, like every entry point; ``--device cpu`` on a machine without one):

  * ``census``       — ``python -m hermes_tpu_torch.obs.profile --check``:
    the round, read and heap censuses against ``obs/op_budget.json``;
  * ``obs-overhead`` — ``checks/obs_overhead.py``: phase metrics and
    per-op tracing change no outcome and cost under a host bound;
  * ``analysis``     — ``python -m hermes_tpu_torch.analysis.gate``: the
    static round analysis of the default, bench, bench-rmw and bench-mega
    configs on both engines, fused and split, and the kernel matrix,
    against the empty ``analysis/analysis_baseline.json``;
  * ``pipeline``     — ``checks/pipeline.py``: depth 1 against depth 3,
    a depth-2 KVS, the in-place round, one control upload a transition;
  * ``chaos``        — ``checks/chaos.py``: the seeded soak, its replay,
    torn snapshots, net chaos on the sim engine;
  * ``elastic``      — ``checks/elastic.py``: rolling restart, resize,
    range migration;
  * ``netchaos``     — ``checks/netchaos.py``: the wire matrix, the CRC,
    partitions at depth 2;
  * ``fleet``        — ``checks/fleet.py``: a four-group fleet's soak on
    both engines, a one-group rolling drill, its replay, the scale-out
    cells;
  * ``serving``      — ``checks/serving.py``: overload soaks at twice the
    probed capacity, the fleet facade, an overload storm, the read soak,
    the columnar plane and its floor, the shm plane and its one-store
    floor;
  * ``heap``         — ``checks/heap.py``: GC, byte-exact reads, a fleet
    move, torn heap snapshots, the heap census equal to the fixed-word
    one;
  * ``hostlint``     — ``python -m hermes_tpu_torch.analysis.hostlint``:
    the static pass over the port against its empty baseline, the red
    legs, and a short serving soak under ``HERMES_LOCKLINT=1`` with no
    lock-order cycle;
  * ``durability``   — ``checks/durability.py``: a store killed by its
    own powercut loses no committed write;
  * ``acceptance``   — ``python -m hermes_tpu_torch --acceptance all``:
    BASELINE configs 1 to 5 at scale 0.01, each drained and checked (the
    port's own gate, last).

The rules of the reference's runner hold:

  * the gates run one at a time, in this order, each in its own process
    group: one that outlasts ``--timeout`` is killed with its whole group
    and recorded ``timed_out``;
  * a live pytest in this checkout (a process whose working directory
    lies in it) aborts the run up front (``--force`` overrides): a
    parallel suite's load disturbs what a gate times, and a suite of
    another checkout is none of this run's business;
  * every gate runs with the flight recorder armed (``HERMES_FLIGHT_DIR``
    under ``--out``), and a failed gate carries the archives dumped
    while it ran.

One JSON summary line is printed; the whole summary goes to
``DIR/gates_summary.json`` under ``--out`` (a fresh temporary directory
by default).  Its ``gates`` block carries, beside each gate's verdict and
seconds, the cells the reference's summary tracks (``gate_cells``): the
hostlint legs, the durability gate's kill legs and WAL tax, the serving
floors and shm verdicts.  Exit 1 if any gate failed, 2 if refused.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, python argv without ``--device``): ``main`` appends
#: ``--device DEVICE`` to every gate's argv
GATES = (
    ("census", ("-m", "hermes_tpu_torch.obs.profile", "--check")),
    ("obs-overhead", ("-m", "hermes_tpu_torch.checks.obs_overhead")),
    ("analysis", ("-m", "hermes_tpu_torch.analysis.gate")),
    ("pipeline", ("-m", "hermes_tpu_torch.checks.pipeline")),
    ("chaos", ("-m", "hermes_tpu_torch.checks.chaos")),
    ("elastic", ("-m", "hermes_tpu_torch.checks.elastic")),
    ("netchaos", ("-m", "hermes_tpu_torch.checks.netchaos")),
    ("fleet", ("-m", "hermes_tpu_torch.checks.fleet")),
    ("serving", ("-m", "hermes_tpu_torch.checks.serving")),
    ("heap", ("-m", "hermes_tpu_torch.checks.heap")),
    ("hostlint", ("-m", "hermes_tpu_torch.analysis.hostlint")),
    ("durability", ("-m", "hermes_tpu_torch.checks.durability")),
    ("acceptance", ("-m", "hermes_tpu_torch", "--acceptance", "all",
                    "--scale", "0.01")),
)


def _runs_pytest(argv) -> bool:
    """True when an argument of ``argv`` is pytest itself (``-m pytest``,
    a ``pytest`` or ``py.test`` executable), not a longer string that
    names it (a shell's ``-c`` script)."""
    return any(os.path.basename(a) in (b"pytest", b"py.test") for a in argv)


def pytest_running() -> list:
    """The pids of live pytest processes whose working directory lies in
    this checkout (Linux /proc; a process this user cannot read is
    skipped)."""
    root = os.path.realpath(ROOT)
    hits = []
    for cmdline in glob.glob("/proc/[0-9]*/cmdline"):
        pid = cmdline.split("/")[2]
        try:
            with open(cmdline, "rb") as f:
                argv = f.read().split(b"\0")
            if not _runs_pytest(argv):
                continue
            cwd = os.path.realpath(os.readlink(f"/proc/{pid}/cwd"))
        except OSError:
            continue
        if cwd == root or cwd.startswith(root + os.sep):
            hits.append(pid)
    return hits


def gate_env(flight_dir: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["HERMES_FLIGHT_DIR"] = flight_dir
    return env


def _dumps(flight_dir: str) -> set:
    return set(glob.glob(os.path.join(flight_dir, "flight_*.json")))


def _report(out: str):
    """The gate's last JSON line, else its last lines of text."""
    lines = out.strip().splitlines()
    for line in reversed(lines):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"stdout_tail": lines[-8:]}


def run_gate(name: str, argv, timeout: int, flight_dir: str) -> dict:
    t0 = time.perf_counter()
    before = _dumps(flight_dir)
    # its own process group: on a timeout the whole group is killed, so a
    # gate wedged in a grandchild cannot stall the run or leak processes
    proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                            env=gate_env(flight_dir), start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out_b, err_b = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        out_b, err_b = proc.communicate()
        dumps = sorted(_dumps(flight_dir) - before)
        return dict(gate=name, ok=False, rc=-9, timed_out=True,
                    seconds=round(time.perf_counter() - t0, 2),
                    error=f"timed out after {timeout}s (process group "
                          "killed)",
                    stderr_tail=err_b.decode(errors="replace")[-1500:],
                    **({"flight_dumps": dumps} if dumps else {}))
    rc = proc.returncode
    dumps = sorted(_dumps(flight_dir) - before)
    return dict(gate=name, ok=rc == 0, rc=rc,
                seconds=round(time.perf_counter() - t0, 2),
                report=_report(out_b.decode(errors="replace")),
                **({"flight_dumps": dumps} if dumps else {}),
                **({} if rc == 0 else
                   {"stderr_tail": err_b.decode(errors="replace")[-1500:]}))


def _pick(cell: dict, keep) -> dict:
    return {k: cell[k] for k in keep if k in cell}


def gate_cells(r: dict) -> dict:
    """The tracked cells of gate result ``r`` that the summary's ``gates``
    block carries beside its verdict: the counterpart of the reference
    runner's ``_gate_cells``, key for key."""
    rep = r.get("report")
    if not isinstance(rep, dict):
        return {}
    if r["gate"] == "serving":
        out = {}
        cell = rep.get("columnar_floor")
        if isinstance(cell, dict):
            out["columnar_floor"] = _pick(cell, (
                "ops_per_sec", "required_ops_per_sec",
                "scalar_baseline_ops_per_sec", "speedup_vs_scalar",
                "current_scalar_ops_per_sec", "speedup_vs_current_scalar"))
        cell = rep.get("one_store_floor")
        if isinstance(cell, dict):
            out["one_store_floor"] = _pick(cell, (
                "ops_per_sec", "loopback_ops_per_sec",
                "speedup_vs_loopback", "required_speedup", "workers"))
        if "shm_replay_identical" in rep:
            out["shm_replay_identical"] = rep["shm_replay_identical"]
        topo = rep.get("one_store_topology")
        if isinstance(topo, dict):
            out["one_store_kill_leg"] = dict(
                survived=topo.get("kill_survived"), eof=topo.get("kill_eof"))
        return out
    if r["gate"] == "hostlint":
        legs = rep.get("legs")
        if not isinstance(legs, dict):
            return {}
        return {"legs": {name: dict(ok=leg.get("ok"),
                                    seconds=leg.get("seconds"))
                         for name, leg in legs.items()
                         if isinstance(leg, dict)}}
    if r["gate"] == "durability":
        out = {}
        for leg in ("kill_batched", "kill_sharded"):
            cell = rep.get(leg)
            if isinstance(cell, dict):
                out[leg] = dict(
                    lost=len(cell.get("committed_write_lost", [])),
                    committed_witnessed=cell.get("committed_witnessed"),
                    recovery_s=cell.get("recovery_s"))
        cell = rep.get("wal_overhead")
        if isinstance(cell, dict):
            out["wal_overhead"] = dict(
                on_vs_off=cell.get("on_vs_off"),
                wal_on_writes_per_s=(cell.get("wal_on") or {}).get(
                    "writes_per_s"),
                wal_off_writes_per_s=(cell.get("wal_off") or {}).get(
                    "writes_per_s"))
        return out
    return {}


def main(argv=None, gates=GATES) -> int:
    """Run ``gates`` (name, python argv) as the flags say; the summary
    line on stdout, exit 0 / 1 / 2."""
    ap = argparse.ArgumentParser(prog="python -m hermes_tpu_torch.gates",
                                 description=__doc__.splitlines()[0])
    names = [g[0] for g in gates]
    ap.add_argument("--device", default="cuda",
                    help="passed to every gate: cuda (default; a gate "
                    "raises without a card) or cpu")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {names}")
    ap.add_argument("--timeout", type=int, default=1200,
                    help="a gate's time limit in seconds")
    ap.add_argument("--force", action="store_true",
                    help="run even while a pytest is live")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="where the summary and the flight dumps go "
                         "(default: a fresh temporary directory)")
    args = ap.parse_args(argv)
    only = None
    if args.only:
        only = [s.strip() for s in args.only.split(",") if s.strip()]
        unknown = [s for s in only if s not in names]
        if unknown:
            ap.error(f"unknown gate(s) {unknown}; want a subset of {names}")
    pids = pytest_running()
    if pids and not args.force:
        print(json.dumps(dict(
            ok=False, error=f"pytest is running (pid {', '.join(pids)}): "
            "the gates must not run beside a test suite; wait for it or "
            "pass --force")))
        return 2
    out_dir = args.out or tempfile.mkdtemp(prefix="hermes_gates_")
    flight_dir = os.path.join(out_dir, "flight_dumps")
    os.makedirs(flight_dir, exist_ok=True)
    results = []
    for name, gate_argv in gates:
        if only is not None and name not in only:
            continue
        print(f"[gates] {name} ...", file=sys.stderr, flush=True)
        r = run_gate(name, (*gate_argv, "--device", args.device),
                     args.timeout, flight_dir)
        print(f"[gates] {name}: {'ok' if r['ok'] else 'FAIL'} in "
              f"{r['seconds']}s", file=sys.stderr, flush=True)
        results.append(r)
    summary = dict(
        ok=all(r["ok"] for r in results), device=args.device,
        gates={r["gate"]: dict(ok=r["ok"], seconds=r["seconds"],
                               **({"timed_out": True} if r.get("timed_out")
                                  else {}),
                               **({"flight_dumps": r["flight_dumps"]}
                                  if not r["ok"] and r.get("flight_dumps")
                                  else {}),
                               **gate_cells(r))
               for r in results},
        total_seconds=round(sum(r["seconds"] for r in results), 2),
        results=results, out=out_dir)
    with open(os.path.join(out_dir, "gates_summary.json"), "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(dict(ok=summary["ok"], device=args.device,
                          gates=summary["gates"],
                          total_seconds=summary["total_seconds"],
                          out=out_dir)))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
