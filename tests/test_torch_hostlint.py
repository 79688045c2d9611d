"""The port's host concurrency analysis (hermes_tpu_torch/concurrency.py,
analysis/hostlint.py, analysis/lockgraph.py) against the reference's
(hermes_tpu/concurrency.py, analysis/hostlint.py, analysis/lockgraph.py).

The static lint runs on every fixture source of tests/test_hostlint.py
under the same registry in both packages: the findings (code, severity,
class or function, attribute, audit tag, count) must be equal.  The
dynamic sanitizer takes the same scripted lock acquisitions in both: the
same cycles and the same per-lock counts.  Then the port's own tree lints
clean against its own registry and its empty baseline, the registry
schema refuses what the reference's refuses, ``make_lock`` obeys
``HERMES_LOCKLINT``, and the gate's legs pass.
"""

import json
import os
import threading

import pytest

from hermes_tpu import concurrency as ref_conc
from hermes_tpu.analysis import hostlint as ref_lint
from hermes_tpu.analysis import lockgraph as ref_graph
from hermes_tpu_torch import concurrency as conc
from hermes_tpu_torch.analysis import hostlint, lockgraph
from hermes_tpu_torch.analysis.findings import ERROR, WARN


def _registry(c):
    """tests/test_hostlint.py's synthetic registry, in package ``c``."""
    return (
        c.ClassGuards(
            cls="Box", module="m", locks=("_lk", "_lk2"),
            guards=(c.Guard("_lk", ("items",)),),
            audited=(c.audited("test-lockfree", "hits"),),
            blocking=(c.BlockingAudit("_lk", "sendall", "test-sanctioned"),)),
        c.ClassGuards(cls="Wild", module="m", audited=(
            c.audited("single-threaded-by-contract", "*"),)),
        c.ClassGuards(cls="Owned", module="m", thread_owner="_threads",
                      audited=(c.audited("test", "*"),)),
    )


# every source the reference's static-lint tests feed its lint
FIXTURES = {
    "guarded_write": "class Box:\n    def f(self):\n        self.items.append(1)\n",
    "guarded_read": "class Box:\n    def f(self):\n        return len(self.items)\n",
    "right_lock": ("class Box:\n    def f(self):\n        with self._lk:\n"
                   "            self.items.append(1)\n"),
    "wrong_lock": ("class Box:\n    def f(self):\n        with self._lk2:\n"
                   "            self.items.append(1)\n"),
    "init_exempt": "class Box:\n    def __init__(self):\n        self.items = []\n",
    "except_handler": (
        "class Box:\n    def f(self):\n        try:\n            pass\n"
        "        except Exception:\n            with self._lk:\n"
        "                self.items.append(1)\n        with self._lk:\n"
        "            try:\n                pass\n"
        "            except Exception:\n                self.items.clear()\n"),
    "nested_def": (
        "class Box:\n    def f(self):\n        with self._lk:\n"
        "            def cb():\n                self.items.append(1)\n"
        "            return cb\n"),
    "audited_attr": "class Box:\n    def f(self):\n        self.hits += 1\n",
    "blocking": ("class Box:\n    def f(self, sock):\n        with self._lk:\n"
                 "            sock.recv(4)\n"),
    "blocking_audit": ("class Box:\n    def f(self, sock):\n"
                       "        with self._lk:\n            sock.sendall(b'x')\n"),
    "blocking_audit_other_lock": (
        "class Box:\n    def f(self, sock):\n        with self._lk2:\n"
        "            sock.sendall(b'x')\n"),
    "method_cycle": (
        "class Box:\n    def f(self):\n        with self._lk:\n"
        "            with self._lk2:\n                pass\n    def g(self):\n"
        "        with self._lk2:\n            with self._lk:\n"
        "                pass\n"),
    "function_cycle": (
        "def f():\n    with a_lock:\n        with b_lock:\n            pass\n"
        "def g():\n    with b_lock:\n        with a_lock:\n            pass\n"),
    "consistent_order": (
        "def f():\n    with a_lock:\n        with b_lock:\n            pass\n"
        "def g():\n    with a_lock:\n        with b_lock:\n            pass\n"),
    "unregistered_lock": ("import threading\nclass Rogue:\n    def setup(self):\n"
                          "        self._lock = threading.Lock()\n"),
    "undeclared_lock": ("import threading\nclass Box:\n    def setup(self):\n"
                        "        self._extra_lock = threading.Lock()\n"),
    "thread_no_owner": ("import threading\nclass Box:\n    def go(self):\n"
                        "        threading.Thread(target=self.go).start()\n"),
    "thread_owned": (
        "import threading\nclass Owned:\n    def go(self):\n"
        "        t = threading.Thread(target=self.go)\n"
        "        self._threads.append(t)\n        t.start()\n"
        "    def close(self):\n        pass\n"),
    "function_thread_unjoined": ("import threading\ndef fire():\n"
                                 "    threading.Thread(target=print).start()\n"),
    "function_thread_joined": (
        "import threading\ndef fire():\n    t = threading.Thread(target=print)\n"
        "    t.start()\n    t.join()\n"),
    "wildcard": ("class Wild:\n    def f(self):\n        self.a = 1\n"
                 "        self.b.append(2)\n"),
    "undeclared_attr": "class Box:\n    def f(self):\n        self.stray = 1\n",
}


def _facts(findings):
    return sorted((f.code, f.severity, f.fn, f.op, f.audit, f.count,
                   f.line) for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_torch_hostlint_fixture_findings_equal_the_reference(name):
    src = FIXTURES[name]
    got = hostlint.lint_source(src, module="m", registry=_registry(conc))
    want = ref_lint.lint_source(src, module="m", registry=_registry(ref_conc))
    assert _facts(got) == _facts(want)
    assert [f.message for f in got if f.code == "lock-order-cycle"] == [
        f.message for f in want if f.code == "lock-order-cycle"]


def test_torch_hostlint_red_sources_flip():
    leg = hostlint.leg_red_static()
    assert leg == dict(ok=True, guarded_flip=True, order_flip=True)


class TestRegistry:
    def test_registry_validates_and_covers_the_ports_classes(self):
        conc.validate()
        table = conc.by_class()
        assert len(table) == len(conc.REGISTRY)
        assert table[("hermes_tpu_torch.serving.rpc", "TcpRpcServer")].locks \
            == ("_lock", "_map_lock")
        assert all(e.module.startswith("hermes_tpu_torch.")
                   for e in conc.REGISTRY)

    @pytest.mark.parametrize("bad,msg", [
        (lambda c: (c.ClassGuards(cls="C", module="m", locks=("_a",),
                                  guards=(c.Guard("_b", ("x",)),)),),
         "not in the entry's declared"),
        (lambda c: (c.ClassGuards(cls="C", module="m", locks=("_a",),
                                  guards=(c.Guard("_a", ("x",)),),
                                  audited=(c.audited("why", "x"),)),),
         "declared twice"),
        (lambda c: (c.ClassGuards(cls="C", module="m"),) * 2, "duplicate"),
    ])
    def test_schema_refusals_equal_the_reference(self, bad, msg):
        with pytest.raises(ValueError, match=msg) as got:
            conc.validate(bad(conc))
        with pytest.raises(ValueError) as want:
            ref_conc.validate(bad(ref_conc))
        assert str(got.value) == str(want.value)

    def test_audit_tag_contract(self):
        for args in (("", "x"), ("bad [tag]", "x"), ("tag-only",)):
            with pytest.raises(ValueError):
                conc.audited(*args)
        assert conc.audited("ok", "x", "y").attrs == ("x", "y")

    def test_make_lock_obeys_the_switch(self, monkeypatch):
        monkeypatch.delenv(conc.LOCKLINT_ENV, raising=False)
        assert not isinstance(conc.make_lock("T.plain"), lockgraph.ObsLock)
        monkeypatch.setenv(conc.LOCKLINT_ENV, "1")
        lk = conc.make_lock("T.obs")
        assert isinstance(lk, lockgraph.ObsLock) and lk.name == "T.obs"
        monkeypatch.setenv(conc.LOCKLINT_ENV, "0")
        assert not isinstance(conc.make_lock("T.off"), lockgraph.ObsLock)
        assert conc.LOCKLINT_ENV == ref_conc.LOCKLINT_ENV


class TestPackage:
    def test_port_lints_clean_against_its_registry(self):
        rep = hostlint.lint_package()
        assert hostlint.key_counts(rep["findings"]) == {}
        assert rep["proved"]["registered"] == len(conc.REGISTRY)
        assert rep["proved"]["files"] > 50
        assert rep["proved"]["with_sites"] > 10

    def test_shipped_baseline_is_empty(self):
        doc = json.loads(open(hostlint.BASELINE_PATH).read())
        assert doc["grandfathered"] == {}
        assert hostlint.load_baseline() == {}

    def test_stale_registry_entry_warns(self):
        ghost = conc.ClassGuards(cls="Ghost", module="hermes_tpu_torch.nowhere")
        rep = hostlint.lint_package(registry=conc.REGISTRY + (ghost,))
        hit = [f for f in rep["findings"] if f.code == "registry-stale-entry"]
        assert [f.fn for f in hit] == ["Ghost"] and hit[0].severity == WARN

    def test_baseline_diff(self):
        new, stale = hostlint.diff_baseline({"a": 2, "b": 1}, {"a": 1, "c": 3})
        assert new == {"a": 1, "b": 1} and stale == {"c": 3}


def _script(mod):
    """One scripted run of acquisitions: re-entry, a consistent pair, an
    inversion on two threads, run one after the other."""
    g = mod.LockGraph()
    a, b, c = (mod.ObsLock(n, g) for n in ("t.A", "t.B", "t.C"))
    with a:
        with a:
            pass
    with a:
        with c:
            pass

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    for fn in (fwd, rev):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    return g


def test_torch_lockgraph_scripted_run_equals_the_reference():
    got, want = _script(lockgraph), _script(ref_graph)
    assert got.cycles() == want.cycles() and len(got.cycles()) == 1
    strip = lambda rep: {n: dict(acquires=s["acquires"],
                                 contended=s["contended"])
                         for n, s in rep["locks"].items()}
    assert strip(got.report()) == strip(want.report())
    assert got.report()["n_edges"] == want.report()["n_edges"]
    assert sorted(got.edges()) == sorted(want.edges())
    (f,) = got.findings()
    (g,) = want.findings()
    assert (f.code, f.severity, f.op, f.engine) == (g.code, g.severity,
                                                    g.op, g.engine)
    assert f.severity == ERROR
    assert "fwd" in f.message and "rev" in f.message


def test_torch_obslock_semantics():
    g = lockgraph.LockGraph()
    lk = lockgraph.ObsLock("t.cm", g)
    grabbed = []

    def try_grab():
        got = lk.acquire(blocking=False)
        grabbed.append(got)
        if got:
            lk.release()

    with lk:
        t = threading.Thread(target=try_grab)
        t.start()
        t.join()
    t = threading.Thread(target=try_grab)
    t.start()
    t.join()
    assert grabbed == [False, True]
    with pytest.raises(RuntimeError):
        lockgraph.ObsLock("t.bad", g).release()


def test_torch_lockgraph_feeds_the_ports_registry():
    from hermes_tpu_torch.obs.metrics import MetricsRegistry

    g = lockgraph.LockGraph()
    reg = MetricsRegistry()
    g.attach_registry(reg)
    lk = lockgraph.ObsLock("t.feed", g)
    for _ in range(3):
        with lk:
            pass
    names = reg.names()
    assert "lock_hold_us:t.feed" in names and "lock_acquires:t.feed" in names
    assert all(n.startswith(lockgraph.LOCK_METRIC_PREFIX) for n in names)


def test_torch_reset_global_retargets_default_locks():
    lk = lockgraph.ObsLock("t.global")
    try:
        with lk:
            pass
        fresh = lockgraph.reset_global()
        with lk:
            pass
        assert fresh.report()["locks"]["t.global"]["acquires"] == 1
    finally:
        lockgraph.reset_global()


def test_torch_hostlint_gate_legs(tmp_path):
    """The gate: the static leg (with a findings export), the dynamic
    red leg and the serving soak under the sanitizer, on the CPU."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"_doc": "t", "grandfathered": {}}))
    out = tmp_path / "host.jsonl"
    st = hostlint.leg_static(str(base), False, str(out))
    assert st["ok"] and st["errors"] == 0 and st["warnings"] == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert any(r.get("record") == "program" for r in recs)
    assert hostlint.leg_red_dynamic()["n_findings"] == 1
    old = os.environ.get(conc.LOCKLINT_ENV)
    os.environ[conc.LOCKLINT_ENV] = "1"
    try:
        soak = hostlint.leg_soak(batches=8, warmup=1, device="cpu")
    finally:
        if old is None:
            os.environ.pop(conc.LOCKLINT_ENV)
        else:
            os.environ[conc.LOCKLINT_ENV] = old
        lockgraph.reset_global()
    assert soak["ok"] and soak["cycles"] == 0 and soak["n_lock_series"]
    assert "ColumnarTcpServer._lock" in soak["locks"]


def test_torch_hostlint_soak_and_gate_ask_for_the_card(monkeypatch):
    """The soak and the gate's entry point default to the card and raise
    without one; ``--static-only`` needs no device."""
    import torch

    monkeypatch.setenv(conc.LOCKLINT_ENV, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="asks for the card"):
        hostlint.leg_soak(batches=1, warmup=0)
    with pytest.raises(RuntimeError, match="asks for the card"):
        hostlint.main([])


def test_torch_hostlint_gate_fails_on_a_new_finding(tmp_path, monkeypatch):
    from hermes_tpu_torch.analysis.findings import Finding

    injected = Finding(pass_name="hostlint", code="guarded-attr-unlocked",
                       severity=ERROR, message="injected", file="x.py",
                       fn="X.f", op="boom", engine="host")
    monkeypatch.setattr(hostlint, "lint_package", lambda *a, **k: dict(
        engine="host", n_eqns=1, n_sites=1, proved={}, findings=[injected]))
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"_doc": "t", "grandfathered": {}}))
    st = hostlint.leg_static(str(base), False, None)
    assert not st["ok"] and st["new_findings"] == [injected.key]
    st = hostlint.leg_static(str(base), True, None)
    assert st["ok"]
    doc = json.loads(base.read_text())
    assert doc["grandfathered"][injected.key]["count"] == 1


def test_torch_chip_smoke_locklint_rehearsal(monkeypatch):
    """``chip_smoke.phase_locklint`` on the CPU at a cut shape (2^12 keys,
    64 sessions; 2 columnar batches of 384 requests; 100 socket
    requests): both socket drives answer everything under the sanitizer
    with no cycle and holds within the bound, and no mega kernel runs."""
    from types import SimpleNamespace

    import torch

    import chip_smoke as cs
    from hermes_tpu_torch import config, serving
    from hermes_tpu_torch.core import kernels, megaround
    from hermes_tpu_torch.workload import openloop

    counters = {"stats_block": kernels.stats_block,
                "mega_route": megaround.mega_route,
                "mega_apply": megaround.mega_apply,
                "mega_replay": megaround.mega_replay}
    monkeypatch.setattr(cs, "COLUMNAR_OPS", 4 * 384)
    monkeypatch.setattr(cs, "COLUMNAR_PER_ROUND", 384)
    monkeypatch.setattr(cs, "SOCKET_N", 100)
    monkeypatch.delenv(conc.LOCKLINT_ENV, raising=False)
    sv = SimpleNamespace(
        kvs_cfg=lambda **over: config.bench_cfg("a", over=dict(
            device_stream=False, read_unroll=1, n_keys=1 << 12,
            n_sessions=64, **over)),
        device="cpu", ServingConfig=serving.ServingConfig,
        MixSpec=openloop.MixSpec)
    ac = SimpleNamespace(concurrency=conc, lockgraph=lockgraph,
                         hostlint=hostlint)
    moved = cs.phase_locklint(torch, sv, ac, counters, "cpu")
    assert set(moved) == set(counters)
    assert not any(moved[k] for k in moved if k != "stats_block")
    assert conc.LOCKLINT_ENV not in os.environ
