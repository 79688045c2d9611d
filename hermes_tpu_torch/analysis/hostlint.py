"""The static host-concurrency lint: the port's copy of
``hermes_tpu/analysis/hostlint.py``, holding the port's threaded host tier
to the guard registry in ``hermes_tpu_torch/concurrency.py``.

One AST pass over the whole package (lexical, intra-procedural; what it
cannot see, the rules below say):

  * **guarded-attr-unlocked** (error): a read or write of a registry-
    guarded attribute outside ``with self.<lock>:`` in the declaring
    class (``__init__`` is exempt: construction before publication).
  * **blocking-under-lock** (error): a blocking call (``sendall`` /
    ``recv`` / ``accept`` / ``fsync`` / ``sleep`` / ``Future.result`` /
    ``device_get`` / ``join`` / ``wait``) lexically inside a held-lock
    region.  A ``BlockingAudit`` in the registry downgrades the one
    sanctioned site class to info, its tag attached.
  * **lock-order-cycle** (error): the nested-``with`` static held-before
    graph across ALL modules has a cycle (the lexical twin of
    lockgraph.py's dynamic graph).
  * **undeclared-lock** / **unregistered-lock-class** (warn): a bare
    ``threading.Lock()`` (or ``make_lock``/``RLock``) assigned on a class
    outside the registry, or a lock attribute the class's entry does not
    declare.
  * **daemon-thread-unowned** (warn): a ``threading.Thread`` started
    from a class without a registered ``thread_owner`` and a ``close()``,
    or from a function that never ``join``s it.
  * **undeclared-mutable-attr** (warn): a registered class mutates an
    attribute outside ``__init__`` that is neither guarded nor audited.
  * **host-audited** (info): every access under an ``audited(tag)``
    declaration; suppressions stay visible.

Lexical means: ``fe = self.fe`` aliasing and locks threaded across
functions are out of model; the registry documents those contracts as
audited entries instead (the Frontend's wildcard).

Findings use the reference's ``Finding`` schema
(``analysis/findings.py``) and gate through ``python -m
hermes_tpu_torch.gates`` against the port's baseline,
``hostlint_baseline.json`` beside this module, which ships empty.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from hermes_tpu_torch import concurrency as conc
from hermes_tpu_torch.analysis import findings as findings_lib
from hermes_tpu_torch.analysis.findings import (ERROR, INFO, WARN, Finding,
                                                diff_baseline, key_counts)

#: blocking callees (join and wait too: the same deadlock class)
BLOCKING_CALLS = frozenset({
    "sendall", "recv", "accept", "fsync", "sleep", "result",
    "device_get", "join", "wait"})

#: method names that mutate their receiver (list/dict/set/deque/queue)
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "clear", "add", "discard", "update", "setdefault",
    "put", "set", "sort"})

#: lock-constructor callees recognized by the bare-lock rule
LOCK_CTORS = frozenset({"Lock", "RLock", "make_lock", "ObsLock"})

CLOSERS = ("close", "stop", "shutdown")


def _split_fields(node) -> Tuple[list, list]:
    """Partition a statement's AST fields into (statement-bodies,
    expressions).  ``except``/``case`` wrappers are not ``ast.stmt``
    themselves but carry statement bodies — flattening them into the
    expression scan would lose ``with``-block tracking inside handlers
    (the pump loop's error path lives in one)."""
    body_fields: list = []
    exprs: list = []
    for _name, value in ast.iter_fields(node):
        if isinstance(value, list):
            for v in value:
                if isinstance(v, ast.stmt):
                    body_fields.append([v])
                elif isinstance(v, ast.ExceptHandler):
                    if v.type is not None:
                        exprs.append(v.type)
                    body_fields.append(v.body)
                elif v.__class__.__name__ == "match_case":
                    if v.guard is not None:
                        exprs.append(v.guard)
                    body_fields.append(v.body)
                elif isinstance(v, ast.AST):
                    exprs.append(v)
        elif isinstance(value, ast.AST):
            exprs.append(value)
    return body_fields, exprs


def _module_of(path: str, pkg_root: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(pkg_root))
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _call_name(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lockish(name: str) -> bool:
    return "lock" in name.lower()


class _Sink:
    """Finding aggregator: one record per stable key, counted."""

    def __init__(self):
        self._by_key: Dict[str, Finding] = {}
        self.n_with_sites = 0
        self.n_classes = 0
        self.n_threads = 0
        # static held-before graph: (a, b) -> first site "file:line in fn"
        self.edges: Dict[Tuple[str, str], str] = {}

    def add(self, f: Finding) -> None:
        have = self._by_key.get(f.key)
        if have is None:
            self._by_key[f.key] = f
        else:
            have.count += f.count

    def findings(self) -> List[Finding]:
        return sorted(self._by_key.values(),
                      key=lambda f: (f.file, f.line, f.code, f.op))


class _ClassLinter:
    def __init__(self, module: str, relfile: str,
                 entry: Optional[conc.ClassGuards], cls: ast.ClassDef,
                 sink: _Sink):
        self.module = module
        self.relfile = relfile
        self.entry = entry
        self.cls = cls
        self.sink = sink
        self.guard_of: Dict[str, str] = {}
        self.audit_of: Dict[str, str] = {}
        self.wildcard: Optional[str] = None
        if entry is not None:
            for g in entry.guards:
                for a in g.attrs:
                    self.guard_of[a] = g.lock
            for au in entry.audited:
                if au.attrs == ("*",):
                    self.wildcard = au.tag
                else:
                    for a in au.attrs:
                        self.audit_of[a] = au.tag
        self.methods = [n for n in cls.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))]
        self.method_names = {m.name for m in self.methods}

    def _find(self, code: str, severity: str, message: str, *, fn: str,
              op: str, line: int, audit: Optional[str] = None,
              pass_name: str = "hostlint") -> None:
        self.sink.add(Finding(
            pass_name=pass_name, code=code, severity=severity,
            message=message, file=self.relfile, line=line, fn=fn, op=op,
            engine="host", audit=audit))

    # -- mutation discovery --------------------------------------------------

    def mutated_attrs(self) -> Dict[str, int]:
        """{attr: first line} mutated outside __init__ (assignment,
        aug-assign, subscript store, del, or a MUTATORS method call)."""
        out: Dict[str, int] = {}

        def note(attr, line):
            out.setdefault(attr, line)

        for m in self.methods:
            if m.name == "__init__":
                continue
            for node in ast.walk(m):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        self._note_target(tgt, note)
                elif isinstance(node, ast.AugAssign):
                    self._note_target(node.target, note)
                elif isinstance(node, ast.Delete):
                    for tgt in node.targets:
                        self._note_target(tgt, note)
                elif isinstance(node, ast.Call):
                    name = _call_name(node.func)
                    if (name in MUTATORS
                            and isinstance(node.func, ast.Attribute)):
                        attr = _self_attr(node.func.value)
                        if attr is not None:
                            note(attr, node.lineno)
        return out

    def _note_target(self, tgt, note) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._note_target(e, note)
            return
        if isinstance(tgt, (ast.Subscript, ast.Starred)):
            self._note_target(tgt.value, note)
            return
        attr = _self_attr(tgt)
        if attr is not None:
            note(attr, tgt.lineno)

    # -- the lexical walk ----------------------------------------------------

    def lock_id(self, expr) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None:
            if self.entry is not None and attr in self.entry.locks:
                return f"{self.cls.name}.{attr}"
            if _is_lockish(attr):
                return f"{self.cls.name}.{attr}"
            return None
        if isinstance(expr, ast.Name) and _is_lockish(expr.id):
            return f"{self.module}.{expr.id}"
        return None

    def run(self) -> None:
        self.sink.n_classes += 1
        mutated = self.mutated_attrs()
        for m in self.methods:
            self._walk_fn(m, held=())

        if self.entry is None:
            return
        # registry completeness over the class's mutable surface
        undeclared = {a: ln for a, ln in mutated.items()
                      if a not in self.guard_of and a not in self.audit_of}
        if self.wildcard is not None and undeclared:
            attrs = sorted(undeclared)
            self.sink.add(Finding(
                pass_name="hostlint", code="host-audited", severity=INFO,
                message=f"{len(attrs)} lock-free attribute(s) covered by "
                f"the class's wildcard audit: {', '.join(attrs)}",
                file=self.relfile, line=min(undeclared.values()),
                fn=self.cls.name, op="*", engine="host",
                audit=self.wildcard, count=len(attrs)))
        elif undeclared:
            for a, ln in sorted(undeclared.items()):
                self._find(
                    "undeclared-mutable-attr", WARN,
                    f"{self.cls.name}.{a} is mutated outside __init__ but "
                    f"the concurrency registry neither guards nor audits "
                    f"it — declare it in hermes_tpu_torch/concurrency.py",
                    fn=self.cls.name, op=a, line=ln)

    def _walk_fn(self, fn, held: tuple) -> None:
        fn_label = f"{self.cls.name}.{fn.name}"
        in_init = fn.name == "__init__"
        self._walk_body(fn.body, held, fn_label, in_init)

    def _walk_body(self, stmts, held, fn_label, in_init) -> None:
        for node in stmts:
            self._walk_node(node, held, fn_label, in_init)

    def _walk_node(self, node, held, fn_label, in_init) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, possibly without the lock: fresh
            # lexical context
            self._walk_body(node.body, (), f"{fn_label}.{node.name}",
                            in_init)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly = list(held)
            for item in node.items:
                lid = self.lock_id(item.context_expr)
                # the context expression itself evaluates UNLOCKED
                self._scan_exprs([item.context_expr], tuple(newly),
                                 fn_label, in_init, skip_lock=lid)
                if lid is not None:
                    self.sink.n_with_sites += 1
                    for h in newly:
                        if h != lid and (h, lid) not in self.sink.edges:
                            self.sink.edges[(h, lid)] = (
                                f"{self.relfile}:{node.lineno} in "
                                f"{fn_label}")
                    newly.append(lid)
            self._walk_body(node.body, tuple(newly), fn_label, in_init)
            return
        # compound statements: recurse into their bodies with the same
        # held set; scan their own expressions
        body_fields, exprs = _split_fields(node)
        self._scan_exprs(exprs, held, fn_label, in_init)
        for body in body_fields:
            self._walk_body(body, held, fn_label, in_init)

    def _scan_exprs(self, exprs, held, fn_label, in_init,
                    skip_lock=None) -> None:
        for root in exprs:
            for node in ast.walk(root):
                if isinstance(node, ast.Call):
                    self._check_call(node, held, fn_label, in_init)
                attr = _self_attr(node)
                if attr is None:
                    continue
                if (self.entry is not None and attr in self.entry.locks
                        and f"{self.cls.name}.{attr}" == skip_lock):
                    continue
                self._check_access(attr, node.lineno, held, fn_label,
                                   in_init)

    def _check_access(self, attr, line, held, fn_label, in_init) -> None:
        if self.entry is None or in_init:
            return
        lock = self.guard_of.get(attr)
        if lock is not None:
            lid = f"{self.cls.name}.{lock}"
            if lid not in held:
                self._find(
                    "guarded-attr-unlocked", ERROR,
                    f"{self.cls.name}.{attr} is declared guarded by "
                    f"{lid} but accessed without it",
                    fn=fn_label, op=attr, line=line)
            return
        tag = self.audit_of.get(attr)
        if tag is not None:
            self._find(
                "host-audited", INFO,
                f"{self.cls.name}.{attr} accessed lock-free under an "
                f"audited declaration",
                fn=fn_label, op=attr, line=line, audit=tag)

    def _check_call(self, node, held, fn_label, in_init) -> None:
        name = _call_name(node.func)
        if name is None:
            return
        # thread-ownership rule
        if name == "Thread":
            self.sink.n_threads += 1
            owned = (self.entry is not None
                     and self.entry.thread_owner is not None
                     and any(c in self.method_names for c in CLOSERS))
            if not owned:
                self._find(
                    "daemon-thread-unowned", WARN,
                    f"{self.cls.name} starts threads but the registry "
                    f"declares no thread_owner (or the class has no "
                    f"{'/'.join(CLOSERS)} to deregister them)",
                    fn=fn_label, op="Thread", line=node.lineno,
                    pass_name="hostthreads")
        if not held:
            return
        if name in BLOCKING_CALLS:
            # sanctioned sites downgrade with the audit tag attached
            if self.entry is not None:
                for b in self.entry.blocking:
                    if (b.call == name
                            and f"{self.cls.name}.{b.lock}" in held):
                        self._find(
                            "blocking-under-lock-audited", INFO,
                            f"audited blocking call {name}() under "
                            f"{self.cls.name}.{b.lock}",
                            fn=fn_label, op=name, line=node.lineno,
                            audit=b.tag)
                        return
            self._find(
                "blocking-under-lock", ERROR,
                f"blocking call {name}() while holding "
                f"{', '.join(held)} — a stalled peer (or a slow device "
                f"sync) extends the critical section unboundedly",
                fn=fn_label, op=name, line=node.lineno)


def _lint_bare_locks(module, relfile, cls, entry, sink: _Sink) -> None:
    """threading.Lock() assigned on a class the registry doesn't cover
    (or to an attribute its entry doesn't declare) — warn."""
    for m in (n for n in cls.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
        for node in ast.walk(m):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            if _call_name(node.value.func) not in LOCK_CTORS:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if entry is None:
                    sink.add(Finding(
                        pass_name="hostlint", code="unregistered-lock-class",
                        severity=WARN, engine="host", file=relfile,
                        line=node.lineno, fn=f"{cls.name}.{m.name}",
                        op=attr,
                        message=f"{cls.name} creates lock {attr!r} but "
                        f"has no entry in the concurrency registry "
                        f"(hermes_tpu_torch/concurrency.py) — declare its "
                        f"guards or audit it"))
                elif attr not in entry.locks:
                    sink.add(Finding(
                        pass_name="hostlint", code="undeclared-lock",
                        severity=WARN, engine="host", file=relfile,
                        line=node.lineno, fn=f"{cls.name}.{m.name}",
                        op=attr,
                        message=f"{cls.name}.{attr} is a lock the "
                        f"registry entry does not declare in its "
                        f"``locks`` tuple"))


def _lint_function_threads(module, relfile, fn, sink: _Sink,
                           prefix: str = "") -> None:
    """Module-level function rule: a created Thread must be joined in
    the same function (lexically) or it leaks past its owner."""
    label = f"{prefix}{fn.name}"
    makes = [n for n in ast.walk(fn)
             if isinstance(n, ast.Call) and _call_name(n.func) == "Thread"]
    if not makes:
        return
    sink.n_threads += len(makes)
    joins = any(isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
                for n in ast.walk(fn))
    if not joins:
        for n in makes:
            sink.add(Finding(
                pass_name="hostthreads", code="daemon-thread-unowned",
                severity=WARN, engine="host", file=relfile,
                line=n.lineno, fn=label, op="Thread",
                message=f"function {label} starts a thread it never "
                f"joins — the thread outlives its owner with no "
                f"deregistration path"))


def _lint_tree(tree: ast.AST, module: str, relfile: str,
               reg: dict, sink: _Sink, seen_classes: set) -> None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            entry = reg.get((module, node.name))
            if entry is not None:
                seen_classes.add((module, node.name))
            _ClassLinter(module, relfile, entry, node, sink).run()
            _lint_bare_locks(module, relfile, node, entry, sink)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _lint_function_threads(module, relfile, node, sink)
            # module-level functions may also nest with-locks
            _FnOrderScan(module, relfile, node, sink).run()


class _FnOrderScan:
    """Order-graph (+ blocking) scan for module-level functions — same
    lexical rules, no registry entry (self-less)."""

    def __init__(self, module, relfile, fn, sink: _Sink):
        self.module = module
        self.relfile = relfile
        self.fn = fn
        self.sink = sink

    def run(self) -> None:
        self._walk(self.fn.body, ())

    def _lock_id(self, expr) -> Optional[str]:
        if isinstance(expr, ast.Name) and _is_lockish(expr.id):
            return f"{self.module}.{expr.id}"
        return None

    def _walk(self, stmts, held) -> None:
        for node in stmts:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                newly = list(held)
                for item in node.items:
                    lid = self._lock_id(item.context_expr)
                    if lid is not None:
                        self.sink.n_with_sites += 1
                        for h in newly:
                            if h != lid and (h, lid) not in self.sink.edges:
                                self.sink.edges[(h, lid)] = (
                                    f"{self.relfile}:{node.lineno} in "
                                    f"{self.fn.name}")
                        newly.append(lid)
                self._walk(node.body, tuple(newly))
                continue
            body_fields, exprs = _split_fields(node)
            if held:
                for root in exprs:
                    for sub in ast.walk(root):
                        if (isinstance(sub, ast.Call)
                                and _call_name(sub.func)
                                in BLOCKING_CALLS):
                            self.sink.add(Finding(
                                pass_name="hostlint",
                                code="blocking-under-lock",
                                severity=ERROR, engine="host",
                                file=self.relfile, line=sub.lineno,
                                fn=self.fn.name,
                                op=_call_name(sub.func),
                                message=f"blocking call "
                                f"{_call_name(sub.func)}() while "
                                f"holding {', '.join(held)}"))
            for body in body_fields:
                self._walk(body, held)


def _cycle_findings(sink: _Sink) -> List[Finding]:
    adj: Dict[str, list] = {}
    for a, b in sink.edges:
        adj.setdefault(a, []).append(b)
    out: List[Finding] = []
    seen = set()

    def dfs(node, path, on_path):
        for nxt in adj.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                canon = tuple(sorted(cyc))
                if canon in seen:
                    continue
                seen.add(canon)
                ring = cyc + cyc[:1]
                sites = [sink.edges.get((x, y), "?")
                         for x, y in zip(ring, ring[1:])
                         if (x, y) in sink.edges]
                out.append(Finding(
                    pass_name="hostlint", code="lock-order-cycle",
                    severity=ERROR, engine="host",
                    file=sites[0].split(":")[0] if sites else "<unknown>",
                    fn="static", op="->".join(cyc),
                    message=f"static lock-order cycle "
                    f"{' -> '.join(cyc)} -> {cyc[0]} (acquisition "
                    f"sites: {'; '.join(sites)})"))
                continue
            path.append(nxt)
            on_path.add(nxt)
            dfs(nxt, path, on_path)
            on_path.discard(nxt)
            path.pop()

    for start in sorted(adj):
        dfs(start, [start], {start})
    return out


def lint_source(src: str, module: str, relfile: str = "<mem>",
                registry: Optional[tuple] = None) -> List[Finding]:
    """Lint one module's SOURCE (tests, the gate's red cases).
    ``module`` selects which registry entries apply."""
    reg = conc.by_class(registry if registry is not None
                        else conc.REGISTRY)
    sink = _Sink()
    _lint_tree(ast.parse(src), module, relfile, reg, sink, set())
    return sink.findings() + _cycle_findings(sink)


def lint_package(root: Optional[str] = None,
                 registry: Optional[tuple] = None) -> dict:
    """Lint every module under ``root`` (default: the hermes_tpu_torch
    package) against ``registry`` (default: the port's).  Returns one
    report dict in the reference's shape (engine/n_eqns/proved/findings)
    so ``key_counts``, ``diff_baseline`` and ``export_findings`` apply."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reg = conc.by_class(registry if registry is not None
                        else conc.REGISTRY)
    sink = _Sink()
    seen_classes: set = set()
    n_files = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            relfile = os.path.relpath(path, os.path.dirname(root))
            module = _module_of(path, root)
            with open(path, encoding="utf-8") as f:
                src = f.read()
            try:
                tree = ast.parse(src, filename=relfile)
            except SyntaxError as e:
                sink.add(Finding(
                    pass_name="hostlint", code="unparseable",
                    severity=ERROR, engine="host", file=relfile,
                    line=e.lineno or 0, fn="<module>", op="parse",
                    message=f"cannot parse: {e.msg}"))
                continue
            n_files += 1
            _lint_tree(tree, module, relfile, reg, sink, seen_classes)
    # registry completeness the other way: stale entries rot silently
    for (module, cls), _entry in sorted(reg.items()):
        if (module, cls) not in seen_classes and module.startswith(
                os.path.basename(root)):
            sink.add(Finding(
                pass_name="hostlint", code="registry-stale-entry",
                severity=WARN, engine="host", file="<registry>",
                fn=cls, op=module,
                message=f"concurrency registry entry {module}.{cls} "
                f"matches no class in the package (renamed or removed?)"))
    findings = sink.findings() + _cycle_findings(sink)
    return dict(
        engine="host",
        n_eqns=n_files,
        n_sites=n_files,
        proved=dict(files=n_files, classes=sink.n_classes,
                    registered=len(seen_classes),
                    with_sites=sink.n_with_sites,
                    lock_edges=len(sink.edges),
                    threads=sink.n_threads),
        findings=findings,
    )


# --------------------------------------------------------------------------
# The baseline (the reference's currency: gating finding keys, counted)
# --------------------------------------------------------------------------

#: the port's grandfathered host findings (ships empty)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "hostlint_baseline.json")


def load_baseline(path: str = BASELINE_PATH) -> dict:
    """{key: count} of a baseline file (by default the port's); {} when
    there is none."""
    return findings_lib.load_baseline(path)


# --------------------------------------------------------------------------
# The hostlint gate: python -m hermes_tpu_torch.analysis.hostlint
# --------------------------------------------------------------------------

# an unguarded write of a registry-guarded attribute on the real class:
# the static pass must flag it, or the gate is vacuous
RED_GUARDED_SRC = """
class TcpRpcServer:
    def _accept_loop(self):
        self._conns.append(object())
"""

# a nested-with order inversion: f takes a then b, g takes b then a
RED_ORDER_SRC = """
def f():
    with a_lock:
        with b_lock:
            pass


def g():
    with b_lock:
        with a_lock:
            pass
"""


def leg_static(baseline: str, update: bool, out: Optional[str]) -> dict:
    """The whole package against the baseline (``update`` rewrites it)."""
    import json

    from hermes_tpu_torch.analysis.findings import export_findings

    report = lint_package()
    measured = key_counts(report["findings"])
    new, stale = diff_baseline(measured, load_baseline(baseline))
    if (new or stale) and update:
        doc = {"_doc": json.load(open(baseline))["_doc"]
               if os.path.exists(baseline) else "grandfathered findings",
               "grandfathered": {
                   k: {"count": c,
                       "note": next((f.message for f in report["findings"]
                                     if f.key == k), "")}
                   for k, c in sorted(measured.items())}}
        with open(baseline, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        new, stale = {}, {}
    if out:
        export_findings(out, [report], extra={"config": "host"})
    by_sev = {sev: sum(f.count for f in report["findings"]
                       if f.severity == sev) for sev in (ERROR, WARN, INFO)}
    return dict(ok=not new, proved=report["proved"], errors=by_sev[ERROR],
                warnings=by_sev[WARN], infos=by_sev[INFO],
                gating_sites=len(measured), new_findings=sorted(new),
                stale_baseline=sorted(stale))


def leg_red_static() -> dict:
    """The lint must still be able to fail."""
    guarded = lint_source(RED_GUARDED_SRC,
                          module="hermes_tpu_torch.serving.rpc",
                          relfile="<red:guarded>")
    guarded_hit = any(f.code == "guarded-attr-unlocked"
                      and f.severity == ERROR and f.op == "_conns"
                      for f in guarded)
    order = lint_source(RED_ORDER_SRC, module="redmod",
                        relfile="<red:order>")
    order_hit = any(f.code == "lock-order-cycle" and f.severity == ERROR
                    for f in order)
    return dict(ok=guarded_hit and order_hit, guarded_flip=guarded_hit,
                order_flip=order_hit)


def leg_red_dynamic() -> dict:
    """Two ObsLocks taken in opposite orders by two threads (one after
    the other: no real deadlock) must give one cycle with both stacks."""
    import threading

    from hermes_tpu_torch.analysis import lockgraph

    g = lockgraph.LockGraph()
    a = lockgraph.ObsLock("red.A", g)
    b = lockgraph.ObsLock("red.B", g)

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
    cycles = g.cycles()
    findings = g.findings()
    evidence = all("held at" in f.message and "acquired at" in f.message
                   for f in findings)
    ok = (len(cycles) == 1 and sorted(cycles[0]) == ["red.A", "red.B"]
          and len(findings) == 1 and evidence)
    return dict(ok=ok, cycles=cycles, n_findings=len(findings))


def leg_soak(batches: int = 24, warmup: int = 3,
             max_hold_p99_us: Optional[float] = 500_000.0, device="cuda",
             cfg=None, scfg=None, rows: int = 4) -> dict:
    """A columnar serving drive over TCP (a ``ColumnarTcpServer``, its
    accept, reader and pump threads, one ``ColumnarClient``) with every
    ``make_lock`` lock an ObsLock: ``batches`` closed-loop batches of
    ``rows`` requests, puts and gets in turns, after ``warmup`` put
    batches.  No cycle, every lock's hold p99 under ``max_hold_p99_us``
    (None: no fixed bound), the ``lock_*`` series present; the report
    carries the measured batches' wall seconds and store rounds.
    ``cfg`` and ``scfg`` default to the gate's small store (3 replicas,
    64 keys) and envelope; the store lies on ``device`` (the card unless
    the caller asks for the CPU; raises when the card is asked for and
    absent)."""
    import time

    import numpy as np

    from hermes_tpu_torch import device as device_lib
    from hermes_tpu_torch.analysis import lockgraph
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.obs.metrics import MetricsRegistry
    from hermes_tpu_torch.serving import (ColumnarClient, ColumnarFrontend,
                                          ColumnarTcpServer, ServingConfig,
                                          wire)

    dev = device_lib.resolve(device)
    if not conc.locklint_enabled():
        raise RuntimeError(f"the soak needs {conc.LOCKLINT_ENV}=1 before "
                           "any serving lock is minted")
    if cfg is None:
        cfg = HermesConfig(
            n_replicas=3, n_keys=64, n_sessions=4, replay_slots=6,
            ops_per_session=96, value_words=6, pipeline_depth=2,
            workload=WorkloadConfig(read_frac=0.5, seed=7))
    if scfg is None:
        scfg = ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e4,
                             tenant_quota=16, queue_cap=64, round_us=1000)
    fe = ColumnarFrontend(KVS(cfg, device=dev), scfg)
    val = (np.arange(rows * fe.u, dtype=np.int64) % (1 << 30)
           ).astype(np.int32).reshape(rows, fe.u)
    nothing = np.zeros((rows, fe.u), np.int32)

    def batch(kind, i, rid0):
        return wire.ReqBatch(
            kind=np.full(rows, kind, np.uint8),
            req_id=np.arange(rid0, rid0 + rows, dtype=np.uint32),
            tenant=np.zeros(rows, np.uint16),
            trace=np.zeros(rows, np.uint16),
            deadline_us=np.zeros(rows, np.uint32),
            key=(i * rows + np.arange(rows, dtype=np.int64)) % cfg.n_keys,
            value=val if kind == wire.K_PUT else nothing)

    server = ColumnarTcpServer(fe)
    try:
        cl = ColumnarClient(server.addr, fe.u)
        for i in range(warmup):
            cl.call_batch(batch(wire.K_PUT, i, int(cl.next_ids(rows)[0])))
        # holds of the warm-up land in the graph thrown away here
        graph = lockgraph.reset_global()
        reg = MetricsRegistry()
        graph.attach_registry(reg)
        first = fe.store.rt.step_idx
        t0 = time.perf_counter()
        for i in range(batches):
            kind = wire.K_PUT if i % 2 == 0 else wire.K_GET
            rsps = cl.call_batch(batch(kind, i, int(cl.next_ids(rows)[0])))
            if len(rsps) != rows:
                raise RuntimeError(f"soak batch {i}: {len(rsps)}/{rows} "
                                   "responses")
        wall = time.perf_counter() - t0
        rounds = fe.store.rt.step_idx - first
        cl.close()
    finally:
        server.close()
    if server.pump_error is not None:
        raise server.pump_error
    rep = graph.report()
    series = [n for n in reg.names()
              if n.startswith(lockgraph.LOCK_METRIC_PREFIX)]
    over = {n: st.get("hold_p99_us") for n, st in rep["locks"].items()
            if max_hold_p99_us is not None
            and (st.get("hold_p99_us") or 0) > max_hold_p99_us}
    ok = (not rep["cycles"] and not over and bool(rep["locks"])
          and bool(series))
    return dict(ok=ok, cycles=len(rep["cycles"]), locks=rep["locks"],
                n_edges=rep["n_edges"], n_lock_series=len(series),
                requests=batches * rows, wall_s=wall, rounds=rounds,
                max_hold_p99_us=max_hold_p99_us,
                findings=[f.message for f in graph.findings()])


def main(argv=None) -> int:
    """The hostlint gate: the static pass over the port against its
    baseline, both red legs, and the serving soak under the sanitizer.
    One JSON line; exit 1 on a new finding, a missing red flip or a soak
    violation."""
    import argparse
    import json
    import sys
    import time

    ap = argparse.ArgumentParser(
        prog="python -m hermes_tpu_torch.analysis.hostlint",
        description=main.__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline instead of failing (it ships "
                    "empty)")
    ap.add_argument("--out", default=None, metavar="FINDINGS_JSONL",
                    help="export the static findings as JSONL")
    ap.add_argument("--static-only", action="store_true",
                    help="skip the dynamic legs")
    ap.add_argument("--device", default="cuda",
                    help="device of the soak's store (default: the card; "
                    "--device cpu runs it on the CPU)")
    args = ap.parse_args(argv)
    if not args.static_only:
        from hermes_tpu_torch import device as device_lib

        device_lib.resolve(args.device)  # raises when the card is absent
    # every serving lock the soak mints must be an ObsLock
    os.environ[conc.LOCKLINT_ENV] = "1"
    legs = {}

    def run_leg(name, fn, *a):
        t0 = time.perf_counter()
        try:
            r = fn(*a)
        except Exception as e:  # noqa: BLE001 — a crashed leg is a
            # failed leg with the exception as its report
            r = dict(ok=False, error=f"{type(e).__name__}: {e}")
        r["seconds"] = round(time.perf_counter() - t0, 2)
        legs[name] = r
        print(f"[hostlint] {name}: {'ok' if r['ok'] else 'FAIL'} in "
              f"{r['seconds']}s", file=sys.stderr)

    run_leg("static", leg_static, args.baseline, args.update, args.out)
    run_leg("red_static", leg_red_static)
    if not args.static_only:
        run_leg("red_dynamic", leg_red_dynamic)
        run_leg("soak", leg_soak, 24, 3, 500_000.0, args.device)
    ok = all(leg["ok"] for leg in legs.values())
    st = legs["static"]
    print(json.dumps(dict(ok=ok, errors=st.get("errors", -1),
                          warnings=st.get("warnings", -1),
                          new_findings=st.get("new_findings", []),
                          stale_baseline=st.get("stale_baseline", []),
                          legs=legs)))
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
