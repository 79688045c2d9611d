"""The dynamic lock-order sanitizer: the port's copy of
``hermes_tpu/analysis/lockgraph.py``.

``ObsLock`` is a drop-in instrumented lock: every acquisition records the
acquiring thread's stack into a process-wide HELD-BEFORE graph (lock A ->
lock B whenever a thread acquires B while holding A), plus per-lock
hold-time and wait-time series and contention counters.  A cycle in the
graph is a potential deadlock even if no run has deadlocked yet (two
threads that ever take the same pair of locks in opposite orders only
need the right interleaving), and the finding carries BOTH acquisition
stacks as evidence.

Deployment is the ``HERMES_LOCKLINT=1`` switch: the serving tier mints
its locks through ``concurrency.make_lock``, which returns an ObsLock
under the switch, so every serving soak doubles as a sanitizer run (a
plain ``threading.Lock`` otherwise).  The static twin, the lexical
nested-``with`` graph over the whole package, is ``analysis/hostlint.py``;
the gate (``python -m hermes_tpu_torch.gates``, ``hostlint``) runs both.

The metrics registry a graph feeds (``attach_registry``) keeps a PLAIN
lock: instrumenting the sink's own lock would recurse.

Stdlib-only imports at module level: the torch-free shm worker processes
(``serving/ipc.py``) mint their locks through ``concurrency.make_lock``
and must load no torch; ``Finding`` objects are built lazily.
"""

from __future__ import annotations

import collections
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

#: registry metric-name prefix of everything ObsLock feeds
LOCK_METRIC_PREFIX = "lock_"
HOLD_SERIES_FMT = LOCK_METRIC_PREFIX + "hold_us:{name}"
WAIT_SERIES_FMT = LOCK_METRIC_PREFIX + "wait_us:{name}"

_STACK_SKIP = 2   # drop the ObsLock/LockGraph frames from evidence
_STACK_KEEP = 8   # frames of evidence per acquisition
_HOLD_KEEP = 4096  # per-lock hold samples kept for percentiles


def _stack() -> str:
    frames = traceback.format_stack()[:-_STACK_SKIP]
    return "".join(frames[-_STACK_KEEP:])


class LockGraph:
    """One process-wide held-before graph + per-lock stats."""

    def __init__(self):
        self._graph_lock = threading.Lock()
        # (held_name, acquired_name) -> dict(count, held_stack,
        # acquire_stack): first-occurrence stacks are the evidence pair
        self._edges: Dict[Tuple[str, str], dict] = {}
        # name -> dict(acquires, contended, holds: deque, wait_us_max)
        self._stats: Dict[str, dict] = {}
        self._registry = None  # obs MetricsRegistry (optional sink)
        self._held = threading.local()  # per-thread acquisition stack

    # -- wiring --------------------------------------------------------------

    def attach_registry(self, registry) -> None:
        """Feed per-lock hold/wait series and counters into an obs
        ``MetricsRegistry`` (obs/series.py rings).  The registry's own
        lock stays uninstrumented (concurrency.REGISTRY)."""
        with self._graph_lock:
            self._registry = registry

    def _held_list(self) -> list:
        ent = getattr(self._held, "stack", None)
        if ent is None:
            ent = self._held.stack = []
        return ent

    # -- ObsLock callbacks ---------------------------------------------------

    def note_acquire(self, name: str, wait_s: float) -> None:
        held = self._held_list()
        for ent in held:
            if ent["name"] == name:   # reentrant re-acquire: no new edge
                ent["depth"] += 1
                return
        stack = _stack()
        wait_us = wait_s * 1e6
        with self._graph_lock:
            st = self._stats.setdefault(
                name, dict(acquires=0, contended=0,
                           holds=collections.deque(maxlen=_HOLD_KEEP),
                           seq=0))
            st["acquires"] += 1
            if wait_s > 0:
                st["contended"] += 1
            for prior in held:
                edge = (prior["name"], name)
                ent = self._edges.get(edge)
                if ent is None:
                    self._edges[edge] = dict(count=1,
                                             held_stack=prior["stack"],
                                             acquire_stack=stack)
                else:
                    ent["count"] += 1
            if self._registry is not None:
                st["seq"] += 1
                if wait_s > 0:
                    self._registry.series(
                        WAIT_SERIES_FMT.format(name=name)).append(
                            st["seq"], wait_us)
                self._registry.counter(
                    LOCK_METRIC_PREFIX + "acquires:" + name).inc()
                if wait_s > 0:
                    self._registry.counter(
                        LOCK_METRIC_PREFIX + "contended:" + name).inc()
        held.append(dict(name=name, stack=stack, depth=1,
                         t0=time.perf_counter()))

    def note_release(self, name: str) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i]["name"] != name:
                continue
            held[i]["depth"] -= 1
            if held[i]["depth"] > 0:
                return
            hold_us = (time.perf_counter() - held[i]["t0"]) * 1e6
            del held[i]
            with self._graph_lock:
                st = self._stats.get(name)
                if st is not None:
                    st["holds"].append(hold_us)
                    if self._registry is not None:
                        st["seq"] += 1
                        self._registry.series(
                            HOLD_SERIES_FMT.format(name=name)).append(
                                st["seq"], hold_us)
            return
        # release without a matching note_acquire: let the caller's
        # underlying lock.release() raise — nothing to unwind here

    # -- analysis ------------------------------------------------------------

    def edges(self) -> dict:
        with self._graph_lock:
            return {e: dict(v) for e, v in self._edges.items()}

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable in the held-before graph,
        as name lists (first node repeated implicitly).  The graph is
        tiny (locks, not ops), so a plain DFS is fine."""
        with self._graph_lock:
            adj: Dict[str, list] = {}
            for a, b in self._edges:
                adj.setdefault(a, []).append(b)
        out: List[List[str]] = []
        seen_cycles = set()

        def dfs(node, path, on_path):
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):]
                    canon = tuple(sorted(cyc))
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(cyc))
                    continue
                path.append(nxt)
                on_path.add(nxt)
                dfs(nxt, path, on_path)
                on_path.discard(nxt)
                path.pop()

        for start in sorted(adj):
            dfs(start, [start], {start})
        return out

    def hold_p99_us(self, name: str) -> Optional[float]:
        with self._graph_lock:
            st = self._stats.get(name)
            holds = sorted(st["holds"]) if st else []
        if not holds:
            return None
        return holds[min(len(holds) - 1, int(0.99 * len(holds)))]

    def findings(self) -> list:
        """Cycle findings in the reference's Finding schema (ERROR, both
        stacks as evidence): what the hostlint gate fails on."""
        from hermes_tpu_torch.analysis.findings import ERROR, Finding

        edges = self.edges()
        out = []
        for cyc in self.cycles():
            ring = cyc + cyc[:1]
            ev = []
            for a, b in zip(ring, ring[1:]):
                e = edges.get((a, b))
                if e:
                    ev.append(f"-- {a} held at:\n{e['held_stack']}"
                              f"-- then {b} acquired at:\n"
                              f"{e['acquire_stack']}")
            out.append(Finding(
                pass_name="lockgraph", code="lock-order-cycle",
                severity=ERROR, engine="host",
                file="<runtime>", fn="dynamic",
                op="->".join(cyc),
                message=("potential deadlock: locks acquired in "
                         f"conflicting orders ({' -> '.join(cyc)} -> "
                         f"{cyc[0]}); acquisition stacks:\n"
                         + "\n".join(ev))))
        return out

    def report(self) -> dict:
        """JSON-ready summary for the CLI's lines and the gate's report."""
        with self._graph_lock:
            stats = {n: dict(acquires=st["acquires"],
                             contended=st["contended"],
                             holds=sorted(st["holds"]))
                     for n, st in self._stats.items()}
            n_edges = len(self._edges)
        locks = {}
        for n, st in sorted(stats.items()):
            holds = st.pop("holds")
            if holds:
                st["hold_p99_us"] = round(
                    holds[min(len(holds) - 1, int(0.99 * len(holds)))], 1)
                st["hold_max_us"] = round(holds[-1], 1)
            locks[n] = st
        return dict(locks=locks, n_edges=n_edges, cycles=self.cycles())


class ObsLock:
    """Drop-in instrumented lock.

    Wraps a ``threading.RLock`` (reentrant — a drop-in must never turn a
    legal re-acquire into a self-deadlock) and reports acquisitions /
    releases to a :class:`LockGraph`.  Reentrant re-acquires count depth
    only: no new edge, no new stack, and the hold interval runs from the
    OUTERMOST acquire to the matching release — context-manager
    semantics are exactly ``threading.Lock``'s otherwise."""

    def __init__(self, name: str, graph: Optional[LockGraph] = None):
        self.name = name
        self._graph = graph  # None -> follow the CURRENT global graph
        self._lk = threading.RLock()

    @property
    def graph(self) -> LockGraph:
        """The explicit graph if one was given, else the current GLOBAL,
        resolved per call, so ``reset_global()`` at a quiescent point
        (say after a warm-up) retargets every default lock at once
        without re-minting them."""
        return self._graph if self._graph is not None else GLOBAL

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lk.acquire(False)
        wait_s = 0.0
        if not got:
            if not blocking:
                return False
            t0 = time.perf_counter()
            got = self._lk.acquire(True, timeout)
            wait_s = time.perf_counter() - t0
            if not got:
                return False
        self.graph.note_acquire(self.name, wait_s)
        return True

    def release(self) -> None:
        self.graph.note_release(self.name)
        self._lk.release()

    def __enter__(self) -> "ObsLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


#: process-wide default graph (what make_lock-minted ObsLocks join)
GLOBAL = LockGraph()


def global_graph() -> LockGraph:
    return GLOBAL


def reset_global() -> LockGraph:
    """Fresh process-wide graph (gates/tests).  Default-graph ObsLocks
    follow the swap on their next acquire (the ``graph`` property);
    only locks minted with an EXPLICIT graph keep the old one.  Call at
    a quiescent point — an acquisition spanning the swap records its
    acquire in the old graph and its release in the new one (both are
    tolerated, the sample is simply dropped)."""
    global GLOBAL
    GLOBAL = LockGraph()
    return GLOBAL
