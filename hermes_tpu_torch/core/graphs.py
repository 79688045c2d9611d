"""The counterpart of ``jax.jit`` for both engines: one CUDA graph a
round, and one a chunk of rounds.

The JAX package compiles a round once and sends it to the device as one
program: ``build_fast_batched`` is ``jax.jit(step, donate_argnums=...)``
(``hermes_tpu/core/faststep.py:1630-1636``) and ``build_fast_scan`` a
``lax.scan`` of rounds under one ``jax.jit`` (:1639-1654); the phases
engine's ``build_step_batched`` / ``build_step_scan`` /
``build_step_sharded`` / ``build_step_sharded_scan`` are ``jax.jit``s
too (``hermes_tpu/core/step.py:142``, ``:167``, ``:225``, ``:264``).  Run
eagerly, the port's fast round makes some 400 kernel launches and 800
aten ops on the host, a phases round some 1,000 launches; here a round is
captured once into a ``torch.cuda.CUDAGraph`` and each later round is one
replay.

``Compiled`` wraps a round ``fn(fs, stream, ctl) -> (fs, comp)`` (or, with
``comps=False``, a chunk of rounds ``fn(fs, stream, ctl) -> fs``); ``fs``
is a ``FastState`` or a phases ``ReplicaState`` (both lead with the
table), ``ctl`` a ``FastCtl`` or a phases ``StepCtl``:

* **Bound inputs.**  The first call binds the tensors it is given — the
  ``FastState`` leaves, the op stream and the ctl rows, the 0-dim step
  among them — as the graph's inputs.  A later call that passes the same
  tensors costs nothing.  A tensor of the bound one's shape, dtype and
  device in its place is copied in; any other change (a shape, a dtype,
  the tree) rebinds and drops every graph, and the next call captures
  again.  The ctl's fields that are tensors are bound (``ctl_tensors``),
  the step first.
* **Outputs.**  Inside the graph, every state leaf the round returns as a
  new tensor is copied back into the bound leaf (the table is updated in
  place by the round itself), so the state returned IS the bound state.
  The completions and the ``extra`` column of the returned state (the
  fast round's ``Meta.suspect_age``; none for the phases round) go to one
  int32 buffer, which is copied after the replay into the next of
  ``ring`` slots: a round dispatched but not yet harvested is not
  overwritten until ``ring`` more rounds have run (``stale`` tells: each
  call hands out a new tree of its slot's views).  The graph then adds
  ``rounds`` to the bound step in place.
* **One graph a variant.**  ``variant(ctl)`` keys a call by the host
  values its round reads.  The fast round reads two (``fast_variant``):
  ``ctl.host_step % cfg.replay_scan_every == 0`` (the replay scan) and
  ``ctl.quiesce``; each pair (a chunk: each pattern of scan rounds at its
  offsets, and quiesce) gets its own graph, chosen on the host each
  call.  The phases round reads none (``one_variant``).
  All of a call's graphs share one memory pool; their outputs all live
  outside it.
* **Capture.**  A variant's first call runs the function once on a side
  stream (the warm-up, which is that call's real work); its second call
  captures it into a ``torch.cuda.CUDAGraph`` on a stream of its own and
  replays it, so a variant called once (a short-lived store's replay
  round) costs no capture.  A capture that fails (a host sync, a copy
  from pageable host memory, a data-dependent shape) raises, naming the
  last op dispatched before it; nothing runs the eager function instead.
* **Launch counts.**  A kernel wrapper adds to its ``launches`` where it
  launches, so inside a capture it counts once what the graph will
  launch at every replay: the capture's counts are taken off the
  counters and added back at each replay, by kernel.
* **On the CPU, and with ``graph=False``** (a ``DistGroup``'s round, whose
  collectives leave the device): the same binding, variants, ring and
  step; calling the function takes the place of the replay.

Who runs a round eagerly, and says so: the census
(``obs/profile.py``) and the analysis (``analysis/graph.py`` traces the
round function) call ``faststep.fast_round_batched`` /
``fast_round_sharded``; the smoke's comparisons of graphed and eager
rounds run a compiled round under ``Compiled.eager()`` (the phases
engine's) or with ``graph = False`` (the fast engine's)."""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import NamedTuple, Optional

import torch

from hermes_tpu_torch.core import dispatch

I32 = torch.int32

_LEAF = "leaf"


def flatten(tree):
    """``(leaves, spec)`` of a tree of (named) tuples of tensors, None
    kept in the spec."""
    if isinstance(tree, torch.Tensor):
        return [tree], _LEAF
    if tree is None:
        return [], None
    if isinstance(tree, tuple):
        leaves, specs = [], []
        for x in tree:
            sub, spec = flatten(x)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree), tuple(specs))
    raise TypeError(f"a round's tree holds tensors, tuples and None, got "
                    f"{type(tree).__name__}")


def unflatten(spec, leaves):
    """The inverse of ``flatten``."""
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if s is None:
            return None
        typ, subs = s
        vals = [build(x) for x in subs]
        return typ(*vals) if hasattr(typ, "_fields") else typ(vals)

    return build(spec)


def ctl_tensors(ctl) -> tuple:
    """The names of ``ctl``'s fields that are tensors, in order (the step
    first): what a compiled call binds."""
    return tuple(f for f in ctl._fields if torch.is_tensor(getattr(ctl, f)))


def fast_variant(scan_every: int, rounds: int):
    """The fast round's variant key of a call: which of its ``rounds``
    rounds run the replay scan, and quiesce."""

    def key(ctl) -> tuple:
        h = ctl.host_step
        if rounds == 1:
            return (h % scan_every == 0, bool(ctl.quiesce))
        return (tuple((h + o) % scan_every == 0 for o in range(rounds)),
                bool(ctl.quiesce))

    return key


def one_variant(_ctl) -> tuple:
    """The variant key of a round that reads no host value: one graph."""
    return ()


def suspect_ages(fs):
    """The fast round's extra output column: its ``Meta.suspect_age``."""
    return fs.meta.suspect_age


def launch_counts() -> dict:
    """Every hand-kernel wrapper's ``launches``, by name."""
    return {n: w.launches for n, w in dispatch.HAND_KERNELS.items()
            if hasattr(w, "launches")}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by kernel name) to the wrappers' ``launches``."""
    for n, c in counts.items():
        dispatch.HAND_KERNELS[n].launches += c


class Variant(NamedTuple):
    """One captured variant: the graph (None where the function is called
    in its place), the launches it makes a replay, by kernel, and the
    body it runs."""

    graph: Optional[torch.cuda.CUDAGraph]
    launches: dict
    body: object


class _LastOp(torch.utils._python_dispatch.TorchDispatchMode):
    """Keeps the name of the last aten op dispatched (what a failed
    capture names)."""

    last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


#: below this share of the card's memory free, a capture first collects
#: the garbage and empties the allocator's cache
ROOM_SHARE = 0.25


def make_room(device) -> None:
    """Before a capture: where less than ``ROOM_SHARE`` of the card's
    memory is free, collect the garbage (dead graphs release their
    pools) and empty the allocator's cache, after a sync."""
    free, total = torch.cuda.mem_get_info(device)
    if free < ROOM_SHARE * total:
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()


_every_span = None  # while ``timed_all`` runs: every compiled call's


@contextlib.contextmanager
def timed_all():
    """``Compiled.timed`` for every compiled round and chunk called
    inside the block (of stores built inside it too)."""
    global _every_span
    prev, _every_span = _every_span, []
    try:
        yield _every_span
    finally:
        _every_span = prev


class Compiled:
    """A round (or a chunk of ``rounds`` rounds) compiled as above.
    ``variant`` keys a call (``fast_variant``, ``one_variant``); ``ring``
    the completion slots (``max(pipeline_depth, 1) + 1`` in the fast
    runtime); ``graph`` False keeps every call eager (still bound, ringed
    and stepped); ``extra`` the returned state's extra output column
    (``suspect_ages``), if any."""

    def __init__(self, fn, variant, *, rounds: int = 1, comps: bool = True,
                 ring: int = 2, graph: bool = True, name: str = "round",
                 extra=None):
        if rounds < 1 or ring < 1:
            raise ValueError(f"{name}: rounds and ring must be >= 1")
        self.fn = fn
        self.key = variant
        self.extra = extra
        self.rounds = rounds
        self.comps = comps
        self.ring_size = ring
        self.graph = graph
        self.name = name
        self.captures = 0  # variants captured, over every binding
        self.replays = 0  # calls served by a captured variant
        self.warmups = 0  # a variant's first calls, run eagerly
        self.rebinds = 0
        self._eager = False
        self._spans = None  # (start, end) CUDA events a call, while timed
        self._reset()

    def _reset(self) -> None:
        self._fs = None  # the bound FastState (what a call returns)
        self._fs_leaves: list = []
        self._fs_spec = None
        self._storages: set = set()
        self._stream = None
        self._stream_leaves: list = []
        self._stream_spec = None
        self._ctl: list = []
        self._variants: dict = {}
        self._warm: set = set()  # variants called once, eagerly
        self._pool = None
        self._flat = None  # the graph's completion buffer
        self._ring: list = []  # (flat slot, comp views, ages view)
        self._handed: list = []  # the tree a slot's last call handed out
        self._ctl_fields: tuple = ()
        self._comp_spec = None
        self._next = 0
        self.ages = None  # the last call's extra column (suspect ages)
        # the state leaves (flattened order: vpts, bank, sess, ...) the
        # function returned anew and the body copied back, at its last run
        self.copied_back: list = []

    # -- binding ---------------------------------------------------------------

    @property
    def bound(self) -> bool:
        return self._fs is not None

    @property
    def step(self):
        """The bound step tensor (None before the first call)."""
        return self._ctl[0] if self._ctl else None

    def drop(self) -> None:
        """Drop every graph and the binding: the next call binds and
        captures again."""
        self._reset()

    def _bind(self, fs, stream, ctl) -> None:
        if self.bound:
            self.rebinds += 1
        self._reset()
        leaves, spec = flatten(fs)
        seen, bound = set(), []
        for i, x in enumerate(leaves):
            ptr = x.untyped_storage().data_ptr()
            if not x.is_contiguous() or ptr in seen:
                if i < len(fs.table):
                    raise ValueError(f"{self.name}: the table's leaves are "
                                     "updated in place and must be "
                                     "contiguous tensors of their own")
                x = x.clone()
                ptr = x.untyped_storage().data_ptr()
            seen.add(ptr)
            bound.append(x)
        self._fs_leaves, self._fs_spec = bound, spec
        self._storages = seen
        self._fs = (fs if all(a is b for a, b in zip(bound, leaves))
                    else unflatten(spec, bound))
        self._stream = stream
        self._stream_leaves, self._stream_spec = flatten(stream)
        fields = ctl_tensors(ctl)
        step = ctl.step
        if fields[:1] != ("step",) or step.dim() != 0 or step.dtype != I32:
            raise TypeError(f"{self.name}: ctl.step must be its first field, "
                            "a 0-dim int32 tensor")
        if step.untyped_storage().data_ptr() in seen:
            step = step.clone()
        self._ctl_fields = fields
        self._ctl = [step] + [getattr(ctl, f) for f in fields[1:]]
        self.device = step.device

    def _same(self, got, bound) -> bool:
        return (got.shape == bound.shape and got.dtype == bound.dtype
                and got.device == bound.device)

    def _take(self, fs, stream, ctl) -> None:
        """Bind at the first call; later, copy in what changed or rebind."""
        if not self.bound:
            self._bind(fs, stream, ctl)
            return
        copies = []
        if fs is not self._fs:
            leaves, spec = flatten(fs)
            if spec != self._fs_spec or len(leaves) != len(self._fs_leaves):
                self._bind(fs, stream, ctl)
                return
            for x, b in zip(leaves, self._fs_leaves):
                if x is not b:
                    if not self._same(x, b):
                        self._bind(fs, stream, ctl)
                        return
                    copies.append((b, x))
        if stream is not self._stream:
            leaves, spec = flatten(stream)
            if spec != self._stream_spec:
                self._bind(fs, stream, ctl)
                return
            for x, b in zip(leaves, self._stream_leaves):
                if x is not b:
                    if not self._same(x, b):
                        self._bind(fs, stream, ctl)
                        return
                    copies.append((b, x))
        for f, b in zip(self._ctl_fields, self._ctl):
            x = getattr(ctl, f)
            if x is not b:
                if not self._same(x, b):
                    self._bind(fs, stream, ctl)
                    return
                copies.append((b, x))
        for b, x in copies:
            b.copy_(x)

    # -- the body ----------------------------------------------------------------

    def _body(self, ctl):
        """The function over the bound inputs with ``ctl``'s host values,
        its outputs copied back into the bound leaves and its completions
        into the completion buffer, then the step advanced."""
        bctl = ctl._replace(**dict(zip(self._ctl_fields, self._ctl)))
        fs_in, stream = self._fs, self._stream
        # a weak reference: the body is kept in ``_variants``, and a cycle
        # would keep a dropped runtime's graphs and their pool until a
        # garbage collection
        me = weakref.proxy(self)

        def body():
            out = me.fn(fs_in, stream, bctl)
            if me.comps:
                fs_out, comp = out
                me._write_comps(comp, None if me.extra is None
                                else me.extra(fs_out))
            else:
                fs_out = out
            me._copy_back(fs_out)
            bctl.step.add_(me.rounds)

        return body

    def _write_comps(self, comp, extra) -> None:
        leaves, spec = flatten(comp)
        leaves = leaves + ([] if extra is None else [extra])
        if self._flat is None:
            self._layout(spec, leaves)
        elif spec != self._comp_spec:
            raise RuntimeError(f"{self.name}: the completions' tree changed "
                               "between calls")
        torch.cat([x.reshape(-1) for x in leaves], out=self._flat)

    def _layout(self, spec, leaves) -> None:
        """Allocate the completion buffer and the ring (outside any graph
        pool: on the caller's stream) from the first call's completions."""
        for x in leaves:
            if x.dtype != I32:
                raise TypeError(f"{self.name}: completions are int32, got "
                                f"{x.dtype}")
        self._comp_spec = spec
        sizes = [(x.shape, x.numel()) for x in leaves]
        total = sum(n for _, n in sizes)
        ctx = (torch.cuda.stream(self._main) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            self._flat = torch.empty(total, dtype=I32, device=self.device)
            for _ in range(self.ring_size):
                slot = torch.empty(total, dtype=I32, device=self.device)
                views, at = [], 0
                for shape, n in sizes:
                    views.append(slot[at:at + n].view(shape))
                    at += n
                extra = None if self.extra is None else views.pop()
                self._ring.append((slot, views, extra))
                self._handed.append(None)

    def _copy_back(self, fs_out) -> None:
        outs, spec = flatten(fs_out)
        if spec != self._fs_spec:
            raise RuntimeError(f"{self.name}: the round returned a state of "
                               "another tree")
        pairs, copied = [], []
        for i, (b, o) in enumerate(zip(self._fs_leaves, outs)):
            if o is b:
                continue
            if o.untyped_storage().data_ptr() in self._storages:
                o = o.clone()  # read before any bound leaf is written
            pairs.append((b, o))
            copied.append(i)
        for b, o in pairs:
            b.copy_(o)
        self.copied_back = copied

    # -- calls -------------------------------------------------------------------

    @contextlib.contextmanager
    def eager(self):
        """Calls inside the block run the function itself, with the same
        binding, ring and step, and capture nothing (an explicit eager
        run: what sees the kernel wrappers' arguments)."""
        prev, self._eager = self._eager, True
        try:
            yield
        finally:
            self._eager = prev

    @contextlib.contextmanager
    def timed(self):
        """Yields a list that gets one ``(start, end)`` pair of timing CUDA
        events a call made inside the block, recorded on the stream around
        its replay: a graph runs on the device without a host gap, so
        their elapsed times sum to the device time of the calls (after a
        sync).  On the CPU the list stays empty."""
        prev, self._spans = self._spans, []
        try:
            yield self._spans
        finally:
            self._spans = prev

    def __call__(self, fs, stream, ctl):
        """One call: the bound state, and (``comps``) the completions of
        this call's ring slot."""
        self._take(fs, stream, ctl)
        span = None
        spans = self._spans if self._spans is not None else _every_span
        if self.device.type == "cuda":
            self._main = torch.cuda.current_stream(self.device)
            if spans is not None:
                span = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                span[0].record()
        if self._eager:
            self._body(ctl)()
        else:
            key = self.key(ctl)
            var = self._variants.get(key)
            if var is None and key in self._warm:
                var = self._capture(key, ctl)
            if var is None:
                self._warm_up(key, ctl)
            else:
                self._replay(var)
        if self.comps:
            i = self._next
            self._next = (i + 1) % self.ring_size
            slot, views, ages = self._ring[i]
            slot.copy_(self._flat)
            comp = self._handed[i] = unflatten(self._comp_spec, views)
            self.ages = ages
        if span is not None:
            span[1].record()
            spans.append(span)
        return (self._fs, comp) if self.comps else self._fs

    def _replay(self, var: Variant) -> None:
        self.replays += 1
        if var.graph is None:
            var.body()
            return
        var.graph.replay()
        add_launches(var.launches)

    def _warm_up(self, key, ctl) -> None:
        """A variant's first call: the function itself, on a side stream
        on the card (the warm-up, which is this call's work).  A variant
        called once is never captured."""
        self._warm.add(key)
        self.warmups += 1
        body = self._body(ctl)
        if self.device.type != "cuda":
            body()
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(self._main)
        with torch.cuda.stream(side):
            body()
        self._main.wait_stream(side)

    def _capture(self, key, ctl) -> Variant:
        """A variant's second call captures it (running nothing); the
        replay that follows is the call's work."""
        body = self._body(ctl)
        if not (self.device.type == "cuda" and self.graph):
            var = Variant(None, {}, body)
        else:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph()
            before = launch_counts()
            watch = _LastOp()
            cap = torch.cuda.Stream(self.device)
            cap.wait_stream(self._main)
            # freeing device memory invalidates a capture: no garbage
            # collection runs while it records (a dropped runtime's graphs,
            # held in a reference cycle, would release their pools), and
            # where the card is short of free memory the allocator's cache
            # is emptied first (as torch.cuda.graph does every time), so
            # that the pool's allocations never free cached blocks
            make_room(self.device)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(cap):
                    g.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                    try:
                        with watch:
                            body()
                    finally:
                        g.capture_end()
            except Exception as err:
                raise RuntimeError(
                    f"{self.name}: the capture of variant {key} failed; the "
                    f"last op dispatched was {watch.last}: {err}") from err
            finally:
                if collecting:
                    gc.enable()
                got = launch_counts()
                for n, w in dispatch.HAND_KERNELS.items():
                    if n in before:
                        w.launches = before[n]
            self._main.wait_stream(cap)
            var = Variant(g, {n: got[n] - before[n] for n in before
                              if got[n] != before[n]}, body)
        self._variants[key] = var
        self.captures += 1
        return var

    def stale(self, comp) -> bool:
        """True when ``comp`` is a ring slot's completions and a later
        call has since written that slot (handed out another tree)."""
        if not isinstance(comp, tuple):
            return False  # a host fetch, enqueued behind its round
        ptr = flatten(comp)[0][0].untyped_storage().data_ptr()
        for (slot, _views, _ages), handed in zip(self._ring, self._handed):
            if slot.untyped_storage().data_ptr() == ptr:
                return handed is not comp
        return False

