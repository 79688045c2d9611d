"""On-card checks of the port's CUDA kernels (marker ``gpu``).

Each test skips on a machine without the card.  This file imports only
torch and the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
The tolerance is exact equality: every output is an integer and the
kernel's atomics are integer adds, so their order cannot change a bit.
"""

import pytest
import torch

import chip_smoke
from hermes_tpu_torch.core import kernels


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _build(checked):
    """The release build, or a checked_build block (outputs poisoned, so
    an element the kernel leaves unwritten shows)."""
    import contextlib

    from hermes_tpu_torch.core import dispatch

    return dispatch.checked_build() if checked else contextlib.nullcontext()


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("R,S", list(chip_smoke.STATS_SHAPES) + [(3, 5)])
def test_stats_block_cuda_matches_plain(R, S, checked):
    """At every chip_smoke.py shape and a row shorter than one 16-lane
    chunk, in the release and the checked build: equal to the plain
    version, one launch a call; in the checked build ctr and hist start
    poisoned, so equality shows every element written, and no guard
    fires."""
    dev = _card()
    args = chip_smoke.stats_inputs(torch, R, S, seed=R * 7919 + S)
    want = kernels.stats_block_plain(*args)
    before = kernels.stats_block.launches
    with _build(checked) as chk:
        got = kernels.stats_block(*(a.to(dev) for a in args))
        torch.cuda.synchronize(dev)
    assert kernels.stats_block.launches == before + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())
    if checked:
        assert chk.violations == [] and len(chk.launched) == 1


def _device_ops(call):
    """The device operations one call enqueues: the nodes of a CUDA graph
    it is captured into (``profiling.graph_ops``; no profiler record can
    be lost)."""
    from hermes_tpu_torch.profiling import graph_ops

    return graph_ops(call)["total"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stats_block", "mega_apply", "mega_replay",
                                  "probe_serial", "probe_vgather", "fx_pack",
                                  "fx_store_at", "fx_acc_revisit",
                                  "fx_block_copy", "fx_serial_scan",
                                  "fx_async_copy", "fx_loop_inc"])
def test_kernel_call_is_one_device_operation(name):
    """At the bench shape a call enqueues exactly one device operation
    (a node of the CUDA graph it is captured into): no fill, no memset,
    no second launch
    (``probe_serial`` after its first call, which fills its winner
    column); the fixtures at chip_smoke.py's last shape (4.1 MB for
    ``fx_async_copy``, the word path for ``fx_loop_inc`` and
    ``fx_acc_revisit``, the 40 MB bench table for ``fx_serial_scan``,
    96 MB moved for ``fx_pack``, a 64 MB output for ``fx_store_at``)."""
    dev = _card()
    if name.startswith("fx_"):
        wrapper, _plain, args = _analysis_case(
            name, len(chip_smoke.FX_SHAPES[name]) - 1)
        args = chip_smoke._to(torch, args, dev)
        call = lambda: wrapper(*args)
    elif name == "stats_block":
        args = [a.to(dev) for a in chip_smoke.stats_inputs(
            torch, *chip_smoke.STATS_SHAPES[0], seed=1)]
        call = lambda: kernels.stats_block(*args)
    elif name == "probe_serial":
        from hermes_tpu_torch.core import probe_kernels as pk

        args = [a.to(dev) for a in _probe_args(chip_smoke.PROBE_SHAPES[0])]
        call = lambda: pk.probe_serial(*args)
    elif name == "probe_vgather":
        from hermes_tpu_torch.core import probe_kernels as pk

        table, keys, _rows = (a.to(dev) for a in _probe_args(
            chip_smoke.PROBE_SHAPES[0]))
        call = lambda: pk.probe_vgather(keys, table)
    else:
        wrapper, _plain, args = _mega_call(
            name, (chip_smoke.APPLY_SHAPES if name == "mega_apply"
                   else chip_smoke.REPLAY_SHAPES)[0])
        args = chip_smoke._to(torch, args, dev)
        call = lambda: wrapper(*args)
    assert _device_ops(call) == 1


def _graph_equals_eager(make_args, call):
    """One torch.cuda.CUDAGraph capture of ``call(*args)`` replayed on
    fresh arguments equals the eager call on another fresh set: the
    launch can be captured, as a graph of the round will need."""
    eager = chip_smoke._flat(call(*make_args()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        call(*make_args())
    torch.cuda.current_stream().wait_stream(side)
    static = make_args()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # records the launch, runs nothing
        captured = chip_smoke._flat(call(*static))
    graph.replay()
    torch.cuda.synchronize()
    assert len(captured) == len(eager)
    for g, e in zip(captured, eager):
        assert torch.equal(g, e)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stats_block", "mega_apply", "mega_replay",
                                  "fx_pack", "fx_store_at", "fx_acc_revisit",
                                  "fx_serial_scan", "fx_async_copy",
                                  "fx_loop_inc"])
def test_kernel_call_replays_from_a_cuda_graph(name):
    """A call captured into a CUDA graph (on the capture's own stream,
    which has seen no call: nothing is kept per stream) replays equal to
    the eager call; the fixtures at every chip_smoke.py shape."""
    dev = _card()
    if name.startswith("fx_"):
        for index in range(len(chip_smoke.FX_SHAPES[name])):
            wrapper, _plain, args = _analysis_case(name, index)
            _graph_equals_eager(lambda: chip_smoke._to(torch, args, dev),
                                wrapper)
    elif name == "stats_block":
        cpu = chip_smoke.stats_inputs(torch, *chip_smoke.STATS_SHAPES[0],
                                      seed=2)
        _graph_equals_eager(lambda: [a.to(dev) for a in cpu],
                            kernels.stats_block)
    else:
        wrapper, _plain, args = _mega_call(
            name, (chip_smoke.APPLY_SHAPES if name == "mega_apply"
                   else chip_smoke.REPLAY_SHAPES)[0])
        _graph_equals_eager(lambda: chip_smoke._to(torch, args, dev),
                            wrapper)


def _probe_args(shape, seed=2):
    from types import SimpleNamespace

    from hermes_tpu_torch import table_probe
    from hermes_tpu_torch.core import probe_kernels as pk

    port = SimpleNamespace(pk=pk, probe=table_probe)
    args, _timing, _info = chip_smoke.serial_case(torch, port, shape, seed)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.PROBE_SHAPES[:2])
def test_probe_serial_replays_from_a_cuda_graph(shape):
    """``probe_serial`` captured once on a stream whose winner column
    exists, then replayed three times with new keys and rows copied into
    the static buffers: the table equals the plain version applied three
    times, and the column is all -1 after each replay (the graph holds no
    memset: the call resets what it raised)."""
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    draws = [_probe_args(shape, seed=10 + n) for n in range(4)]
    table0 = draws[0][0]
    want = table0.clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        static = [x.to(dev) for x in draws[0]]
        pk.probe_serial(*static)  # warm-up: makes the stream's column
        torch.cuda.synchronize()
        static[0].copy_(table0)
        col = pk.win_columns[(static[0].device, s.cuda_stream, shape[0])]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            pk.probe_serial(*static)
        for _table, keys, rows in draws[1:]:
            static[1].copy_(keys)
            static[2].copy_(rows)
            graph.replay()
            torch.cuda.synchronize()
            want = pk.probe_serial_plain(want, keys, rows)
            assert torch.equal(static[0].cpu(), want)
            assert bool((col == -1).all())


def _vgather_edge(edge, dev):
    """``(keys, table, path)`` of a ``probe_vgather`` edge on the card:
    ``w<W>`` a (1000, W) table with 1,000 messages (31 whole tiles and a
    ragged one of 8) and keys outside [0, K), ``w<W>_off4`` the same from a
    table view 4 bytes off its allocation, ``one_row`` the probe step's own
    input (``chip_smoke.probe_step_inputs``); ``path`` the (vec_ld,
    vec_st) the wrapper must take."""
    from types import SimpleNamespace

    from hermes_tpu_torch import table_probe

    if edge == "one_row":
        keys, table = chip_smoke.probe_step_inputs(
            torch, SimpleNamespace(probe=table_probe))["probe_inputs"]
        return keys.to(dev), table.to(dev), (1, 1)
    W = int(edge[1:].split("_")[0])
    table, keys, _rows = chip_smoke.probe_inputs(torch, 1000, 1000, W,
                                                 seed=W, out_of_range=True)
    if edge.endswith("_off4"):
        buf = torch.empty(table.numel() + 1, dtype=torch.int32, device=dev)
        view = buf[1:].view(table.shape)
        view.copy_(table)
        return keys.to(dev), view, (0, 1)
    return keys.to(dev), table.to(dev), (int(W % 2 == 0), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("edge", ["w1", "w3", "w10", "w17", "w10_off4",
                                  "w3_off4", "one_row"])
def test_probe_vgather_cuda_edges(edge, checked):
    """``probe_vgather`` on the word path (odd W, a table 4 bytes off its
    allocation) and the 8-byte path (even W), with a ragged last tile, and
    on the probe step's all-one-row input, in the release and the checked
    build (outputs poisoned, so an unwritten word shows): equal to the
    plain version, one launch, no guard fired."""
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    keys, table, path = _vgather_edge(edge, dev)
    assert pk.vgather_access(table, torch.empty_like(table)) == path
    want = pk.probe_vgather_plain(keys.cpu(), table.cpu())
    before = pk.probe_vgather.launches
    with _build(checked) as chk:
        got = pk.probe_vgather(keys, table)
        torch.cuda.synchronize(dev)
    assert pk.probe_vgather.launches == before + 1
    assert torch.equal(got.cpu(), want)
    if checked:
        assert chk.violations == [] and len(chk.launched) == 1


@pytest.mark.gpu
def test_probe_vgather_replays_from_a_cuda_graph():
    """One ``probe_vgather`` call captured into a CUDA graph, then replayed
    with new keys copied into the static buffer: each replay equals the
    eager call on those keys."""
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    shape = chip_smoke.PROBE_SHAPES[0]
    draws = [_probe_args(shape, seed=20 + n) for n in range(3)]
    table = draws[0][0].to(dev)
    keys = draws[0][1].to(dev)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pk.probe_vgather(keys, table)  # warm-up off the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            captured = pk.probe_vgather(keys, table)
        for _table, new_keys, _rows in draws[1:]:
            keys.copy_(new_keys)
            graph.replay()
            torch.cuda.synchronize()
            eager = pk.probe_vgather(new_keys.to(dev), table)
            torch.cuda.synchronize()
            assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("edge", ["c1001", "c1000_off4", "c256_off4"])
def test_fx_block_copy_cuda_edges(edge, checked):
    """``fx_block_copy`` on the word path: C = 1,001 (not a multiple of
    4), and input views 4 bytes off their allocation (C = 1,000, and the
    fixture's 256): equal to the plain version in both builds, one
    launch."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk

    dev = _card()
    C = int(edge[1:].split("_")[0])
    g = torch.Generator().manual_seed(C)
    x = torch.randint(-(1 << 31), 1 << 31, (5, C), generator=g,
                      dtype=torch.int64).to(torch.int32)
    if "off4" in edge:
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
        xd = buf[1:].view(x.shape)
        xd.copy_(x)
    else:
        xd = x.to(dev)
    assert fk.block_copy_access(xd, torch.empty_like(xd)) == 0
    before = fk.fx_block_copy.launches
    with _build(checked) as chk:
        got = fk.fx_block_copy(xd)
        torch.cuda.synchronize(dev)
    assert fk.fx_block_copy.launches == before + 1
    assert torch.equal(got.cpu(), fk.fx_block_copy_plain(x))
    if checked:
        assert chk.violations == [] and len(chk.launched) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("shape", [(8, 256), (32, 32768)])
def test_fx_acc_revisit_cuda_edges(shape, checked):
    """``fx_acc_revisit`` through the ctypes entry with init 0 adds onto
    a pre-filled output (nothing zeroes it), at one CTA and with a
    cluster; an ``x`` view 4 bytes off its allocation takes the word path
    and is right; the entry refuses (cudaErrorInvalidValue, 1) int4 loads
    from that view and a plan that leaves columns out, in both builds."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.core import dispatch

    dev = _card()
    R, C = shape
    g = torch.Generator().manual_seed(C)
    x = torch.randint(-(1 << 31), 1 << 31, (R, C), generator=g,
                      dtype=torch.int64).to(torch.int32)
    old = torch.randint(-(1 << 31), 1 << 31, (R, 1), generator=g,
                        dtype=torch.int64).to(torch.int32)
    want = fk.fx_acc_revisit_plain(x, init=False, acc=old.clone())
    buf = torch.empty(x.numel() + 4, dtype=torch.int32, device=dev)
    aligned, off = buf[:-4].view(R, C), buf[1:-3].view(R, C)
    assert fk.acc_revisit_access(aligned) == 1
    assert fk.acc_revisit_access(off) == 0
    for xd in (aligned, off):
        xd.copy_(x)
        plan = fk.acc_revisit_plan(R, C, bool(fk.acc_revisit_access(xd)))
        acc = old.to(dev)
        with _build(checked) as chk:
            dispatch.launch("fx_acc_revisit", dev, xd, acc, R, C, 0, *plan,
                            lib=fk.LIB)
            torch.cuda.synchronize(dev)
        assert torch.equal(acc.cpu(), want)
        if checked:
            assert chk.violations == []
        with _build(checked):
            assert torch.equal(fk.fx_acc_revisit(xd).cpu(),
                               fk.fx_acc_revisit_plain(x))
    vec4 = fk.acc_revisit_plan(R, C, True)
    short = (vec4.vec, vec4.cluster, vec4.cols - 4)
    with _build(checked):
        for xd, plan in ((off, vec4), (aligned, short)):
            with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
                dispatch.launch("fx_acc_revisit", dev, xd, acc, R, C, 1,
                                *plan, lib=fk.LIB)


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("edge", ["one_key", "descending", "three_ctas"])
def test_fx_serial_scan_cuda_edges(edge, checked):
    """``fx_serial_scan`` with every message on one key, with keys in
    descending order, and over a table of two whole slices and a ragged
    third (three CTAs): the serial loop's table, in both builds, no guard
    firing."""
    from hermes_tpu_torch import build
    from hermes_tpu_torch.analysis import fixture_kernels as fk

    dev = _card()
    src = (build.CSRC / "analysis_fixtures.cu").read_text()
    slots = int(src.split("constexpr int kScanSlots = ")[1].split(";")[0])
    K, M = {"one_key": (64, 4096), "descending": (5000, 5000),
            "three_ctas": (2 * slots + 5, 20000)}[edge]
    g = torch.Generator().manual_seed(K)
    i32 = lambda shape, lo, hi: torch.randint(
        lo, hi, shape, generator=g, dtype=torch.int64).to(torch.int32)
    table, rows = i32((K, 10), -(1 << 31), 1 << 31), i32((M, 10), 0, 1 << 20)
    keys = {"one_key": torch.full((M,), 17, dtype=torch.int32),
            "descending": torch.arange(M - 1, -1, -1, dtype=torch.int32),
            "three_ctas": i32((M,), 0, K)}[edge]
    want = table.clone()
    for i in range(M):  # the serial loop
        want[keys[i]] = rows[i]
    with _build(checked) as chk:
        got = fk.fx_serial_scan(table.to(dev), keys.to(dev), rows.to(dev))
        torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), want)
    if checked:
        assert chk.violations == [] and len(chk.launched) == 1


@pytest.mark.gpu
def test_probe_serial_first_call_in_a_capture_raises():
    """A capture on a stream that has no winner column yet raises rather
    than record the column's fill, and keeps no column for that stream."""
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    shape = chip_smoke.PROBE_SHAPES[0]
    static = [x.to(dev) for x in _probe_args(shape)]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(graph, stream=s):
            pk.probe_serial(*static)
    assert (static[0].device, s.cuda_stream, shape[0]) not in pk.win_columns


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("edge", ["bank_off_by_4", "bank_off_by_1",
                                  "stuck_in_last_span"])
def test_mega_replay_cuda_edges(edge, checked):
    """``mega_replay`` at the bench shape with the bank 4 bytes off its
    allocation (4-byte sst words, byte-wise value copies) and 1 byte off
    (the byte path for both), and with every stuck row in the last CTA's
    span (the ranks all made by one CTA at the end of the grid): equal to
    the plain version in both builds."""
    from hermes_tpu_torch.core import megaround as mega

    dev = _card()
    wrapper, plain, (cfg, step, frozen, vpts, bank, rep) = _mega_call(
        "mega_replay", chip_smoke.REPLAY_SHAPES[0])
    K = bank.shape[0]
    if edge == "stuck_in_last_span":
        R, RS = rep.active.shape
        plan = mega.replay_plan(
            K, mega.REPLAY_GRID_MAX - mega.replay_slot_tasks(R, RS))
        lo = (plan.ctas - 1) * plan.per * mega.REPLAY_UNIT_ROWS
        sst = bank[:, 4:8].clone()
        bank[:, 4:8] = 0  # VALID at step 0: not stuck
        bank[lo:, 4:8] = sst[lo:]
        bank[lo + 5:lo + 400:3, 4:8] = sst[0:1].new_tensor(
            [[1, 0, 0, 0]], dtype=torch.int8)  # INVALID at step 0
    want = chip_smoke._flat(plain(cfg, step, frozen, vpts, bank.clone(), rep))
    card = chip_smoke._to(torch, (step, frozen, vpts, bank, rep), dev)
    off = {"bank_off_by_4": 4, "bank_off_by_1": 1}.get(edge)
    if off:
        big = torch.zeros(bank.numel() + off, dtype=torch.int8, device=dev)
        big[off:] = card[3].reshape(-1)
        card[3] = big[off:].view(bank.shape)
        assert card[3].data_ptr() % 8 == off
        words, vec = mega.replay_access(card[3], card[4].val, card[4].val,
                                        card[4].active)
        assert (words, vec) == ((1, 1) if off == 4 else (0, 1))
    with _build(checked) as chk:
        got = chip_smoke._flat(wrapper(cfg, *card))
        torch.cuda.synchronize(dev)
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())
    assert bool((want[1] & ~rep.active).any())  # slots were taken
    if checked:
        assert chk.violations == []


@pytest.mark.gpu
def test_mega_replay_refused_cooperative_launch_raises(monkeypatch):
    """A plan of more CTAs than co-reside on the card (made here, beside
    the program's own ``replay_plan``) is refused by the C entry, and the
    wrapper raises: nothing falls back to more launches."""
    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core import megaround as mega

    dev = _card()
    # 2,000 CTAs of one unit: more than the 1,056 CTAs of 256 threads an
    # H100's 132 SMs can hold at all
    ctas, R, RS, V = 2000, 2, 2, 2
    K = ctas * mega.REPLAY_UNIT_ROWS
    cfg = chip_smoke.mega_cfg(config, R, K=K, L=RS + 4, RS=RS, V=V)
    args = chip_smoke._to(torch, chip_smoke.replay_inputs(
        torch, fst, K, R, RS, V, 8, seed=5), dev)
    monkeypatch.setattr(mega, "replay_plan",
                        lambda rows, cap=None: mega.ReplayPlan(ctas, 1))
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        mega.mega_replay(cfg, *args)
        torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_stats_block_cuda_rejects_strided_input():
    dev = _card()
    op = torch.zeros((4, 64), dtype=torch.int32, device=dev)[:, ::2]
    z = torch.zeros((4, 32), dtype=torch.bool, device=dev)
    inv = torch.zeros((4, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.stats_block(torch.tensor(1, dtype=torch.int32, device=dev),
                            op, inv, z, z, z)


MEGA_CASES = {"mega_route": (chip_smoke.ROUTE_SHAPES, chip_smoke.route_case),
              "mega_apply": (chip_smoke.APPLY_SHAPES, chip_smoke.apply_case),
              "mega_replay": (chip_smoke.REPLAY_SHAPES,
                              chip_smoke.replay_case)}


def _mega_call(name, shape):
    """(wrapper, plain, CPU arguments) of one mega kernel at one of
    chip_smoke.py's shapes (bench, the reference's cells, ragged)."""
    from types import SimpleNamespace

    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core import megaround as mega

    port = SimpleNamespace(config=config, fst=fst, mega=mega)
    args, _timing, _info = MEGA_CASES[name][1](torch, port, shape, seed=1)
    return getattr(mega, name), getattr(mega, f"{name}_plain"), args


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("name,shape", [
    (name, shape) for name, (shapes, _case) in MEGA_CASES.items()
    for shape in shapes])
def test_mega_kernel_cuda_matches_plain(name, shape, checked):
    """Each mega kernel at chip_smoke.py's shapes, in the release and the
    checked build: equal to the plain version, one launch a call, no
    guard firing on the round's inputs."""
    dev = _card()
    wrapper, plain, args = _mega_call(name, shape)
    want = chip_smoke._flat(plain(*chip_smoke._to(torch, args, "cpu")))
    before = wrapper.launches
    with _build(checked) as chk:
        got = chip_smoke._flat(wrapper(*chip_smoke._to(torch, args, dev)))
        torch.cuda.synchronize(dev)
    assert wrapper.launches == before + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())
    if checked:
        assert chk.violations == []


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("edge", ["one_key", "masked_out", "misaligned"])
def test_mega_apply_cuda_edges(edge, checked):
    """``mega_apply`` at the bench shape with every row on one key (the
    read-back after the grid barrier must see the last maximum: a stale
    L1 line would show here), with every row masked out, and with keys
    and pts off 16-byte alignment (the row-by-row path): equal to the
    plain version in both builds."""
    dev = _card()
    wrapper, plain, (cfg, vpts, keys, pts, mask) = _mega_call(
        "mega_apply", chip_smoke.APPLY_SHAPES[0])
    if edge == "one_key":
        keys = torch.full_like(keys, 12345)
        mask = torch.ones_like(mask)
    elif edge == "masked_out":
        mask = torch.zeros_like(mask)
    want = chip_smoke._flat(plain(cfg, vpts.clone(), keys, pts, mask))
    card = [x.to(dev) for x in (vpts, keys, pts, mask)]
    if edge == "misaligned":  # views one element into larger tensors
        N = keys.numel()
        for i in (1, 2):
            big = torch.zeros(N + 1, dtype=torch.int32, device=dev)
            big[1:] = card[i]
            card[i] = big[1:]
        assert card[1].data_ptr() % 16 == 4
    with _build(checked) as chk:
        got = chip_smoke._flat(wrapper(cfg, *card))
        torch.cuda.synchronize(dev)
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())
    if checked:
        assert chk.violations == []
    if edge == "one_key":
        assert (got[1] == got[0][12345]).all()


def _route_within_freedom(si, word, srank, C, lane_word, slot_lane):
    """True when every element of the kernel's outputs is one of its
    writers' values, and 0 where no position writes it: the freedom the
    kernel matrix's ``mega_route`` cell declares on repeated targets
    (``analysis/diffcheck.py``), checked for whole rows at once."""
    R, L = si.shape
    lane = si.long().clamp(0, L - 1)
    s = srank.long()
    for got, tgt, val, keep, n in (
            (lane_word, lane, word, torch.ones_like(s, dtype=torch.bool), L),
            (slot_lane, s.clamp(0, max(C - 1, 0)), lane.int(),
             (s >= 0) & (s < C), C)):
        if n == 0:
            continue
        writers = torch.zeros((R, n), dtype=torch.int32).scatter_add_(
            1, tgt, keep.int())
        ok = keep & (torch.gather(got, 1, tgt) == val)
        hit = torch.zeros((R, n), dtype=torch.int32).scatter_reduce_(
            1, tgt, ok.int(), "amax")
        if not bool(torch.where(writers > 0, hit == 1, got == 0).all()):
            return False
    return True


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.ROUTE_SHAPES)
def test_mega_route_cuda_repeated_targets_within_freedom(shape):
    """Uniform draws of ``si`` (a few outside [0, L)) and ``srank`` (a few
    outside [0, C)) repeat targets, which the round never does: each
    element must hold one of its writers' values, 0 where none writes,
    and the check itself must turn red on one wrong word."""
    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import megaround as mega

    dev = _card()
    R, L, C = shape
    cfg = chip_smoke.mega_cfg(config, R, L=L, C=C)
    g = torch.Generator().manual_seed(R * L + C)
    si = torch.randint(-2, L + 2, (R, L), generator=g, dtype=torch.int32)
    srank = torch.randint(-2, C + 2, (R, L), generator=g, dtype=torch.int32)
    word = torch.randint(1, 1 << 22, (R, L), generator=g, dtype=torch.int32)
    assert len(si[0].unique()) < L  # a repeated lane
    lane_word, slot_lane = (x.cpu() for x in mega.mega_route(
        cfg, si.to(dev), word.to(dev), srank.to(dev)))
    assert _route_within_freedom(si, word, srank, C, lane_word, slot_lane)
    lane_word[0, int(si[0].clamp(0, L - 1)[0])] += 1
    assert not _route_within_freedom(si, word, srank, C, lane_word, slot_lane)


@pytest.mark.gpu
def test_mega_kernels_reject_strided_input():
    dev = _card()
    wrapper, _plain, (cfg, *args) = _mega_call("mega_route", (2, 12, 12))
    si, word, srank = (x.to(dev)[:, ::2] for x in args)
    with pytest.raises(ValueError):
        wrapper(cfg, si, word, srank)


PROBE_CASES = {"probe_serial": chip_smoke.serial_case,
               "probe_vgather": chip_smoke.vgather_case}


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape", [
    (name, shape) for name in PROBE_CASES for shape in chip_smoke.PROBE_SHAPES])
def test_probe_kernel_cuda_matches_plain(name, shape):
    """The table-step probe's kernels at chip_smoke.py's shapes (the bench
    table, the probe's cell, almost all duplicates, ragged with keys
    outside [0, K)): equal to the plain version, one launch per call."""
    from types import SimpleNamespace

    from hermes_tpu_torch import table_probe
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    port = SimpleNamespace(pk=pk, probe=table_probe)
    args, _timing, _info = PROBE_CASES[name](torch, port, shape, seed=2)
    wrapper, plain = getattr(pk, name), getattr(pk, f"{name}_plain")
    want = plain(*chip_smoke._to(torch, args, "cpu"))
    before = wrapper.launches
    got = wrapper(*chip_smoke._to(torch, args, dev))
    torch.cuda.synchronize(dev)
    assert wrapper.launches == before + 1
    assert torch.equal(want, got.cpu())


@pytest.mark.gpu
def test_probe_kernels_reject_strided_input():
    from hermes_tpu_torch.core import probe_kernels as pk

    dev = _card()
    table = torch.zeros((16, 20), dtype=torch.int32, device=dev)[:, ::2]
    keys = torch.zeros((4,), dtype=torch.int32, device=dev)
    rows = torch.zeros((4, 10), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pk.probe_serial(table, keys, rows)
    with pytest.raises(ValueError):
        pk.probe_vgather(keys, table)


ANALYSIS_KERNELS = ("scan_acc", "fx_pack", "fx_store_at", "fx_acc_revisit",
                    "fx_block_copy", "fx_serial_scan", "fx_async_copy",
                    "fx_loop_inc")


def _analysis_case(name, index):
    from types import SimpleNamespace

    from hermes_tpu_torch.analysis import fixture_kernels as fk

    wrapper, plain, _lib, _replaces = fk.KERNELS[name]
    shapes = (chip_smoke.SCAN_ACC_SHAPES if name == "scan_acc"
              else chip_smoke.FX_SHAPES[name])
    case = (chip_smoke.scan_acc_case if name == "scan_acc"
            else chip_smoke.fx_case(name))
    args, _timing, _info = case(torch, SimpleNamespace(), shapes[index],
                                seed=3)
    return wrapper, plain, args


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("name,index", [
    (name, i) for name in ANALYSIS_KERNELS
    for i in range(len(chip_smoke.SCAN_ACC_SHAPES if name == "scan_acc"
                       else chip_smoke.FX_SHAPES[name]))])
def test_analysis_kernel_cuda_matches_plain(name, index, checked):
    """The sentinel and the seven fixtures at chip_smoke.py's shapes (the
    fixture's own, a larger ragged one), in the release and in the
    bound-checked build: equal to the plain version, one launch per call,
    and in the checked build no guard fires on inputs in bounds."""
    import contextlib

    from hermes_tpu_torch.core import dispatch

    dev = _card()
    wrapper, plain, args = _analysis_case(name, index)
    want = chip_smoke._flat(plain(*chip_smoke._to(torch, args, "cpu")))
    before = wrapper.launches
    block = dispatch.checked_build() if checked else contextlib.nullcontext()
    with block as chk:
        got = chip_smoke._flat(wrapper(*chip_smoke._to(torch, args, dev)))
        torch.cuda.synchronize(dev)
    assert wrapper.launches == before + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())
    if checked:
        assert chk.violations == [] and len(chk.launched) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
def test_fx_loop_inc_and_async_copy_take_only_paths_the_pointers_allow(
        checked):
    """``fx_loop_inc``'s word path into an output 4 bytes off its
    allocation (1,024 words, a multiple of 4) is right in both builds, the
    word before it untouched; through ctypes the C entries refuse
    (cudaErrorInvalidValue, 1) a vector store into that output and a bulk
    copy from or to a pointer 4 bytes off."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.core import dispatch

    dev = _card()
    poison = dispatch.poison(torch.int32)
    buf = torch.full((1025,), poison, dtype=torch.int32, device=dev)
    acc = buf[1:]
    assert fk.loop_inc_access(acc) == 0
    with _build(checked) as chk:
        dispatch.launch("fx_loop_inc", dev, acc, 1024, 10, 0, lib=fk.LIB)
        torch.cuda.synchronize(dev)
    assert bool((acc == 10).all()) and int(buf[0]) == poison
    if checked:
        assert chk.violations == []
    x = torch.arange(1028, dtype=torch.int32, device=dev)
    o = torch.empty_like(x)
    with _build(checked):
        with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
            dispatch.launch("fx_loop_inc", dev, acc, 1024, 10, 1, lib=fk.LIB)
        for src, dst in ((x[1:1025], o[:1024]), (x[:1024], o[1:1025])):
            with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
                dispatch.launch("fx_async_copy", dev, src, dst, 1024, 1024,
                                lib=fk.LIB)


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True])
def test_fx_pack_and_store_at_take_only_paths_the_pointers_allow(checked):
    """An output 4 bytes off its allocation (1,024 words, a multiple of 4)
    takes the word path of ``fx_pack`` and of ``fx_store_at`` and is right
    in both builds, the word before it untouched; through ctypes the C
    entries refuse (cudaErrorInvalidValue, 1) int4s into that output, and
    ``fx_pack``'s int4s from an ``a`` or ``b`` 4 bytes off."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.core import dispatch

    dev = _card()
    poison = dispatch.poison(torch.int32)
    g = torch.Generator().manual_seed(12)
    a, b = (torch.randint(-(1 << 31), 1 << 31, (1024,), generator=g,
                          dtype=torch.int64).to(torch.int32) for _ in "ab")
    v = b.view(8, 128)
    idx = torch.tensor([[5]], dtype=torch.int32, device=dev)
    ad, bd, vd = a.to(dev), b.to(dev), v.to(dev)
    buf = torch.full((1025,), poison, dtype=torch.int32, device=dev)
    off = buf[1:]
    assert fk.pack_access(ad, bd, off) == 0 and fk.store_at_access(off) == 0
    with _build(checked) as chk:
        dispatch.launch("fx_pack", dev, ad, bd, off, 1024, 0, lib=fk.LIB)
        torch.cuda.synchronize(dev)
        assert torch.equal(off.cpu(), fk.fx_pack_plain(a, b))
        dispatch.launch("fx_store_at", dev, idx, vd, off, 8, 128, 0,
                        lib=fk.LIB)
        torch.cuda.synchronize(dev)
        assert torch.equal(off.view(8, 128).cpu(),
                           fk.fx_store_at_plain(idx.cpu(), v))
    assert int(buf[0]) == poison
    if checked:
        assert chk.violations == []
    x = torch.empty(1025, dtype=torch.int32, device=dev)
    with _build(checked):
        for args in ((ad, bd, off), (x[1:], bd, buf[:1024]),
                     (ad, x[1:], buf[:1024])):
            with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
                dispatch.launch("fx_pack", dev, *args, 1024, 1, lib=fk.LIB)
        with pytest.raises(RuntimeError, match=r"CUDA error 1$"):
            dispatch.launch("fx_store_at", dev, idx, vd, off, 8, 128, 1,
                            lib=fk.LIB)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (7, 13)])
def test_fx_store_at_release_index_past_the_end_writes_zeros_only(shape):
    """The release ``fx_store_at`` with ``idx`` = rows (one past the end),
    on its int4 path and its word path, into a fresh allocation with a
    guard word after the output: every output word is 0 and the guard
    word keeps its value (the old design stored the row past the end)."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.core import dispatch

    dev = _card()
    rows, W = shape
    n = rows * W
    v = torch.arange(1, n + 1, dtype=torch.int32, device=dev).view(rows, W)
    idx = torch.tensor([[rows]], dtype=torch.int32, device=dev)
    buf = torch.full((n + 1,), 12345, dtype=torch.int32, device=dev)
    stored = buf[:n]
    vec = fk.store_at_access(stored)
    assert vec == int(n % 4 == 0)
    dispatch.launch("fx_store_at", dev, idx, v, stored, rows, W, vec,
                    lib=fk.LIB)
    torch.cuda.synchronize(dev)
    assert bool((stored == 0).all()) and int(buf[n]) == 12345


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 65536])
def test_checked_fx_async_copy_skips_a_tile_past_its_output(n):
    """The checked entry driven through ctypes with an output extent 4
    words short of the copy: the range check records the fault once (a
    store in ``async_copy_kernel`` at its ``HG_ST_RANGE`` line, index and
    extent n - 4) and skips the whole last tile, whose words keep their
    poison, while the tiles before it are copied; with the full extent the
    same call copies everything and reports only its declared bulk
    copy."""
    from hermes_tpu_torch import build
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.core import dispatch

    dev = _card()
    src = (build.CSRC / "analysis_fixtures.cu").read_text().splitlines()
    line = next(i for i, t in enumerate(src, 1) if "HG_ST_RANGE(" in t
                and dispatch.kernel_at(fk.LIB, i) == "async_copy_kernel")
    tile = next(int(t.split("=")[1].split(";")[0]) for t in src
                if "constexpr int kTileBytes" in t) // 4
    last = (n - 1) // tile * tile  # the last tile's first word
    x = torch.arange(n, dtype=torch.int32, device=dev)
    with dispatch.checked_build() as chk:
        o = dispatch.out((n,), torch.int32, dev)
        dispatch.launch("fx_async_copy", dev, x, o, n, n - 4, lib=fk.LIB)
    [v] = chk.violations
    assert (v["kernel"], v["line"], v["index"], v["extent"], v["store"],
            v["count"]) == ("async_copy_kernel", line, n - 4, n - 4, True, 1)
    assert torch.equal(o[:last], x[:last])
    assert bool((o[last:] == dispatch.poison(torch.int32)).all())
    with dispatch.checked_build() as chk:
        o = dispatch.out((n,), torch.int32, dev)
        dispatch.launch("fx_async_copy", dev, x, o, n, n, lib=fk.LIB)
    assert chk.violations == [] and torch.equal(o, x)
    assert [u["kernel"] for u in chk.unguarded] == ["async_copy_kernel"]
    assert "cp.async.bulk" in chk.unguarded[0]["what"]


@pytest.mark.gpu
def test_kernel_matrix_green_on_card_in_both_builds():
    """Every cell of the kernel matrix: analyzed in the checked build with
    no finding and every guard site proved, sanitized on 3 draws in the
    release and in the checked build, where ``diff_check`` also holds every
    output equal to the plain version's on the CPU; a cell whose plain
    version is made to differ turns red in both builds."""
    import dataclasses

    from hermes_tpu_torch import analysis as ana
    from hermes_tpu_torch.analysis import diffcheck as dc

    _card()
    cell = dc.cell_by_name("mega_replay/k2500b3")
    wrong = dataclasses.replace(
        cell, plain=lambda *a: tuple(o + 1 if i == 2 else o
                                     for i, o in enumerate(cell.plain(*a))))
    for checked in (False, True):
        r = dc.diff_check(wrong, n_draws=1, device="cuda", checked=checked)
        assert {(v["kind"], v["out"]) for v in r["violations"]} == {
            ("plain", 2)}, r
        reports = ana.run_kernel_matrix(n_draws=3, device="cuda",
                                        checked=checked)
        assert len(reports) == 9
        for r in reports:
            assert r["build"] == "checked" and r["findings"] == [], r
            assert r["proved"]["refhazard"] == r["n_sites"] > 0
            assert r["sanitizer"]["ok"], r["sanitizer"]["violations"]


@pytest.mark.gpu
@pytest.mark.parametrize("red", ["store_at", "block_copy", "serial_scan",
                                 "acc_revisit", "mega_apply", "async_copy"])
def test_red_fixture_gives_its_finding_and_context_lives(red):
    """Each red fixture in the checked build gives its finding, with the
    kernel's name and the .cu file and line of the guard site; the guard
    skips the access, so a release launch afterwards is still right.
    ``mega_apply`` is red only in the test-only build without its clamp
    (the reference's test_broken_kernel_oob_store_flips_analyzer_red) and
    clean with it, on the same wire keys."""
    from hermes_tpu_torch.analysis import fixture_kernels as fk
    from hermes_tpu_torch.analysis.diffcheck import analyze_call
    from hermes_tpu_torch.analysis.domain import iv, top
    from hermes_tpu_torch.core import megaround as mega

    dev = _card()
    g = torch.Generator().manual_seed(11)
    i32 = lambda shape, lo, hi: torch.randint(
        lo, hi, shape, generator=g, dtype=torch.int64).to(torch.int32).to(dev)
    v, x = i32((8, 128), 0, 101), i32((8, 256), 0, 4)
    any32 = top("int32")
    lib, broken = fk.LIB, False
    if red == "store_at":
        idx = torch.tensor([[100]], dtype=torch.int32, device=dev)
        call, avs, want = (lambda: (fk.fx_store_at(idx, v),), [iv(0, 100)],
                           ("oob-block-store", "store_at_kernel"))
    elif red == "block_copy":
        call, avs, want = (lambda: (fk.fx_block_copy(x, 1),), [any32],
                           ("oob-block-store", "block_copy_kernel"))
    elif red == "serial_scan":
        keys = i32((32,), 0, 64)
        keys[5] = 64
        table, rows = i32((64, 10), 0, 101), i32((32, 10), 0, 1 << 20)
        call, avs, want = (lambda: (fk.fx_serial_scan(table, keys, rows),),
                           [iv(0, 1 << 20)],
                           ("oob-block-store", "serial_scan_kernel"))
    elif red == "acc_revisit":
        call, avs, want = (lambda: (fk.fx_acc_revisit(x, init=False),),
                           [iv(0, 3 * 256)],
                           ("ref-read-before-init", "fx_acc_revisit"))
    elif red == "async_copy":
        call, avs, want = (lambda: (fk.fx_async_copy(v),), [iv(0, 100)],
                           ("guard-skipped", "async_copy_kernel"))
    else:
        from hermes_tpu_torch import config

        cfg = chip_smoke.mega_cfg(config, 2)
        vpts, keys, pts, mask = (t.to(dev) for t in chip_smoke.apply_inputs(
            torch, 16, 16, seed=3))
        mask[:] = True
        call = lambda: mega.mega_apply(cfg, vpts.clone(), keys, pts, mask)
        avs, want = [iv(0, 1 << 25)] * 2, ("oob-block-store", "apply_kernel")
        lib, broken = "mega_apply", True
        _outs, sound = analyze_call(call, avs, "mega_apply", lib)
        assert sound == []  # with its clamp the same keys are clean
    _outs, found = analyze_call(call, avs, want[1], lib, broken=broken)
    hit = [f for f in found if f.code == want[0]]
    assert hit, [f.code for f in found]
    f = hit[0]
    assert f.fn == want[1] and f.file == f"hermes_tpu_torch/csrc/{lib}.cu"
    assert f.line > 0
    if red == "async_copy":
        assert f.severity == "info" and "cp.async" in f.message
    else:
        assert f.severity == "error"
    # the context lives: a release launch, held against its plain version
    probe = torch.arange(128, dtype=torch.int32).reshape(16, 8)
    assert torch.equal(fk.scan_acc(probe.to(dev)).cpu(),
                       fk.scan_acc_plain(probe))


@pytest.mark.gpu
def test_probe_cells_analysis_clean_on_card():
    """The probe's analysis fields from the checked build of its kernels,
    a resident table of any content."""
    from hermes_tpu_torch import table_probe

    _card()
    for cand in ("torch", "serial", "onehot", "vgather"):
        c = table_probe.analyze_step(cand, 4096, 4096, "cuda")
        assert c["analysis_clean"] and c["analysis_build"] == "checked", c


def _tree_np(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_np(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_tree_np(x) for x in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _assert_equal_trees(a, b, path):
    import numpy as np

    if hasattr(a, "_fields") or isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}[{i}]")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.gpu
@pytest.mark.parametrize("arb_mode", ["race", "sort", "sort-mega"])
def test_round_on_card_matches_cpu(arb_mode):
    """The whole round on the card (sorts, scatters, the kernels) is
    bit-identical to the round on the CPU, which the CPU suite holds
    against the JAX reference — through a freeze and a removal, with the
    replay scan firing; "sort-mega" runs the mega round."""
    from hermes_tpu_torch import convert
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.workload import ycsb

    dev = _card()
    mega_round = arb_mode == "sort-mega"
    arb_mode = arb_mode.split("-")[0]
    cfg = HermesConfig(
        n_replicas=4, n_keys=256, n_sessions=32, replay_slots=8,
        ops_per_session=16, arb_mode=arb_mode, mega_round=mega_round,
        chain_writes=4 if arb_mode == "sort" else 0, wrap_stream=True,
        device_stream=True, lane_budget_cfg=24, read_unroll=2, replay_age=2,
        replay_scan_every=2, workload=WorkloadConfig(read_frac=0.4,
                                                     rmw_frac=0.3, seed=3))
    states = {d: fst.init_fast_state(cfg, d) for d in ("cpu", dev)}
    streams = {d: fst.prep_stream(ycsb.stub_stream(cfg), d) for d in states}
    for s in range(40):
        outs = {}
        for d in states:
            ctl = fst.make_fast_ctl(cfg, s, d)
            if 10 <= s:
                ctl = ctl._replace(frozen=torch.tensor([0, 0, 0, 1], dtype=torch.bool, device=d))
            if 20 <= s:
                ctl = ctl._replace(
                    live_mask=torch.full((4,), 0b0111, dtype=torch.int32, device=d),
                    epoch=torch.ones(4, dtype=torch.int32, device=d))
            states[d], comp = fst.fast_round_batched(cfg, ctl, states[d], streams[d])
            outs[d] = (convert.fast_state_to_numpy(states[d]), _tree_np(comp))
        _assert_equal_trees(outs["cpu"], outs[dev], f"round {s}")


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_runtime_and_kvs_on_card_match_cpu(depth):
    """FastRuntime and KVS on the card (depth 2 harvests through the
    pinned asynchronous copy) give the CPU run's completions, Meta and a
    green checker."""
    import numpy as np

    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.runtime import FastRuntime

    dev = _card()
    cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=8, replay_slots=4,
                       ops_per_session=24, value_words=4, arb_mode="sort",
                       chain_writes=3, pipeline_depth=depth,
                       workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.3,
                                               seed=17))
    runs = {d: FastRuntime(cfg, record=True, device=d) for d in ("cpu", dev)}
    for s in range(30):
        outs = {d: _tree_np(rt.step_once()) for d, rt in runs.items()}
        if outs["cpu"] is None:
            assert outs[dev] is None
        else:
            _assert_equal_trees(outs["cpu"], outs[dev], f"step {s}")
    for rt in runs.values():
        assert rt.drain(400)
    _assert_equal_trees(_tree_np(runs["cpu"].fs.meta),
                        _tree_np(runs[dev].fs.meta), "meta")
    assert runs[dev].check().ok

    res = {}
    for d in ("cpu", dev):
        kvs = KVS(cfg, record=True, device=d)
        rng = np.random.default_rng(8)
        kinds = rng.choice([KVS.GET, KVS.PUT, KVS.RMW], 64)
        bf = kvs.submit_batch(kinds, rng.integers(0, 16, 64),
                              rng.integers(0, 1000, (64, 2)))
        assert kvs.run_batch(bf, 300)
        assert kvs.rt.check().ok
        res[d] = (bf.code, bf.value, bf.uid, bf.step)
    _assert_equal_trees(res["cpu"], res[dev], "kvs")


@pytest.mark.gpu
@pytest.mark.parametrize("mega_round", [False, True])
def test_round_duplicate_scatters_write_identical_rows_on_card(
        mega_round, monkeypatch):
    """The round's two set-scatters with duplicate indices, the winner-row
    write (``core/faststep.py:_winner_row_scatter``) and the replay mark
    (``_replay_scan``), are right only because every duplicate writes the
    same bytes: ``index_put_`` on the card leaves their order open.  On
    bench-a (fused, where ``_replay_scan`` marks) and bench-a-mega (where
    ``mega_replay`` marks), with replica 1 frozen from round 8 until after
    the replay scan of round 32, every row the two sites pass to
    ``index_put_`` is recorded: every duplicated target but the drop row
    must receive byte-identical rows."""
    import sys

    from hermes_tpu_torch import config
    from hermes_tpu_torch.runtime import FastRuntime

    _card()
    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, device="cuda")
    rt.fetch_completions = False
    bank = rt.fs.table.bank
    drop = bank.shape[0] - 1
    sites = {"_winner_row_scatter": [], "_replay_scan": []}
    real = torch.Tensor.index_put_

    def index_put_(self, indices, values, accumulate=False):
        site = sys._getframe(1).f_code.co_name
        if site in sites and self.dtype == torch.int8 and (
                self.shape == bank.shape):
            rows, vals = indices[0], values
            order = torch.argsort(rows, stable=True)
            r, v = rows[order], vals[order]
            dup = (r[1:] == r[:-1]) & (r[1:] != drop)
            differ = dup & (v[1:] != v[:-1]).any(dim=1)
            sites[site].append(torch.stack([dup.sum(), differ.sum()]))
        return real(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_put_", index_put_)
    for s in range(40):
        if s == 8:
            rt.freeze(1)
        if s == 33:
            rt.thaw(1)
        rt.step_once()
    torch.cuda.synchronize()
    got = {site: torch.stack(v).sum(0).tolist() if v else [0, 0]
           for site, v in sites.items()}
    assert len(sites["_winner_row_scatter"]) == 40
    if not mega_round:
        assert sites["_replay_scan"], "the replay mark never ran"
    assert sum(dup for dup, _ in got.values()) > 0, got
    assert all(differ == 0 for _, differ in got.values()), got


@pytest.mark.gpu
@pytest.mark.parametrize("mega_round", [False, True])
def test_sharded_round_duplicate_scatters_write_identical_rows_on_card(
        mega_round, monkeypatch):
    """The sharded round's set-scatters with duplicate indices: the
    winner-row write (``_winner_row_scatter`` from ``_apply_commit``,
    R x Rsrc x C rows into the R copies, more duplicates than batched)
    and the replay mark (``_replay_scan``, each replica into its own
    copy).  On bench-a and bench-a-mega on the sharded engine, with
    replica 1 frozen from round 8 until after the replay scan of round
    32, every duplicated target but a copy's drop row must receive
    byte-identical rows."""
    import sys

    from hermes_tpu_torch import config
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.runtime import FastRuntime

    _card()
    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, backend="sharded", group=LocalGroup("cuda"))
    rt.fetch_completions = False
    bank = rt.fs.table.bank
    K = cfg.n_keys
    sites = {"_winner_row_scatter": [], "_replay_scan": []}
    real = torch.Tensor.index_put_

    def index_put_(self, indices, values, accumulate=False):
        site = sys._getframe(1).f_code.co_name
        if site in sites and self.dtype == torch.int8 and (
                self.shape == bank.shape):
            rows, vals = indices[0], values
            order = torch.argsort(rows, stable=True)
            r, v = rows[order], vals[order]
            dup = (r[1:] == r[:-1]) & (r[1:] % (K + 1) != K)
            differ = dup & (v[1:] != v[:-1]).any(dim=1)
            sites[site].append(torch.stack([dup.sum(), differ.sum()]))
        return real(self, indices, values, accumulate)

    monkeypatch.setattr(torch.Tensor, "index_put_", index_put_)
    for s in range(40):
        if s == 8:
            rt.freeze(1)
        if s == 33:
            rt.thaw(1)
        rt.step_once()
    torch.cuda.synchronize()
    got = {site: torch.stack(v).sum(0).tolist() if v else [0, 0]
           for site, v in sites.items()}
    assert len(sites["_winner_row_scatter"]) == 40
    if not mega_round:
        assert sites["_replay_scan"], "the replay mark never ran"
    assert sum(dup for dup, _ in got.values()) > 0, got
    assert all(differ == 0 for _, differ in got.values()), got


@pytest.mark.gpu
def test_mega_kernels_at_the_sharded_sites_match_plain_on_card():
    """``mega_apply`` at the sharded site (one launch over the flat
    R*(K+1)-row table: every replica's gathered slots and replay keys,
    keys offset into its own copy) and ``mega_replay`` on one copy's K-row
    view, on the inputs of real bench-a-mega rounds of the sharded engine
    (``chip_smoke.sharded_site_inputs``, which freezes replica 1 so that
    the scan takes slots): equal to their plain versions on the CPU, one
    launch a call."""
    from types import SimpleNamespace

    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import megaround as mega
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.runtime import FastRuntime

    _card()
    cfg = config.bench_cfg("a", over=dict(mega_round=True))
    rt = FastRuntime(cfg, backend="sharded", group=LocalGroup("cuda"))
    rt.fetch_completions = False
    rt.run(6)
    sh = SimpleNamespace(mega=mega, device="cuda")
    got = chip_smoke.sharded_site_inputs(torch, sh, rt)
    for name, args in got.items():
        wrapper = getattr(mega, name)
        plain = getattr(mega, name + "_plain")
        want = chip_smoke._flat(plain(*chip_smoke._to(torch, args, "cpu")))
        before = wrapper.launches
        out = chip_smoke._flat(wrapper(*chip_smoke._to(torch, args, "cuda")))
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        for w, x in zip(want, out):
            assert torch.equal(w, x.cpu()), name
    _cfg, vpts, keys, _pts, mask = got["mega_apply"]
    assert vpts.shape[0] == cfg.n_replicas * (cfg.n_keys + 1)
    assert bool(mask.any())
    assert got["mega_replay"][4].shape[0] == cfg.n_keys
    taken = mega.mega_replay_plain(*chip_smoke._to(
        torch, got["mega_replay"], "cpu"))[1][0]
    assert bool((taken & ~got["mega_replay"][5].active.cpu()).any())


_TWO_RANKS_ONE_CARD = r"""
import sys
import torch
from hermes_tpu_torch import launch
from hermes_tpu_torch.core.group import DistGroup
launch.init_distributed(sys.argv[1], 2, int(sys.argv[2]), device="cuda")
try:
    DistGroup(None, "cuda:0")
except ValueError as e:
    print("REFUSED", e)
"""


@pytest.mark.gpu
def test_dist_group_refuses_two_ranks_on_one_card(tmp_path):
    """A ``DistGroup`` on CUDA needs NCCL and one distinct card a rank:
    two ranks of an NCCL group both on card 0 are refused, on both ranks,
    before any collective runs on the card."""
    import os
    import subprocess
    import sys

    _card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "two_ranks.py"
    script.write_text(_TWO_RANKS_ONE_CARD)
    init = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, str(script), init, str(r)],
                              env=dict(os.environ, PYTHONPATH=root),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        assert "REFUSED" in out and "distinct device" in out, out[-2000:]


def _read_drive(kvs, np):
    """Writes beside local reads: a batch stepped part way with replica 2
    frozen (so keys are Invalid), multi-gets with a session, a scan, the
    fallbacks driven home; returns every answer column."""
    out = []
    rng = np.random.default_rng(21)
    for it in range(4):
        kvs.freeze(2)
        keys = rng.integers(0, 48, 32)
        bf = kvs.submit_batch(np.full(32, kvs.PUT, np.int32), keys,
                              rng.integers(-999, 999, (32, 4)))
        kvs.step()
        kvs.step()
        lane = (it % 2, 0)
        res = kvs.multi_get(rng.integers(0, 64, 40), session=lane,
                            wait=False)
        sc = kvs.scan(0, 64, wait=False)
        kvs.rt.thaw(2)
        assert kvs.run_batch(bf, 300)
        for r in (res, sc):
            if r._fallback is not None:
                assert kvs.run_batch(r._fallback[0], 300)
            r._pull()
            out.append((r.code, r.value, r.found, r.local, r.step, r.key))
        kvs.pin_read_fence(lane, int(keys[0]),
                           (int(bf.tsv[0]) + 1, 0))
        f = kvs.multi_get([int(keys[0])], session=lane)
        out.append((f.code, f.value, f.local, bf.uid, bf.tsv))
    out.append(tuple(kvs.read_stats().values()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_read_path_on_card_matches_cpu(depth):
    """multi_get / scan / the RYW fence on the card give the CPU port's
    answers column for column (the CPU port is held to the JAX reference
    by tests/test_torch_readpath.py), and a green checker with no stale
    read."""
    import numpy as np

    from hermes_tpu_torch.checker import linearizability as lin
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS

    dev = _card()
    cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=8, replay_slots=4,
                       value_words=6, pipeline_depth=depth)
    got = {}
    for d in ("cpu", dev):
        kvs = KVS(cfg, record=True, device=d)
        got[d] = _read_drive(kvs, np)
        assert kvs.rt.check().ok
        assert lin.stale_read(kvs.rt.history_ops()) == []
    _assert_equal_trees(tuple(got["cpu"]), tuple(got[dev]), "reads")
    assert got[dev][-1][1] > 0  # some reads went through the round path


@pytest.mark.gpu
def test_heap_device_gather_on_card_equals_mirror_at_bench_size():
    """The extent gather on the card, from the 8 MiB log of the bench
    heap filled with memcached-shaped values, equals the host mirror;
    hostile refs (negative, past the log, past the declared fields)
    answer what the CPU port answers, in bounds; and appends after a
    first gather reach the card through the dirty-tail sync."""
    import numpy as np

    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import layouts
    from hermes_tpu_torch.heap import ValueHeap, pack_ref
    from hermes_tpu_torch.workload import ycsb

    _card()
    cfg = config.bench_cfg("a", over=dict(
        device_stream=False, read_unroll=1, max_value_bytes=1024,
        heap_bytes=layouts.MAX_HEAP_BYTES))
    heaps = {d: ValueHeap(cfg, device=d) for d in ("cpu", "cuda")}
    lens = ycsb.value_sizes(dict(n=40000, max_bytes=1024), 3)
    refs = []
    for i, n in enumerate(lens[:30000]):
        p = ycsb.value_payload(3, i, int(n))
        refs.append(heaps["cpu"].append(p))
        assert heaps["cuda"].append(p) == refs[-1]
    cpu, card = heaps["cpu"], heaps["cuda"]
    hostile = [-1, -(1 << 31), (1 << 31) - 1, pack_ref(cpu.granules - 1, 1024),
               pack_ref((1 << 19) - 1, 4095), pack_ref(3, 4000), 0]

    def check(batch, n_real):
        rows, glens = card.device_gather(batch)
        crows, clens = cpu.device_gather(batch)
        assert np.array_equal(rows, crows) and np.array_equal(glens, clens)
        for i in range(n_real):
            ln = int(glens[i])
            assert rows[i, :ln].tobytes() == card.read(int(batch[i]))
            assert not rows[i, ln:].any()

    check(np.asarray(refs + hostile, np.int32), len(refs))
    more = []
    for i, n in enumerate(lens[30000:31000]):
        p = ycsb.value_payload(4, i, int(n))
        more.append(card.append(p))
        assert cpu.append(p) == more[-1]
    check(np.asarray(more + refs[:100], np.int32), len(more) + 100)


@pytest.mark.gpu
def test_heap_gc_column_rewrite_leaves_the_drop_row_on_card():
    """A contended heap drive on the card (16 writers a key, so losing
    rows scatter to row K in any order), then a GC that moves every
    extent: the ref-word rewrite of rows [0, K) leaves row K byte for
    byte as it was, the values stay byte-exact, and the heap stats equal
    the CPU port's on the same drive."""
    import numpy as np

    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS

    dev = _card()
    cfg = HermesConfig(n_replicas=3, n_keys=128, value_words=3,
                       n_sessions=16, replay_slots=8, max_value_bytes=256,
                       heap_bytes=1 << 14)
    stats, data = {}, {}
    for d in ("cpu", dev):
        kvs = KVS(cfg, device=d)
        for rnd in range(6):
            keys = np.arange(48, dtype=np.int64) % 3
            pays = [bytes([(rnd * 48 + i) & 0xFF]) * (10 + i)
                    for i in range(48)]
            bf = kvs.submit_batch(np.full(48, KVS.PUT, np.int32), keys, pays)
            assert kvs.run_batch(bf, 300)
        bank = kvs.rt.fs.table.bank
        row_k = bank[-1].clone()
        stats[d] = kvs.heap_gc(reason="card")
        assert stats[d] and stats[d]["gc_reclaimed_bytes"] > 0
        assert torch.equal(bank[-1], row_k)
        data[d] = kvs.multi_get(np.arange(3)).data
    assert stats["cpu"] == stats[dev] and data["cpu"] == data[dev]
    assert all(x is not None for x in data[dev])


@pytest.mark.gpu
@pytest.mark.parametrize("heap", [False, True], ids=["words", "heap"])
def test_wal_replay_on_card_equals_cpu(heap):
    """The vectorised WAL replay on the card: many records a key, out of
    timestamp order, over a table that already holds some of them, give
    the CPU port's applied/skipped counts, table and heap; the drop row
    stays as it was."""
    import numpy as np

    from hermes_tpu_torch import convert
    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.wal import replay

    dev = _card()
    over = (dict(value_words=4, max_value_bytes=64, heap_bytes=1 << 22)
            if heap else dict(value_words=6))
    cfg = HermesConfig(n_replicas=3, n_keys=4096, n_sessions=8,
                       replay_slots=4, **over)
    rng = np.random.default_rng(3)

    def records(n_rec, per, first):
        out = []
        for j in range(n_rec):
            lens = (rng.integers(0, 40, per) if heap
                    else np.zeros(per, np.int64)).astype(np.int32)
            out.append(dict(
                kind=1, lsn=first + j, round_idx=first + j,
                step=np.full(per, first + j, np.int64),
                key=rng.integers(0, cfg.n_keys, per).astype(np.int32),
                ver=rng.integers(1, 9, per).astype(np.int64),
                fc=rng.integers(0, 8, per).astype(np.int32),
                wv=rng.integers(-99, 99, (per, cfg.value_words)
                                ).astype(np.int32), lens=lens,
                blob=rng.integers(0, 256, int(lens.sum())
                                  ).astype(np.uint8).tobytes()))
        return out

    seed, recs = records(2, 2048, 0), records(8, 4096, 10)
    got = {}
    for d in ("cpu", dev):
        kvs = KVS(cfg, device=d)
        replay.apply_records(kvs.rt, seed, heap=kvs.heap)
        counts = replay.apply_records(kvs.rt, recs, heap=kvs.heap)
        assert int(kvs.rt.fs.table.vpts[-1]) == 0
        assert not kvs.rt.fs.table.bank[-1].any()
        got[d] = (counts, convert.fast_state_to_numpy(kvs.rt.fs).table,
                  None if kvs.heap is None else kvs.heap._mirror.copy())
    (ca, ta, ha), (cb, tb, hb) = got["cpu"], got[dev]
    assert ca == cb and ca[0] > 0 and ca[1] > 0
    np.testing.assert_array_equal(ta.vpts, tb.vpts)
    np.testing.assert_array_equal(ta.bank, tb.bank)
    if heap:
        np.testing.assert_array_equal(ha, hb)


@pytest.mark.gpu
def test_traced_bench_drive_leaves_state_identical():
    """At the bench shape on the card, a KVS with an obs context attached
    (per-step spans, 1-in-64 op tracing) ends a put/get drive with the
    state tree and the completions of an untraced one, byte for byte."""
    import numpy as np

    from hermes_tpu_torch import config, convert
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.obs import Observability, canonical_span_bytes

    dev = _card()
    out = []
    for traced in (True, False):
        cfg = config.bench_cfg("a", over=dict(
            device_stream=False, read_unroll=1,
            trace_sample=64 if traced else 0))
        kvs = KVS(cfg, device=dev)
        obs = (kvs.rt.attach_obs(Observability(trace_steps=True))
               if traced else None)
        rng = np.random.default_rng(8)
        n = 65536
        keys = rng.choice(cfg.n_keys, n, replace=False)
        vals = rng.integers(0, 1 << 30, (n, cfg.value_words - 2),
                            dtype=np.int32)
        bf = kvs.submit_batch(np.full(n, KVS.PUT, np.int32), keys, vals)
        assert kvs.run_batch(bf, 64)
        futs = [kvs.put(r, 7, int(keys[r]), [r]) for r in range(8)]
        futs += [kvs.get(r, 9, int(keys[r])) for r in range(8)]
        assert kvs.run_until(futs, 64)
        torch.cuda.synchronize()
        out.append((convert.fast_state_to_numpy(kvs.rt.fs),
                    bf.code.copy(), bf.uid.copy(),
                    [f.result() for f in futs], kvs.rt.step_idx))
        if traced:
            assert canonical_span_bytes(obs.records)
    (sa, *ra), (sb, *rb) = out
    for x, y in zip(sa, sb):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1], rb[1])
    assert ra[2:] == rb[2:]


def _chaos_cfg(depth):
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig

    return HermesConfig(n_replicas=5, n_keys=96, n_sessions=6,
                        replay_slots=6, ops_per_session=24, replay_age=6,
                        replay_scan_every=4, rebroadcast_every=2,
                        lease_steps=6, pipeline_depth=depth,
                        workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.25,
                                                seed=23))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["batched", "sharded"])
@pytest.mark.parametrize("depth", [1, 2])
def test_chaos_runner_on_card_matches_cpu(backend, depth):
    """A seeded fault schedule with the detector attached (crash restarts,
    freezes, detector removals, heal) gives the CPU port's executed log,
    membership events and final state on the card, on both backends; at
    depth 2 the card's ages ride the pinned harvest copy."""
    from hermes_tpu_torch import chaos, convert
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.obs import Observability
    from hermes_tpu_torch.runtime import FastRuntime

    dev = _card()
    cfg = _chaos_cfg(depth)
    out = {}
    for d in ("cpu", dev):
        rt = FastRuntime(cfg, backend=backend, record=True, device=d)
        obs = rt.attach_obs(Observability())
        rt.attach_membership(MembershipService(cfg, confirm_steps=3))
        runner = chaos.ChaosRunner(rt, chaos.Schedule.random(
            cfg, seed=23, steps=120, spec=chaos.ChaosSpec(p_crash=0.03)))
        res = runner.run(120, check=True)
        assert res["drained"] and res["checked_ok"]
        names = [r["name"] for r in obs.records if r.get("kind") == "event"]
        assert "membership_fetch" not in names and "remove" in names
        out[d] = (runner.log_json(),
                  [(e.step, e.kind, e.replica, e.live_mask)
                   for e in rt.membership.events],
                  convert.fast_state_to_numpy(rt.fs, n_copies=rt.n_copies))
    assert out["cpu"][0] == out[dev][0]
    assert out["cpu"][1] == out[dev][1]
    _assert_equal_trees(out["cpu"][2], out[dev][2], "state")


@pytest.mark.gpu
def test_detector_ages_add_no_sync_to_the_harvest_on_card():
    """On the card at depth 2 a round's suspect-age columns ride its
    completions' pinned copy: a harvest waits on one event with the
    detector as without, and never copies a device tensor to the host
    synchronously."""
    from hermes_tpu_torch import runtime
    from hermes_tpu_torch.membership import MembershipService

    dev = _card()
    cfg = _chaos_cfg(2)
    counts = {"event_waits": 0, "sync_copies": 0}
    real_event = torch.cuda.Event
    real_cpu = torch.Tensor.cpu

    class CountingEvent(real_event):
        def synchronize(self):
            counts["event_waits"] += 1
            return super().synchronize()

    def counting_cpu(self, *args, **kwargs):
        if self.is_cuda:
            counts["sync_copies"] += 1
        return real_cpu(self, *args, **kwargs)

    per = {}
    for detector in (False, True):
        rt = runtime.FastRuntime(cfg, record=True, device=dev)
        if detector:
            rt.attach_membership(MembershipService(cfg))
        torch.cuda.Event = CountingEvent
        torch.Tensor.cpu = counting_cpu
        try:
            rt.run(4)  # every fetch in the ring holds a counting event
            counts.update(event_waits=0, sync_copies=0)
            rt.run(20)
        finally:
            torch.cuda.Event = real_event
            torch.Tensor.cpu = real_cpu
        per[detector] = dict(counts)
        if detector:
            age_round, ages = rt.harvested_ages
            assert age_round == rt.step_idx - 2 and ages.shape == (5, 5)
            assert len(rt._age_ring) == len(rt._ring) == 1
    assert per[True] == per[False] == {"event_waits": 20, "sync_copies": 0}


def _migrate_on(device, backend, depth):
    """A seeded range migration ending at slot K-1 (replica 1 of the
    source frozen across the move), then a cross-group fleet move, on one
    device: the final states, completions and both checkers."""
    import numpy as np

    from hermes_tpu_torch import convert, elastic, fleet
    from hermes_tpu_torch.config import FleetConfig, HermesConfig
    from hermes_tpu_torch.kvs import KVS

    cfg = HermesConfig(n_replicas=4, n_keys=96, n_sessions=8, value_words=6,
                       replay_slots=8, pipeline_depth=depth)
    K, lo = cfg.n_keys, 64
    src = KVS(cfg, backend=backend, record=True, device=device)
    dst = KVS(cfg, backend=backend, record=True, device=device)
    bf = elastic.submit_drill_mix(src, 300, seed=5, read_frac=0.0)
    assert src.run_batch(bf)
    src.freeze(1)
    res = elastic.migrate_range(src, dst, lo, K)
    src.rt.thaw(1)
    gets = [dst.get(r, 2, k) for r in range(4) for k in (lo, K - 1)]
    assert dst.run_until(gets)
    assert src.rt.check().ok and dst.rt.check().ok
    fcfg = FleetConfig(groups=2, base=cfg, ranges=((0, 64), (64, 128)))
    fl = fleet.Fleet(fcfg, backend="batched", record=True,
                     devices=[device, device])
    fb = fl.submit_batch(np.full(40, fl.PUT, np.int32),
                         np.arange(60, 100, dtype=np.int64),
                         np.ones((40, 2), np.int32))
    assert fl.run_batch(fb)
    fres = fl.migrate(64, 80, 0)
    assert fl.check()["ok"]
    return dict(
        summary={k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in res.items()},
        gets=[(g.result().kind, g.result().value) for g in gets],
        states=[convert.fast_state_to_numpy(k.rt.fs, n_copies=k.rt.n_copies)
                for k in (src, dst)] + [
                    convert.fast_state_to_numpy(g.rt.fs) for g in fl.groups],
        fleet=(fres["dest_slots"].tolist(), fb.code.tolist(),
               fl.router.owned_ranges()))


@pytest.mark.gpu
@pytest.mark.parametrize("backend,depth", [("sharded", 1), ("sharded", 2),
                                           ("batched", 2)])
def test_range_migration_on_card_matches_cpu(backend, depth):
    """A migration of a range that ends at K-1 on the card (sharded: one
    copy a replica, each with its drop row; the donor the lowest live,
    unfrozen copy) and a fleet's cross-group move give the CPU port's
    summaries, completions and every state leaf; the destination's copies
    agree over the range."""
    dev = _card()
    want = _migrate_on("cpu", backend, depth)
    got = _migrate_on(dev, backend, depth)
    assert got["summary"] == want["summary"] and got["gets"] == want["gets"]
    assert got["fleet"] == want["fleet"]
    for a, b in zip(want["states"], got["states"]):
        _assert_equal_trees(a, b, "state")
    if backend == "sharded":
        tbl = got["states"][1].table
        v = tbl.vpts.reshape(4, 96)[:, 64:]
        assert (v == v[0]).all() and (v[0] != 0).any()


# ---------------------------------------------------------------------------
# The reference phases engine (core/phases.py, runtime.Runtime) on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_phases_apply_inv_duplicate_targets_write_identical_rows_on_card(
        monkeypatch):
    """``apply_inv``'s set-scatters could name one key from several lanes
    that carry the same winning timestamp (a coordinator's INV and a
    replay of it); ``index_put_`` on the card leaves their order open.
    At BASELINE config 3 (7 replicas, Zipfian 0.99, full width) with
    replica 1 frozen across rounds 8-40 (replays of stuck keys), every
    round's beating lanes are grouped by target: duplicates occur, carry
    equal (state, ver, fc, value) rows, and the lanes kept for the
    scatters (``beats``) name every target once, its last lane."""
    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import phases
    from hermes_tpu_torch.runtime import Runtime

    _card()
    cfg = chip_smoke.baseline_cfg(config, 3)
    K = cfg.n_keys
    seen = []
    real = phases.inv_winners

    def groups(w, beats):
        """(target, lane) of the given lanes, sorted by target then lane;
        targets of other lanes are -1 (first)."""
        n, m = w.key.shape
        base = torch.arange(n, device=w.key.device)[:, None] * (K + 1)
        j = torch.where(w.key < 0, w.key + K, w.key)
        tgt = torch.where(beats, base + j, -1).reshape(-1)
        order = torch.argsort(tgt, stable=True)
        return tgt[order], order

    def inv_winners(*args):
        w = real(*args)
        row = torch.cat([w.new_state[..., None], w.ver[..., None],
                         w.fc[..., None], w.val], dim=-1)
        row = row.reshape(-1, row.shape[-1])
        t, order = groups(w, w.beats_all)
        r = row[order]
        dup = (t[1:] == t[:-1]) & (t[1:] >= 0)
        differ = dup & (r[1:] != r[:-1]).any(dim=1)
        # each target's last lane (order holds flat lanes, ascending
        # within a target) against the lanes kept for the scatters
        end = torch.cat([t[1:] != t[:-1], t.new_ones(1, dtype=torch.bool)])
        end &= t >= 0
        kt, korder = groups(w, w.beats)
        keep = kt >= 0
        same = (torch.equal(t[end], kt[keep])
                and torch.equal(order[end], korder[keep]))
        seen.append(torch.stack([dup.sum(), differ.sum(),
                                 torch.tensor(int(not same),
                                              device=dup.device)]))
        return w

    monkeypatch.setattr(phases, "inv_winners", inv_winners)
    rt = Runtime(cfg, backend="batched", device="cuda")
    for s in range(48):
        if s == 8:
            rt.freeze(1)
        if s == 40:
            rt.thaw(1)
        rt.step_once()
    torch.cuda.synchronize()
    dup, differ, not_last = torch.stack(seen).sum(0).tolist()
    assert len(seen) == 48
    assert dup > 0, "no duplicated target: the check saw nothing"
    assert differ == 0 and not_last == 0, (dup, differ, not_last)


@pytest.mark.gpu
def test_phases_replay_selection_matches_nonzero_on_card():
    """The replay scan's sync-free selection (``phases._first_true``)
    against ``torch.nonzero`` on the card, on the stuck-key mask of a
    config-3 table with replica 1 frozen, and on masks with fewer, as
    many and more true rows than slots."""
    from hermes_tpu_torch import config
    from hermes_tpu_torch.core import phases
    from hermes_tpu_torch.core import types as t
    from hermes_tpu_torch.runtime import Runtime

    dev = _card()
    cfg = chip_smoke.baseline_cfg(config, 3)
    rt = Runtime(cfg, backend="batched", device="cuda")
    for s in range(30):
        if s == 4:
            rt.freeze(1)
        rt.step_once()
    tbl = rt.rs.table
    stuck = (((tbl.state == t.INVALID) | (tbl.state == t.TRANS))
             & (rt.step_idx - tbl.inv_step > 0))
    g = torch.Generator(device="cpu").manual_seed(5)
    masks = [stuck, torch.zeros_like(stuck), torch.ones_like(stuck),
             (torch.rand(stuck.shape, generator=g) < 1e-4).to(dev)]
    assert bool(stuck.any()), "no stuck key to select"
    for m in masks:
        for size, fill in ((cfg.replay_slots, cfg.n_keys), (3, -1)):
            got = phases._first_true(m, size, fill)
            for r in range(m.shape[0]):
                nz = torch.nonzero(m[r]).flatten()[:size].to(torch.int32)
                want = torch.full((size,), fill, dtype=torch.int32,
                                  device=dev)
                want[:nz.numel()] = nz
                assert torch.equal(got[r], want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_phases_round_is_sync_free_on_card(backend):
    """After the first round (the control rows' upload), an unrecorded
    ``Runtime.step_once`` makes no host sync at config 1's full width:
    ``torch.cuda.set_sync_debug_mode("error")`` raises on any."""
    from hermes_tpu_torch import config
    from hermes_tpu_torch.runtime import Runtime

    _card()
    rt = Runtime(chip_smoke.baseline_cfg(config, 1), backend=backend,
                 device="cuda")
    rt.run(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rt.run(6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rt.step_idx == 8


@pytest.mark.gpu
def test_phases_runtime_raises_without_a_visible_card():
    """On the card's machine with the card hidden
    (``CUDA_VISIBLE_DEVICES=""``): ``Runtime`` asked for the card, and the
    TCP driver without ``--device``, raise; nothing falls back to the
    CPU."""
    import os
    import pathlib
    import subprocess
    import sys

    _card()
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("from hermes_tpu_torch import HermesConfig\n"
            "from hermes_tpu_torch.runtime import Runtime\n"
            "Runtime(HermesConfig(n_keys=64, n_sessions=4))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "is_available" in r.stderr, r.stderr
    r = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.distributed",
                        "--rank", "0", "--n-ranks", "2", "--steps", "1"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "is_available" in r.stderr, r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_serve_soak_on_card_matches_cpu(depth):
    """``run_open_loop`` under an overload storm over a KVS on the card
    gives the CPU port's response log, counters and a green checker;
    the front end reads nothing back from the card outside the store's
    rounds (``chip_smoke.frontend_sync_free``)."""
    from hermes_tpu_torch import chaos, serving
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.workload import openloop

    dev = _card()
    cfg = HermesConfig(n_replicas=3, n_keys=64, n_sessions=4,
                       replay_slots=6, ops_per_session=96, value_words=6,
                       pipeline_depth=depth,
                       workload=WorkloadConfig(read_frac=0.5, seed=7))
    out = {}
    for d in ("cpu", dev):
        store = KVS(cfg, record="array", device=d)
        arrivals = openloop.ShapedArrivals(6000.0, 300, 17)
        runner = chaos.ChaosRunner(
            store, chaos.Schedule.overload_storm(5, 60), load=arrivals)
        scfg = serving.ServingConfig(tenant_quota=6, queue_cap=24,
                                     tenant_rate_per_s=1e6,
                                     tenant_burst=1e4)
        with chip_smoke.frontend_sync_free(torch, d != "cpu", store,
                                           runner):
            res = serving.run_open_loop(
                store, scfg, openloop.MixSpec(tenants=3), 6000.0, 300, 17,
                9000, chaos_runner=runner, arrivals=arrivals)
        assert store.rt.check().ok
        out[str(d)] = {k: v for k, v in res.items() if not k.startswith("_")}
    assert out[str(dev)] == out["cpu"]
    assert out["cpu"]["retry_after"] > 0


@pytest.mark.gpu
def test_columnar_tcp_server_round_trip_on_card():
    """A ``ColumnarTcpServer`` over a KVS on the card: puts then gets
    through framed columnar batches over localhost, every row answered,
    the values read back."""
    import numpy as np

    from hermes_tpu_torch.config import HermesConfig
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving import (ColumnarClient, ColumnarFrontend,
                                          ColumnarTcpServer, ServingConfig,
                                          wire)

    dev = _card()
    cfg = HermesConfig(n_replicas=4, n_keys=1 << 10, n_sessions=64,
                       value_words=6, pipeline_depth=2)
    fe = ColumnarFrontend(KVS(cfg, device=dev), ServingConfig(
        tenant_rate_per_s=1e9, tenant_burst=1e9, tenant_quota=1024,
        queue_cap=1024))
    srv = ColumnarTcpServer(fe)
    try:
        cl = ColumnarClient(srv.addr, fe.u)
        k = 256
        keys = np.arange(k, dtype=np.int64) * 3
        val = np.arange(k * fe.u, dtype=np.int32).reshape(k, fe.u)

        def batch(kind, value=None):
            return wire.ReqBatch(
                kind=np.full(k, kind, np.uint8), req_id=cl.next_ids(k),
                tenant=np.zeros(k, np.uint16), trace=np.zeros(k, np.uint16),
                deadline_us=np.zeros(k, np.uint32), key=keys,
                value=value if value is not None
                else np.zeros((k, fe.u), np.int32))

        puts = cl.call_batch(batch(wire.K_PUT, val))
        assert all(r.status_name == "ok" for r in puts.values())
        gb = batch(wire.K_GET)
        gets = cl.call_batch(gb)
        for i, rid in enumerate(gb.req_id.tolist()):
            assert gets[rid].status_name == "ok"
            assert gets[rid].value == val[i].tolist()
        cl.close()
    finally:
        srv.close()
    assert srv.pump_error is None
    assert fe.requests == fe.responses == 2 * k


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["batched", "sharded"])
@pytest.mark.parametrize("mega", [False, True])
def test_round_census_on_card_equals_cpu(backend, mega):
    """The op census of one round at a small shape on the card equals
    the CPU's (a hand-kernel call is one op on both devices), with a
    kernel_total from a CUDA graph of the round; the launch counters are
    put back."""
    from hermes_tpu_torch.config import bench_cfg
    from hermes_tpu_torch.core import megaround as mega_mod
    from hermes_tpu_torch.obs import profile as prof

    _card()
    cfg = bench_cfg("a", over=dict(n_keys=1 << 12, n_sessions=256,
                                   replay_slots=16, mega_round=mega))
    before = (kernels.stats_block.launches, mega_mod.mega_route.launches)
    got = prof.op_census(cfg, backend, device="cuda")
    want = prof.op_census(cfg, backend, device="cpu")
    assert (kernels.stats_block.launches,
            mega_mod.mega_route.launches) == before
    assert got.pop("kernel_total") > got["hand_kernel_calls"]
    assert got == want


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 5])
def test_acceptance_small_on_card_equals_cpu(n):
    from hermes_tpu_torch import acceptance

    _card()
    c, v = acceptance.run_config(n, scale=0.01, device="cuda")
    want, wv = acceptance.run_config(n, scale=0.01, device="cpu")
    assert c == want and v.ok and wv.ok


@pytest.mark.gpu
def test_graft_entry_on_card_equals_cpu(monkeypatch):
    from hermes_tpu_torch import convert, graft

    _card()
    monkeypatch.setenv("HERMES_ENTRY_PROBE", "0")
    fn, ex = graft.entry("cuda")
    fs, _ = fn(*ex)
    fn_c, ex_c = graft.entry("cpu")
    fs_c, _ = fn_c(*ex_c)
    a, b = convert.fast_state_to_numpy(fs), convert.fast_state_to_numpy(fs_c)
    for part in ("table", "sess", "replay", "meta"):
        for f in getattr(a, part)._fields:
            assert (getattr(getattr(a, part), f)
                    == getattr(getattr(b, part), f)).all(), f"{part}.{f}"


def _graph_namespace(**over):
    """What ``chip_smoke.graph_pair`` / ``kvs_graph_pair`` take, at a small
    shape on the card."""
    from types import SimpleNamespace

    import numpy as np

    from hermes_tpu_torch import profiling
    from hermes_tpu_torch.config import HermesConfig, WorkloadConfig
    from hermes_tpu_torch.core import faststep as fst
    from hermes_tpu_torch.core import graphs
    from hermes_tpu_torch.core.group import LocalGroup
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.runtime import FastRuntime

    def cfg(mega_round=False, **more):
        return HermesConfig(**dict(dict(
            n_replicas=4, n_keys=4096, n_sessions=256, replay_slots=8,
            ops_per_session=32, arb_mode="sort", chain_writes=4,
            wrap_stream=True, device_stream=True, read_unroll=2,
            replay_age=2, replay_scan_every=32, mega_round=mega_round,
            workload=WorkloadConfig(read_frac=0.4, rmw_frac=0.2, seed=5)),
            **over, **more))

    return SimpleNamespace(
        cfg=cfg, FastRuntime=FastRuntime, LocalGroup=LocalGroup, KVS=KVS,
        kvs_cfg=lambda **o: cfg(device_stream=False, read_unroll=1,
                                value_words=6, **o),
        graphs=graphs, profiling=profiling, np=np, fst=fst)


def _round_counters():
    from hermes_tpu_torch.core import megaround

    return {"stats_block": kernels.stats_block,
            "mega_route": megaround.mega_route,
            "mega_apply": megaround.mega_apply,
            "mega_replay": megaround.mega_replay}


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["fused", "mega", "sharded",
                                    "sharded-mega"])
def test_graphed_round_equals_the_eager_round(engine):
    """The compiled round (a CUDA graph a variant, replayed) against the
    round function called each round, from one seed over 64 rounds with
    a freeze, a thaw, a set_live, a quiesce window and the graphs dropped
    mid-run: completions every round and the state trees bit-identical,
    the graphed launches by kernel those of an eager round each
    (``chip_smoke.graph_pair``).  The mega scan variant's one graph holds
    both cooperative kernels, ``mega_apply`` and ``mega_replay``."""
    _card()
    gr = _graph_namespace()
    cfg = gr.cfg(mega_round=engine.endswith("mega"))
    if engine.startswith("sharded"):
        make = lambda: gr.FastRuntime(cfg, backend="sharded",
                                      group=gr.LocalGroup("cuda"))
        copies = cfg.n_replicas
    else:
        make = lambda: gr.FastRuntime(cfg, device="cuda")
        copies = 1
    _graphed, _eager, got, variants = chip_smoke.graph_pair(
        torch, gr, _round_counters(), make, copies)
    assert got["stats_block"] == chip_smoke.GRAPH_ROUNDS
    if engine.endswith("mega"):
        scan = [v for k, v in variants.items() if k[0]]
        assert scan and scan[0]["mega_apply"] >= 1
        assert scan[0]["mega_replay"] == copies


@pytest.mark.gpu
def test_graphed_kvs_equals_the_eager_kvs_at_depth_2():
    """Two KVSs at depth 2, graphed and eager, under one op mix with a
    freeze, a thaw and a set_live: every batch column and the states
    equal (``chip_smoke.kvs_graph_pair``)."""
    _card()
    got = chip_smoke.kvs_graph_pair(torch, _graph_namespace(),
                                    _round_counters())
    assert got["ops_done"] > 0 and got["captures"] >= 2


@pytest.mark.gpu
def test_a_failed_capture_raises_naming_the_op():
    """A round that syncs the host cannot be captured: at its second call
    (the first runs eagerly) the compiled round raises, naming the op,
    and runs nothing eagerly instead."""
    from hermes_tpu_torch.core import graphs

    _card()

    def syncing(fs, stream, ctl):
        int(fs.meta.n_read.sum())  # a host sync inside the round
        return fs

    gr = _graph_namespace()
    rt = gr.FastRuntime(gr.cfg(), device="cuda")
    comp = graphs.Compiled(syncing, 32, comps=False)
    comp(rt.fs, rt.stream, rt._ctl())  # the first call runs eagerly
    with pytest.raises(RuntimeError, match="capture of variant .* failed; "
                       "the last op dispatched was aten._local_scalar_dense"):
        comp(rt.fs, rt.stream, rt._ctl())
    assert comp.captures == 0 and comp.warmups == 1


@pytest.mark.gpu
def test_graph_ops_counts_one_kernel_a_hand_kernel_call():
    """``profiling.graph_ops`` counts the device operations of a call off
    a CUDA graph it captures: one kernel node a ``stats_block`` call."""
    from hermes_tpu_torch import profiling

    dev = _card()
    args = chip_smoke._to(torch, chip_smoke.stats_inputs(torch, 8, 65536, 1),
                          dev)
    assert profiling.graph_ops(lambda: kernels.stats_block(*args)) == {
        "kernel": 1, "total": 1}
