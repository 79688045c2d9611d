"""The port's table-step probe (hermes_tpu_torch/table_probe.py and its two
kernels, core/probe_kernels.py) against the reference's
(scripts/pallas_probe.py, loaded with importlib; its Pallas kernels run in
interpret mode on the CPU, as the script runs them there).

* ``probe_serial`` and ``probe_vgather`` (plain versions, through the
  wrappers on CPU tensors) against ``serial_fn`` and ``_vgather_kernel``:
  duplicate-heavy keys and keys outside [0, K).
* Each candidate, three chained steps, on the reference's own arguments
  (jax.random draws, handed over as numpy): ``torch`` against ``xla``,
  ``serial``, ``onehot`` and ``vgather`` against their namesakes.
* The probe's command line on the CPU, and its refusal without a card.

Tolerance: exact equality (every output is an integer), except the bank of
``torch``/``xla`` at a key hit by several messages, where neither library
scatter fixes which message's row lands: there the row must be one of
that key's messages' (``table_probe.check_state``).  The CUDA kernels are
held against the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hermes_tpu_torch import table_probe as tp
from hermes_tpu_torch.core import probe_kernels as pk

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
W = tp.W


@pytest.fixture(scope="module")
def ref():
    """scripts/pallas_probe.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "pallas_probe_reference", ROOT / "scripts" / "pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return np.asarray(jax.device_get(x))


def _keys(rng, K, M, out_of_range):
    keys = rng.integers(0, K, M, dtype=np.int32)
    if out_of_range:
        bad = np.array([-1, K, K + 5, -K - 3, -(1 << 31), (1 << 31) - 1,
                        -K, 1 - K], np.int32)
        keys[rng.choice(M, len(bad), replace=False)] = bad
    return keys


@pytest.mark.parametrize("K,M,out_of_range", [
    (64, 256, False), (8, 256, False), (4096, 4096, False), (64, 256, True),
    (5, 40, True)])
def test_torch_probe_serial_matches_reference(ref, K, M, out_of_range):
    """The ordered scatter, last writer winning, onto a table whose
    untouched rows must keep their values; (8, 256) is almost all
    duplicates."""
    rng = np.random.default_rng(K * 1000 + M + out_of_range)
    table = rng.integers(-(1 << 31), 1 << 31, (K, W), dtype=np.int32)
    keys = _keys(rng, K, M, out_of_range)
    rows = rng.integers(-(1 << 31), 1 << 31, (M, W), dtype=np.int32)
    serial_fn, _args, _ = ref.candidate_step("serial", K, M)
    want = _np(serial_fn(jnp.asarray(table), jnp.asarray(keys),
                         jnp.asarray(rows)))
    if not out_of_range:
        assert len(np.unique(keys)) < M  # duplicates are the case here
    t = torch.from_numpy(table.copy())
    before = pk.probe_serial.launches
    got = pk.probe_serial(t, torch.from_numpy(keys), torch.from_numpy(rows))
    assert got is t and pk.probe_serial.launches == before  # in place, plain
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("K,M,out_of_range", [
    (64, 256, False), (4096, 4096, False), (64, 256, True), (5, 40, True)])
def test_torch_probe_vgather_matches_reference(ref, K, M, out_of_range):
    rng = np.random.default_rng(K * 1000 + M + out_of_range)
    table = rng.integers(-(1 << 31), 1 << 31, (K, W), dtype=np.int32)
    keys = _keys(rng, K, M, out_of_range)
    want = _np(pl.pallas_call(
        ref._vgather_kernel,
        out_shape=jax.ShapeDtypeStruct((M, W), jnp.int32),
        interpret=True)(jnp.asarray(keys), jnp.asarray(table)))
    before = pk.probe_vgather.launches
    got = pk.probe_vgather(torch.from_numpy(keys), torch.from_numpy(table))
    assert pk.probe_vgather.launches == before
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("K,M,width", [
    (64, 256, 1), (5, 40, 1), (64, 256, 3), (5, 40, 3), (64, 256, 17),
    (1000, 777, 17)])
def test_torch_probe_vgather_plain_matches_reference_at_widths(ref, K, M,
                                                               width):
    """The plain gather against ``_vgather_kernel`` (interpret mode) at
    row widths beside the probe's W = 10, keys outside [0, K) among
    them."""
    rng = np.random.default_rng(K * 1000 + M + width)
    table = rng.integers(-(1 << 31), 1 << 31, (K, width), dtype=np.int64
                         ).astype(np.int32)
    keys = _keys(rng, K, M, True)
    want = _np(pl.pallas_call(
        ref._vgather_kernel,
        out_shape=jax.ShapeDtypeStruct((M, width), jnp.int32),
        interpret=True)(jnp.asarray(keys), jnp.asarray(table)))
    got = pk.probe_vgather_plain(torch.from_numpy(keys),
                                 torch.from_numpy(table))
    np.testing.assert_array_equal(want, got.numpy())


def _cu_const(name):
    """A ``constexpr int`` of ``csrc/probe_vgather.cu``: the replay takes
    the kernel's own geometry."""
    text = (ROOT / "hermes_tpu_torch" / "csrc" / "probe_vgather.cu"
            ).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _recip(d):
    """``probe_vgather.cu``'s reciprocal of a divisor d (the entry's
    arithmetic): ceil(2^32 / d), 0 for d = 1."""
    return 0 if d == 1 else ((1 << 32) + d - 1) // d


def _row_in_tile(p, d):
    """The kernel's ``row_in_tile``: p / d as a multiply-high by the
    reciprocal (p itself for d = 1)."""
    p = np.asarray(p, np.uint64)
    return p if d == 1 else (p * np.uint64(_recip(d))) >> np.uint64(32)


def test_torch_probe_vgather_reciprocal_division_is_exact():
    """umulhi(p, ceil(2^32 / d)) == p // d wherever the kernel uses it:
    p below 32 d + 512 (a tile's pieces or words, and the unused slots of
    its last pass), for every d up to VGATHER_W_MAX: the bound p * (m d -
    2^32) < 2^32 holds for each, and a brute force over every such p
    agrees at the smallest and the largest divisors."""
    stage = _cu_const("kStage")
    assert _cu_const("kMaxW") == pk.VGATHER_W_MAX
    for d in range(1, pk.VGATHER_W_MAX + 1):
        reach = 32 * d + stage
        assert d == 1 or reach * (_recip(d) * d - (1 << 32)) < 1 << 32
    for d in (*range(1, 65), 4095, 4096, 8191, pk.VGATHER_W_MAX):
        p = np.arange(32 * d + stage, dtype=np.uint64)
        np.testing.assert_array_equal(_row_in_tile(p, d), p // np.uint64(d))


def _vgather_replay(keys, table, rows, cap):
    """``csrc/probe_vgather.cu`` replayed in numpy on ``keys`` (M,) and
    ``table`` (K, W) tensors, ``rows`` the output tensor whose pointer the
    launch would get, with ``cap`` co-resident CTAs: the grid the entry
    makes (a tile of kTile messages a warp, as many CTAs of kThreads / 32
    warps as the tiles need, at most ``cap``), the path
    (``vgather_access``) the wrapper picks, every warp's tiles by grid
    stride, each lane's key, the
    pieces or words it loads (row numbers taken from the lane that holds
    them, as ``__shfl_sync`` does), the stage and the stores.  Asserts that
    every tile is taken by one warp, every load stays in the table, every
    store in the output, every vector access is aligned, and every output
    word is written once from a staged word (rows within a tile by the
    kernel's reciprocal division); returns the output and the path."""
    K, W = table.shape
    M = keys.shape[0]
    vec_ld, vec_st = pk.vgather_access(table, rows)
    if vec_ld:
        assert table.data_ptr() % 8 == 0 and W % 2 == 0
    if vec_st:
        assert rows.data_ptr() % 16 == 0
    T, S = _cu_const("kTile"), _cu_const("kStage")
    tiles = -(-M // T)
    ctas = min(cap, -(-tiles // (_cu_const("kThreads") // 32)))
    warps = ctas * (_cu_const("kThreads") // 32)
    k_np, flat = keys.numpy(), table.numpy().reshape(-1)
    lane = np.arange(32)
    out = np.zeros(M * W, np.int64)
    writes = np.zeros(M * W, np.int64)
    taken = np.zeros(tiles, np.int64)
    for w in range(warps):
        for tile in range(w, tiles, warps):
            taken[tile] += 1
            m0 = tile * T
            n = min(T, M - m0)
            key = np.where(lane < n, k_np[np.minimum(m0 + lane, M - 1)], 0)
            row = pk.row_index(torch.from_numpy(key), K).numpy()
            words = n * W
            for base in range(0, words, S):
                cnt = min(S, words - base)
                stage = np.zeros(S, np.int64)
                filled = np.zeros(S, bool)
                if vec_ld:
                    H = W // 2
                    slot = (lane[None, :] + 32 * np.arange(S // 64)[:, None]
                            ).ravel()
                    p = base // 2 + slot
                    r = _row_in_tile(p, H).astype(np.int64)
                    src = row[r & 31]
                    ok = 2 * slot < cnt
                    piece = (src * H + p - r * H)[ok]
                    assert (0 <= piece).all() and (piece < K * H).all()
                    for half in (0, 1):
                        stage[2 * slot[ok] + half] = flat[2 * piece + half]
                        filled[2 * slot[ok] + half] = True
                else:
                    slot = (lane[None, :] + 32 * np.arange(S // 32)[:, None]
                            ).ravel()
                    p = base + slot
                    r = _row_in_tile(p, W).astype(np.int64)
                    src = row[r & 31]
                    ok = slot < cnt
                    word = (src * W + p - r * W)[ok]
                    assert (0 <= word).all() and (word < K * W).all()
                    stage[slot[ok]] = flat[word]
                    filled[slot[ok]] = True
                assert filled[:cnt].all()
                o = m0 * W + base
                assert o % 4 == 0
                nv = cnt >> 2 if vec_st else 0
                vec = (o >> 2) + np.arange(nv)
                assert (vec < (M * W) >> 2).all()
                at = np.concatenate([(4 * vec[:, None] + np.arange(4)).ravel(),
                                     o + np.arange(4 * nv, cnt)])
                assert (at < M * W).all()
                out[at] = stage[:cnt]
                writes[at] += 1
    assert (taken == 1).all()  # every message is in exactly one tile
    assert (writes == 1).all()  # every output word written once
    return out.reshape(M, W).astype(np.int32), (vec_ld, vec_st)


@pytest.mark.parametrize("width", [1, 3, 10, 17])
@pytest.mark.parametrize("M", [1, 31, 32, 33, 4096, 49152])
def test_torch_probe_vgather_plan_replays_in_numpy(M, width):
    """The kernel's tiles, grid and paths replayed in numpy equal the plain
    gather: at a grid of as many CTAs as the tiles need (a warp a tile)
    and at a grid of 3 CTAs (warps striding over many tiles), from an
    aligned table (8-byte pieces where W is even) and from a view 4 bytes
    off its allocation (the word path), with keys outside [0, K)."""
    K = 1000
    rng = np.random.default_rng(M * 31 + width)
    keys = torch.from_numpy(_keys(rng, K, M, M >= 8))
    buf = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, K * width + 1,
                                        dtype=np.int64).astype(np.int32))
    rows = torch.empty((M, width), dtype=torch.int32)
    for table, cap in ((buf[:-1].view(K, width), 10 ** 6),
                       (buf[1:].view(K, width), 3)):
        want = pk.probe_vgather_plain(keys, table).numpy()
        got, path = _vgather_replay(keys, table, rows, cap)
        np.testing.assert_array_equal(got, want)
        off = table.data_ptr() - buf.data_ptr()
        assert path == (int(off == 0 and width % 2 == 0), 1)
    rows = torch.empty(M * width + 1, dtype=torch.int32)[1:].view(M, width)
    got, path = _vgather_replay(keys, table, rows, 3)  # output 4 bytes off
    assert path[1] == 0
    np.testing.assert_array_equal(got, want)


def _port_args(cand, args):
    """The reference candidate's arguments, as numpy, in the port's
    layout: the state first; ``torch`` takes int64 keys."""
    a = [torch.from_numpy(np.array(_np(x))) for x in args]
    if cand == "torch":
        return ((a[0], a[1]), a[2].long(), a[3], a[4])
    return tuple(a)


def _ref_chain(cand, fn, args, reps=3):
    if cand == "torch":
        state = args[:2]
        for _ in range(reps):
            state = fn(*state, *args[2:])
        return tuple(torch.from_numpy(np.array(_np(x))) for x in state)
    state = args[0]
    for _ in range(reps):
        state = fn(state, *args[1:])
    return torch.from_numpy(np.array(_np(state)))


@pytest.mark.parametrize("cand,K,M", [
    ("torch", 4096, 4096), ("torch", 1 << 20, 49152), ("serial", 4096, 4096),
    ("onehot", 1024, 4096), ("onehot", 4096, 4096), ("vgather", 4096, 4096)])
def test_torch_probe_candidate_matches_reference(ref, cand, K, M):
    """Three chained steps of the port's candidate on the reference
    candidate's own arguments equal the reference's three steps; the
    port's own draw has the reference's shapes and types."""
    fn_ref, args_ref, _ = ref.candidate_step("xla" if cand == "torch"
                                             else cand, K, M)
    want = _ref_chain(cand, fn_ref, args_ref)
    fn, own = tp.candidate_step(cand, K, M, "cpu")
    args = _port_args(cand, args_ref)
    got = tp.run_chain(fn, args)
    tp.check_state(cand, got, want, args)
    flat = lambda xs: [y for x in xs
                       for y in (x if isinstance(x, tuple) else (x,))]
    assert ([(tuple(x.shape), x.dtype) for x in flat(own)]
            == [(tuple(x.shape), x.dtype) for x in flat(args)])
    if cand == "torch":  # a key hit by several messages is the common case
        assert len(torch.unique(args[1])) < M


def test_torch_probe_rows8_byte_order():
    """``rows.view(torch.int8)`` lays the int32 words out as JAX's
    ``bitcast_convert_type`` does (little-endian hosts; the card is one)."""
    rng = np.random.default_rng(5)
    rows = rng.integers(-(1 << 31), 1 << 31, (7, W), dtype=np.int32)
    want = _np(jax.lax.bitcast_convert_type(jnp.asarray(rows), jnp.int8)
               .reshape(7, 4 * W))
    assert sys.byteorder == "little"
    np.testing.assert_array_equal(
        want, torch.from_numpy(rows).view(torch.int8).numpy())


@pytest.mark.parametrize("tf32", [True, False])
def test_torch_probe_onehot_leaves_tf32_setting(tf32):
    """Building and stepping ``onehot`` leaves the process's TF32 setting
    as it found it (the product turns TF32 off for itself only)."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        fn, args = tp.candidate_step("onehot", 64, 32, "cpu")
        tp.run_chain(fn, args, reps=1)
        assert matmul.allow_tf32 is tf32
    finally:
        matmul.allow_tf32 = old


def test_torch_probe_check_state_duplicate_rule():
    """The ``torch`` comparison accepts, at a duplicated key, any byte of
    any of its messages' rows, and counts a row mixed from two messages;
    a byte of no message, or any change at a key hit once, fails."""
    fn, args = tp.candidate_step("torch", 64, 64, "cpu")
    want = tp.run_chain(fn, args, reps=1)
    keys, rows8 = args[1], args[3]
    hits = torch.bincount(keys, minlength=64)
    dup, single = int(hits.argmax()), int((hits == 1).nonzero()[0, 0])
    assert hits[dup] > 1
    mine = rows8[keys == dup]
    assert not torch.equal(mine[0], mine[1])

    def bank_with(key, row):
        bank = want[1].clone()
        bank[key] = row
        return want[0], bank

    for row in mine:  # any message of the key: no mixed row
        assert tp.check_state("torch", bank_with(dup, row), want, args) == 0
    mixed = torch.cat([mine[0][:4], mine[1][4:]])
    assert tp.check_state("torch", bank_with(dup, mixed), want, args) == 1
    for key in (dup, single):
        with pytest.raises(AssertionError):
            tp.check_state("torch", bank_with(key, rows8[keys == key][0] ^ 1),
                           want, args)


@pytest.mark.parametrize("wrapper,call", [
    (pk.probe_serial, lambda t, k, r: pk.probe_serial(t, k, r)),
    (pk.probe_vgather, lambda t, k, r: pk.probe_vgather(k, t))])
def test_torch_probe_kernels_dispatch(wrapper, call):
    """A CPU tensor takes the plain version (no launch counted); a wrong
    type or shape raises."""
    t = torch.zeros((16, W), dtype=torch.int32)
    k = torch.arange(5, dtype=torch.int32)
    r = torch.ones((5, W), dtype=torch.int32)
    before = wrapper.launches
    call(t, k, r)
    assert wrapper.launches == before
    with pytest.raises(TypeError):
        call(t, k.long(), r)
    with pytest.raises(TypeError):
        call(t.float(), k, r)
    with pytest.raises(ValueError):
        call(t, k[None], r)
    with pytest.raises(ValueError):
        call(t[:0], k, r)
    if wrapper is pk.probe_serial:
        with pytest.raises(ValueError):
            call(t, k, r[:, :3])


def test_torch_probe_vgather_refuses_rows_wider_than_its_kernel():
    """Rows wider than ``VGATHER_W_MAX`` words raise on either device: the
    wrapper takes what the kernel takes."""
    keys = torch.zeros((3,), dtype=torch.int32)
    wide = torch.zeros((2, pk.VGATHER_W_MAX + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        pk.probe_vgather(keys, wide)
    got = pk.probe_vgather(keys, wide[:, :pk.VGATHER_W_MAX])
    assert got.shape == (3, pk.VGATHER_W_MAX)


def test_torch_table_probe_cli_cpu(tmp_path):
    """``python -m hermes_tpu_torch.table_probe --device cpu`` runs every
    cell and prints one JSON object (no device time on the CPU)."""
    out = tmp_path / "probe.json"
    r = subprocess.run(
        [sys.executable, "-m", "hermes_tpu_torch.table_probe", "--device",
         "cpu", "--json", str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc == json.loads(out.read_text())
    assert doc["platform"] == "cpu"
    assert [(c["cand"], c["K"], c["M"]) for c in doc["cells"]] == list(
        tp.CELLS)
    for c in doc["cells"]:
        assert c["device_s_per_call"] is None and c["calls"] == 4


def test_torch_table_probe_cli_needs_card():
    """Without ``--device`` the probe asks for the card and, on a machine
    without one, exits non-zero naming it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would run on it")
    r = subprocess.run([sys.executable, "-m", "hermes_tpu_torch.table_probe"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert r.stdout == ""


def _serial_protocol(K, keys, table, rows, seed):
    """probe_serial.cu's winner column replayed in numpy: phase 0 takes
    the maximum message index per row in one shuffled order; phase 1, in
    another, lets each message read its row's entry once, and the winner
    store its row and then reset the entry to -1.  Returns the table and
    the column."""
    rng = np.random.default_rng(seed)
    k = pk.row_index(torch.from_numpy(keys), K).numpy()
    win = np.full(K, -1, np.int64)
    for i in rng.permutation(len(keys)):
        win[k[i]] = max(win[k[i]], i)
    for i in rng.permutation(len(keys)):
        if win[k[i]] == i:  # a loser sees the winner's index or -1
            table[k[i]] = rows[i]
            win[k[i]] = -1
    return table, win


@pytest.mark.parametrize("K,M,out_of_range,seed", [
    (64, 256, False, 0), (8, 256, False, 1), (4096, 4096, False, 2),
    (1000, 777, True, 3), (5, 40, True, 4)])
def test_torch_probe_serial_max_then_reset_protocol_in_numpy(K, M,
                                                             out_of_range,
                                                             seed):
    """The kernel's max-then-reset protocol, its messages in shuffled
    order, gives the ordered loop's table, the plain version's, and
    leaves the column all -1 for the next call."""
    rng = np.random.default_rng(seed)
    keys = _keys(rng, K, M, out_of_range)
    table = rng.integers(-(1 << 31), 1 << 31, (K, W), dtype=np.int64).astype(
        np.int32)
    rows = rng.integers(-(1 << 31), 1 << 31, (M, W), dtype=np.int64).astype(
        np.int32)
    want = table.copy()
    k = pk.row_index(torch.from_numpy(keys), K).numpy()
    for i in range(M):
        want[k[i]] = rows[i]
    got, win = _serial_protocol(K, keys, table.copy(), rows, seed)
    np.testing.assert_array_equal(got, want)
    assert (win == -1).all()
    plain = pk.probe_serial_plain(torch.from_numpy(table.copy()),
                                  torch.from_numpy(keys),
                                  torch.from_numpy(rows))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_torch_probe_serial_win_column_cache(monkeypatch):
    """One winner column per (device, stream, K), made once, all -1; the
    plain path (CPU tensors) makes none."""
    monkeypatch.setattr(pk, "win_columns", {})
    cpu = torch.device("cpu")
    col = pk.win_column(cpu, 7, 16)
    assert col.dtype == torch.int32 and col.shape == (16,)
    assert (col == -1).all()
    assert pk.win_column(cpu, 7, 16) is col
    assert pk.win_column(cpu, 8, 16) is not col
    assert pk.win_column(cpu, 7, 17) is not col
    assert sorted(pk.win_columns) == [(cpu, 7, 16), (cpu, 7, 17), (cpu, 8, 16)]
    monkeypatch.setattr(pk, "win_columns", {})
    t = torch.zeros((16, W), dtype=torch.int32)
    pk.probe_serial(t, torch.arange(5, dtype=torch.int32),
                    torch.ones((5, W), dtype=torch.int32))
    assert pk.win_columns == {}


def test_torch_probe_serial_win_column_not_made_in_a_capture(monkeypatch):
    """Inside a CUDA graph capture a missing winner column raises (its -1
    fill would only be recorded) and none is kept; a column made before
    the capture is returned as it is."""
    monkeypatch.setattr(pk, "win_columns", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    card = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="before the capture"):
        pk.win_column(card, 7, 16)
    assert pk.win_columns == {}
    made = object()
    pk.win_columns[(card, 7, 16)] = made
    assert pk.win_column(card, 7, 16) is made
