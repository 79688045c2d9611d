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
