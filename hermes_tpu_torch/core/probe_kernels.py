"""The table-step probe's two kernels: ``probe_serial`` and
``probe_vgather``.

Port of the two Pallas kernels of ``scripts/pallas_probe.py``, the probe
behind the reference's decision to keep the key-state table step in
library scatter/gather (``table_probe.py`` drives them):

* ``probe_serial`` — ``_serial_kernel``: ``table[keys[i]] = rows[i]`` in
  message order, in place, the last writer on a key winning;
* ``probe_vgather`` — ``_vgather_kernel``: ``out = table[keys]``.

Each replaces a Pallas kernel with a CUDA kernel written for Hopper
(``csrc/probe_serial.cu``, ``csrc/probe_vgather.cu``, built by
``build.py`` and loaded with ctypes); the source notes there and the
docstrings below say what bounds each one on the card and what its design
does about it.  Both are the reference's bit for bit, keys outside
[0, K) included (``row_index``).

Dispatch, as for ``core/megaround.py``: a CPU tensor goes to the plain
version (``probe_*_plain``), a CUDA tensor launches the kernel or raises.
``.launches`` on each wrapper counts the calls that launched its kernel,
one per call; each call is one device operation (``probe_serial``'s first
call on a (device, stream, K) also fills its winner column).
"""

from __future__ import annotations

import torch

from hermes_tpu_torch.core.dispatch import (hand_kernel, launch, need,
                                            on_card, out)

I32 = torch.int32


def row_index(keys, K: int):
    """The table row a key lands on, as the reference's interpret mode
    places it (both kernels alike): a negative key counts from the end
    (``k + K``), then the index is clamped to [0, K-1]."""
    return torch.where(keys < 0, keys + K, keys).clamp(0, K - 1)


def _check(name, table, keys):
    need(name, "table", table, I32)
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"{name}: table must be a (K, W) table with K >= 1, "
                         f"got {tuple(table.shape)}")
    need(name, "keys", keys, I32)
    if keys.dim() != 1:
        raise ValueError(f"{name}: keys must be (M,), got {tuple(keys.shape)}")
    return table.shape[0], keys.shape[0], table.shape[1]


# --------------------------------------------------------------------------
# probe_serial: the ordered scatter of message rows into the table
# --------------------------------------------------------------------------


def probe_serial_plain(table, keys, rows):
    """``table[row_index(keys[i])] = rows[i]`` for i in message order, in
    place: the winner on each row is resolved explicitly (the last message
    on it) and only winners are stored, so no two stores share a row —
    ``index_put_`` leaves the order of duplicates unspecified."""
    K = table.shape[0]
    k = row_index(keys, K).long()
    order = torch.arange(keys.shape[0], device=keys.device)
    last = torch.full((K,), -1, dtype=torch.long, device=keys.device)
    last.scatter_reduce_(0, k, order, "amax")
    won = last[k] == order
    table[k[won]] = rows[won]
    return table


#: probe_serial's winner columns, one a (device, stream, K): int32 (K,),
#: all -1 between calls (each call resets what it raised)
win_columns: dict = {}


def win_column(device, stream: int, K: int):
    """The winner column of ``probe_serial`` calls on ``stream`` (its
    ``cuda_stream`` handle) of ``device`` over a K-row table: made once,
    filled with -1 on that stream, and kept.  Raises where it would be made
    inside a CUDA graph capture: the fill would only be recorded, and an
    eager call before the graph's first replay would read a column that
    was never filled."""
    key = (device, stream, K)
    col = win_columns.get(key)
    if col is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"probe_serial: no winner column yet for K={K} on the "
                "capturing stream; call probe_serial once on that stream "
                "before the capture")
        col = win_columns[key] = torch.full((K,), -1, dtype=I32,
                                            device=device)
    return col


@hand_kernel
def probe_serial(table, keys, rows):
    """The serial probe step: writes ``rows`` (M, W) int32 into ``table``
    (K, W) int32 at ``keys`` (M,) int32, in place, as the ordered loop
    ``for i in range(M): table[row_index(keys[i])] = rows[i]`` does.
    Returns ``table``.

    Replaces ``scripts/pallas_probe.py:candidate_step.serial_fn`` (Pallas
    ``_serial_kernel``).  Bound by memory: a key read per message, and
    per distinct key the winning row read and written, ~4 MB at the bench
    table shape.  The Pallas loop's order becomes data on the card, an
    int32 (K,) winner column kept all -1 between calls (``win_column``):
    one cooperative launch whose phase 0 takes an integer ``atomicMax`` of
    the message index per row (order-free, so exact) and whose phase 1,
    after a grid barrier, has each message read its row's winner once;
    the winner stores its row and resets the entry to -1.  So a call is
    one device operation, with no memset of the column."""
    name = "probe_serial"
    K, M, W = _check(name, table, keys)
    need(name, "rows", rows, I32, (M, W))
    if not on_card(name, table, keys, rows):
        return probe_serial_plain(table, keys, rows)
    if M and W:
        dev = table.device
        win = win_column(dev, torch.cuda.current_stream(dev).cuda_stream, K)
        launch(name, dev, table, keys, rows, win, K, M, W)
        probe_serial.launches += 1
    return table


probe_serial.launches = 0


# --------------------------------------------------------------------------
# probe_vgather: the row gather
# --------------------------------------------------------------------------


def probe_vgather_plain(keys, table):
    """``table[row_index(keys)]``: the (M, W) rows of the keys."""
    return table[row_index(keys, table.shape[0]).long()]


#: the widest row probe_vgather.cu takes (kMaxW: the most its reciprocal
#: division is exact for)
VGATHER_W_MAX = 8192


def vgather_access(table, rows):
    """``(vec_ld, vec_st)`` for ``probe_vgather.cu``, from the pointers and
    the row width alone: ``vec_ld`` 1 where the table's rows move as 8-byte
    pieces (the table 8-byte aligned, W even), else 0 (4-byte words);
    ``vec_st`` 1 where the output tiles are stored in 16 bytes (``rows``
    16-byte aligned), else 0 (words)."""
    vec_ld = table.data_ptr() % 8 == 0 and table.shape[1] % 2 == 0
    return int(vec_ld), int(rows.data_ptr() % 16 == 0)


@hand_kernel
def probe_vgather(keys, table):
    """The gather probe step: ``out[m] = table[row_index(keys[m])]`` from
    ``keys`` (M,) int32 and ``table`` (K, W) int32; returns ``out`` (M, W)
    int32.

    Replaces ``scripts/pallas_probe.py:candidate_step.vgather_fn`` (Pallas
    ``_vgather_kernel``, which Mosaic would not lower on the TPU).  Bound
    by memory: a key read and a row written per message, a row read per
    distinct key, ~4 MB at the bench table shape (a 40-byte row spans two
    32-byte sectors: ~5.3 MB of sectors).  One plain launch of a
    persistent grid (at most the CTAs that co-reside, no more than the
    tiles need), a warp a tile of 32 messages: the
    keys in one coalesced load, the rows fetched as 8-byte pieces whose
    row numbers reach the lanes by shuffle, all loads in flight before the
    first store, then the tile staged in shared memory and stored in
    16-byte vectors; ``vgather_access`` picks the vector or the word path
    from the pointers."""
    name = "probe_vgather"
    K, M, W = _check(name, table, keys)
    if W > VGATHER_W_MAX:
        raise ValueError(f"{name}: rows of at most {VGATHER_W_MAX} words, "
                         f"got {W}")
    if not on_card(name, keys, table):
        return probe_vgather_plain(keys, table)
    rows = out((M, W), I32, table.device)
    if M and W:
        launch(name, table.device, keys, table, rows, K, M, W,
               *vgather_access(table, rows))
        probe_vgather.launches += 1
    return rows


probe_vgather.launches = 0
