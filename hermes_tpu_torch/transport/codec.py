"""Host codecs: the port's copy of the block layer (``block_nbytes``,
``frame_nbytes``, ``pack``, ``unpack``, ``stack``), the checksummed frame
layer (``frame_pack``, ``frame_unpack``, ``wire_crc``), the byte/word
codecs (``rows_to_words`` / ``words_to_rows``, ``bytes_to_words`` /
``words_to_bytes``) and the columnar record primitives of the serving
wire (``gather_records`` / ``scatter_records``, ``ragged_gather`` /
``ragged_scatter``) from ``hermes_tpu/transport/codec.py``.

A block (``state.Invs`` / ``Acks`` / ``Vals`` of numpy arrays, or a bare
tuple of arrays) serializes to a fixed byte length: its fields
concatenated in definition order, raveled, raw little-endian bytes (bool
one byte, int32 four), the layout both ends derive from one config.

A frame is ``[magic u16 | algo u8 | pad u8 | length u32 | crc u32] +
payload``; the write-ahead log (``wal/``) stores its records as frames,
byte-compatible with the JAX package's segments.  The checksum is CRC32C
when the ``crc32c`` module is importable, else zlib's CRC32; the ``algo``
byte records which, and a frame is never verified with the other
polynomial.

The byte/word codecs are the numpy mirrors of ``core.faststep._bank_to_i32`` /
``_i32_to_bank``: little-endian byte composition, each byte reinterpreted
as unsigned (a numpy view between same-width integer types keeps the
bits, whatever the host's byte order), never an ``astype`` of a signed
byte through a wider type.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:  # pragma: no cover - depends on the installation
    from crc32c import crc32c as _crc32c

    _ALGO = 1  # CRC32C (Castagnoli)
except ImportError:
    _crc32c = None
    _ALGO = 0  # IEEE CRC32 (zlib)

FRAME_MAGIC = 0x48F7
FRAME_HEADER = struct.Struct("<HBBII")  # magic, algo, pad, length, crc
FRAME_OVERHEAD = FRAME_HEADER.size


class FrameCorrupt(ValueError):
    """A framed payload failed its integrity check (bad magic, length or
    checksum): it must never be applied."""


def wire_crc(payload: bytes, algo: int = _ALGO) -> int:
    """Frame checksum over ``payload`` with the header's algo byte;
    raises ``FrameCorrupt`` for an algo this end cannot compute."""
    if algo == 1:
        if _crc32c is None:
            raise FrameCorrupt(
                "frame uses crc32c but no crc32c module is available on "
                "this end — install it or have the sender use the crc32 "
                "fallback (algo=0)")
        return _crc32c(payload) & 0xFFFFFFFF
    if algo == 0:
        return zlib.crc32(payload) & 0xFFFFFFFF
    raise FrameCorrupt(f"unknown frame checksum algo {algo}")


def block_nbytes(template) -> int:
    return sum(np.asarray(f).nbytes for f in template)


def frame_nbytes(template) -> int:
    """On-the-wire size of a framed block (header + payload)."""
    return FRAME_OVERHEAD + block_nbytes(template)


def pack(block) -> np.ndarray:
    """Serialize a block to a 1-D uint8 array."""
    parts = [np.ascontiguousarray(np.asarray(f)).view(np.uint8).ravel()
             for f in block]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def unpack(template, buf: np.ndarray):
    """Deserialize ``buf`` (uint8, ``block_nbytes(template)`` long) into a
    block shaped like ``template`` (a NamedTuple block, or a bare tuple of
    arrays)."""
    need = block_nbytes(template)
    if buf.nbytes != need:
        raise ValueError(f"wire size mismatch: {buf.nbytes} bytes for a "
                         f"{need}-byte block")
    out = []
    off = 0
    for f in template:
        f = np.asarray(f)
        n = f.nbytes
        out.append(buf[off:off + n].view(f.dtype).reshape(f.shape))
        off += n
    if hasattr(template, "_fields"):
        return type(template)(*out)
    return tuple(out)


def stack(blocks):
    """Stack per-source blocks into an inbound block with a leading R
    axis."""
    first = blocks[0]
    return type(first)(*[np.stack([np.asarray(b[i]) for b in blocks])
                         for i in range(len(first))])


def frame_pack(payload: np.ndarray) -> np.ndarray:
    """Wrap a uint8 payload in a checksummed frame."""
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    pb = payload.tobytes()
    hdr = FRAME_HEADER.pack(FRAME_MAGIC, _ALGO, 0, len(pb), wire_crc(pb))
    return np.concatenate([np.frombuffer(hdr, np.uint8), payload])


def frame_unpack(buf: np.ndarray) -> np.ndarray:
    """Verify and strip a frame header; returns the payload bytes.
    Raises ``FrameCorrupt`` on any integrity failure."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if buf.nbytes < FRAME_OVERHEAD:
        raise FrameCorrupt(f"frame truncated: {buf.nbytes} < header "
                           f"{FRAME_OVERHEAD} bytes")
    magic, algo, _pad, length, crc = FRAME_HEADER.unpack(
        buf[:FRAME_OVERHEAD].tobytes())
    if magic != FRAME_MAGIC:
        raise FrameCorrupt(f"bad frame magic 0x{magic:04x}")
    payload = buf[FRAME_OVERHEAD:]
    if length != payload.nbytes:
        raise FrameCorrupt(f"frame length mismatch: header says {length}, "
                           f"got {payload.nbytes}")
    got = wire_crc(payload.tobytes(), algo)
    if got != crc:
        raise FrameCorrupt(
            f"frame checksum mismatch: header 0x{crc:08x} != payload "
            f"0x{got:08x} (algo={'crc32c' if algo == 1 else 'crc32'})")
    return payload


def rows_to_words(rows8: np.ndarray) -> np.ndarray:
    """int8 byte rows (..., 4*W) -> int32 words (..., W)."""
    u = rows8.view(np.uint8).astype(np.uint32)
    w = (u[..., 0::4] | (u[..., 1::4] << 8)
         | (u[..., 2::4] << 16) | (u[..., 3::4] << 24))
    return np.ascontiguousarray(w).view(np.int32)


def words_to_rows(rows32: np.ndarray) -> np.ndarray:
    """Inverse of ``rows_to_words``: int32 words (..., W) -> int8 byte
    rows (..., 4*W)."""
    u = np.ascontiguousarray(rows32).view(np.uint32)
    parts = np.stack([((u >> (8 * k)) & 0xFF) for k in range(4)],
                     axis=-1).astype(np.uint8)
    b = parts.reshape(rows32.shape[:-1] + (4 * rows32.shape[-1],))
    return b.view(np.int8)


def bytes_to_words(data, n_words=None) -> np.ndarray:
    """Ragged bytes -> zero-padded little-endian int32 words.  ``n_words``
    fixes the output width (the config-width discipline: both ends derive
    it from the same config); default is the tightest fit.  Byte-exact
    round trip with ``words_to_bytes`` for EVERY length including 0 and
    non-word-multiples — the tail bytes ride a zero-padded buffer view,
    never a sign-extending arithmetic conversion."""
    raw = bytes(data)
    need = (len(raw) + 3) // 4
    if n_words is None:
        n_words = need
    elif need > n_words:
        raise ValueError(f"{len(raw)} bytes exceed {n_words} int32 words")
    buf = np.zeros(4 * n_words, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    return buf.view(np.dtype("<i4")).copy()


def words_to_bytes(words, length=None) -> bytes:
    """int32 words -> the first ``length`` bytes (little-endian); default
    the full word span.  Inverse of ``bytes_to_words``."""
    w = np.ascontiguousarray(np.asarray(words, np.int32).ravel())
    raw = w.astype(np.dtype("<i4"), copy=False).tobytes()
    if length is None:
        return raw
    if length > len(raw):
        raise ValueError(f"length {length} exceeds the {len(raw)}-byte span")
    return raw[:length]


# Columnar record primitives: the columnar wire codec (serving/wire.py)
# decodes a whole drained socket buffer in one numpy pass.  Fixed-stride
# record streams are one reshape; heap-mode streams have variable
# strides, so it gathers K fixed-size heads at arbitrary byte offsets and
# moves ragged payload extents between a record stream and one blob —
# fancy-index passes over uint8 views, no per-row Python.


def _ragged_index(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat byte indices addressing ``lens[i]`` consecutive bytes from each
    ``starts[i]`` — the one index pattern behind ragged gather/scatter.
    Length-0 rows contribute nothing (np.repeat drops them)."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    # position-within-row = global arange minus each row's exclusive cumsum
    excl = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return (np.repeat(starts, lens)
            + (np.arange(total, dtype=np.int64) - np.repeat(excl, lens)))


def gather_records(buf8: np.ndarray, offs: np.ndarray, nbytes: int) -> np.ndarray:
    """(K, nbytes) uint8 matrix of the fixed-size record heads at byte
    offsets ``offs`` in ``buf8`` — the variable-stride decode primitive
    (a fixed-stride stream is just ``buf8.reshape(k, stride)``)."""
    offs = np.asarray(offs, np.int64)
    if offs.size == 0:
        return np.zeros((0, nbytes), np.uint8)
    return buf8[offs[:, None] + np.arange(nbytes, dtype=np.int64)]


def scatter_records(out8: np.ndarray, offs: np.ndarray,
                    mat: np.ndarray) -> None:
    """Inverse of ``gather_records``: write each row of ``mat`` at its
    record's byte offset in ``out8`` (in place)."""
    offs = np.asarray(offs, np.int64)
    if offs.size == 0:
        return
    out8[offs[:, None] + np.arange(mat.shape[1], dtype=np.int64)] = mat


def ragged_gather(buf8: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Concatenate the ragged extents ``buf8[starts[i]:starts[i]+lens[i]]``
    into one contiguous uint8 blob (one fancy-index pass)."""
    return buf8[_ragged_index(starts, lens)]


def ragged_scatter(out8: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   blob8: np.ndarray) -> None:
    """Inverse of ``ragged_gather``: scatter a contiguous blob back out to
    ragged extents at ``starts`` (in place)."""
    idx = _ragged_index(starts, lens)
    out8[idx] = blob8[:idx.size]
