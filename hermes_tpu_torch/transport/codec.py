"""Host codecs: the port's copy of the checksummed frame layer
(``frame_pack``, ``frame_unpack``, ``wire_crc``) and of ``rows_to_words``
/ ``words_to_rows`` from ``hermes_tpu/transport/codec.py``.

A frame is ``[magic u16 | algo u8 | pad u8 | length u32 | crc u32] +
payload``; the write-ahead log (``wal/``) stores its records as frames,
byte-compatible with the JAX package's segments.  The checksum is CRC32C
when the ``crc32c`` module is importable, else zlib's CRC32; the ``algo``
byte records which, and a frame is never verified with the other
polynomial.

They are the numpy mirrors of ``core.faststep._bank_to_i32`` /
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
                "this end")
        return _crc32c(payload) & 0xFFFFFFFF
    if algo == 0:
        return zlib.crc32(payload) & 0xFFFFFFFF
    raise FrameCorrupt(f"unknown frame checksum algo {algo}")


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
        raise FrameCorrupt(f"frame checksum mismatch: header 0x{crc:08x} "
                           f"!= payload 0x{got:08x}")
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
