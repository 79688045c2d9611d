"""Host byte <-> word codecs: the port's copy of ``rows_to_words`` and
``words_to_rows`` from ``hermes_tpu/transport/codec.py``.

They are the numpy mirrors of ``core.faststep._bank_to_i32`` /
``_i32_to_bank``: little-endian byte composition, each byte reinterpreted
as unsigned (a numpy view between same-width integer types keeps the
bits, whatever the host's byte order), never an ``astype`` of a signed
byte through a wider type.
"""

from __future__ import annotations

import numpy as np


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
