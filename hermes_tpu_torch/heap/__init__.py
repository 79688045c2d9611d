"""The value heap: MICA-style variable-length values behind one packed
ref word per key.  See ``heap/core.py`` for the design notes."""

from hermes_tpu_torch.heap.core import (  # noqa: F401
    GRANULE,
    HeapFull,
    ValueHeap,
    build_append,
    build_extent_gather,
    cap_bytes,
    pack_ref,
    ref_gran,
    ref_len,
)
