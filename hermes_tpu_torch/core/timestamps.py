"""Lamport timestamps of the phases engine: the port of
``hermes_tpu/core/timestamps.py``.

A timestamp is two int32 columns: ``ver`` (the key's version) and ``fc``
(the tie-break word ``(write_flag << 8) | cid``), compared
lexicographically.  Every helper is elementwise over tensors (or Python
ints).
"""

from __future__ import annotations


def make_fc(write_flag, cid):
    """Pack the tie-break word: (flag << 8) | cid."""
    return (write_flag << 8) | cid


def fc_cid(fc):
    """Extract the coordinator id from the tie-break word."""
    return fc & 0xFF


def ts_gt(ver_a, fc_a, ver_b, fc_b):
    """Lexicographic (ver, fc) greater-than: a > b."""
    return (ver_a > ver_b) | ((ver_a == ver_b) & (fc_a > fc_b))


def ts_eq(ver_a, fc_a, ver_b, fc_b):
    return (ver_a == ver_b) & (fc_a == fc_b)
