"""The host lock factory: the port's copy of ``make_lock`` from
``hermes_tpu/concurrency.py``.

The reference mints every serving-tier lock here so that
``HERMES_LOCKLINT=1`` can swap in its instrumented lock (its
``analysis/lockgraph``); that sanitizer is ROADMAP A16, so the port's
factory returns a plain ``threading.Lock``.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A ``threading.Lock`` for the attribute ``name`` (``"Class.attr"``,
    the identity the reference's lock sanitizer keys on)."""
    del name
    return threading.Lock()
