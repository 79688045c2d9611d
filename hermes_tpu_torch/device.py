"""Device selection for the port's entry points.

Every entry point takes one ``device=`` argument that defaults to
``"cuda"``: the port runs on the card unless the caller asks for the CPU
(the CPU tests pass ``device="cpu"``).  Asking for the card on a machine
without one raises — nothing carries on on the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device`` (a string or a device); raises
    when it names the card and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asks for the card, but "
                "torch.cuda.is_available() is False on this machine; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (want 'cuda' "
                         "or 'cpu')")
    return dev
