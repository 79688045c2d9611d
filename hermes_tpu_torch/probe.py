"""A bounded probe of the card, taken before a process touches it: the
port's counterpart of ``hermes_tpu/probe.py``.

A CUDA context that cannot be made (a card lost, its runtime wedged) can
hang the first CUDA call of a process.  So ``probe_backend`` initialises
CUDA in a CHILD process under a time bound first; only when the child
says it got a context does the caller touch the card itself.  On a
timeout the child is abandoned, not killed, as the reference does: it
either finishes later and exits, or idles without blocking anyone.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

#: what the probe child prints when it made a context and ran a kernel
MARKER = "HERMES_BACKEND_OK"


def probe_backend(timeout_s: float, device="cuda", cmd=None):
    """``(ok, info)``: ``info`` is the card's name on success, else a
    one-line diagnosis.  Trivially ``(True, "cpu")`` when ``device``
    names the CPU (its init cannot hang).  ``cmd`` replaces the child's
    command line (tests)."""
    import torch

    if torch.device(device).type == "cpu":
        return True, "cpu"
    if cmd is None:
        code = ("import torch; torch.ones(1, device='cuda').sum().item(); "
                f"print('{MARKER}', torch.cuda.get_device_name(0))")
        cmd = [sys.executable, "-c", code]
    with tempfile.TemporaryFile(mode="w+") as out:
        p = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                             text=True)
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return False, (
                f"CUDA init did not complete within {timeout_s:.0f}s (card "
                f"lost or its runtime wedged); probe child pid={p.pid} left "
                f"running")
        out.seek(0)
        txt = out.read()
    if p.returncode != 0 or MARKER not in txt:
        tail = [line for line in txt.strip().splitlines() if line.strip()][-1:]
        return False, (f"CUDA init failed rc={p.returncode}: "
                       f"{tail[0] if tail else 'no output'}")
    return True, txt.split(MARKER, 1)[1].strip()
