"""The table-step probe on the card: hand-written table-step kernels beside
PyTorch's own scatter and gather.

Counterpart of ``scripts/pallas_probe.py``, whose TPU run is the evidence
behind the reference's decision to keep the key-state table step in
library scatter/gather.  The same four candidates, each a step
``state = fn(state, *rest)`` over M messages into a K-row table of W = 10
int32 words:

  ``torch``   — the production formulation (the reference's ``xla``):
                ``vpts.scatter_reduce_(0, keys, pts, "amax")`` into the (K,)
                arbiter column, then ``bank.index_put_((keys,), rows8)`` of
                the rows' bytes into the (K, 40) int8 bank;
  ``serial``  — ``core/probe_kernels.probe_serial``, the ordered scatter
                (CUDA kernel ``csrc/probe_serial.cu``);
  ``onehot``  — the scatter as a matrix product, one-hot(keys)^T @ rows,
                O(K x M) work for O(M) payload;
  ``vgather`` — ``probe_kernels.probe_vgather`` (``csrc/probe_vgather.cu``),
                whose ``out[:, 0] & (K-1)`` feeds back as the next keys.

Run (the device defaults to the card, and the probe raises without one):

    python -m hermes_tpu_torch.table_probe [--device cpu] [--json PATH]

One JSON object goes to stdout.  Each cell carries ``s_per_call`` (the
slope between two counts of eager calls, each timed as the median of 5
runs, host enqueue included) and ``device_s_per_call`` (the device time
a call queued behind a spin kernel, from CUDA events).  On the CPU the probe checks
function only: the host clock and two short runs, and no device time.
Each cell also carries the reference's analysis fields
(``analysis_clean``, ``analysis_findings``; ``analyze_step``): one step of
the candidate in the bound-checked build of its kernel, on the messages'
concrete values and a resident table of any content.  The reference walks
the step's jaxpr; the port observes the guards on that run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from hermes_tpu_torch.analysis import findings as F
from hermes_tpu_torch.analysis.domain import iv, top
from hermes_tpu_torch.core.probe_kernels import probe_serial, probe_vgather
from hermes_tpu_torch.device import resolve
from hermes_tpu_torch.profiling import queued_s

W = 10  # int32 words per table row ([pts | sst | 8 val words], bench shape)
I32 = torch.int32

BENCH = (1 << 20, 49152)  # the bench table (K keys) and lanes (M messages)
#: the cells of ``main``: the reference's, plus ``serial`` and ``vgather``
#: at the bench table shape, which the TPU's VMEM kept them from
CELLS = (("torch", 4096, 4096), ("serial", 4096, 4096), ("torch", *BENCH),
         ("serial", *BENCH), ("onehot", 1024, 4096), ("onehot", 4096, 4096),
         ("onehot", 16384, 4096), ("vgather", 4096, 4096),
         ("vgather", *BENCH))
#: the kernel each candidate launches
KERNEL = {"serial": probe_serial, "vgather": probe_vgather}


def _msgs(seed, K, M, dev):
    """M messages of a seeded draw: keys in [0, K), pts in [1, 2^20) and
    each row ``pts`` tiled over W words."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, M, dtype=np.int32)
    pts = rng.integers(1, 1 << 20, M, dtype=np.int32)
    rows = np.tile(pts[:, None], (1, W))
    return tuple(torch.from_numpy(x).to(dev) for x in (keys, pts, rows))


def torch_step(state, keys, pts, rows8):
    """The production formulation, two library calls: scatter-max of the
    packed ts into the arbiter column, then the row bytes into the bank
    (at a key hit by several messages, ``index_put_`` leaves unspecified
    whose row lands).  ``keys`` are int64, torch's index type."""
    vpts, bank = state
    vpts.scatter_reduce_(0, keys, pts, "amax")
    bank.index_put_((keys,), rows8)
    return vpts, bank


def onehot_step(acc, keys, rows):
    """One-hot(keys)^T @ rows with the payload masked to its low 7 bits,
    the carry mixed in so no call can be hoisted.  float32 on both
    devices (CUDA has no int8 matmul at W = 10): every sum is at most
    M x 127 < 2^24, so it is exact — with TF32 off, which the product sets
    for itself and then restores."""
    K = acc.shape[0]
    hot = keys[:, None] == torch.arange(K, dtype=I32, device=keys.device)
    r = (rows + acc[:1, :]) & 0x7F
    matmul = torch.backends.cuda.matmul
    tf32, matmul.allow_tf32 = matmul.allow_tf32, False
    try:
        return (hot.to(torch.float32).T @ r.to(torch.float32)).to(I32)
    finally:
        matmul.allow_tf32 = tf32


def vgather_step(keys, table):
    """The row gather, its first word fed back as the next keys."""
    return probe_vgather(keys, table)[:, 0] & (table.shape[0] - 1)


def candidate_step(cand, K, M, device="cuda"):
    """``(fn, args)`` of one candidate: the step and its arguments, the
    state first (``state = fn(*args)`` runs one step).  Each candidate
    draws its own messages (seeds 0-3, as the reference's)."""
    dev = resolve(device)
    if cand == "torch":
        keys, pts, rows = _msgs(0, K, M, dev)
        rows8 = rows.view(torch.int8)  # (M, 4W) little-endian bytes
        state = (torch.zeros((K,), dtype=I32, device=dev),
                 torch.zeros((K, 4 * W), dtype=torch.int8, device=dev))
        return torch_step, (state, keys.long(), pts, rows8)
    if cand == "serial":
        keys, _pts, rows = _msgs(1, K, M, dev)
        return probe_serial, (torch.zeros((K, W), dtype=I32, device=dev),
                              keys, rows)
    if cand == "onehot":
        keys, _pts, rows = _msgs(2, K, M, dev)
        return onehot_step, (torch.zeros((K, W), dtype=I32, device=dev),
                             keys, rows)
    if cand == "vgather":
        keys, _pts, _rows = _msgs(3, K, M, dev)
        return vgather_step, (keys, torch.ones((K, W), dtype=I32, device=dev))
    raise KeyError(cand)


def _any_content(state, seed=7):
    """``state`` (a tensor or a tuple of them) refilled with a seeded draw
    over its whole type: a resident table of any reachable content."""
    if isinstance(state, tuple):
        return tuple(_any_content(x, seed + i) for i, x in enumerate(state))
    info = torch.iinfo(state.dtype)
    g = torch.Generator(device=state.device).manual_seed(seed)
    return torch.randint(info.min, info.max + 1, tuple(state.shape),
                         dtype=state.dtype, device=state.device, generator=g)


def _declared_out(cand, K, args):
    """The declared bound of each tensor one step of ``cand`` returns,
    from the messages' concrete bounds and a state of any content:
    ``torch`` and ``serial`` keep or overwrite table words (any content
    stays any content); ``onehot`` sums M payloads masked to 7 bits;
    ``vgather`` masks a table word to [0, K)."""
    if cand == "torch":
        return [top(np.int32), top(np.int8)]
    if cand == "serial":
        return [top(np.int32)]
    if cand == "onehot":
        return [iv(0, 0x7F * args[1].shape[0])]
    return [iv(0, K - 1)]


def analyze_step(cand, K, M, device="cuda"):
    """The analysis fields of one candidate cell: one step in the
    bound-checked build (``core/dispatch.checked_build``), the messages as
    drawn and the resident state refilled with any content.
    ``analysis_clean`` is true when no guard fired and every output stayed
    inside its declared bound; ``analysis_findings`` lists what did not, as
    ``severity:pass/code@file:line``; ``analysis_build`` says what ran:
    ``checked`` on the card, ``plain`` on the CPU, where the kernels' plain
    versions are held to the declared bounds only and no access is
    bound-checked.  ``analysis_calls`` counts the steps it made."""
    from hermes_tpu_torch.analysis.diffcheck import analyze_call

    fn, args = candidate_step(cand, K, M, device)
    on_card = args[1].device.type == "cuda"
    name = KERNEL[cand].__name__ if cand in KERNEL else cand

    def step():
        outs = fn(_any_content(args[0]), *args[1:])
        return outs if isinstance(outs, tuple) else (outs,)

    _outs, found = analyze_call(step, _declared_out(cand, K, args), name,
                                name)
    gating = [f for f in found if f.severity in F.GATING]
    skipped = [f.message for f in found if f.code == "guard-skipped"]
    return dict(
        analysis_clean=not gating,
        analysis_findings=[f"{f.severity}:{f.pass_name}/{f.code}@{f.site}"
                           for f in gating],
        analysis_build="checked" if on_card else "plain", analysis_calls=1,
        **({"analysis_skipped": skipped} if skipped else {}))


def run_chain(fn, args, reps=3):
    """The state after ``reps`` chained steps from ``args``."""
    state = args[0]
    for _ in range(reps):
        state = fn(state, *args[1:])
    return state


def check_state(cand, got, want, args) -> int:
    """Raise AssertionError unless the state ``got`` equals ``want``: bit
    for bit, except the ``torch`` bank at a key hit by more than one
    message, where ``index_put_`` leaves unspecified which message's
    bytes land — there each byte of ``got``'s row must be that byte of
    one of the key's messages.  On the card a row can mix the bytes of
    several messages (``index_put_`` does not write a row as one unit);
    returns how many duplicated keys hold such a mixed row (0 for the
    other candidates).  ``args``: the arguments the chain ran on."""
    if cand != "torch":
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{cand}: the states differ")
        return 0
    (vpts, bank), (want_vpts, want_bank) = got, want
    if not torch.equal(vpts.cpu(), want_vpts.cpu()):
        raise AssertionError("torch: vpts differ")
    bank, want_bank = bank.cpu(), want_bank.cpu()
    keys, rows8 = args[1].cpu(), args[3].cpu()
    K = bank.shape[0]
    hits = torch.bincount(keys, minlength=K)
    single = hits <= 1
    if not torch.equal(bank[single], want_bank[single]):
        raise AssertionError("torch: bank rows of keys hit once differ")
    match = (bank[keys] == rows8).to(I32)  # (M, 4W): byte from message i
    byte_held = torch.zeros(bank.shape, dtype=I32).index_add_(0, keys, match)
    if not (byte_held[~single] > 0).all():
        raise AssertionError("torch: a duplicated key holds a byte of none "
                             "of its messages")
    row_held = torch.zeros(K, dtype=I32).index_add_(
        0, keys, match.all(1).to(I32))
    return int(((row_held == 0) & ~single).sum())


def _time(fn, args, n_lo=20, n_hi=100, samples=5):
    """Per-call times of the chained step ``fn`` from ``args``:
    ``s_per_call``, the slope between ``n_lo`` and ``n_hi`` eager calls,
    each count timed as the median of ``samples`` runs with CUDA events
    (the host's enqueue included: a call that enqueues slower than the
    card runs it is timed at its enqueue); ``device_s_per_call``, the
    device time per call of calls queued behind a spin kernel
    (``profiling.queued_s``: CUDA events, nothing lost; None where the
    step's enqueue outlasts the spin).
    On the CPU: the host clock, one run of 1 and 2 calls, no device time.
    ``calls`` counts every call made, the warm-up one included."""
    state, rest = args[0], args[1:]
    card = args[1].device.type == "cuda"
    if not card:
        n_lo, n_hi, samples = 1, 2, 1
    calls = 0

    def steps(n):
        nonlocal state, calls
        for _ in range(n):
            state = fn(state, *rest)
        calls += n

    def per_count(n):
        ts = []
        for _ in range(samples):
            if card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                steps(n)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                steps(n)
                ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    steps(1)  # warm-up
    s_per_call = (per_count(n_hi) - per_count(n_lo)) / (n_hi - n_lo)
    out = dict(s_per_call=s_per_call, device_s_per_call=None)
    if card:
        out["device_s_per_call"] = queued_s(lambda: steps(1))
    out["calls"] = calls
    return out


def cell(cand, K, M, device="cuda"):
    """One timed cell: a fresh candidate at (K, M) on ``device``."""
    fn, args = candidate_step(cand, K, M, device)
    t = _time(fn, args)
    out = dict(cand=cand, K=K, M=M, **t, us_per_msg=t["s_per_call"] / M * 1e6)
    if cand == "onehot":
        out["flops_amplification"] = K
    out.update(analyze_step(cand, K, M, device))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the result to PATH")
    a = ap.parse_args(argv)
    dev = resolve(a.device)
    cells = [cell(cand, K, M, dev) for cand, K, M in CELLS]
    for c in cells:
        print(json.dumps(c), file=sys.stderr)
    out = dict(platform=dev.type,
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               torch=torch.__version__, cells=cells)
    print(json.dumps(out))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
