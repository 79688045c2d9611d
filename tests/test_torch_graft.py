"""The port's entry points (hermes_tpu_torch/graft.py, probe.py) against
the reference's (__graft_entry__.py, hermes_tpu/probe.py).

``entry()``'s round from the reference's inputs, on the CPU, must leave
every state leaf and completion column equal to the reference's;
``_cfg`` is the reference's; the bounded probe reports success, a failed
child and a timeout as the reference's does; the multi-process dry run
completes over gloo; and asking for the card without one raises.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_graft
from hermes_tpu_torch import convert, graft, probe

torch.set_num_threads(1)


@pytest.mark.parametrize("n,tiny", [(8, False), (8, True), (3, True)])
def test_torch_graft_cfg_equals_the_reference(n, tiny):
    assert (dataclasses.asdict(graft._cfg(n, tiny))
            == dataclasses.asdict(ref_graft._cfg(n, tiny)))


def test_torch_graft_entry_round_equals_the_reference(capsys):
    rfn, rargs = ref_graft.entry()
    rfs, rcomp = rfn(*rargs)
    fn, args = graft.entry("cpu")
    assert "entry(device='cpu'): entered" in capsys.readouterr().out
    fs, comp = fn(*args)
    got = convert.fast_state_to_numpy(fs)
    for part in ("table", "sess", "replay", "meta"):
        for f in getattr(got, part)._fields:
            a = np.asarray(getattr(getattr(got, part), f))
            b = np.asarray(getattr(getattr(rfs, part), f))
            assert np.array_equal(a, b), f"{part}.{f}"
    # read_unroll=2: a tuple of per-sub-step completions, then the round's
    assert len(comp) == len(rcomp) == 2
    for c, rc in zip(comp, rcomp):
        for f in c._fields:
            assert np.array_equal(getattr(c, f).numpy(),
                                  np.asarray(getattr(rc, f))), f


def test_torch_probe_backend_paths():
    assert probe.probe_backend(1.0, device="cpu") == (True, "cpu")
    ok, info = probe.probe_backend(
        60.0, cmd=[sys.executable, "-c",
                   f"print('{probe.MARKER}', 'Some Card')"])
    assert ok and info == "Some Card"
    ok, info = probe.probe_backend(
        60.0, cmd=[sys.executable, "-c", "raise SystemExit('no card here')"])
    assert not ok and "rc=1" in info and "no card here" in info
    # a child past its bound is abandoned, not killed; this one ends itself
    ok, info = probe.probe_backend(
        0.2, cmd=[sys.executable, "-c", "import time; time.sleep(1.5)"])
    assert not ok and "did not complete within" in info and "pid=" in info


def test_torch_graft_entry_refuses_the_card_without_one(monkeypatch):
    """Without a card the probe child fails and ``entry`` raises its
    diagnosis; with the probe off, the device rule raises."""
    monkeypatch.setenv("HERMES_ENTRY_PROBE_TIMEOUT", "120")
    with pytest.raises(RuntimeError, match="the card is unavailable"):
        graft.entry()
    monkeypatch.setenv("HERMES_ENTRY_PROBE", "0")
    with pytest.raises(RuntimeError, match="asks for the card"):
        graft.entry()


def test_torch_graft_dryrun_over_gloo(capfd):
    graft.dryrun_multichip(2, timeout_s=240)
    out = capfd.readouterr().out
    assert "dryrun rank 0/2: ok" in out and "dryrun rank 1/2: ok" in out
    assert "every rank completed" in out


def test_torch_graft_main_runs_dryrun_then_entry(capfd):
    assert graft.main(["--device", "cpu", "--dryrun", "2"]) == 0
    out = capfd.readouterr().out
    assert out.index("dryrun_multichip ok") < out.index("entry step ok")
