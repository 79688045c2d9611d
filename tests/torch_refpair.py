"""Shared helpers of the phases-engine tests (tests/test_torch_phases.py,
test_torch_step.py, test_torch_sim.py, test_torch_netchaos.py,
test_torch_tcp.py): one config built in both packages, a completion tap
on a recorder, and exact comparisons of the two packages' states and
completions.  Not a test module itself."""

from __future__ import annotations

import random
import socket

import numpy as np

from hermes_tpu.config import HermesConfig as JaxConfig
from hermes_tpu.config import WorkloadConfig as JaxWorkload
from hermes_tpu_torch.config import HermesConfig as PortConfig
from hermes_tpu_torch.config import WorkloadConfig as PortWorkload

PARTS = ("table", "sess", "replay", "meta")


def pair(workload=None, **kw):
    """(reference cfg, port cfg) with the same fields."""
    wl = dict(workload or {})
    return (JaxConfig(workload=JaxWorkload(**wl), **kw),
            PortConfig(workload=PortWorkload(**wl), **kw))


def acceptance_pair(n, scale):
    """Acceptance config ``n`` of ``hermes_tpu/acceptance.py:_cfg`` at
    ``scale``, in both packages."""
    import dataclasses

    from hermes_tpu.acceptance import _cfg

    jc = _cfg(n, scale)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
              if f.name != "workload"}
    wl = {f.name: getattr(jc.workload, f.name)
          for f in dataclasses.fields(jc.workload)}
    return jc, PortConfig(workload=PortWorkload(**wl), **fields)


def tap(rt):
    """Record every completion block ``rt``'s recorder is given."""
    got = []
    orig = rt.recorder.record_step

    def record(c):
        got.append(c)
        orig(c)

    rt.recorder.record_step = record
    return got


def ref_state(rt):
    import jax

    return jax.device_get(rt.rs)


def port_state(rt):
    from hermes_tpu_torch import convert

    return convert.replica_state_to_numpy(rt.rs)


def assert_states_equal(a, b, where=""):
    """Every leaf of two ReplicaStates (numpy), exactly."""
    for part in PARTS:
        pa, pb = getattr(a, part), getattr(b, part)
        for f in pa._fields:
            x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
            assert x.shape == y.shape and np.array_equal(x, y), \
                f"{where} {part}.{f} differs"


def assert_blocks_equal(a, b, where=""):
    """Every field of two NamedTuple blocks (numpy or tensors), exactly."""
    for f in a._fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f)
        y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y), \
            f"{where} {f} differs"


def assert_ops_equal(a, b):
    """Two histories (lists of Op), field by field, in order."""
    assert len(a) == len(b), (len(a), len(b))
    fields = ("kind", "key", "inv", "resp", "wuid", "ruid", "ts", "replica",
              "session")
    for x, y in zip(a, b):
        assert all(getattr(x, f) == getattr(y, f) for f in fields), (x, y)


def lockstep(steps, *runtimes, check_each=True, comps=None, where=""):
    """Step the runtimes together ``steps`` rounds; with ``check_each``
    compare the first (the reference) with every other each round: state
    and, given ``comps`` (their taps), the round's completions."""
    for s in range(steps):
        for rt in runtimes:
            rt.step_once()
        if check_each:
            want = ref_state(runtimes[0])
            for i, rt in enumerate(runtimes[1:], 1):
                assert_states_equal(want, port_state(rt),
                                    f"{where} round {s} runtime {i}")
                if comps is not None:
                    assert_blocks_equal(comps[0][-1], comps[i][-1],
                                        f"{where} round {s} comp {i}")


def ref_undone(a):
    """The reference runtime's sessions not yet S_DONE on live, unfrozen
    replicas, and its network's pending blocks."""
    import jax

    status = np.asarray(jax.device_get(a.rs.sess.status))
    live = int(a.live[0])
    active = np.array([(live >> r) & 1 and not a.frozen[r]
                       for r in range(status.shape[0])], bool)
    net = getattr(a, "transport", None)
    return (int(((status != 4) & active[:, None]).sum()),
            net.pending() if net is not None else 0)


def drain_both(a, b, comps, limit=400):
    """Step both until drained, comparing every round; they must drain
    on the same round."""
    for _ in range(limit):
        want = ref_undone(a)
        net = getattr(b, "transport", None)
        got = (int(b.pending_sessions()),
               net.pending() if net is not None else 0)
        assert want == got, f"round {a.step_idx}: {want} != {got}"
        if want == (0, 0):
            return
        lockstep(1, a, b, comps=comps, where="drain")
    raise AssertionError("did not drain")


def free_base_port(n):
    """A base port with ``n`` consecutive free ports, outside the range
    the reference's TCP tests use."""
    for _ in range(200):
        base = random.randint(21000, 28900)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port window")
