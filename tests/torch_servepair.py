"""Shared helpers of the serving tests (``tests/test_torch_serving*.py``,
``tests/test_torch_shm_ipc.py``): one namespace a package, so a drive is
written once and run on the reference (``hermes_tpu``) and on the port
(``hermes_tpu_torch``, on the CPU) with the same arguments.  Not a test
module."""

import dataclasses
import importlib
import types

import jax
import torch

torch.set_num_threads(1)


def _ns(root: str, port: bool) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")
    ns = types.SimpleNamespace(
        root=root, port=port, config=m("config"), kvs_mod=m("kvs"),
        serving=m("serving"), wire=m("serving.wire"),
        server=m("serving.server"), rpc=m("serving.rpc"),
        soak=m("serving.soak"), admission=m("serving.admission"),
        ipc=m("serving.ipc"), shm=m("transport.shm"),
        openloop=m("workload.openloop"), chaos=m("chaos"),
        codec=m("transport.codec"), obs=m("obs"), fleet=m("fleet"),
        tracing=m("obs.tracing"))
    ns.HermesConfig = ns.config.HermesConfig
    ns.WorkloadConfig = ns.config.WorkloadConfig
    ns.FleetConfig = ns.config.FleetConfig
    return ns


REF = _ns("hermes_tpu", port=False)
PORT = _ns("hermes_tpu_torch", port=True)
BOTH = (REF, PORT)


def settle(rt):
    """Each dispatched reference round completes before host code goes
    on (ROADMAP C: the reference's depth-2 aliasing); what it computes is
    unchanged."""
    dispatch = rt.dispatch_round

    def settled(*args, **kwargs):
        comp = dispatch(*args, **kwargs)
        jax.block_until_ready((comp, rt.fs))
        return comp

    rt.dispatch_round = settled


def kvs(ns, cfg, settled=True, **kw):
    """A KVS of package ``ns``: the port's on the CPU, the reference's
    settled at pipeline depth 2 unless ``settled=False``."""
    if ns.port:
        return ns.kvs_mod.KVS(cfg, device="cpu", **kw)
    store = ns.kvs_mod.KVS(cfg, **kw)
    if settled and cfg.pipeline_depth > 1:
        settle(store.rt)
    return store


def fleet(ns, fcfg, settled=True, **kw):
    if ns.port:
        return ns.fleet.Fleet(fcfg, device="cpu", **kw)
    fl = ns.fleet.Fleet(fcfg, **kw)
    if settled and fcfg.base.pipeline_depth > 1:
        for g in fl.groups:
            settle(g.rt)
    return fl


def cfg(ns, **over):
    """``tests/test_serving.py``'s small store shape."""
    wl = over.pop("workload", None) or dict(read_frac=0.5, seed=7)
    kw = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=6,
              ops_per_session=96, value_words=6, replay_age=6,
              replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
              workload=ns.WorkloadConfig(**wl))
    kw.update(over)
    return ns.HermesConfig(**kw)


def scfg(ns, **over):
    """``tests/test_serving.py``'s serving envelope."""
    kw = dict(tenant_rate_per_s=1e6, tenant_burst=1e4, tenant_quota=16,
              queue_cap=64, round_us=1000)
    kw.update(over)
    return ns.server.ServingConfig(**kw)


def rsp_bytes(ns, fe, rsps) -> bytes:
    """The wire bytes of a list of scalar/read responses."""
    return b"".join(ns.wire.encode_any_response(r, fe.u, fe.vbytes)
                    for r in rsps)


def public(res: dict) -> dict:
    """A soak summary without its live objects."""
    return {k: v for k, v in res.items() if not k.startswith("_")}


def same(fn):
    """Run ``fn(ns)`` on both packages; assert equal results; return the
    port's."""
    want = fn(REF)
    got = fn(PORT)
    assert got == want
    return got


def replace(c, **kw):
    return dataclasses.replace(c, **kw)


def smoke_namespace(monkeypatch):
    """The namespace ``chip_smoke.main`` hands its serving phases, on the
    CPU at a cut shape (2^12 keys, 64 sessions a replica), with
    ``stats_block``'s plain version counted as its wrapper's launch (on
    the CPU a wrapper counts CUDA launches only)."""
    from types import SimpleNamespace

    from hermes_tpu_torch import chaos, config, fleet, serving
    from hermes_tpu_torch.checker import linearizability as lin
    from hermes_tpu_torch.core import kernels, types
    from hermes_tpu_torch.kvs import KVS
    from hermes_tpu_torch.serving import bench, soak
    from hermes_tpu_torch.workload import openloop

    def counted(*a, _p=kernels.stats_block_plain, **k):
        kernels.stats_block.launches += 1
        return _p(*a, **k)

    monkeypatch.setattr(kernels, "stats_block_plain", counted)
    return SimpleNamespace(
        kvs_cfg=lambda **over: config.bench_cfg("a", over=dict(
            device_stream=False, read_unroll=1, n_keys=1 << 12,
            n_sessions=64, **over)),
        HermesConfig=config.HermesConfig, device="cpu", KVS=KVS,
        kernels=kernels, types=types, chaos=chaos,
        ShapedArrivals=openloop.ShapedArrivals, MixSpec=openloop.MixSpec,
        ServingConfig=serving.ServingConfig,
        run_open_loop=serving.run_open_loop,
        run_columnar_soak=soak.run_columnar_soak,
        run_serve_bench=bench.run_serve_bench,
        run_one_store_cell=bench.run_one_store_cell,
        run_columnar_worker_cell=bench.run_columnar_worker_cell,
        measure_columnar_floor=soak.measure_columnar_floor,
        Fleet=fleet.Fleet, FleetConfig=config.FleetConfig,
        verify_fleet=fleet.verify_fleet, lin=lin,
        committed_uids=soak.committed_uids, make_mix=openloop.make_mix,
        sync=lambda: None)
