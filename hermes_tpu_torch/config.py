"""Run configuration for the PyTorch port.

A copy of ``hermes_tpu/config.py``'s ``WorkloadConfig``,
``HermesConfig`` and ``FleetConfig`` (fields, validation and
properties), so that a config built for one package can be rebuilt field
for field in the other (``HermesConfig(**dataclasses.asdict(ref_cfg))``).
The knobs of subsystems the port does not have yet stay declared; the
modules that would read them refuse loudly when they are set
(``kvs.KVS``).

``bench_cfg`` is the port's copy of ``bench.py:_cfg`` — the flagship
bench shape that ``chip_smoke.py`` and the CLI drive.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Literal, Optional, Tuple

from hermes_tpu_torch.core import layouts

#: The reference's mega-round budget for the (K,) vpts arbiter column
#: (4 bytes per key), sized there for a TPU core's VMEM.  The card has no
#: VMEM and its kernel keeps the column in device memory (4 MB at 2^20
#: keys fits the 50 MB L2), but the limit stays so that both packages
#: accept and refuse the same mega_round configs.
MEGA_VPTS_VMEM_BYTES = 8 << 20

# The declared chain-rank field must hold every legal chain_writes value.
assert 4096 < layouts.LANE_WORD.field("chain_rank").cap
assert 4096 < layouts.ARB_WORD.field("chain_rank").cap


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """YCSB-style synthetic workload knobs: YCSB-A = read_frac .5,
    rmw_frac 0; YCSB-F = rmw mix; Zipfian hotspot via
    ``distribution='zipfian'`` with theta 0.99."""

    read_frac: float = 0.5
    rmw_frac: float = 0.0  # fraction of *update* ops that are RMWs
    distribution: Literal["uniform", "zipfian"] = "uniform"
    zipf_theta: float = 0.99
    seed: int = 0

    def __post_init__(self) -> None:
        if self.distribution == "zipfian" and not (0.0 < self.zipf_theta < 1.0):
            raise ValueError("zipf_theta must be in (0, 1)")


@dataclasses.dataclass(frozen=True)
class HermesConfig:
    """Static shape + protocol configuration (see ``hermes_tpu/config.py``
    for the meaning of every knob; the defaults and bounds are the same)."""

    n_replicas: int = 3
    n_keys: int = 1 << 16
    value_words: int = 2  # int32 words per value; words 0/1 hold the write uid
    n_sessions: int = 256
    replay_slots: int = 64
    ops_per_session: int = 1024

    replay_age: int = 16
    lease_steps: int = 8
    wrap_stream: bool = False

    # --- fast-engine knobs (core/faststep.py) -----------------------------
    lane_budget_cfg: Optional[int] = None
    rebroadcast_every: int = 4
    replay_scan_every: int = 8
    read_unroll: int = 1
    arb_slots_cfg: Optional[int] = None
    arb_mode: Literal["race", "sort"] = "race"
    fused_sort: bool = True
    # the mega round (core/megaround.py): route-back, arbiter apply and
    # replay scan as three CUDA kernels; needs the fused sort arbiter
    mega_round: bool = False
    chain_writes: int = 0
    auto_rebase: bool = True
    rebase_fraction: float = 0.5
    rmw_retries: int = 0
    phase_metrics: bool = True

    # --- serving pipeline (runtime.FastRuntime / kvs.KVS) -----------------
    # The port updates the key-state table in place every round, so the
    # donate_state knob has nothing to select; it stays for config parity.
    donate_state: bool = True
    pipeline_depth: int = 1

    # --- client layer (kvs.KVS): watchdog and retry, degraded mode, the
    # value heap, the write-ahead log and per-op tracing ----------------------
    op_timeout_rounds: int = 0
    op_retry_limit: int = 0
    op_backoff: int = 2
    trace_sample: int = 0
    min_healthy_for_writes: int = 0
    max_value_bytes: int = 0
    heap_bytes: int = 1 << 22
    wal_dir: Optional[str] = None
    wal_sync: Literal["commit", "round", "off"] = "commit"
    wal_segment_bytes: int = 1 << 20
    wal_dirty_window: int = 256

    device_stream: bool = False

    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)

    def __post_init__(self) -> None:
        if isinstance(self.workload, dict):
            # dataclasses.asdict flattens the nested workload config
            object.__setattr__(self, "workload", WorkloadConfig(**self.workload))
        if not (1 <= self.n_replicas <= 31):
            raise ValueError(
                "n_replicas must be in [1, 31] (live mask is an int32 bitmap and"
                " (1<<32)-1 overflows int32)"
            )
        if self.read_unroll < 1:
            raise ValueError("read_unroll must be >= 1")
        if self.arb_slots_cfg is not None and (
            self.arb_slots_cfg <= 0
            or self.arb_slots_cfg & (self.arb_slots_cfg - 1)
        ):
            raise ValueError("arb_slots_cfg must be a positive power of two")
        if self.arb_mode not in ("race", "sort"):
            raise ValueError("arb_mode must be 'race' or 'sort'")
        if not (0 <= self.chain_writes <= 4096):
            raise ValueError("chain_writes must be in [0, 4096]")
        if self.chain_writes and self.arb_mode != "sort":
            raise ValueError(
                "chain_writes needs arb_mode='sort' (chain ranks come from "
                "the sorted equal-key runs)"
            )
        if self.mega_round:
            if self.arb_mode != "sort" or not self.fused_sort:
                raise ValueError(
                    "mega_round needs arb_mode='sort' and fused_sort=True "
                    "(the mega route kernel consumes the fused sort's "
                    "sorted-order verdicts)")
            if 4 * self.n_keys > MEGA_VPTS_VMEM_BYTES:
                raise ValueError(
                    f"mega_round needs the vpts arbiter column VMEM-"
                    f"resident: 4*n_keys = {4 * self.n_keys} bytes exceeds "
                    f"the {MEGA_VPTS_VMEM_BYTES}-byte budget "
                    f"(config.MEGA_VPTS_VMEM_BYTES)")
        if not (0 <= self.rmw_retries <= (1 << 20)):
            raise ValueError("rmw_retries must be in [0, 2^20]")
        if self.op_timeout_rounds < 0:
            raise ValueError("op_timeout_rounds must be >= 0 (0 disables)")
        if self.op_retry_limit < 0:
            raise ValueError("op_retry_limit must be >= 0 (0 disables)")
        if self.op_retry_limit and not self.op_timeout_rounds:
            raise ValueError(
                "op_retry_limit needs op_timeout_rounds > 0 (the watchdog "
                "is what detects a wedged op in the first place)")
        if self.op_backoff < 1:
            raise ValueError("op_backoff must be >= 1")
        if self.trace_sample < 0:
            raise ValueError("trace_sample must be >= 0 (0 disables, N = "
                             "one in N ops)")
        if not (0 <= self.min_healthy_for_writes <= self.n_replicas):
            raise ValueError(
                "min_healthy_for_writes must be in [0, n_replicas]")
        if not (1 <= self.pipeline_depth <= 64):
            raise ValueError(
                "pipeline_depth must be in [1, 64] (each in-flight round "
                "pins a full Completions tuple in device memory)"
            )
        if self.n_keys > layouts.INV_PKF.field("key").cap:
            raise ValueError(
                "n_keys must fit the declared INV key field "
                f"({layouts.INV_PKF.field('key').bits} bits; see "
                "core/layouts.py)"
            )
        if self.value_words < 2:
            raise ValueError("value_words >= 2 (words 0-1 carry the unique write id)")
        if self.max_value_bytes < 0:
            raise ValueError("max_value_bytes must be >= 0 (0 disables the heap)")
        if self.max_value_bytes:
            if self.value_words < 3:
                raise ValueError(
                    "the value heap needs value_words >= 3 (2 uid words + "
                    "the packed heap-ref payload word, layouts.HEAP_REF)")
            if self.max_value_bytes > layouts.MAX_VALUE_BYTES:
                raise ValueError(
                    f"max_value_bytes {self.max_value_bytes} exceeds the "
                    f"declared heap-ref len field ({layouts.MAX_VALUE_BYTES} "
                    "bytes)")
            if self.heap_bytes % layouts.HEAP_GRANULE:
                raise ValueError(
                    f"heap_bytes must be a multiple of the "
                    f"{layouts.HEAP_GRANULE}-byte heap granule")
            if self.heap_bytes > layouts.MAX_HEAP_BYTES:
                raise ValueError(
                    f"heap_bytes {self.heap_bytes} exceeds the declared "
                    f"granule field's reach ({layouts.MAX_HEAP_BYTES} bytes)")
            if self.heap_bytes < layouts.HEAP_GRANULE + 2 * (
                    (self.max_value_bytes + layouts.HEAP_GRANULE - 1)
                    // layouts.HEAP_GRANULE) * layouts.HEAP_GRANULE:
                raise ValueError(
                    f"heap_bytes {self.heap_bytes} cannot hold two "
                    f"max_value_bytes={self.max_value_bytes} extents plus "
                    "the reserved null granule")
        if self.wal_sync not in ("commit", "round", "off"):
            raise ValueError("wal_sync must be 'commit', 'round' or 'off'")
        if self.wal_segment_bytes < 4096:
            raise ValueError("wal_segment_bytes must be >= 4096")
        if self.wal_dirty_window < 1:
            raise ValueError("wal_dirty_window must be >= 1")
        # Unique write ids are (hi=replica, lo=session*G+op) int32 pairs.
        if self.n_sessions * self.ops_per_session >= 2**31:
            raise ValueError("n_sessions * ops_per_session must fit int32")
        if self.device_stream:
            if self.workload.distribution not in ("uniform", "zipfian"):
                raise ValueError(
                    "device_stream supports uniform or zipfian keys"
                )
            if self.n_keys & (self.n_keys - 1):
                raise ValueError("device_stream needs power-of-two n_keys")

    @property
    def full_mask(self) -> int:
        """Bitmap with one bit per configured replica."""
        return (1 << self.n_replicas) - 1

    @property
    def n_lanes(self) -> int:
        """Outbound message lanes per replica: sessions + replay slots."""
        return self.n_sessions + self.replay_slots

    @property
    def use_fused_sort(self) -> bool:
        """Resolved fused-sort switch: the sort arbiter with both n_keys
        and n_lanes inside the declared FUSED_KEY sub field; anything else
        runs the split two-sort program."""
        return (self.arb_mode == "sort" and self.fused_sort
                and self.n_lanes <= layouts.FUSED_KEY.field("sub").cap)

    @property
    def use_mega_round(self) -> bool:
        """The mega-round switch: the knob is on and the fused sort
        resolves (the route kernel consumes its sorted-order verdicts).
        It alone decides; there is no build-time refusal and no
        fallback."""
        return self.mega_round and self.use_fused_sort

    @property
    def use_heap(self) -> bool:
        return self.max_value_bytes > 0

    @property
    def heap_granules(self) -> int:
        """Heap log capacity in granules (granule 0 = the null ref)."""
        return self.heap_bytes // layouts.HEAP_GRANULE

    @property
    def use_wal(self) -> bool:
        return self.wal_dir is not None

    @property
    def lane_budget(self) -> int:
        """Resolved compaction budget (slots per outbound block)."""
        if self.lane_budget_cfg is not None:
            return min(self.lane_budget_cfg, self.n_lanes)
        return self.n_lanes

    @property
    def max_key_versions(self) -> int:
        """Versions one key can take before the int32 sign bit corrupts
        the packed Lamport compare."""
        return layouts.MAX_KEY_VERSIONS

    @property
    def arb_slots(self) -> int:
        """Hash-slot count of the race arbiter: power of two, >= 8x
        sessions, capped at 512Ki (override with arb_slots_cfg)."""
        if self.arb_slots_cfg is not None:
            return self.arb_slots_cfg
        hs = 1
        while hs < min(8 * self.n_sessions, 1 << 19):
            hs <<= 1
        return hs


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Key-sharded fleet shape (``fleet/``): G independent replica groups
    side by side, each owning a contiguous range of the fleet keyspace,
    each a full FastRuntime/KVS stack with its own membership service,
    chaos scope and snapshot scope; nothing is shared between groups but
    the fleet router.

    ``ranges`` partitions the FLEET keyspace ``[0, total_keys)`` into one
    contiguous ``[lo, hi)`` per group (default: ``groups`` equal splits of
    ``groups * base.n_keys``).  A group's range must fit its dense table
    (``hi - lo <= group n_keys``): fleet key ``k`` lands on local slot
    ``k - lo`` of its owning group until a migration remaps it.

    ``overrides[g]`` replaces HermesConfig fields for group g.
    ``vary_seed`` (default) adds the group id to each group's workload
    seed, so group op streams are distinct but deterministic.  With
    ``base.wal_dir`` each group logs into its own ``group{g:03d}``
    subdirectory (an explicit per-group ``wal_dir`` override wins).
    """

    groups: int = 2
    base: HermesConfig = dataclasses.field(default_factory=HermesConfig)
    ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    overrides: Optional[Tuple[Optional[dict], ...]] = None
    vary_seed: bool = True

    def __post_init__(self) -> None:
        if self.groups < 1:
            raise ValueError("groups must be >= 1")
        if self.overrides is not None and len(self.overrides) != self.groups:
            raise ValueError(
                f"overrides must carry one entry per group "
                f"({len(self.overrides)} != {self.groups}; use None for "
                "groups with no overrides)")
        if self.ranges is not None:
            if len(self.ranges) != self.groups:
                raise ValueError(
                    f"ranges must carry one (lo, hi) per group "
                    f"({len(self.ranges)} != {self.groups})")
            cursor = 0
            for g, (lo, hi) in enumerate(self.ranges):
                if lo != cursor or hi <= lo:
                    raise ValueError(
                        f"ranges must tile the fleet keyspace contiguously "
                        f"from 0 (group {g} has [{lo}, {hi}), expected "
                        f"lo={cursor} and hi > lo)")
                cursor = hi
        # every group config must build AND hold its range: a bad
        # per-group override surfaces here, not at the g-th runtime
        for g in range(self.groups):
            cfg = self.group_cfg(g)
            lo, hi = self.group_range(g)
            if hi - lo > cfg.n_keys:
                raise ValueError(
                    f"group {g} owns {hi - lo} fleet keys but its dense "
                    f"table holds n_keys={cfg.n_keys}; shrink the range or "
                    "grow the group")

    @property
    def total_keys(self) -> int:
        """Fleet keyspace size (the router's slot space)."""
        if self.ranges is not None:
            return self.ranges[-1][1]
        return self.groups * self.base.n_keys

    def group_range(self, g: int) -> Tuple[int, int]:
        """Fleet-key range ``[lo, hi)`` group ``g`` owns at construction
        (migrations move ownership afterwards; the fleet router is the
        live source of truth)."""
        if not (0 <= g < self.groups):
            raise ValueError(f"group {g} out of range [0, {self.groups})")
        if self.ranges is not None:
            return self.ranges[g]
        k = self.base.n_keys
        return (g * k, (g + 1) * k)

    def group_cfg(self, g: int) -> HermesConfig:
        """The g-th group's HermesConfig (base + overrides + seed vary)."""
        if not (0 <= g < self.groups):
            raise ValueError(f"group {g} out of range [0, {self.groups})")
        over = dict((self.overrides[g] or {})
                    if self.overrides is not None else {})
        wl = over.pop("workload", self.base.workload)
        if self.vary_seed:
            wl = dataclasses.replace(wl, seed=wl.seed + g)
        cfg = dataclasses.replace(self.base, workload=wl, **over)
        # each group logs into its own WAL subdirectory: one group's
        # recovery must never replay another group's records
        if cfg.wal_dir is not None and "wal_dir" not in over:
            cfg = dataclasses.replace(
                cfg, wal_dir=os.path.join(cfg.wal_dir, f"group{g:03d}"))
        return cfg


def bench_cfg(mix: str = "a", over: Optional[dict] = None) -> HermesConfig:
    """The flagship bench shape, field for field ``bench.py:_cfg`` (held
    equal by tests/test_torch_config.py): 8 replicas, 2^20 keys, 32-byte
    values, the sort arbiter with chaining, the device-side op stream,
    read_unroll=2 and the replay scan every 32 rounds.  ``over`` replaces
    any field; the lane budget tracks an overridden session count at 3/4
    unless it is pinned."""
    wl = {
        "a": WorkloadConfig(read_frac=0.5, seed=0),
        "rmw": WorkloadConfig(read_frac=0.5, rmw_frac=1.0, seed=0),
        "zipfian": WorkloadConfig(
            read_frac=0.5, seed=0, distribution="zipfian", zipf_theta=0.99
        ),
    }[mix]
    arb = dict(arb_mode="sort")
    if mix == "a":
        arb["chain_writes"] = 128
    elif mix == "zipfian":
        arb["chain_writes"] = 2048
    elif mix == "rmw":
        arb["rmw_retries"] = 16
    S = 32768 if mix == "zipfian" else 65536
    kw = dict(
        **arb,
        n_replicas=8,
        n_keys=1 << 20,
        value_words=8,
        n_sessions=S,
        replay_slots=256,
        ops_per_session=256,
        wrap_stream=True,
        device_stream=True,
        lane_budget_cfg=(3 * S) // 4,
        read_unroll=2,
        rebroadcast_every=4,
        replay_scan_every=32,
    )
    kw.update(over or {})
    if "lane_budget_cfg" not in (over or {}):
        kw["lane_budget_cfg"] = (3 * kw["n_sessions"]) // 4
    return HermesConfig(workload=wl, **kw)
