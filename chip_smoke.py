#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``hermes_tpu_torch``) on one
NVIDIA H100: the quickest proof that the port builds, runs and is right
on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero and
prints no result):

1. device  — the card (nvidia-smi name and power limit), torch and CUDA.
2. build   — nvcc of every ``hermes_tpu_torch/csrc/*.cu``, all at once:
   the release library of each source, its bound-checked one
   (``-DHERMES_CHECKED``, ``csrc/guard.cuh``) and the test-only broken one.
3. kernels — every ported kernel (``stats_block``, ``mega_route``,
   ``mega_apply``, ``mega_replay``, ``probe_serial``, ``probe_vgather``,
   the sentinel ``scan_acc`` and the seven analysis fixtures ``fx_*``)
   against its plain PyTorch version on the same inputs, bit-exact
   (integer outputs: tolerance 0), at the reference's kernel-matrix
   shapes, the bench shape and a ragged one, with the kernel's and the
   plain version's times beside the least time the card could take: per
   call on the stream (CUDA events, median of 25 samples of 10 calls) and
   on the device (torch.profiler, the kernels one call enqueues, mean of
   20 calls in one trace, each device operation of a call listed apart;
   every kernel in ``ONE_OPERATION`` must be one operation a call,
   ``mega_route`` is also timed with clusters of 16 and of 8,
   ``stats_block`` and ``mega_apply`` also on the inputs of one real
   bench-a-mega round, ``mega_replay`` on those of two replay-scan rounds,
   bench-a-mega's and checked-mega's, and ``probe_vgather`` on the probe
   phase's own input, ``probe_inputs``); where one
   PyTorch call computes the same function (``index_put_``,
   ``index_select``, ``sum``, ``clone``, ``new_full``; yardsticks of time
   only: for ``mega_route`` the fused round's ``scatter_reduce_``, for
   ``fx_store_at`` the fill ``zeros_like``, for ``fx_pack``
   ``bitwise_or(a << 29, b)``) that call's time; and the kernel in the
   bound-checked build, held against the plain version again and timed.
   sanitizer — the kernel matrix (``hermes_tpu_torch.analysis``): every
   cell analyzed in the checked build and sanitized on 3 draws, in the
   release and in the checked build (every output inside its declared
   bound and equal to the plain version's on the CPU), all green; a cell
   whose plain version is made to differ must turn red; every fixture
   green in the checked build on inputs in bounds; then the red fixtures,
   each of which must give its finding (an index, an offset or a key out
   of extent, a dropped initialisation, ``mega_apply`` built without its
   clamp, the undeclarable asynchronous copy), and after each a release
   launch that must still be right: the guard records and skips, the
   context lives.
   probe — the table-step probe (``hermes_tpu_torch.table_probe``): every
   cell of its ``main`` on the card, each candidate's state after three
   chained steps held against the CPU port's on the same inputs, then
   timed and analyzed in the checked build (``analysis_clean``); the probe
   kernels' launches over the phase must equal the calls it made.
4. reference — the whole round on the card against the same round on the
   CPU (which the CPU tests hold bit-exact against the JAX reference) at
   a small shape, through a freeze and a removal: identical every round.
   reference-mega: the same drive with ``mega_round=True``.
5. main    — the flagship bench configuration (``config.bench_cfg("a")``:
   8 replicas, 2^20 keys, 65,536 sessions per replica, full width) on
   ``FastRuntime(device="cuda")``: committed writes/s and us/round over a
   timed window, every kernel's launch count over that window (must equal
   the rounds run), and a profiled window's device busy share.
   main-mega: the same with ``mega_round=True`` (each mega kernel's
   launches must equal its rounds), printed beside main's numbers; ab:
   four more windows of the two runtimes in turns (fused and mega three
   windows each, in the order A B B A A B).
6. checked — the same configuration with the columnar history recorder
   for 16 rounds, then quiesced until nothing is in flight: the
   linearizability check must pass, every key must be VALID again, and
   the device op counters must equal the recorded completions.
   checked-mega: ``mega_round=True`` with replica 1 frozen from round 8
   until after the replay scan of round 32, which must take slots.
   sharded — bench-a on the sharded engine (``backend="sharded"``, one
   table copy a replica, every replica in this process on a
   ``LocalGroup``; 8 copies of 2^20+1 rows): the main window's rounds,
   launches and profile.  sharded-mega: the same with ``mega_round=True``
   (``mega_replay`` once a copy on a replay-scan round), and
   ``mega_apply`` at the sharded site (one launch over the flat table)
   and ``mega_replay`` on one copy's view held against their plain
   versions on a real round's inputs.  checked-sharded: a healthy drive
   beside the batched engine (every copy equal to its table after the
   drain), then a recorded one with replica 1 frozen across the round-32
   replay scan (the copies must differ), replica 2 removed and re-joined
   from replica 0: the checker passes, the counters equal the recorded
   completions, the copies converge.  (A ``DistGroup`` across cards is not
   run here: one card.)
7. kvs     — a ``KVS`` at the full key count, value width and session
   count: puts from replica 0 read back from every replica, one RMW.
8. reads   — the local-read path at the same shape, recorded: 65,536
   distinct keys put with ``submit_batch``, one ``multi_get`` of 65,536
   keys (half written, half never written) and one ``scan`` of all 2^20
   rows, every answer held to what was written or to the initial value,
   every key served locally; then one key fenced ahead of its row
   (``pin_read_fence``) must go through the round path; the checker and
   ``stale_read`` must pass.  Reads/s and GB/s of the multi-get and the
   scan on the host clock.  reads-sharded: a sharded KVS, 4,096 keys read
   back through named replicas' copies; a row made to differ in one copy
   is read by that replica only; replica 0 frozen, replica 1's copy
   serves.
9. values  — the value heap at the same shape (``max_value_bytes=1024``,
   the 8 MiB heap the ref layout allows): 32,768 keys put with
   memcached-shaped byte values, all overwritten once, 4,096 keys a
   batch, which passes the heap's capacity (a pressure GC must run); read back byte-exact; every
   live ref gathered from the device log equal to the mirror; one
   explicit GC.  Writes/s, put, read and device-gather GB/s.
10. durable — a child process (``python -m
   hermes_tpu_torch.wal.crashdrive``) runs a ``KVS`` at the same shape
   with ``wal_sync="commit"`` and a WAL under a temporary directory: waves
   of 131,072 distinct-key puts through ``submit_batch``, the committed
   uids and values written to a witness after each; in the fifth wave,
   once a log batch of its first half is durable, it submits the second
   half, steps once and SIGKILLs itself.  The parent
   requires death by signal 9 and the card's memory back, recovers the
   store with ``chaos.recover_store(device="cuda")`` in under 90 s, and
   holds it to the witness and the log (no committed write lost, every
   key reads its newest logged value, which is the witness's unless the
   killed wave's own write survived).  Then waves with the WAL on (the
   recovered store) and off (a fresh one), in turns on off off on.
11. restart — ``chaos.restart_replica`` of replica 3 from a snapshot and
   the WAL tail, with ops in flight on it: they resolve ``lost``, the
   table equals the donor's, the restarted replica commits and the
   checker passes.
12. observed — an ``Observability`` run log with per-step spans,
   ``trace_sample=64``, ``op_timeout_rounds=8`` and ``op_retry_limit=2``:
   16 puts wedged on frozen replica 7 give one ``stuck_op`` event each and
   a flight archive, are retried on a healthy replica and resolve after
   ``remove(7)``; the checker passes and the log's ``t`` never decreases.
   Traced against untraced waves in turns.
13. chaos   — bench-a at pipeline depth 2, recorded, the failure detector
   attached (``MembershipService(confirm_steps=2)``), through the
   declarative ``CHAOS_SCHEDULE`` for 64 rounds (freezes and thaws, a
   heartbeat skew, two crash-restarts, a remove and a join, a partition
   the detector acts on, a heal), healed and quiesced: the executed log
   holds every verb and a detector removal, the checker passes, every key
   is VALID, the device op counters equal the recorded completions (a
   crash's maybe_w rows at most its lost ops), no ``membership_fetch``
   event, each kernel's launches equal the rounds.  chaos-sharded-mega:
   the same on the sharded engine with ``mega_round=True``, each join's
   copy held against its donor's (equal but for the folded states).
14. detect-cost — bench-a at depth 2 with completions harvested, without
   and with the detector, 30-round windows in turns off on on off: host
   us/round and a profiled window's busy share of each.
15. drill   — ``elastic.run_rolling_restart`` on bench-a at depth 2,
   recorded, a restart every 3 rounds (31 rounds): 8 restarts, each
   restart's seconds, the dip and the lost ops; quiesced, checked.
16. resize  — ``elastic.rolling_resize`` (``hold_steps=8``) on a KVS at the
   reads shape with ``RESIZE_SESSIONS`` sessions a replica under the
   reference CLI's standing load: 8 resizes, puts to retired replicas
   ``rejected``, the load completes; then degraded mode
   (``min_healthy_for_writes=5``, four replicas frozen): every write of a
   mixed batch shed, every get answered, writes commit after the thaw,
   ``degraded`` then ``degraded_clear`` traced; the checker passes.
17. migrate — ``elastic.migration_drill`` at the KVS bench shape (two
   recorded stores, a seed load of R x S ops and a standing mix of 8 x R
   x S, the middle third of the keys moved under the mix): each stage's host
   seconds (fence, drain with its rounds, snapshot, transfer, restore,
   flip), the rows moved, the ops rejected at the fence, salvaged,
   rejected and lost; the destination's reads at lo, the midpoint and
   hi-1 equal the source's rows, a source get at lo ``rejected``, both
   checkers green.  Then the same move on the sharded engine (8 copies)
   with replica 1 of the source frozen across it: every destination copy
   equal to copy 0 over the range, every replica's read the source's.
18. fleet — ``fleet.Fleet`` of four groups at the KVS bench shape (4 x
   2^20 fleet keys; group 3 on the mega round, with 65,536 spare slots):
   a 262,144-op mix, ``Fleet.migrate`` of 65,536 keys from group 0 to
   group 3 under a standing batch, a seeded ``fleet_schedules`` run of 64
   rounds crashing replicas of groups 0 and 2 only, every group's checker
   and ``verify_fleet``, a save/load round trip; then ``run_fleet_cells``
   (per-group and concurrent writes/s; on one card the summed per-group
   rate is no capacity and is printed under a name that says so).
   Every KVS phase holds ``stats_block``'s launches equal to its rounds
   (the migrate and fleet phases each store's or group's own, and group
   3's mega kernels equal to its rounds and replay-scan rounds).
19. phases — the reference phases engine (``runtime.Runtime``,
   ``core/phases.py``) at BASELINE configs 1 and 3 at full width
   (``baseline_cfg``: 3 and 7 replicas, 2^20 keys, 1,024 sessions, 128
   ops, YCSB-A uniform and Zipfian 0.99): recorded and drained, checked,
   the device op counters equal to the recorded completions, every key
   VALID and equal across replicas; an unrecorded runtime over as many
   rounds (host us a round ending in a sync, its final state equal to the
   recorded one's); rounds under ``torch.cuda.set_sync_debug_mode
   ("error")`` (no host sync inside a round); a profiled window (device
   us and CUDA kernels a round, busy share); peak memory.
   The phases round is compiled (``core/step.py``'s builders: a CUDA
   graph a round after its second call).  phases-graph (run first): for
   config 1 and config 3 batched and config 1 sharded (a ``LocalGroup``),
   a graphed runtime and one whose round runs under ``Compiled.eager()``
   driven together through a freeze, a thaw, a remove and a join, every
   state leaf and completion column equal every round; then each one's
   host us a round (a window ending in a sync), device us a round (the
   rounds queued behind a spin kernel, CUDA events), busy share and host
   launch calls of one round (graphed: one replay by the compiled round's
   own count, at most ``PHASES_LAUNCH_CALLS`` host launch calls);
   and the compiled chunks (``build_step_scan``,
   ``build_step_sharded_scan``) equal to the graphed round loop.
20. phases-sharded — config 1 on ``Runtime(backend="sharded")`` over a
   ``LocalGroup`` on the card, equal to the batched backend after each of
   32 rounds and on the round it drained; checked, converged.
21. sim-wire — config 1 on ``Runtime(backend="sim")`` over
   ``chaos.net.FaultingTransport(SimTransport(3))``: the wire matrix
   (drop, delay, duplicate, reorder, corrupt under the frame CRC) and a
   partition of replica 1's outbound side healed at round 40, drained and
   checked, nothing applied past the CRC; then a seeded ``ChaosRunner``
   schedule with wire verbs through ``wire=``, the detector attached.
22. tcp — config 1 as three processes of ``python -m
   hermes_tpu_torch.distributed`` sharing the card over loopback TCP,
   checked, tables equal, every session done, no clean frame dropped;
   again under corrupt and drop windows, every corrupted frame dropped by
   the CRC.  Each rank's rounds/s, the run's seconds.
   The CPU port runs configs 1 (drained) and 3 (to round 256) and both
   sim-wire drives in a child process beside these phases
   (``cpu_reference``); ``phases-cpu`` holds the card's states, fault
   logs and executed chaos log to it byte for byte.  No hand kernel
   launches across phases 19-22 (their counters must not move).
23. serve — the serving front end (``serving.Frontend``) over a recorded
   ``KVS`` at the reads shape: ``run_open_loop`` of 4,000 requests at
   24 a virtual round, deadlines of 4 rounds, an envelope the load
   overruns (the store takes 32 ops at a time) and
   ``Schedule.overload_storm`` through ``ChaosRunner(load=arrivals)``,
   twice: ``verify_serving``, the checker, the ops handed to the store =
   the device op counters = the recorded completions, refusals,
   deadlines and commits all present, one response log between the two
   runs; the same drive at a small shape on the card and on the CPU
   port: one response log.  Inside, any host sync with the card outside
   the store's rounds raises (``frontend_sync_free``).
24. serve-columnar, serve-columnar-mega — ``run_columnar_soak`` of 2^21
   ops at the reads shape, unrecorded, 393,216 arrivals a round (the
   lane budget), fused and with ``mega_round=True``: every request
   answered ok, ops/s and host us a round, the lanes holding an op each
   round, each kernel launched once a round (``mega_replay`` on the
   replay-scan rounds); then a soak of two rounds of arrivals over a
   fresh store traced by ``torch.profiler``: device us and CUDA kernels
   a round, the card's busy and idle shares.
25. serve-socket — ``serving.bench.run_serve_bench``'s capacity probe
   (100 requests), latency (400, open loop) and throughput (800)
   points through a localhost ``TcpRpcServer``
   at ``host_cfg(mode, on_card=True)``: client-socket p50/p99 and ops/s,
   every request answered, no cell with an error.
26. serve-one-store — first the host (``serve-host``: SO_REUSEPORT on
   two listeners, the size of /dev/shm), then ``run_one_store_cell``:
   two torch-free shm front-end processes feeding one store on the card,
   four client processes: every row answered once (rows in = rows out =
   rows sent, requests = responses), ops/s.
   serve-fleet — a two-group ``fleet.Fleet`` at the reads shape (each
   group a recorded store) behind ``Frontend``, driven as the serve phase
   drives one store (4,000 open-loop requests under the overload storm,
   its envelope, a ``ChaosRunner`` over group 0 carrying the storm): the
   mix spans both groups, ``verify_serving`` and ``verify_fleet``, every
   group's checker, ``committed_write_lost == []`` against the uids the
   client saw, the ops handed to the fleet = the groups' device op
   counters = their recorded completions; the same drive at a small
   shape on the card and on the CPU port: one response log.
   serve-workers — ``run_columnar_worker_cell`` at 1, 2 and 4 worker
   processes (each a private store on the card), the columnar loopback
   cell (``measure_columnar_floor``) and ``run_one_store_cell`` at 4 shm
   workers: every row answered, no cell with an error, the topology
   labels; each cell's ops/s beside the card.
   Each serving phase holds ``stats_block``'s launches equal to its
   store rounds; the kernels line carries them as ``serve_launches``,
   ``serve_columnar_launches`` (and B2-B4's of the mega run),
   ``serve_socket_launches``, ``serve_one_store_launches``,
   ``serve_fleet_launches`` and ``serve_workers_launches`` (this
   process's stores only: the worker processes count their own).
27. census (run right after the build, first of all phases: torch.profiler
   keeps fewer of a round's device records the older the process is —
   787 fresh, 736 after the whole smoke, while the host's 777 launch
   calls and 844 aten ops stay the same) —
   ``obs.profile.measure`` at the bench shape: one round 0 (a
   replay-scan round) of bench-a, bench-a-mega, sharded and sharded-mega
   on a fresh state, counted under a ``TorchDispatchMode`` (aten ops,
   sparse ops, the group's collectives, each hand-kernel call as one op)
   and traced by torch.profiler (``kernel_total``, two agreeing traces),
   and the read and heap censuses: every field held to
   ``hermes_tpu_torch/obs/op_budget.json`` (its ``card`` section for
   ``kernel_total``), the aten census equal to the CPU port's at the
   gate's cut shape.
28. acceptance — BASELINE configs 1, 2, 2r, 3, 3c, 4 and 5 through
   ``acceptance.run_config`` at scale 1.0 (2^20 keys, 1,024 sessions, 128
   ops, recorded, ``check_keys=512``): each drained and checked, config
   4's stall detected, ``stats_block`` launched once a round and no mega
   kernel; seconds, rounds and counters of each.  Then configs 1-5 at
   scale 0.01 on the card and on the CPU port: equal counters and rounds.
29. graft — ``probe.probe_backend`` (a child process makes a CUDA context
   under a bound), then ``graft.entry()``'s round on the card and on the
   CPU port from the same inputs: every state leaf and completion column
   equal, the hand kernels launched as often as the CPU run called them.
30. locklint (run right after the serving phases) — the socket serving
   drives under ``HERMES_LOCKLINT=1``, every lock an ObsLock, at the
   serving phases' shapes on the card: the serve-socket phase's
   throughput cell (a ``TcpRpcServer``, 8 replicas, 2^20 keys x 4,096
   sessions, 400 closed-loop requests), then the serve-columnar
   phase's store (8 x 65,536 sessions) behind a ``ColumnarTcpServer``
   (``analysis.hostlint.leg_soak``: 2 batches of 393,216 requests over
   TCP); half the depth of the serving phases' own drives of the same
   cell and store.  Each: every request answered, no lock-order cycle, every
   lock's hold p99 within 10 mean store rounds of its drive.
   The kernels line carries ``census_calls``, ``acceptance_launches``,
   ``graft_launches`` and ``locklint_launches``.
31. analysis (run after every profiled phase: it needs no profiler) —
   the static round analysis (``hermes_tpu_torch.analysis``): the
   ``analysis`` gate's four configs (default, bench, bench-rmw,
   bench-mega at the bench shape) on both
   engines, fused and split, traced with fake tensors on the card's
   device: no error or warn finding, every finding at a port
   ``file:line``, the seven audit tags present, the four hand kernels each
   one node in the mega programs and ``stats_block`` in every program,
   every program's nodes and finding keys equal to the CPU port's; each
   program's nodes and seconds.  Then ``python -m hermes_tpu_torch
   --analyze FILE`` (``cli.main`` in this process) at bench-a-mega's shape
   for 8 rounds: the findings file clean and the run's launches those of
   its rounds (the kernels line's ``analysis_launches``).

32. gates (run last, after the analysis: run right after the census, its
   processes left this one's torch.profiler keeping 7 records of 20
   launches in the kernels phase) — the nine gates of
   ``hermes_tpu_torch/checks/`` (``obs-overhead``, ``pipeline``,
   ``chaos``, ``elastic``, ``netchaos``, ``fleet``, ``serving``, ``heap``,
   ``durability``) through ``python -m hermes_tpu_torch.gates --device
   cuda --only ...`` in a process of their own at the JAX package's gate
   shapes: every gate ``ok`` on ``cuda``, ``stats_block`` launched in
   each, the three mega kernels in the heap gate's census rounds; each
   gate's seconds and launches, and the gates' tracked cells: the
   columnar floor (at least 50 x the pinned 351.8 ops/s scalar cell, the
   port's own scalar cell beside it), the one-store floor (at least 2 x
   the loopback cell) and the fleet's ``scaleout_x`` (at least 3).  Then
   the obs-overhead timing at the bench shape (``checks.obs_overhead
   --shape bench --chunks 1 --reps 5``, 20 rounds a run): phase metrics
   on against off, record-only, its
   ratio, medians and per-rep samples beside the card.  The kernels line
   carries ``gates_launches`` (the nine gates' sum).

Then the whole smoke's seconds, the kernels summary line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Without a
card, or without the package beside it, the script exits non-zero before
any phase.

    python3 chip_smoke.py --kernels mega_route,scan_acc

runs the device, build and kernels phases for the named kernels alone,
prints their summary line and the card, and no result line.

    python3 chip_smoke.py --kernels stats_block,mega_apply --root DIR

does the same for the ``hermes_tpu_torch`` of another checkout in DIR
(say the parent commit's, unpacked with ``git archive``), so that two
designs of a kernel are timed in one call on the same inputs; the
one-operation rule is this checkout's and is not held there.

    python3 chip_smoke.py --census-each FILE

runs the whole smoke and, after every phase, traces one bench-a round on
a fresh state (two agreeing traces) and counts its aten ops: a
``census-each`` line with its CUDA kernels, the host's launch calls and
the aten ops, and in FILE (JSONL) the kernels and calls by name beside
the process's global torch settings, to find a phase after which a
round launches, or a trace keeps, other kernels.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32 rate
# outside the tensor cores, the table's nearest figure for scalar
# integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# kernel shapes: the bench shape first (bench-a with mega_round: R=8,
# S=65,536, L=65,792, C=49,152, K=2^20, 256 replay slots, 8 value words),
# then the reference's kernel cells (analysis/diffcheck.py) and ragged ones
BENCH_INDEX = 0
STATS_SHAPES = ((8, 65536), (4, 512), (1024, 600), (512, 2000),
                (2, 40000))  # R, S
# R, L, C; the last row (7.3 MB) needs several passes of mega_route's
# windows
ROUTE_SHAPES = ((8, 65792, 49152), (2, 6, 6), (3, 1001, 700),
                (2, 1 << 20, 786432))
ROUTE_CLUSTERS = (16, 8)  # the cluster sizes mega_route is timed at
APPLY_SHAPES = ((1 << 20, 8 * 65792), (16, 16), (100003, 77777))  # K, N
REPLAY_SHAPES = ((1 << 20, 8, 256, 8, 4096),  # K, R, RS, V, stuck rows
                 (16, 2, 2, 2, 6), (22, 2, 2, 2, 9), (5003, 3, 7, 3, 300),
                 (2500, 2, 2, 2, 40))  # the matrix's three ragged blocks
REPLAY_STEP, REPLAY_AGE = 1000, 16
# K table rows, M messages: the bench table and lanes, the probe's cell,
# almost all duplicates, ragged (with keys outside [0, K))
PROBE_SHAPES = ((1 << 20, 49152), (4096, 4096), (8, 256), (1000, 777))
PROBE_OUT_OF_RANGE = 3  # the index of the shape with keys outside [0, K)
# the analysis kernels: the fixture's shape first (what the kernel matrix
# and the red tests give them), then a larger, ragged one; fx_async_copy
# also at 4.1 MB (a partial last tile), fx_loop_inc, fx_pack and
# fx_store_at at 91 words (their word paths), fx_acc_revisit at 4 MB (a
# cluster, int4 loads) and with C = 1,001 (its word path), fx_serial_scan
# at the probe's bench table (40 MB), fx_pack at 96 MB moved and
# fx_store_at at a 64 MB output (past the 50 MB L2)
SCAN_ACC_SHAPES = ((16, 8), (4096, 256), (4097, 257), (65536, 8))  # M, W
# the kernels whose call must enqueue exactly one device operation: all
# fourteen (probe_serial after its first call on a stream, which fills its
# winner column: the kernels phase makes that call before it counts)
ONE_OPERATION = ("stats_block", "mega_route", "mega_apply", "mega_replay",
                 "probe_serial", "probe_vgather", "scan_acc", "fx_pack",
                 "fx_store_at", "fx_acc_revisit", "fx_block_copy",
                 "fx_serial_scan", "fx_async_copy", "fx_loop_inc")
FX_SHAPES = {  # rows, columns (fx_serial_scan: K, M; W = 10)
    "fx_pack": ((8, 128), (1000, 77), (7, 13), (8192, 1024)),
    "fx_store_at": ((8, 128), (64, 10), (7, 13), (1 << 20, 16)),
    "fx_acc_revisit": ((8, 256), (20, 1000), (32, 32768), (7, 1001)),
    "fx_block_copy": ((8, 256), (5, 1000)),
    "fx_serial_scan": ((64, 32), (1000, 777), (1 << 20, 49152)),
    "fx_async_copy": ((8, 128), (64, 1024), (1000, 1028)),
    "fx_loop_inc": ((8, 128), (1000, 77), (7, 13)),
}
FX_W = 10


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started (the smoke's time by phase)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, samples=25, inner=10):
    """Median over ``samples`` of the CUDA-event time of ``inner`` calls,
    per call, in ms (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def queued_ms(torch, fn, label, inner=20, spin_cycles=1 << 24, tries=4):
    """The device time of a call in ms with the host out of the way
    (``profiling.queued_s``: ``inner`` calls enqueued behind a spin kernel
    that outlasts their enqueueing, timed between two CUDA events; the
    spin four times longer at each of ``tries``).  For wrappers whose
    host work outlasts their kernel, where ``cuda_ms`` measures the host.
    None (not measured, said on stderr) for a call that cannot be queued
    (it waits on the device, or enqueues slower than the longest spin)."""
    from hermes_tpu_torch.profiling import queued_s

    got = queued_s(fn, inner, spin_cycles, tries)
    if got is None:
        print("chip_smoke: a call could not be queued behind the spin "
              f"kernel ({label}): queued time not measured", file=sys.stderr)
        return None
    return got * 1e3


def _us(ms):
    return None if ms is None else ms * 1e3


def stats_inputs(torch, R, S, seed):
    g = torch.Generator().manual_seed(seed)
    op = torch.randint(0, 4, (R, S), generator=g, dtype=torch.int32)
    invoke = torch.randint(0, 90, (R, S), generator=g, dtype=torch.int32)
    commit = torch.rand((R, S), generator=g) < 0.3
    abort = (torch.rand((R, S), generator=g) < 0.05) & ~commit
    read = (torch.rand((R, S), generator=g) < 0.3) & ~commit & ~abort
    step = torch.tensor(77, dtype=torch.int32)
    return step, op, invoke, commit, abort, read


def route_inputs(torch, R, L, seed):
    """si and srank: a permutation of each row (the sort's lane order and
    the slot ranks); word: verdict words."""
    g = torch.Generator().manual_seed(seed)
    si = torch.argsort(torch.rand((R, L), generator=g), dim=1).to(torch.int32)
    srank = torch.argsort(torch.rand((R, L), generator=g), dim=1).to(
        torch.int32)
    word = torch.randint(0, 1 << 22, (R, L), generator=g, dtype=torch.int32)
    return si, word, srank


def apply_inputs(torch, K, N, seed):
    """Lane keys over the column, a few outside it (negative, K and past
    it), packed timestamps, three quarters of the rows masked in."""
    g = torch.Generator().manual_seed(seed)
    vpts = torch.randint(0, 1 << 24, (K,), generator=g, dtype=torch.int32)
    keys = torch.randint(0, K, (N,), generator=g, dtype=torch.int32)
    keys[:4] = torch.tensor([-1, K, K + 5, (1 << 29) - 1])
    pts = torch.randint(0, 1 << 25, (N,), generator=g, dtype=torch.int32)
    mask = torch.rand((N,), generator=g) < 0.75
    return vpts, keys, pts, mask


def replay_inputs(torch, fst, K, R, RS, V, n_stuck, seed):
    """A bank of K rows, VALID but for ``n_stuck`` aged rows in state
    INVALID, TRANS or REPLAY scattered over the key range and as many
    young ones; replay slots 40 % active but replica 0's first, replica 1
    frozen and, with 3 or more replicas, the last one without a free
    slot."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31, (K, 2 + V), generator=g,
                          dtype=torch.int64).to(torch.int32)
    state = torch.zeros((K,), dtype=torch.int32)
    sst_step = torch.full((K,), REPLAY_STEP, dtype=torch.int32)
    rows = torch.randperm(K, generator=g)
    aged, young = rows[:n_stuck], rows[n_stuck:2 * n_stuck]
    pick = torch.tensor([1, 3, 4], dtype=torch.int32)  # INVALID TRANS REPLAY
    for part, lo, hi in ((aged, 0, REPLAY_STEP - REPLAY_AGE),
                         (young, REPLAY_STEP - REPLAY_AGE, REPLAY_STEP + 1)):
        state[part] = pick[torch.randint(0, 3, (len(part),), generator=g)]
        sst_step[part] = torch.randint(lo, hi, (len(part),), generator=g,
                                       dtype=torch.int32)
    words[:, 1] = (sst_step << 3) | state
    active = torch.rand((R, RS), generator=g) < 0.4
    active[0, 0] = False  # replica 0 takes at least one candidate
    if R >= 3:
        active[R - 1] = True
    frozen = torch.zeros((R,), dtype=torch.bool)
    frozen[1 % R] = True
    replay = fst.FastReplay(
        active=active,
        key=torch.randint(0, K, (R, RS), generator=g, dtype=torch.int32),
        pts=torch.randint(0, 1 << 24, (R, RS), generator=g,
                          dtype=torch.int32),
        val=torch.randint(-128, 128, (R, RS, 4 * V), generator=g,
                          dtype=torch.int8),
        acks=torch.randint(0, 1 << R, (R, RS), generator=g,
                           dtype=torch.int32))
    vpts = torch.randint(0, 1 << 24, (K,), generator=g, dtype=torch.int32)
    step = torch.tensor(REPLAY_STEP, dtype=torch.int32)
    return step, frozen, vpts, fst._i32_to_bank(words), replay


def probe_inputs(torch, K, M, W, seed, out_of_range):
    """A (K, W) table, M keys in [0, K) (with ``out_of_range`` also -1,
    K, K+5, -K-3 and the int32 extremes) and M rows, all int32."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randint(-(1 << 31), 1 << 31, (K, W), generator=g,
                          dtype=torch.int64).to(torch.int32)
    keys = torch.randint(0, K, (M,), generator=g, dtype=torch.int32)
    if out_of_range:
        keys[:6] = torch.tensor([-1, K, K + 5, -K - 3, -(1 << 31),
                                 (1 << 31) - 1])
    rows = torch.randint(-(1 << 31), 1 << 31, (M, W), generator=g,
                         dtype=torch.int64).to(torch.int32)
    return table, keys, rows


def mega_cfg(config, R, K=16, L=6, RS=2, V=2, C=None):
    """A mega_round config with R replicas, K keys, L lanes of which RS
    replay slots, V value words and lane budget C."""
    return config.HermesConfig(
        n_replicas=R, n_keys=K, n_sessions=L - RS, replay_slots=RS,
        value_words=V, ops_per_session=4, lane_budget_cfg=C,
        arb_mode="sort", mega_round=True, replay_age=REPLAY_AGE)


def bound(nbytes, ops):
    """The least time in us for ``nbytes`` moved and ``ops`` scalar
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return dict(bound_us=max(t_bytes, t_ops) * 1e6,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def stats_case(torch, port, shape, seed):
    """stats_block: each input read once (2 int32 + 3 bool per lane, the
    step), each output written once (the int32 code per lane, the counter
    and histogram rows); ~10 scalar ops per lane."""
    R, S = shape
    nbytes = R * S * (4 + 4 + 1 + 1 + 1) + 4 + R * S * 4 + R * (8 + 64) * 4
    return (stats_inputs(torch, R, S, seed=R * 7919 + S), None,
            dict(R=R, S=S, **bound(nbytes, 10 * R * S)))


def route_case(torch, port, shape, seed):
    """mega_route: si, word and srank read, lane_word and slot_lane
    written; a few operations per lane."""
    R, L, C = shape
    cfg = mega_cfg(port.config, R, L=L, C=C)
    args = (cfg, *route_inputs(torch, R, L, seed))
    nbytes = 3 * 4 * R * L + 4 * R * L + 4 * R * C
    return args, None, dict(R=R, L=L, C=C, **bound(nbytes, 6 * R * L))


def apply_case(torch, port, shape, seed):
    """mega_apply: keys, pts (int32) and mask (bool) read, the vpts column
    read and written once, post written; a few operations per row."""
    K, N = shape
    args = (mega_cfg(port.config, 2), *apply_inputs(torch, K, N, seed))
    nbytes = N * (4 + 4 + 1) + 2 * 4 * K + 4 * N
    return args, None, dict(K=K, N=N, **bound(nbytes, 6 * N))


def replay_case(torch, port, shape, seed):
    """mega_replay, held bit-exact at replay_age 16.  The timed calls run
    at replay_age -1, which counts every INVALID, TRANS or REPLAY row as
    stuck, so a call's REPLAY marks leave the stuck set, and each later
    call's work, as it was.  The least bytes of a timed call: every row's
    4-byte sst word; the slot leaves read and written (active, key, pts,
    acks, value bytes); each candidate's vpts and value bytes read and its
    sst written; a few operations per row.  ``sector_bound_us``: the
    32-byte sector each row's sst read costs in the 40-byte bank row."""
    K, R, RS, V, n_stuck = shape
    cfg = mega_cfg(port.config, R, K=K, L=RS + 4, RS=RS, V=V)
    args = (cfg, *replay_inputs(torch, port.fst, K, R, RS, V, n_stuck, seed))
    timing = (dataclasses.replace(cfg, replay_age=-1),) + args[1:]
    replay = args[5]
    active = port.mega.mega_replay_plain(*_to(torch, args, "cpu"))[1][0]
    n_cand = min(2 * n_stuck, RS)  # the timed calls' stuck rows
    nbytes = (4 * K + 2 * R * RS * (1 + 4 + 4 + 4 + 4 * V)
              + n_cand * (4 + 4 * V + 4) + R + 4)
    info = dict(K=K, R=R, RS=RS, V=V, stuck_rows=n_stuck,
                slots_taken=int((active & ~replay.active).sum()),
                sector_bound_us=32 * K / HBM_BYTES_PER_S * 1e6,
                **bound(nbytes, 8 * K))
    if info["slots_taken"] == 0:
        raise AssertionError(f"mega_replay takes no slot at {shape}")
    return args, timing, info


def _probe_case(torch, port, shape, seed):
    """Inputs of a probe kernel at (K, M), the table's W and the number D
    of distinct rows the keys land on."""
    K, M = shape
    W = port.probe.W
    outside = shape == PROBE_SHAPES[PROBE_OUT_OF_RANGE]
    table, keys, rows = probe_inputs(torch, K, M, W, seed, outside)
    D = len(port.pk.row_index(keys, K).unique())
    return table, keys, rows, W, dict(K=K, M=M, distinct_rows=D,
                                      keys_out_of_range=outside)


def serial_case(torch, port, shape, seed):
    """probe_serial: every key read; only the last message on each of the
    D distinct rows decides it, so D rows read and D rows written; a few
    operations per word."""
    table, keys, rows, W, info = _probe_case(torch, port, shape, seed)
    M, D = info["M"], info["distinct_rows"]
    info.update(bound(4 * M + 2 * 4 * D * W, 4 * M * W))
    return (table, keys, rows), None, info


def vgather_case(torch, port, shape, seed):
    """probe_vgather: every key read and every output row written; each
    of the D distinct table rows read once; a few operations per word."""
    table, keys, _rows, W, info = _probe_case(torch, port, shape, seed)
    M, D = info["M"], info["distinct_rows"]
    info.update(bound(4 * M + 4 * M * W + 4 * D * W, 3 * M * W))
    return (keys, table), None, info


def _i32(torch, g, shape, lo, hi):
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(
        torch.int32)


def scan_acc_case(torch, port, shape, seed):
    """scan_acc: every element read, every column sum written; one add
    an element."""
    M, W = shape
    g = torch.Generator().manual_seed(seed)
    x = _i32(torch, g, (M, W), 0, 101)
    return (x,), None, dict(M=M, W=W, **bound(4 * M * W + 4 * W, M * W))


def fx_case(name):
    """The case maker of one analysis fixture: inputs in bounds at
    (rows, columns) (``fx_serial_scan``: K table rows, M messages), and
    the least bytes (each input read once, each output written once) and
    operations."""
    def case(torch, port, shape, seed):
        r, c = shape
        n = r * c
        g = torch.Generator().manual_seed(seed)
        if name == "fx_serial_scan":  # keys read; winners' rows moved
            K, M = shape
            keys = _i32(torch, g, (M,), 0, K)
            args = (_i32(torch, g, (K, FX_W), -(1 << 31), 1 << 31), keys,
                    _i32(torch, g, (M, FX_W), -(1 << 31), 1 << 31))
            D = len(keys.unique())
            return args, None, dict(rows=K, cols=M, **bound(
                4 * M + 8 * D * FX_W, 4 * M * FX_W))
        x = _i32(torch, g, (r, c), 0, 4)
        if name == "fx_pack":
            args = (_i32(torch, g, (r, c), 0, 3),
                    _i32(torch, g, (r, c), 0, 1 << 29))
            cost = bound(12 * n, 2 * n)
        elif name == "fx_store_at":  # index, row 0 of v read; out written
            args = (torch.tensor([[r - 1]], dtype=torch.int32), x)
            cost = bound(4 + 4 * c + 4 * n, n)
        elif name == "fx_acc_revisit":
            args = (x, True)
            cost = bound(4 * n + 4 * r, n)
        elif name == "fx_block_copy":
            args = (x, 0)
            cost = bound(8 * n, n)
        elif name == "fx_async_copy":
            args = (x,)
            cost = bound(8 * n, n)
        else:  # fx_loop_inc: x is not read
            args = (x, 10)
            cost = bound(4 * n, 10 * n)
        return args, None, dict(rows=r, cols=c, **cost)
    return case


def route_library(cfg, si, word, srank):
    """The fused round's own route-back (``core/faststep.py``): one
    ``scatter_reduce_(..., "amax")`` of the words and lane ids into the
    prepared (R, L + C + 1) target (made before the timed calls).  A
    yardstick of time only: on repeated targets it keeps the max."""
    import torch

    R, L = si.shape
    C = cfg.lane_budget
    tgt = torch.cat([si, torch.where(srank < C, L + srank, L + C)],
                    dim=1).long()
    vals = torch.cat([word, si], dim=1)
    flat = torch.zeros((R, L + C + 1), dtype=torch.int32, device=si.device)
    return lambda: flat.scatter_reduce_(1, tgt, vals, "amax")


def round_srank(torch, R, L, seed):
    """Slot ranks shaped as the fused round makes them
    (``core/faststep.py``): the slot-eligible positions (three quarters
    here) ranked 0, 1, ... in order, the others after them in order; a
    bijection onto [0, L) whose stores run in order, unlike a random
    permutation's."""
    g = torch.Generator().manual_seed(seed)
    elig = torch.rand((R, L), generator=g) < 0.75
    cum = torch.cumsum(elig.to(torch.int32), 1, dtype=torch.int32)
    pos = torch.arange(L, dtype=torch.int32)
    return torch.where(elig, cum - 1, cum[:, -1:] + pos - cum)


def route_cluster_us(torch, port, shape, seed):
    """``mega_route`` at ``shape`` with clusters of each of
    ``ROUTE_CLUSTERS``, on the kernels phase's inputs and on slot ranks
    shaped as the round's (``round_srank``): exact against the plain
    version, and the device time of a call (queued, ``device_us``) and
    its device operations (``profiling.graph_ops``).  The module's own
    setting is restored after."""
    from hermes_tpu_torch.profiling import graph_ops

    mega = port.mega
    args, _t, _info = route_case(torch, port, shape, seed)
    inputs = {"permutation": args,
              "round": (*args[:3], round_srank(torch, shape[0], shape[1],
                                               seed))}
    keep, out = mega.ROUTE_CLUSTER, {}
    try:
        for q in ROUTE_CLUSTERS:
            mega.ROUTE_CLUSTER = q
            row = dict(plan=list(mega.route_plan(*shape, cluster=q)))
            for kind, call_args in inputs.items():
                want = _flat(mega.mega_route_plain(*_to(torch, call_args,
                                                        "cpu")))
                dev_args = _to(torch, call_args, "cuda")
                got = _flat(mega.mega_route(*dev_args))
                if not all(torch.equal(g.cpu(), w)
                           for w, g in zip(want, got)):
                    raise AssertionError(f"mega_route with clusters of {q} "
                                         "disagrees with its plain version")
                call = lambda: mega.mega_route(*dev_args)
                us, how = device_us(torch, call, "mega_route clusters")
                row[kind] = dict(device_us=us, timed_by=how,
                                 device_launches=graph_ops(call)["total"])
            out[str(q)] = row
    finally:
        mega.ROUTE_CLUSTER = keep
    out["default_plan"] = list(mega.route_plan(*shape))
    return out


ROUND_WARMUP = 6  # bench-a-mega rounds before the one whose inputs are kept
REPLAY_ROUND = 32  # the replay-scan round whose mega_replay inputs are kept
# checked-mega: replica 1 frozen from this round until after REPLAY_ROUND
CHECKED_FREEZE_AT = 8


def _kept_args(torch, calls, rt, run, device):
    """The arguments each wrapper of ``calls`` ((module, name) pairs) gets
    while ``run()`` runs ``rt``'s round, as copies made on the stream
    before the call (before any in-place update).  The round runs
    eagerly (``rt._step.eager()``): a graph replay calls no wrapper."""
    got = {}

    def keep(module, name):
        fn = getattr(module, name)

        def call(*args):
            got[name] = _to(torch, args, device)
            return fn(*args)
        call.launches = 0  # the wrapper counts on its module's name
        return fn, call

    saved = [(m, name, *keep(m, name)) for m, name in calls]
    try:
        for m, name, _fn, call in saved:
            setattr(m, name, call)
        with rt._step.eager():
            run()
    finally:
        for m, name, fn, call in saved:
            setattr(m, name, fn)
            fn.launches += call.launches
    return got


def round_inputs(torch, port, replay=True, device="cuda"):
    """The arguments the round kernels get in real rounds on the card,
    ``{name: {label: args}}``: ``stats_block`` and ``mega_apply`` in one
    round of bench-a-mega (after ``ROUND_WARMUP`` rounds), labelled
    ``round``; with ``replay``, ``mega_replay`` in its replay-scan round
    ``REPLAY_ROUND`` of the same run (``round``) and of the checked-mega
    phase's drive (``round_frozen``: the recorder on, replica 1 frozen
    from round 8, so that the scan takes slots).  The mega round gives the
    fused round's state and completions every round (the CPU tests hold
    that), so ``stats_block``'s inputs are also bench-a's."""
    kernels, mega = port.kernels, port.mega
    cfg = port.config.bench_cfg("a", over=dict(mega_round=True))
    rt = port.FastRuntime(cfg, device=device)
    rt.fetch_completions = False
    rt.run(ROUND_WARMUP)
    got = {name: {"round": args} for name, args in _kept_args(
        torch, ((kernels, "stats_block"), (mega, "mega_apply")), rt,
        lambda: rt.run(1), device).items()}
    if not replay:
        return got
    rt.run(REPLAY_ROUND - rt.step_idx)
    got["mega_replay"] = {"round": _kept_args(
        torch, ((mega, "mega_replay"),), rt, lambda: rt.run(1),
        device)["mega_replay"]}
    del rt
    rt = port.FastRuntime(cfg, record="array", device=device)
    for s in range(REPLAY_ROUND):
        if s == CHECKED_FREEZE_AT:
            rt.freeze(1)
        rt.step_once()
    got["mega_replay"]["round_frozen"] = _kept_args(
        torch, ((mega, "mega_replay"),), rt, rt.step_once,
        device)["mega_replay"]
    return got


def probe_step_inputs(torch, port):
    """What each ``vgather`` step of the probe phase gathers after its
    first: the bench table of ones (``table_probe.candidate_step``) at
    every key 1, the first word of a row of ones masked to [0, K)."""
    K, M = port.probe.BENCH
    return {"probe_inputs": (torch.ones((M,), dtype=torch.int32),
                             torch.ones((K, port.probe.W),
                                        dtype=torch.int32))}


def round_info(torch, port, name, args):
    """What shapes a round's inputs: for ``probe_vgather`` (the probe
    step's, ``probe_step_inputs``) the shape, the distinct rows and the
    bound; for ``stats_block`` the committed
    share and the share of commits in latency bin 0; for ``mega_apply`` the
    masked rows, their distinct keys, and the share of masked rows whose
    key equals the previous row's; for ``mega_replay`` the stuck rows (at
    the round's replay_age, and at -1, which the timed calls take) and the
    slots the scan takes."""
    if name == "probe_vgather":
        keys, table = args
        (K, W), M = table.shape, keys.shape[0]
        D = len(port.pk.row_index(keys, K).unique())
        return dict(K=K, M=M, W=W, distinct_rows=D,
                    **bound(4 * M + 4 * M * W + 4 * D * W, 3 * M * W))
    if name == "mega_replay":
        cfg, step, _frozen, _vpts, bank, replay = _to(torch, args, "cpu")
        sst = port.fst._bank_to_i32(bank[:, 4:8])[:, 0]
        state = sst & 7
        held = ((state == port.types.INVALID) | (state == port.types.TRANS)
                | (state == port.types.REPLAY))
        taken = port.mega.mega_replay_plain(*_to(torch, args, "cpu"))[1][0]
        return dict(K=bank.shape[0], R=replay.active.shape[0],
                    RS=replay.active.shape[1], step=int(step),
                    replay_age=cfg.replay_age,
                    stuck_rows=int((held & (step - (sst >> 3)
                                            > cfg.replay_age)).sum()),
                    stuck_rows_timed=int(held.sum()),
                    frozen_replicas=int(_frozen.sum()),
                    slots_taken=int((taken & ~replay.active).sum()))
    if name == "stats_block":
        step, op, invoke, commit, abort, read = (x.cpu() for x in args)
        lat = (step - invoke)[commit]
        return dict(R=op.shape[0], S=op.shape[1],
                    commit_share=float(commit.float().mean()),
                    bin0_share=float((lat <= 0).float().mean())
                    if lat.numel() else 0.0)
    _cfg, vpts, keys, _pts, mask = args
    k, m = keys.reshape(-1).cpu(), mask.reshape(-1).cpu()
    km = k[m]
    return dict(K=vpts.shape[0], N=k.numel(), masked_rows=int(m.sum()),
                distinct_masked_keys=int(km.unique().numel()),
                masked_key_repeats_previous=float(
                    (km[1:] == km[:-1]).float().mean()) if km.numel() > 1
                else 0.0)


def sum_library(x, *_):
    """``torch.sum`` over the rows: scan_acc's function in one call."""
    return lambda: x.sum(dim=0, keepdim=True, dtype=x.dtype)


def row_sum_library(x, *_):
    """``torch.sum`` over the columns: fx_acc_revisit's function."""
    return lambda: x.sum(dim=1, keepdim=True, dtype=x.dtype)


def full_library(x, times):
    """``full_like``: the constant fx_loop_inc's loop arrives at."""
    return lambda: x.new_full(x.shape, times)


def zeros_library(_idx, v):
    """``zeros_like``: the fill any library route to fx_store_at pays (a
    yardstick of time only: the row is a second call)."""
    import torch

    return lambda: torch.zeros_like(v)


def pack_library(a, b):
    """``bitwise_or(a << 29, b)``: fx_pack's function in two PyTorch calls
    (a yardstick of time only)."""
    import torch

    return lambda: torch.bitwise_or(a << 29, b)


def clone_library(x, *_):
    """``clone``: the copy fx_block_copy (offset 0) and fx_async_copy
    make."""
    return lambda: x.clone()


def serial_library(table, keys, rows):
    """``index_put_`` of the rows at the keys (int64, made before the
    timed calls): the serial scatter but for the order on duplicate keys,
    which it leaves unspecified — a yardstick of time only."""
    k = keys.long()
    return lambda: table.index_put_((k,), rows)


def vgather_library(keys, table):
    """``index_select`` of the table rows at the keys (int64, made before
    the timed calls)."""
    k = keys.long()
    return lambda: table.index_select(0, k)


def _flat(tree):
    if hasattr(tree, "data_ptr"):
        return [tree]
    return [y for x in tree for y in _flat(x)]


def _to(torch, args, dev):
    """Fresh copies of a call's arguments on ``dev`` (tensors, and the
    tensors of a NamedTuple); other arguments as they are."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, copy=True)
        if hasattr(x, "_fields"):
            return type(x)(*(one(y) for y in x))
        return x
    return [one(x) for x in args]


def device_us(torch, fn, label, tries=4):
    """``(us, how)``: the device time of a call, queued behind a spin
    kernel (``queued_ms``: CUDA events, nothing lost, how ``"queued"``),
    or, for a call that cannot be queued (it waits on the device), the
    CUDA-event time on the stream (``cuda_ms``, how ``"stream"``)."""
    ms = queued_ms(torch, fn, label, tries=tries)
    if ms is not None:
        return ms * 1e3, "queued"
    return cuda_ms(torch, fn) * 1e3, "stream"


def device_busy(torch, run, label, rts=()):
    """The host seconds of ``run()`` (``wall_s``) and its device seconds
    (``busy_s``) from CUDA events, nothing from torch.profiler: with the
    runtimes ``rts``, the events their compiled rounds record around each
    replay (``Compiled.timed``: a graph runs without a host gap, so this
    holds for a run that waits on the device), else a second run queued
    behind a spin kernel (``queued_ms``; None if ``run`` cannot be
    queued); ``busy_by`` says which.  Then the CUDA kernels of one more
    run by name from torch.profiler (``launches``, ``top``, ``top_ops``):
    a report, which a trace that loses records shows short."""
    from hermes_tpu_torch import profiling

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        spans = [stack.enter_context(rt._step.timed()) for rt in rts]
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rts:
        busy = sum(a.elapsed_time(b) for sp in spans for a, b in sp) / 1e3
        how = "graph_events"
    else:
        ms = queued_ms(torch, run, label, inner=1)
        busy = None if ms is None else ms / 1e3
        how = "queued"
    tr = profiling._trace(run)
    return dict(wall_s=wall, busy_s=busy, busy_by=how,
                launches=tr["launches"], top=tr["top"], top_ops=tr["top_ops"])


def _per(x, n):
    return None if x is None else x / n


def check_kernel(torch, wrapper, plain, args, label, timing_args=None,
                 library=None):
    """The kernel against its plain version on the same inputs (on the
    CPU and on the card), bit-exact; the device operations one call
    enqueues, counted off a CUDA graph the call is captured into
    (``profiling.graph_ops``: ``device_launches``, ``device_ops`` by
    kind); its times from CUDA events: per call on the stream
    (``call_us``) and queued behind a spin kernel (``device_us``,
    ``device_us``'s ``timed_by``), the same for the plain version.
    ``timing_args`` (default ``args``) are the inputs of the repeated
    timed calls, which must do the same work every call.
    ``library(*card_args)``, if given, returns a call of one PyTorch
    operation computing the same function, timed the same way.  The call
    also runs in the bound-checked build, where its outputs must again be
    the plain version's and no guard may fire, and is timed there (the
    poison fills of its outputs and the report's pointer copy
    included).  No time or count here rests on torch.profiler keeping
    its records."""
    from hermes_tpu_torch.core import dispatch
    from hermes_tpu_torch.profiling import graph_ops

    want = _flat(plain(*_to(torch, args, "cpu")))
    before = wrapper.launches
    got = _flat(wrapper(*_to(torch, args, "cuda")))
    counted = wrapper.launches - before
    plain_dev = _flat(plain(*_to(torch, args, "cuda")))
    torch.cuda.synchronize()
    if counted != 1:
        raise AssertionError(f"one {label} call counted {counted} launches")
    err = 0
    for w, g, p in zip(want, got, plain_dev):
        w64 = w.to(torch.int64)
        err = max(err, int((w64 - g.cpu().to(torch.int64)).abs().max()))
        if not (torch.equal(g.cpu(), w) and torch.equal(p.cpu(), w)):
            raise AssertionError(f"{label} disagrees with its plain version")
    dev_args = _to(torch, timing_args or args, "cuda")
    call = lambda: wrapper(*dev_args)
    plain_call = lambda: plain(*dev_args)
    ops = graph_ops(call)
    k_us, k_how = device_us(torch, call, label)
    # a plain version that syncs is known after two spins
    p_us, p_how = device_us(torch, plain_call, label + " plain", tries=2)
    out = dict(exact=True, max_abs_err=err, counted_launches=counted,
               call_us=cuda_ms(torch, call) * 1e3, device_us=k_us,
               timed_by=k_how, queued_us=k_us if k_how == "queued" else None,
               device_launches=ops["total"], device_ops=ops,
               plain_call_us=cuda_ms(torch, plain_call) * 1e3,
               plain_device_us=p_us, plain_timed_by=p_how)
    if library is not None:
        l_us, l_how = device_us(torch, library(*dev_args), label + " library")
        out.update(library_device_us=l_us, library_timed_by=l_how)
    with dispatch.checked_build() as chk:
        got = _flat(wrapper(*_to(torch, args, "cuda")))
        c_us, c_how = device_us(torch, call, label + " checked")
        out.update(checked_device_us=c_us, checked_timed_by=c_how,
                   checked_call_us=cuda_ms(torch, call) * 1e3)
    if not all(torch.equal(g.cpu(), w) for w, g in zip(want, got)):
        raise AssertionError(f"{label} in the checked build disagrees with "
                             "its plain version")
    if chk.violations:
        raise AssertionError(f"{label}: the guard fired on inputs in "
                             f"bounds: {chk.violations[:2]}")
    return out


def kernel_specs(port):
    """Every kernel the kernels phase times, in its order: name, wrapper,
    plain version, the ``file:line`` it replaces, shapes, case maker, the
    library call of the same function (or None), the csrc source."""
    kernels, mega, pk, fk = port.kernels, port.mega, port.pk, port.fk
    fx_library = {"fx_pack": pack_library,
                  "fx_store_at": zeros_library,
                  "fx_loop_inc": full_library,
                  "fx_acc_revisit": row_sum_library,
                  "fx_block_copy": clone_library,
                  "fx_serial_scan": serial_library,
                  "fx_async_copy": clone_library}
    fixtures = tuple(
        (name, wrapper, plain, replaces,
         SCAN_ACC_SHAPES if name == "scan_acc" else FX_SHAPES[name],
         scan_acc_case if name == "scan_acc" else fx_case(name),
         sum_library if name == "scan_acc" else fx_library.get(name), lib)
        for name, (wrapper, plain, lib, replaces) in fk.KERNELS.items())
    return (
        ("stats_block", kernels.stats_block, kernels.stats_block_plain,
         "hermes_tpu/core/kernels.py:96", STATS_SHAPES, stats_case, None,
         "stats_block"),
        ("mega_route", mega.mega_route, mega.mega_route_plain,
         "hermes_tpu/core/megaround.py:157", ROUTE_SHAPES, route_case,
         route_library, "mega_route"),
        ("mega_apply", mega.mega_apply, mega.mega_apply_plain,
         "hermes_tpu/core/megaround.py:230", APPLY_SHAPES, apply_case, None,
         "mega_apply"),
        ("mega_replay", mega.mega_replay, mega.mega_replay_plain,
         "hermes_tpu/core/megaround.py:363", REPLAY_SHAPES, replay_case,
         None, "mega_replay"),
        ("probe_serial", pk.probe_serial, pk.probe_serial_plain,
         "scripts/pallas_probe.py:162", PROBE_SHAPES, serial_case,
         serial_library, "probe_serial"),
        ("probe_vgather", pk.probe_vgather, pk.probe_vgather_plain,
         "scripts/pallas_probe.py:204", PROBE_SHAPES, vgather_case,
         vgather_library, "probe_vgather")) + fixtures


def phase_kernels(torch, port, only=None, one_op=ONE_OPERATION):
    """Every ported kernel (or those named in ``only``) against its plain
    version at each of its shapes; returns each kernel's row of the
    summary line, its times from its first shape (the bench shape, or the
    fixture's own).  The library call is timed at every shape but the one
    whose keys leave the table, where ``index_put_`` and ``index_select``
    would fault.  ``stats_block`` and ``mega_apply`` are also held and
    timed on the inputs of one real round (``round_inputs``), and
    ``mega_replay`` on those of two replay-scan rounds, timed at
    replay_age -1 as its synthetic draws are; ``probe_vgather`` on the
    probe step's own input (``probe_step_inputs``).  A kernel named in
    ``one_op`` must enqueue one device operation a call."""
    on_round = {"stats_block", "mega_apply", "mega_replay"} & set(
        only or ("stats_block", "mega_apply", "mega_replay"))
    rounds = (round_inputs(torch, port, replay="mega_replay" in on_round)
              if on_round else {})
    if only is None or "probe_vgather" in only:
        rounds["probe_vgather"] = probe_step_inputs(torch, port)
    out = {}
    for k, (name, wrapper, plain, replaces, shapes, case, library,
            lib) in enumerate(kernel_specs(port)):
        if only is not None and name not in only:
            continue
        rows = []
        for i, shape in enumerate(shapes):
            args, timing, info = case(torch, port, shape, seed=10 * k + i)
            row = check_kernel(torch, wrapper, plain, args, name, timing,
                               None if info.get("keys_out_of_range")
                               else library)
            rows.append(dict(info, **row))
        line = {"phase": "kernels", name: rows}
        for label, rargs in rounds.get(name, {}).items():
            timing = None
            if name == "mega_replay":  # a call's marks leave the stuck set
                timing = [dataclasses.replace(rargs[0], replay_age=-1),
                          *rargs[1:]]
            line[label] = dict(round_info(torch, port, name, rargs),
                               **check_kernel(torch, wrapper, plain, rargs,
                                              name, timing))
        held = rows + [line[label] for label in rounds.get(name, {})]
        for row in held:
            if name in one_op and row["device_launches"] != 1:
                raise AssertionError(
                    f"{name} enqueued {row['device_launches']} device "
                    f"operations a call, want 1: {row['device_ops']}")
        if name == "mega_route":
            line["mega_route_clusters"] = route_cluster_us(
                torch, port, shapes[BENCH_INDEX], seed=10 * k)
        emit(line)
        bench = rows[BENCH_INDEX]
        out[name] = dict(
            name=name, route="cuda",
            source=f"hermes_tpu_torch/csrc/{lib}.cu", replaces=replaces,
            max_abs_err=max(r["max_abs_err"] for r in held),
            ms=bench["device_us"] / 1e3,
            plain_ms=bench["plain_device_us"] / 1e3,
            bound_ms=bench["bound_us"] / 1e3, bound_by=bench["bound_by"],
            library_ms=(bench["library_device_us"] / 1e3
                        if library else None),
            checked_ms=bench["checked_device_us"] / 1e3)
        for label in rounds.get(name, {}):
            out[name][f"{label}_ms"] = line[label]["device_us"] / 1e3
    return out


def phase_probe(torch, probe, card):
    """Every cell of ``table_probe.main`` on the card: each candidate's
    state after three chained steps held against the CPU port's on the
    same inputs (``table_probe.check_state``: bit-exact, but for the
    ``torch`` bank at duplicated keys, whose rows mixed from several
    messages are counted), then the cell timed.  The probe kernels'
    counts are set to 0 before and must equal, after, the calls of their
    candidates.  Returns each probe kernel's launches."""
    for w in probe.KERNEL.values():
        w.launches = 0
    calls = {cand: 0 for cand in probe.KERNEL}
    cells = []
    for cand, K, M in probe.CELLS:
        fn, args = probe.candidate_step(cand, K, M, "cuda")
        got = probe.run_chain(fn, args)
        fn_cpu, args_cpu = probe.candidate_step(cand, K, M, "cpu")
        mixed = probe.check_state(cand, got, probe.run_chain(fn_cpu, args_cpu),
                                  args_cpu)
        cells.append(probe.cell(cand, K, M, "cuda"))
        if cand == "torch":
            cells[-1]["mixed_dup_rows"] = mixed
        if not cells[-1]["analysis_clean"] or (
                cells[-1]["analysis_build"] != "checked"):
            raise AssertionError(f"probe cell {cand} K={K} M={M} is not "
                                 f"clean in the checked build: {cells[-1]}")
        if cand in calls:
            calls[cand] += (3 + cells[-1]["calls"]
                            + cells[-1]["analysis_calls"])
    launches = {w.__name__: w.launches for w in probe.KERNEL.values()}
    want = {probe.KERNEL[c].__name__: n for c, n in calls.items()}
    emit({"phase": "probe", "card": card, "cells": cells,
          "matches_cpu": True, "launches": launches})
    if launches != want:
        raise AssertionError(f"probe kernel launches {launches}, want the "
                             f"calls made {want}")
    return launches


def _codes(findings):
    return sorted({f.code for f in findings})


def phase_sanitizer(torch, port):
    """The kernel matrix in both builds, the fixtures green in the checked
    build, then the red fixtures.  The analysis kernels' counts are set to
    0 before and read after: each must have launched.  Returns them."""
    from hermes_tpu_torch import analysis as ana
    from hermes_tpu_torch.analysis import diffcheck as dc
    from hermes_tpu_torch.analysis.domain import iv
    from hermes_tpu_torch.core import dispatch

    fk, mega = port.fk, port.mega
    for wrapper, _plain, _lib, _replaces in fk.KERNELS.values():
        wrapper.launches = 0
    dev = torch.device("cuda")
    out = {"phase": "sanitizer", "matrix": {}}
    for build_name, checked in (("release", False), ("checked", True)):
        t0 = time.perf_counter()
        reports = ana.run_kernel_matrix(n_draws=3, device="cuda",
                                        checked=checked)
        bad = [(r["engine"], _codes(r["findings"]),
                r["sanitizer"]["violations"][:2]) for r in reports
               if r["findings"] or not r["sanitizer"]["ok"]
               or r["build"] != "checked"
               or r["proved"]["refhazard"] != r["n_sites"]]
        out["matrix"][build_name] = dict(
            cells=len(reports), draws=3, seconds=time.perf_counter() - t0,
            sanitizer_ok=all(r["sanitizer"]["ok"] for r in reports),
            findings=sum(len(r["findings"]) for r in reports),
            guard_sites={r["engine"]: r["n_sites"] for r in reports})
        if bad or len(reports) < 8:
            raise AssertionError(f"kernel matrix ({build_name} sanitizer) "
                                 f"is not green: {bad}")

    # the comparison with the plain version must be able to fail: a plain
    # version made to differ in one output turns the cell red in both builds
    cell = dc.cell_by_name("mega_replay/k2500b3")
    wrong = dataclasses.replace(
        cell, plain=lambda *a: tuple(o + 1 if i == 2 else o
                                     for i, o in enumerate(cell.plain(*a))))
    for checked in (False, True):
        r = dc.diff_check(wrong, n_draws=1, device="cuda", checked=checked)
        if {(v["kind"], v["out"]) for v in r["violations"]} != {("plain", 2)}:
            raise AssertionError(f"a differing plain version stayed green: "
                                 f"{r}")
    out["matrix"]["differing_plain_is_red"] = True

    def alive(after):
        """A release launch after a red fixture, held against its plain
        version: the context must have survived the guard."""
        x = torch.arange(16 * 8, dtype=torch.int32).reshape(16, 8)
        got = fk.scan_acc(x.to(dev))
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), fk.scan_acc_plain(x)):
            raise AssertionError(f"release launch wrong after {after}")

    # every fixture in the checked build on inputs in bounds: no finding,
    # and the result its plain version's
    green = {}
    for k, (name, (wrapper, plain, lib, _r)) in enumerate(fk.KERNELS.items()):
        shape = (SCAN_ACC_SHAPES if name == "scan_acc" else FX_SHAPES[name])[0]
        case = scan_acc_case if name == "scan_acc" else fx_case(name)
        args, _t, _info = case(torch, port, shape, seed=500 + k)
        want = _flat(plain(*_to(torch, args, "cpu")))
        top = [ana.domain.top("int32")] * len(want)
        got, found = dc.analyze_call(
            lambda: _flat(wrapper(*_to(torch, args, dev))), top, name, lib)
        if [f for f in found if f.severity in ana.GATING] or not all(
                (w.numpy() == g).all() for w, g in zip(want, got)):
            raise AssertionError(f"{name} is not green in the checked "
                                 f"build: {[f.message for f in found]}")
        green[name] = _codes(found)
        alive(name)
    out["fixtures_green"] = green

    g = torch.Generator().manual_seed(9)
    v = _i32(torch, g, (8, 128), 0, 101).to(dev)
    x = _i32(torch, g, (8, 256), 0, 4).to(dev)
    table = _i32(torch, g, (64, FX_W), 0, 101).to(dev)
    keys = _i32(torch, g, (32,), 0, 64).to(dev)
    keys[5] = 64  # one key past the table
    rows = _i32(torch, g, (32, FX_W), 0, 1 << 20).to(dev)
    idx = torch.tensor([[100]], dtype=torch.int32, device=dev)
    cfg = mega_cfg(port.config, 2)
    a_vpts, a_keys, a_pts, a_mask = (t.to(dev) for t in apply_inputs(
        torch, 16, 16, seed=3))
    a_mask[:] = True  # the wire keys past the column are masked in
    pts_hi = iv(0, 1 << 25)
    LIB = fk.LIB
    red = (  # name, library, call, declared output bounds, broken, finding
        ("fx_store_at idx=100 rows=8", LIB, lambda: (fk.fx_store_at(idx, v),),
         [iv(0, 100)], False, "oob-block-store"),
        ("fx_block_copy offset=1", LIB, lambda: (fk.fx_block_copy(x, 1),),
         [ana.domain.top("int32")], False, "oob-block-store"),
        ("fx_serial_scan key=64", LIB,
         lambda: (fk.fx_serial_scan(table.clone(), keys, rows),),
         [iv(0, 1 << 20)], False, "oob-block-store"),
        ("fx_acc_revisit init=False", LIB,
         lambda: (fk.fx_acc_revisit(x, init=False),), [iv(0, 3 * 256)], False,
         "ref-read-before-init"),
        ("mega_apply without its clamp", "mega_apply",
         lambda: mega.mega_apply(cfg, a_vpts.clone(), a_keys, a_pts, a_mask),
         [pts_hi, pts_hi], True, "oob-block-store"),
        ("fx_async_copy", LIB, lambda: (fk.fx_async_copy(v),), [iv(0, 100)],
         False, "guard-skipped"))
    out["red"] = {}
    for name, lib, call, out_avs, broken, want in red:
        _outs, found = dc.analyze_call(call, out_avs, name.split()[0], lib,
                                    broken=broken)
        hit = [f for f in found if f.code == want]
        out["red"][name] = dict(want=want, codes=_codes(found), site=(
            f"{hit[0].site} in {hit[0].fn}" if hit else None),
            message=hit[0].message if hit else None)
        if not hit:
            raise AssertionError(f"red fixture {name!r} stayed green: want "
                                 f"{want}, got {_codes(found)}")
        f = hit[0]
        if want.startswith("oob") and not (
                f.file.endswith(f"csrc/{lib}.cu") and f.line > 0
                and f.fn.endswith("_kernel") and f.severity == "error"):
            raise AssertionError(f"{name!r}: finding without its site: {f}")
        if want == "guard-skipped" and ("cp.async" not in f.message
                                        or f.severity != "info"):
            raise AssertionError(f"{name!r}: the info finding does not name "
                                 f"the asynchronous copy: {f}")
        alive(name)
    # the same mega_apply inputs in the sound checked build: clean
    _outs, found = dc.analyze_call(
        lambda: mega.mega_apply(cfg, a_vpts.clone(), a_keys, a_pts, a_mask),
        [pts_hi, pts_hi], "mega_apply", "mega_apply")
    if found:
        raise AssertionError(f"mega_apply with its clamp is not clean: "
                             f"{[f.message for f in found]}")
    launches = {name: w.launches
                for name, (w, _p, _l, _r) in fk.KERNELS.items()}
    out["launches"] = launches
    emit(out)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"the sanitizer phase never launched {idle}")
    return launches


def phase_reference(torch, config, fst, convert, ycsb, card_device="cuda",
                    mega_round=False):
    """The round on the card against the same round on the CPU — which
    the CPU test suite holds bit-exact against the JAX reference — at a
    small shape, through a freeze and a removal with the replay scan
    firing: every state leaf and completion equal after every round."""
    cfg = config.HermesConfig(
        n_replicas=4, n_keys=256, n_sessions=32, replay_slots=8,
        ops_per_session=16, arb_mode="sort", chain_writes=4,
        wrap_stream=True, device_stream=True, lane_budget_cfg=24,
        read_unroll=2, replay_age=2, replay_scan_every=2,
        mega_round=mega_round,
        workload=config.WorkloadConfig(read_frac=0.4, rmw_frac=0.3, seed=3))
    devs = {"cpu": torch.device("cpu"), "card": torch.device(card_device)}
    fs = {k: fst.init_fast_state(cfg, d) for k, d in devs.items()}
    stream = {k: fst.prep_stream(ycsb.stub_stream(cfg), d)
              for k, d in devs.items()}
    rounds, replayed = 40, 0
    for s in range(rounds):
        host = {}
        for k, d in devs.items():
            ctl = fst.make_fast_ctl(cfg, s, d)
            if s >= 10:  # replica 3 freezes, then leaves the membership
                ctl = ctl._replace(frozen=torch.tensor(
                    [False, False, False, True], device=d))
            if s >= 20:
                ctl = ctl._replace(
                    live_mask=torch.full((4,), 0b0111, dtype=torch.int32,
                                         device=d),
                    epoch=torch.ones(4, dtype=torch.int32, device=d))
            fs[k], comp = fst.fast_round_batched(cfg, ctl, fs[k], stream[k])
            leaves = [x.cpu() for c in comp for x in c]
            host[k] = (convert.fast_state_to_numpy(fs[k]), leaves)
        for a, b in zip(host["cpu"][0], host["card"][0]):
            for x, y in zip(a, b):
                if not (x.shape == y.shape and (x == y).all()):
                    raise AssertionError(f"card and CPU states differ at "
                                         f"round {s}")
        if not all(torch.equal(x, y)
                   for x, y in zip(host["cpu"][1], host["card"][1])):
            raise AssertionError(f"card and CPU completions differ at "
                                 f"round {s}")
        replayed = max(replayed, int(fs["card"].replay.active.sum()))
    if replayed == 0:
        raise AssertionError("the replay scan never fired in the reference "
                             "drive")
    emit({"phase": "reference-mega" if mega_round else "reference",
          "rounds": rounds, "identical": True,
          "replay_slots_peak": replayed})


def expected_launches(cfg, first, last):
    """Launches each kernel of the round makes over steps [first, last):
    one a round, ``mega_replay`` only on the replay scan's rounds."""
    n = last - first
    out = {"stats_block": n}
    if cfg.use_mega_round:
        scans = sum(1 for s in range(first, last)
                    if s % cfg.replay_scan_every == 0)
        out.update(mega_route=n, mega_apply=n, mega_replay=scans)
    return out


MAIN_ROUNDS = 60


def timed_window(torch, rt, rounds=MAIN_ROUNDS):
    """Committed writes and RMWs, reads, aborts and host seconds of
    ``rounds`` rounds, ending in a device sync."""
    c0 = rt.counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = rt.counters()
    d = {k: int(c1[k] - c0[k]) for k in ("n_write", "n_rmw", "n_read",
                                         "n_abort")}
    return wall, d["n_write"] + d["n_rmw"], d


def phase_main(torch, counters, config, FastRuntime, card, mega_round=False,
               fused=None):
    """Throughput window of bench-a; returns its numbers (with the launch
    count of each kernel over the timed window) and the runtime."""
    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, device="cuda")
    rt.fetch_completions = False  # throughput drive: counters only
    rt.run(4)  # warm-up
    rounds = MAIN_ROUNDS
    first = rt.step_idx
    for w in counters.values():
        w.launches = 0
    wall, commits, d = timed_window(torch, rt, rounds)
    launches = {name: w.launches for name, w in counters.items()}
    want = expected_launches(cfg, first, rt.step_idx)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in {rounds} "
                             f"main-path rounds, want {want}")
    prof_rounds = 5
    busy = device_busy(torch, lambda: rt.run(prof_rounds), "main", (rt,))
    out = {"phase": "main-mega" if mega_round else "main", "card": card,
           "rounds": rounds, "writes_per_s": commits / wall,
           "us_per_round": wall / rounds * 1e6, "commits": commits,
           "launches": {k: launches[k] for k in want},
           "reads": d["n_read"], "aborts": d["n_abort"]}
    out.update(profiled_rounds=prof_rounds, busy_by=busy["busy_by"],
               device_busy_share=busy["busy_s"] / busy["wall_s"],
               device_us_per_round=busy["busy_s"] / prof_rounds * 1e6,
               cuda_kernels_per_round=busy["launches"] / prof_rounds,
               profiled_us_per_round=busy["wall_s"] / prof_rounds * 1e6,
               top_device_us_per_round=[
                   [name, us / prof_rounds, cnt / prof_rounds]
                   for us, cnt, name in busy["top"]],
               top_ops_device_us_per_round=[
                   [name, us / prof_rounds, cnt / prof_rounds]
                   for us, cnt, name in busy["top_ops"]])
    if fused is not None:  # the A/B: the fused round's numbers of this call
        out["fused"] = {k: fused[k] for k in (
            "writes_per_s", "us_per_round", "device_us_per_round",
            "cuda_kernels_per_round")}
    emit(out)
    if commits <= 0:
        raise AssertionError("the main path committed nothing")
    return out, rt


def phase_ab(torch, main, fused_rt, main_mega, mega_rt):
    """More timed windows of the two bench-a runtimes in turns: after
    main (fused) and main-mega, mega, fused, fused, mega, so each ran
    three windows in the order A B B A A B.  Host-clock writes/s and
    us/round of every window."""
    runs = {"fused": [main], "mega": [main_mega]}
    for name, rt in (("mega", mega_rt), ("fused", fused_rt),
                     ("fused", fused_rt), ("mega", mega_rt)):
        wall, commits, _ = timed_window(torch, rt)
        runs[name].append({"writes_per_s": commits / wall,
                           "us_per_round": wall / MAIN_ROUNDS * 1e6})
    out = {"phase": "ab", "order": "fused mega mega fused fused mega",
           "rounds_per_window": MAIN_ROUNDS}
    for name, ws in runs.items():
        out[name] = {k: [w[k] for w in ws]
                     for k in ("writes_per_s", "us_per_round")}
        out[name]["median_us_per_round"] = statistics.median(
            out[name]["us_per_round"])
    emit(out)


def phase_checked(torch, counters, config, FastRuntime, types,
                  mega_round=False):
    """bench-a with the columnar recorder, then quiesced until nothing is
    in flight and checked.  With ``mega_round`` replica 1 is frozen from
    round 8 until after the replay scan of round 32, which must take
    slots."""
    cfg = config.bench_cfg("a", over=dict(mega_round=mega_round))
    rt = FastRuntime(cfg, record="array", device="cuda")
    freeze = (CHECKED_FREEZE_AT, REPLAY_ROUND + 1) if mega_round else None
    rounds = 40 if mega_round else 16
    for w in counters.values():
        w.launches = 0
    for s in range(rounds):
        if freeze and s == freeze[0]:
            rt.freeze(1)
        if freeze and s == freeze[1]:
            rt.thaw(1)
        rt.step_once()
    rt.quiesce = True  # no new work: in-flight writes and replays drain
    drained = 0
    while rt._inflight_count() and drained < 256:
        rt.step_once()
        drained += 1
    rt.flush_pipeline()
    launches = {name: w.launches for name, w in counters.items()}
    want = expected_launches(cfg, 0, rt.step_idx)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in the checked "
                             f"run, want {want}")
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded = rt.recorder.n_recorded
    valid = bool(((rt.fs.table.sst & 7) == types.VALID).all())
    replay_peak = int(rt.fs.meta.replay_peak.max())
    hist = c["lat_hist"]
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    emit({"phase": "checked-mega" if mega_round else "checked",
          "rounds": rounds, "frozen_rounds": freeze,
          "drain_rounds": drained, "launches": {k: launches[k] for k in want},
          "replay_peak": replay_peak,
          "inflight_left": rt._inflight_count(), "device_ops": device_ops,
          "recorded_ops": recorded, "all_keys_valid": valid,
          "lat_bin0_share": float(hist[0] / max(1, hist.sum())),
          "check_ok": v.ok, "keys_checked": v.keys_checked,
          "check_s": check_s})
    if not v.ok:
        raise AssertionError(f"linearizability check failed: "
                             f"{[f.reason[:200] for f in v.failures[:3]]}")
    if rt._inflight_count() or not valid:
        raise AssertionError("the quiesced store did not converge to all-VALID")
    if device_ops != recorded:
        raise AssertionError(f"device op counters {device_ops} != recorded "
                             f"completions {recorded}")
    if freeze and replay_peak == 0:
        raise AssertionError("the replay scan took no slot in the frozen "
                             "window")
    if not freeze and hist[0] * 2 < hist.sum():
        raise AssertionError("commit latency bulk is not in bin 0")


# --------------------------------------------------------------------------
# The sharded engine (one table copy a replica, a LocalGroup on the card)
# --------------------------------------------------------------------------

SHARDED_WARMUP = 4
SHARDED_PROFILED = 5
# checked-sharded: replica 1 frozen across the replay scan of round 32,
# then replica 2 removed and re-joined from replica 0's copy
SHARDED_FREEZE = (CHECKED_FREEZE_AT, REPLAY_ROUND + 1)
SHARDED_REMOVE_AT = 36
SHARDED_JOIN_AT = 40
SHARDED_ROUNDS = 44
SHARDED_HEALTHY_ROUNDS = 10  # the sharded and batched drives compared
SHARDED_READ_KEYS = 4096
SHARDED_READ_COPY = 5  # the copy whose row of one key is made to differ


def sharded_expected_launches(cfg, first, last, copies):
    """``expected_launches`` of the sharded round: the same but that
    ``mega_replay`` runs once a local copy on each replay-scan round."""
    out = expected_launches(cfg, first, last)
    if "mega_replay" in out:
        out["mega_replay"] *= copies
    return out


def sharded_runtime(sh, cfg, record=False):
    return sh.FastRuntime(cfg, backend="sharded", record=record,
                          group=sh.LocalGroup(sh.device))


def sharded_site_inputs(torch, sh, rt):
    """The arguments of ``mega_apply`` at the sharded site (one launch a
    round over the flat ``R*(K+1)``-row table: every replica's gathered
    slots and its replay keys) in the next round of ``rt``, and of
    ``mega_replay`` on one copy's K-row view (the last local copy) in the
    next replay-scan round, replica 1 frozen from the apply round on so
    that the writes waiting on its ack age into the scan, which takes
    slots."""
    mega = sh.mega
    got = {"mega_apply": _kept_args(torch, ((mega, "mega_apply"),), rt,
                                    lambda: rt.run(1), sh.device)[
                                        "mega_apply"]}
    rt.freeze(1)
    # the first scan round by which a write stalled now is past the age
    every, first = rt.cfg.replay_scan_every, rt.step_idx + rt.cfg.replay_age + 2
    rt.run(-(-first // every) * every - rt.step_idx)
    got["mega_replay"] = _kept_args(torch, ((mega, "mega_replay"),), rt,
                                    lambda: rt.run(1), sh.device)[
                                        "mega_replay"]
    return got


def sharded_site_rows(torch, sh, rt):
    """``mega_apply`` at the sharded site and ``mega_replay`` on a copy's
    view, on the inputs of real bench-a-mega rounds of the sharded engine,
    against their plain versions (``check_kernel``: CUDA-event times, on
    the stream and queued behind a spin kernel) with their bounds."""
    mega = sh.mega
    rows = {}
    for name, args in sharded_site_inputs(torch, sh, rt).items():
        timing = None
        if name == "mega_replay":  # a call's marks leave the stuck set
            timing = [dataclasses.replace(args[0], replay_age=-1),
                      *args[1:]]
        info = round_info(torch, sh.port, name, args)
        if name == "mega_apply":
            _cfg, vpts, keys, _pts, _mask = args
            N, rows_k = keys.numel(), vpts.shape[0]
            info.update(bound(N * (4 + 4 + 1) + 2 * 4 * rows_k + 4 * N,
                              6 * N))
        else:
            # replay_case's bytes: every row's sst word, the slots read
            # and written, the timed calls' candidates
            _cfg, _step, _frozen, vpts, bank, replay = args
            rows_k, V = bank.shape[0], (bank.shape[1] - 8) // 4
            R, RS = replay.active.shape
            if info["slots_taken"] == 0:
                raise AssertionError("mega_replay on the copy's view took "
                                     "no slot")
            n_cand = min(info["stuck_rows_timed"], RS)
            info.update(bound(4 * rows_k + 2 * R * RS * (17 + 4 * V)
                              + n_cand * (8 + 4 * V) + R + 4, 8 * rows_k))
        rows[name] = dict(info, **sh.check_kernel(
            torch, getattr(mega, name), getattr(mega, name + "_plain"),
            args, name, timing))
    return rows


def phase_sharded(torch, counters, sh, card, mega_round=False):
    """bench-a (``mega_round``: bench-a-mega) on the sharded engine at
    full width, every replica in this process on a ``LocalGroup``: the
    4 warm-up and 60 timed rounds of ``main``, each kernel's launches over
    the timed window against the rounds (``mega_replay`` once a copy on a
    replay-scan round), a profiled window.  With ``mega_round`` also
    ``mega_apply`` at the sharded site and ``mega_replay`` on a copy's
    view held against their plain versions.  Returns (numbers, the
    kernel-site rows)."""
    cfg = sh.cfg(mega_round=mega_round)
    sh.reset_peak_memory()
    rt = sharded_runtime(sh, cfg)
    rt.fetch_completions = False  # throughput drive: counters only
    rt.run(SHARDED_WARMUP)
    first = rt.step_idx
    for w in counters.values():
        w.launches = 0
    wall, commits, d = timed_window(torch, rt, sh.rounds)
    launches = {name: w.launches for name, w in counters.items()}
    want = sharded_expected_launches(cfg, first, rt.step_idx, rt.n_copies)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in {sh.rounds} "
                             f"sharded rounds, want {want}")
    busy = sh.device_busy(torch, lambda: rt.run(SHARDED_PROFILED),
                          "sharded", (rt,))
    n = SHARDED_PROFILED
    out = {"phase": "sharded-mega" if mega_round else "sharded",
           "card": card, "copies": rt.n_copies, "rounds": sh.rounds,
           "writes_per_s": commits / wall,
           "us_per_round": wall / sh.rounds * 1e6, "commits": commits,
           "launches": {k: launches[k] for k in want},
           "rounds_timed": rt.step_idx - first - n,
           "reads": d["n_read"], "aborts": d["n_abort"],
           "profiled_rounds": n, "busy_by": busy["busy_by"],
           "device_busy_share": busy["busy_s"] / busy["wall_s"],
           "device_us_per_round": busy["busy_s"] / n * 1e6,
           "cuda_kernels_per_round": busy["launches"] / n,
           "profiled_us_per_round": busy["wall_s"] / n * 1e6,
           "top_device_us_per_round": [[name, us / n, cnt / n]
                                       for us, cnt, name in busy["top"]],
           "top_ops_device_us_per_round": [
               [name, us / n, cnt / n] for us, cnt, name in busy["top_ops"]],
           "peak_memory_bytes": sh.peak_memory()}
    sites = sharded_site_rows(torch, sh, rt) if mega_round else {}
    if sites:
        out["sites"] = sites
    emit(out)
    if commits <= 0:
        raise AssertionError("the sharded path committed nothing")
    del rt
    return out, sites


GRAPH_ROUNDS = 64  # crosses the replay-scan rounds 0 and 32
GRAPH_FREEZE = (8, 36)  # replica 1 frozen over the round-32 scan
GRAPH_SET_LIVE_AT = 20  # a membership change (an epoch bump)
GRAPH_QUIESCE = (44, 47)  # quiesced rounds: a variant captured mid-run
GRAPH_DROP_AT = 52  # the graphed round's graphs dropped: captured again
GRAPH_KVS_OPS = 1 << 18  # the KVS drive's op mix
GRAPH_LAUNCH_CALLS_MAX = 16  # host launch calls of a graphed round


def _graph_hooks(rt, s):
    """The graph phase's scripted faults before round ``s``."""
    if s == GRAPH_FREEZE[0]:
        rt.freeze(1)
    if s == GRAPH_FREEZE[1]:
        rt.thaw(1)
    if s == GRAPH_SET_LIVE_AT:
        rt.set_live(int(rt.live[0]))
    rt.quiesce = GRAPH_QUIESCE[0] <= s <= GRAPH_QUIESCE[1]


def _same_leaves(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _state_leaves(gr, rt):
    """Every state leaf of ``rt``, the table's as its copies' key rows
    (the drop rows, which masked scatters write in any order, left out)."""
    K = rt.cfg.n_keys
    t = rt.fs.table
    return ([gr.fst.copies(t.vpts, K), gr.fst.copies(t.bank, K)]
            + gr.graphs.flatten(rt.fs[1:])[0])


def graph_pair(torch, gr, counters, make, copies=1):
    """A graphed runtime and an explicitly eager one (``rt._step.graph =
    False``: the round function is called each round, with the same bound
    state and ring) from ``make()``, driven together over
    ``GRAPH_ROUNDS`` rounds through ``_graph_hooks`` and a drop of the
    graphed round's graphs: completions equal every round, state trees
    equal at the end, the graphed runtime's launches by kernel (counted
    around its own rounds) those of an eager round each.  Returns (the
    two runtimes, the graphed launches, the launches a replay of every
    variant captured, by variant)."""
    graphed, eager = make(), make()
    eager._step.graph = False
    got = {k: 0 for k in counters}
    seen = {}
    for s in range(GRAPH_ROUNDS):
        for rt in (graphed, eager):
            _graph_hooks(rt, s)
        if s == GRAPH_DROP_AT:
            seen.update(graphed._step._variants)
            graphed._step.drop()
        before = {k: w.launches for k, w in counters.items()}
        cg = graphed.dispatch_round()
        for k, w in counters.items():
            got[k] += w.launches - before[k]
        ce = eager.dispatch_round()
        if not _same_leaves(torch, _flat(cg), _flat(ce)):
            raise AssertionError(f"graphed and eager completions differ at "
                                 f"round {s}")
    if not _same_leaves(torch, _state_leaves(gr, graphed),
                        _state_leaves(gr, eager)):
        raise AssertionError("graphed and eager states differ after "
                             f"{GRAPH_ROUNDS} rounds")
    cfg = graphed.cfg
    want = sharded_expected_launches(cfg, 0, GRAPH_ROUNDS, copies)
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"the graphed rounds launched {got}, want "
                             f"{want}")
    comp = graphed._step
    # scan, plain and quiesce before the drop, plain after it: each run
    # eagerly once, captured at its second call, replayed after
    if comp.captures < 4 or comp.replays + comp.warmups != GRAPH_ROUNDS:
        raise AssertionError(f"{comp.captures} captures, {comp.warmups} "
                             f"warm-ups and {comp.replays} replays in "
                             f"{GRAPH_ROUNDS} rounds")
    seen.update(graphed._step._variants)
    return graphed, eager, {k: got[k] for k in want}, {
        k: v.launches for k, v in seen.items()}


def graph_timing(torch, gr, rt):
    """Host us a round (a throughput window, counters only, after two
    replay-scan rounds have run: every variant of a compiled round
    captured), device us a round (the same rounds queued behind a spin
    kernel: CUDA events), their busy share, and the host launch calls of
    one round with its harvest (``launch_calls``)."""
    rt.quiesce = False
    rt.fetch_completions = False
    rt.run(2 * rt.cfg.replay_scan_every)
    wall, commits, _ = timed_window(torch, rt, MAIN_ROUNDS)
    dev_s = gr.profiling.queued_s(lambda: rt.run(1), inner=10,
                                  spin_cycles=1 << 26)
    rt.fetch_completions = True
    calls = launch_calls(rt.step_once)
    host_us = wall / MAIN_ROUNDS * 1e6
    dev_us = None if dev_s is None else dev_s * 1e6
    return {"host_us_per_round": host_us, "device_us_per_round": dev_us,
            "busy_share": None if dev_us is None else dev_us / host_us,
            "host_launch_calls": sum(calls.values()),
            "launch_calls": calls, "writes_per_s": commits / wall}


def kvs_graph_pair(torch, gr, counters):
    """Two KVSs at the KVS bench shape and depth 2, graphed and explicitly
    eager, under one seeded op mix with a freeze, a thaw and a
    ``set_live`` mid-run: every batch future's columns and the state
    trees equal."""
    cfg = gr.kvs_cfg(pipeline_depth=2)
    np = gr.np
    rng = np.random.default_rng(GRAPH_ROUNDS)
    keys = rng.integers(0, cfg.n_keys, GRAPH_KVS_OPS)
    is_get = rng.random(GRAPH_KVS_OPS) < 0.5
    kinds = np.where(is_get, gr.KVS.GET, gr.KVS.PUT).astype(np.int32)
    values = rng.integers(-2**31, 2**31, (GRAPH_KVS_OPS, cfg.value_words - 2),
                          dtype=np.int64).astype(np.int32)
    stores, batches = [], []
    for graphed in (True, False):
        kv = gr.KVS(cfg, device="cuda")
        kv.rt._step.graph = graphed
        stores.append(kv)
        batches.append(kv.submit_batch(kinds, keys, values))
    for s in range(GRAPH_ROUNDS):
        for kv in stores:
            _graph_hooks(kv.rt, s)
            kv.rt.quiesce = False
            kv.step()
    for kv in stores:
        kv.flush()
    a, b = batches
    for col in ("code", "value", "uid", "step", "tsv", "tsf"):
        if not np.array_equal(getattr(a, col), getattr(b, col)):
            raise AssertionError(f"graphed and eager KVS batches differ in "
                                 f"{col}")
    if not _same_leaves(torch, _state_leaves(gr, stores[0].rt),
                        _state_leaves(gr, stores[1].rt)):
        raise AssertionError("graphed and eager KVS states differ")
    done = a.done_count()
    if done == 0 or stores[0].rt._step.captures == 0:
        raise AssertionError(f"the KVS drive completed {done} ops in "
                             f"{stores[0].rt._step.captures} captures")
    return {"ops_done": done, "rounds": stores[0].rt.step_idx,
            "captures": stores[0].rt._step.captures,
            "rebinds": stores[0].rt._step.rebinds}


def phase_graph(torch, gr, counters, card):
    """The compiled round against the eager round (``graph_pair``) for
    bench-a, bench-a-mega, sharded and sharded-mega (``LocalGroup``) at
    full width, then each one's host and device us a round, busy share
    and host launch calls graphed and eager in this call
    (``graph_timing``), then the KVS drive (``kvs_graph_pair``).  A
    graphed bench-a round makes at most ``GRAPH_LAUNCH_CALLS_MAX`` host
    launch calls.  Returns the graphed launches by engine."""
    engines = (("bench-a", "batched", False), ("bench-a-mega", "batched",
                                               True),
               ("sharded", "sharded", False), ("sharded-mega", "sharded",
                                               True))
    out, launches = {}, {}
    for name, backend, mega_round in engines:
        cfg = gr.cfg(mega_round=mega_round)
        if backend == "batched":
            make = lambda: gr.FastRuntime(cfg, device="cuda")
        else:
            make = lambda: gr.FastRuntime(cfg, backend="sharded",
                                          group=gr.LocalGroup("cuda"))
        t0 = time.perf_counter()
        copies = cfg.n_replicas if backend == "sharded" else 1
        graphed, eager, got, variants = graph_pair(torch, gr, counters,
                                                   make, copies)
        launches[name] = got
        if mega_round:
            scan = [v for k, v in variants.items() if k[0]]
            if not scan or not (scan[0].get("mega_apply")
                                and scan[0].get("mega_replay") == copies):
                raise AssertionError("no captured scan round holds both "
                                     f"cooperative kernels: {variants}")
        row = {"identical": True, "rounds": GRAPH_ROUNDS,
               "captures": graphed._step.captures,
               "replays": graphed._step.replays, "launches": got,
               "variant_launches": {str(k): v for k, v in variants.items()},
               "graphed": graph_timing(torch, gr, graphed),
               "eager": graph_timing(torch, gr, eager),
               "seconds": time.perf_counter() - t0}
        out[name] = row
        emit(dict({"phase": "graph", "engine": name, "card": card}, **row))
        del graphed, eager
        torch.cuda.empty_cache()
    calls = out["bench-a"]["graphed"]["host_launch_calls"]
    if calls > GRAPH_LAUNCH_CALLS_MAX:
        raise AssertionError(f"a graphed bench-a round made {calls} host "
                             f"launch calls, want <= "
                             f"{GRAPH_LAUNCH_CALLS_MAX}")
    t0 = time.perf_counter()
    kv = kvs_graph_pair(torch, gr, counters)
    emit(dict({"phase": "graph-kvs", "card": card, "identical": True,
               "seconds": time.perf_counter() - t0}, **kv))
    return launches


def _bank_equal_but_steps(torch, sh, bank):
    """Every copy's key rows equal to copy 0's in all but the sst step
    (the join re-stamps the rows it transfers and a replay mark stamps
    its own round): pts, state and value bytes."""
    K = sh.cfg().n_keys
    rows = sh.fst.copies(bank, K)
    sst = sh.fst._bank_to_i32(rows[..., 4:8])[..., 0]
    return (torch.equal(rows[..., 0:4], rows[:1, :, 0:4].expand_as(
        rows[..., 0:4])) and torch.equal(rows[..., 8:], rows[:1, :, 8:]
                                         .expand_as(rows[..., 8:]))
            and torch.equal(sst & 7, (sst[:1] & 7).expand_as(sst)))


def phase_checked_sharded(torch, counters, sh, types):
    """The sharded engine at full width and a smaller depth.  (1) Healthy:
    ``SHARDED_HEALTHY_ROUNDS`` rounds and a quiesce drain beside the
    batched engine on the same stream: every copy equals the batched
    table byte for byte.  (2) Recorded (``record="array"``): replica 1
    frozen across the replay scan of round 32 (the copies must differ
    then: the scan re-stamps stuck keys REPLAY in every copy but the
    frozen one's), then replica 2 removed and re-joined from replica 0's
    copy, then a quiesce drain: the checker passes, the device op
    counters equal the recorded completions, every key is VALID and
    every copy equal to copy 0 but for sst steps; each kernel's launches
    equal the rounds as declared."""
    cfg = sh.cfg()
    K = cfg.n_keys

    def drain(rt):
        rt.quiesce = True
        n = 0
        while rt._inflight_count() and n < 256:
            rt.step_once()
            n += 1
        rt.quiesce = False
        rt.flush_pipeline()
        return n

    a = sh.FastRuntime(cfg, device=sh.device)
    b = sharded_runtime(sh, cfg)
    for rt in (a, b):
        rt.fetch_completions = False
        rt.run(SHARDED_HEALTHY_ROUNDS)
        drain(rt)
    healthy = (all(torch.equal(c, a.fs.table.bank[:K])
                   for c in sh.fst.copies(b.fs.table.bank, K))
               and all(torch.equal(c, a.fs.table.vpts[:K])
                       for c in sh.fst.copies(b.fs.table.vpts, K)))
    healthy_rounds = (a.step_idx, b.step_idx)
    del a, b
    rt = sharded_runtime(sh, cfg, record="array")
    for w in counters.values():
        w.launches = 0
    differed = None
    for s in range(SHARDED_ROUNDS):
        if s == SHARDED_FREEZE[0]:
            rt.freeze(1)
        if s == SHARDED_FREEZE[1]:
            rt.thaw(1)
        if s == SHARDED_REMOVE_AT:
            rt.remove(2)
        if s == SHARDED_JOIN_AT:
            rt.join(2, 0)
        rt.step_once()
        if s == REPLAY_ROUND:
            bank = sh.fst.copies(rt.fs.table.bank, K)
            differed = [int((~(c == bank[0]).all(dim=1)).sum())
                        for c in bank]
    drained = drain(rt)
    launches = {name: w.launches for name, w in counters.items()}
    want = sharded_expected_launches(cfg, 0, rt.step_idx, rt.n_copies)
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded = rt.recorder.n_recorded
    rows = sh.fst.copies(rt.fs.table.bank, K)
    valid = bool(((sh.fst._bank_to_i32(rows[..., 4:8])[..., 0] & 7)
                  == types.VALID).all())
    converged = _bank_equal_but_steps(torch, sh, rt.fs.table.bank) and all(
        torch.equal(v, sh.fst.copies(rt.fs.table.vpts, K)[0])
        for v in sh.fst.copies(rt.fs.table.vpts, K))
    replay_peak = int(rt.fs.meta.replay_peak.max())
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    emit({"phase": "checked-sharded", "copies": rt.n_copies,
          "healthy_rounds": healthy_rounds,
          "healthy_copies_equal_batched": healthy,
          "rounds": SHARDED_ROUNDS, "frozen_rounds": SHARDED_FREEZE,
          "removed_at": SHARDED_REMOVE_AT, "joined_at": SHARDED_JOIN_AT,
          "rows_differing_from_copy0_at_replay_scan": differed,
          "drain_rounds": drained,
          "launches": {k: launches[k] for k in want},
          "replay_peak": replay_peak, "inflight_left": rt._inflight_count(),
          "device_ops": device_ops, "recorded_ops": recorded,
          "all_keys_valid": valid, "copies_converged": converged,
          "check_ok": v.ok, "keys_checked": v.keys_checked,
          "check_s": check_s})
    if not healthy:
        raise AssertionError("after a healthy drain a copy differs from the "
                             "batched engine's table")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in the "
                             f"checked-sharded run, want {want}")
    if not differed or not any(differed):
        raise AssertionError("the copies did not differ in the frozen "
                             "window")
    if not v.ok:
        raise AssertionError(f"linearizability check failed: "
                             f"{[f.reason[:200] for f in v.failures[:3]]}")
    if rt._inflight_count() or not valid or not converged:
        raise AssertionError("the drained copies did not converge to "
                             "all-VALID and equal")
    if device_ops != recorded:
        raise AssertionError(f"device op counters {device_ops} != recorded "
                             f"completions {recorded}")
    if replay_peak == 0:
        raise AssertionError("the replay scan took no slot in the frozen "
                             "window")


def sharded_reads(torch, np, kernels, types, KVS, sh):
    """The read path on the sharded layout at the bench shape: keys put,
    then read back through named replicas' copies (``LocalReader``,
    ``replica=``); one copy's row of one key made to differ must be read
    by that replica only; with replica 0 frozen the KVS serves from
    replica 1's copy, and a frozen replica named serves nothing."""
    cfg = _kvs_cfg(sh.config)
    kvs = KVS(cfg, backend="sharded", device=sh.device)
    kernels.stats_block.launches = 0
    K, n, u = cfg.n_keys, SHARDED_READ_KEYS, cfg.value_words - 2
    rng = np.random.default_rng(READS_SEED + 1)
    keys = rng.choice(K, n, replace=False).astype(np.int64)
    vals = rng.integers(-(1 << 30), 1 << 30, (n, u)).astype(np.int32)
    bf = kvs.submit_batch(np.full(n, KVS.PUT, np.int32), keys, vals)
    if not kvs.run_batch(bf, 64) or not (bf.code == types.C_WRITE).all():
        raise AssertionError("sharded reads: the puts did not all commit")
    reader = kvs._get_reader()
    served = {}
    for r in (0, 3, cfg.n_replicas - 1):
        ans, dt = _timed(torch, lambda: reader.multi_get(keys, replica=r))
        if not ans.valid.all() or (ans.val[:, 2:] != vals).any():
            raise AssertionError(f"replica {r}'s copy read back wrong")
        served[r] = dt
    # one copy's row of keys[0] differs: only its replica reads it
    k0, c = int(keys[0]), SHARDED_READ_COPY
    other = torch.tensor([[1 << 10, types.VALID, k0, -1, 5, 6, 7, 8, 9, 10]],
                         dtype=torch.int32)[:, :2 + cfg.value_words]
    row = sh.fst._i32_to_bank(other)[0].to(sh.device)
    sh.fst.copies(kvs.rt.fs.table.bank, K)[c, k0] = row
    got_c = reader.multi_get([k0], replica=c).val[0]
    got_3 = reader.multi_get([k0], replica=3).val[0]
    if got_c.tolist() != other[0, 2:].tolist() or (got_3[2:] != vals[0]).any():
        raise AssertionError(f"the differing copy was not read by its own "
                             f"replica only: {got_c}, {got_3}")
    kvs.freeze(0)
    res = kvs.multi_get(keys[1:])
    if (not res.all_done() or not res.local.all()
            or (res.value != vals[1:]).any()):
        raise AssertionError("with replica 0 frozen the KVS did not serve "
                             "locally from replica 1's copy")
    if reader.multi_get(keys[:1], replica=0) is not None:
        raise AssertionError("a frozen replica served a local read")
    out = {"keys_put": n, "replicas_read": sorted(served),
           "multi_get_dispatch_s": served, "differing_copy": c,
           "rounds": kvs.rt.step_idx,
           "stats_block_launches": kernels.stats_block.launches}
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != sharded KVS rounds")
    return out


def phase_kvs(torch, kernels, config, KVS):
    cfg = config.bench_cfg("a", over=dict(device_stream=False, read_unroll=1))
    kvs = KVS(cfg, device="cuda")
    kernels.stats_block.launches = 0
    keys = [3, 77, (1 << 20) - 1, 123456]
    puts = [kvs.put(0, i, k, [k, -k, 7, i, 0, 1]) for i, k in enumerate(keys)]
    if not kvs.run_until(puts, 64):
        raise AssertionError("puts did not commit")
    gets = [(r, k, kvs.get(r, 100 + i, k))
            for r in range(cfg.n_replicas) for i, k in enumerate(keys)]
    if not kvs.run_until([g for _, _, g in gets], 64):
        raise AssertionError("gets did not complete")
    for r, k, g in gets:
        want = [k, -k, 7, keys.index(k), 0, 1]
        if g.result().value != want:
            raise AssertionError(f"replica {r} read {g.result().value} for "
                                 f"key {k}, want {want}")
    m = kvs.rmw(5, 9, keys[0], [1, 2, 3, 4, 5, 6])
    if not kvs.run_until([m], 64):
        raise AssertionError("rmw did not complete")
    res = m.result()
    if res.kind != "rmw" or res.value != [keys[0], -keys[0], 7, 0, 0, 1]:
        raise AssertionError(f"rmw returned {res}")
    emit({"phase": "kvs", "keys": keys, "replicas_read": cfg.n_replicas,
          "rmw_displaced": res.value, "rounds": kvs.rt.step_idx,
          "stats_block_launches": kernels.stats_block.launches})
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != KVS rounds")


READS_KEYS = 65536  # keys put, and keys of the one multi_get
READS_SEED = 12
VALUES_KEYS = 32768
VALUES_CHUNK = 4096
VALUES_SEED = 17


def _kvs_cfg(config, **over):
    return config.bench_cfg("a", over=dict(device_stream=False,
                                           read_unroll=1, **over))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_reads(torch, np, kernels, types, config, KVS, lin, card,
                sh=None):
    """The local-read path at the bench shape, recorded and checked; with
    ``sh`` then on the sharded layout through named replicas' copies
    (``sharded_reads``, its own line)."""
    cfg = _kvs_cfg(config)
    kvs = KVS(cfg, record="array", device="cuda")
    kernels.stats_block.launches = 0
    K, n, u = cfg.n_keys, READS_KEYS, cfg.value_words - 2
    rng = np.random.default_rng(READS_SEED)
    keys = rng.choice(K, n, replace=False).astype(np.int64)
    vals = rng.integers(-(1 << 30), 1 << 30, (n, u)).astype(np.int32)
    bf, put_s = _timed(torch, lambda: kvs.submit_batch(
        np.full(n, KVS.PUT, np.int32), keys, vals))
    if not kvs.run_batch(bf, 64) or not (bf.code == types.C_WRITE).all():
        raise AssertionError("the puts did not all commit")
    want = np.zeros((K, u), np.int32)  # the initial value's payload words
    want[keys] = vals
    unwritten = np.setdiff1d(np.arange(K), keys)
    rkeys = np.concatenate([keys[: n // 2],
                            rng.choice(unwritten, n // 2, replace=False)])
    res, mget_s = _timed(torch, lambda: kvs.multi_get(rkeys))
    sc, scan_s = _timed(torch, lambda: kvs.scan(0, K))
    for name, r, k in (("multi_get", res, rkeys), ("scan", sc, np.arange(K))):
        if not r.all_done() or r.local_served != len(k) or r.fallbacks:
            raise AssertionError(f"{name}: {r.local_served} of {len(k)} "
                                 f"served locally, {r.fallbacks} fallbacks")
        bad = np.nonzero((r.value != want[k]).any(axis=1))[0]
        if bad.size or not (r.key == k).all():
            raise AssertionError(f"{name}: {bad.size} wrong answers, first "
                                 f"key {k[bad[:1]]}")
    # one key fenced ahead of its row must go through the round path
    fkey = int(keys[0])
    kvs.pin_read_fence("smoke", fkey, (int(bf.tsv[0]) + 1, 0))
    fres = kvs.multi_get([fkey], session="smoke")
    if (not fres.all_done() or fres.local[0] or fres.fallbacks != 1
            or (fres.value[0] != vals[0]).any()):
        raise AssertionError("the fenced key was not served by the round "
                             f"path: local {fres.local[0]}")
    stats = kvs.read_stats()
    # the read dispatches alone (gather or slice, decode, copy to the
    # host), without the KVS's host work: where the two calls' time goes
    reader = kvs._get_reader()
    _, mget_dispatch_s = _timed(torch, lambda: reader.multi_get(rkeys))
    _, scan_dispatch_s = _timed(torch, lambda: reader.scan(0, K))
    t0 = time.perf_counter()
    v = kvs.rt.check()
    check_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stale = lin.stale_read(kvs.rt.history_ops())
    stale_s = time.perf_counter() - t0
    row = 4 * (2 + cfg.value_words)
    emit({"phase": "reads", "nvidia_smi": card, "keys": K, "puts": n,
          "put_s": put_s, "rounds": kvs.rt.step_idx,
          "multi_get_keys": n, "multi_get_s": mget_s,
          "multi_get_reads_per_s": n / mget_s,
          "multi_get_gb_per_s": n * row / mget_s / 1e9,
          "scan_rows": K, "scan_s": scan_s, "scan_reads_per_s": K / scan_s,
          "scan_gb_per_s": K * row / scan_s / 1e9,
          "multi_get_dispatch_s": mget_dispatch_s,
          "scan_dispatch_s": scan_dispatch_s, "read_stats": stats,
          "check_ok": v.ok, "check_s": check_s, "stale_read": len(stale),
          "stale_read_s": stale_s,
          "stats_block_launches": kernels.stats_block.launches})
    if stats["fallback_reads"] != 1 or stats["ryw_fallbacks"] != 1:
        raise AssertionError(f"fallbacks beyond the forced one: {stats}")
    if not v.ok or stale:
        raise AssertionError(f"checker {v.ok}, stale reads {stale[:2]}")
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != KVS rounds")
    if sh is not None:
        del kvs, reader
        emit(dict({"phase": "reads-sharded", "nvidia_smi": card},
                  **sharded_reads(torch, np, kernels, types, KVS, sh)))


def phase_values(torch, np, kernels, types, config, KVS, layouts, ycsb,
                 card):
    """The value heap at the bench shape: churn past the heap's
    capacity, byte-exact reads, device gathers equal to the mirror."""
    cfg = _kvs_cfg(config, max_value_bytes=1024,
                   heap_bytes=layouts.MAX_HEAP_BYTES)
    kvs = KVS(cfg, device="cuda")
    kernels.stats_block.launches = 0
    n = VALUES_KEYS
    keys = np.random.default_rng(VALUES_SEED).choice(
        cfg.n_keys, n, replace=False).astype(np.int64)
    lens = ycsb.value_sizes(dict(n=2 * n, max_bytes=1024), VALUES_SEED)
    pays = [ycsb.value_payload(VALUES_SEED, i, int(lens[i]))
            for i in range(2 * n)]
    put_s = 0.0
    # put every key, then overwrite every key once, in batches of
    # VALUES_CHUNK: an overwritten batch's old extents are dead by the
    # time the heap fills, so the pressure GC has bytes to reclaim
    for lo in range(0, 2 * n, VALUES_CHUNK):
        sl = slice(lo % n, lo % n + VALUES_CHUNK)
        batch = pays[lo:lo + VALUES_CHUNK]
        bf, s1 = _timed(torch, lambda: kvs.submit_batch(
            np.full(len(batch), KVS.PUT, np.int32), keys[sl], batch))
        ok, s2 = _timed(torch, lambda: kvs.run_batch(bf, 64))
        put_s += s1 + s2
        if not ok or not (bf.code == types.C_WRITE).all():
            raise AssertionError(f"the put batch at {lo} did not commit")
    put_bytes = int(lens.sum())
    latest = pays[n:]
    res, get_s = _timed(torch, lambda: kvs.multi_get(keys))
    if not res.all_done() or res.data != latest:
        bad = [i for i in range(n) if res.data[i] != latest[i]]
        raise AssertionError(f"{len(bad)} values not byte-exact")
    heap = kvs.heap
    refs = res.value[:, 0].copy()
    (rows, glens), gather_s = _timed(torch,
                                     lambda: heap.device_gather(refs))
    for i in range(n):
        ln = int(glens[i])
        if rows[i, :ln].tobytes() != heap.read(int(refs[i])) \
                or rows[i, ln:].any():
            raise AssertionError(f"device gather of ref {refs[i]:#x} "
                                 "differs from the mirror")
    gc_runs = heap.gc_runs
    st = kvs.heap_gc(reason="smoke")
    after = kvs.multi_get(keys)
    get_bytes = sum(len(d) for d in latest)
    emit({"phase": "values", "nvidia_smi": card, "keys": n,
          "puts": 2 * n, "rounds": kvs.rt.step_idx,
          "put_s": put_s, "writes_per_s": 2 * n / put_s,
          "put_gb_per_s": put_bytes / put_s / 1e9,
          "get_s": get_s, "read_gb_per_s": get_bytes / get_s / 1e9,
          "gather_s": gather_s,
          "device_gather_gb_per_s": int(glens.sum()) / gather_s / 1e9,
          "pressure_gc_runs": gc_runs, "heap": st,
          "stats_block_launches": kernels.stats_block.launches})
    if gc_runs < 1:
        raise AssertionError("the churn never ran a pressure GC")
    if not st or st["live_bytes"] > st["used_bytes"]:
        raise AssertionError(f"heap_gc gave {st}")
    if after.data != latest:
        raise AssertionError("values changed across the explicit GC")
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != KVS rounds")


DURABLE_WAVES = 5  # the child is killed in the last one
DURABLE_WAVE_PUTS = 131072
DURABLE_CHILD_TIMEOUT_S = 600
RECOVERY_BOUND_S = 90.0  # the JAX package's durability gate's bound
OBSERVED_WEDGED = 16  # per-op puts coordinated on the frozen replica 7


def _fstype(path):
    """The file system type under ``path`` (the longest mount prefix in
    /proc/self/mounts): the WAL's fsync cost depends on it."""
    best, kind = "", "unknown"
    try:
        with open("/proc/self/mounts") as f:
            for ln in f:
                parts = ln.split()
                if len(parts) > 2 and path.startswith(parts[1]) \
                        and len(parts[1]) > len(best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return kind


def _wave_timed(torch, np, kvs, types, wave, n):
    """One wave of ``n`` distinct-key puts through submit_batch, on the
    host clock ending in torch.cuda.synchronize(); returns seconds."""
    from hermes_tpu_torch.wal import crashdrive

    keys, vals = crashdrive.wave_ops(kvs.cfg, wave, n)

    def run():
        bf = kvs.submit_batch(np.full(n, kvs.PUT, np.int32), keys, vals)
        return kvs.run_batch(bf, 256) and (bf.code == types.C_WRITE).all()

    ok, s = _timed(torch, run)
    if not ok:
        raise AssertionError(f"wave {wave}: the puts did not all commit")
    return s


def _card_free_after_child(torch, free_before):
    """The card once the killed child is reaped: its memory back within
    256 MiB of what was free before it started (polled for 10 s)."""
    for _ in range(100):
        free = torch.cuda.mem_get_info()[0]
        if free >= free_before - (256 << 20):
            return free
        time.sleep(0.1)
    raise AssertionError(f"the card holds {(free_before - free) >> 20} MiB "
                         "more after the killed child was reaped")


def phase_durable(torch, np, kernels, types, KVS, port, card):
    """A KVS child with the WAL on at the bench shape, killed by SIGKILL
    in the middle of its last wave; the parent recovers the whole store
    and holds it to the child's witness and to the log."""
    import shutil
    import signal
    import tempfile

    crashdrive, replay = port.crashdrive, port.replay
    tmp = tempfile.mkdtemp(prefix="hermes_durable_")
    try:
        wal_dir, wit = os.path.join(tmp, "wal"), os.path.join(tmp, "wit")
        torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "hermes_tpu_torch.wal.crashdrive",
             wal_dir, wit, "--waves", str(DURABLE_WAVES),
             "--wave-puts", str(port.wave_puts), "--shape", port.shape,
             "--device", port.device],
            cwd=port.root, capture_output=True, text=True,
            timeout=DURABLE_CHILD_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"the child exited {child.returncode}, want death by "
                f"signal 9\n{child.stderr[-3000:]}")
        free_after = _card_free_after_child(torch, free_before)
        scan = replay.read_records(wal_dir)
        log_bytes = sum(os.path.getsize(p) for p in scan["segments"])
        cfg = crashdrive.crash_cfg(port.shape, wal_dir)
        kernels.stats_block.launches = 0
        t0 = time.perf_counter()
        kvs, summary = port.recover_store(cfg, device=port.device)
        torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        resumed = kvs.rt.step_idx
        got = crashdrive.check_recovery(kvs, scan["records"], wit)
        # writes/s with the WAL on (the recovered store, commit) against
        # off (a fresh store), in turns: on off off on
        off = KVS(dataclasses.replace(cfg, wal_dir=None), device=port.device)
        for i, store in enumerate((kvs, off)):  # one untimed wave each
            _wave_timed(torch, np, store, types, 90 + i, port.wave_puts)
        waves = {"on": [], "off": []}
        for i, (label, store) in enumerate((("on", kvs), ("off", off),
                                            ("off", off), ("on", kvs))):
            waves[label].append(_wave_timed(torch, np, store, types,
                                            100 + i, port.wave_puts))
        wal_stats = kvs.wal.stats()
        kvs.wal.close()
        rounds = (kvs.rt.step_idx - resumed) + off.rt.step_idx
        rate = {k: [port.wave_puts / s for s in v]
                for k, v in waves.items()}
        emit({"phase": "durable", "nvidia_smi": card,
              "wal_fs": _fstype(tmp), "waves": DURABLE_WAVES,
              "wave_puts": port.wave_puts, "child_s": child_s,
              "child_rc": child.returncode,
              "card_free_mib": [free_before >> 20, free_after >> 20],
              "records": summary["records"], "applied": summary["applied"],
              "skipped": summary["skipped"],
              "torn_tail": summary["torn_tail"],
              "log_bytes": log_bytes, "recovery_s": recovery_s,
              "check": got, "wal_on_wave_s": waves["on"],
              "wal_off_wave_s": waves["off"],
              "wal_on_writes_per_s": rate["on"],
              "wal_off_writes_per_s": rate["off"],
              "on_vs_off": (statistics.median(rate["on"])
                            / statistics.median(rate["off"])),
              "wal_fsyncs": wal_stats["fsyncs"], "rounds": rounds,
              "stats_block_launches": kernels.stats_block.launches})
        if recovery_s >= RECOVERY_BOUND_S:
            raise AssertionError(f"recovery took {recovery_s:.1f} s, bound "
                                 f"{RECOVERY_BOUND_S} s")
        if kernels.stats_block.launches != rounds:
            raise AssertionError("stats_block launches != KVS rounds")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_restart(torch, np, kernels, types, KVS, port, card):
    """restart_replica of replica 3 at the bench shape, from a snapshot
    and the WAL tail, with ops in flight on it."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="hermes_restart_")
    try:
        wal_dir = os.path.join(tmp, "wal")
        cfg = port.kvs_cfg(wal_dir=wal_dir, wal_sync="commit")
        kvs = KVS(cfg, record="array", device=port.device)
        kernels.stats_block.launches = 0
        _wave_timed(torch, np, kvs, types, 200, port.wave_puts // 2)
        snap = os.path.join(tmp, "snap.npz")
        _, save_s = _timed(torch, lambda: port.snapshot.save(snap, kvs))
        _wave_timed(torch, np, kvs, types, 201, port.wave_puts // 2)
        # per-op puts coordinated on replica 3, caught in flight by the
        # crash (replica 5 frozen: no ack quorum)
        kvs.freeze(5)
        futs = [kvs.put(3, s, 1000 + s, [s, 3]) for s in range(16)]
        kvs.step()
        kvs.step()
        kvs.wal.sync()
        donor = kvs.rt.fs.table.bank.clone()
        donor_vpts = kvs.rt.fs.table.vpts.clone()
        summary, restart_s = _timed(torch, lambda: port.restart_replica(
            kvs, 3, snapshot_path=snap, wal_dir=wal_dir))
        same = (torch.equal(kvs.rt.fs.table.bank, donor)
                and torch.equal(kvs.rt.fs.table.vpts, donor_vpts))
        kvs.rt.thaw(5)
        lost = sum(f.done() and f.result().kind == "lost" for f in futs)
        after = [kvs.put(3, s, 2000 + s, [s, 4]) for s in range(16)]
        if not kvs.run_until(after, 256):
            raise AssertionError("the restarted replica commits nothing")
        for _ in range(8):
            kvs.step()
        t0 = time.perf_counter()
        v = kvs.rt.check()
        check_s = time.perf_counter() - t0
        kvs.wal.close()
        emit({"phase": "restart", "nvidia_smi": card, "summary": summary,
              "snapshot_bytes": os.path.getsize(snap),
              "snapshot_save_s": save_s, "restart_s": restart_s,
              "table_equals_donor": same, "lost_futures": lost,
              "check_ok": v.ok, "check_s": check_s,
              "rounds": kvs.rt.step_idx,
              "stats_block_launches": kernels.stats_block.launches})
        if summary["source"] != "snapshot" or summary["wal_applied"] != 0 \
                or not summary["wal_skipped"]:
            raise AssertionError(f"restart_replica gave {summary}")
        if not same:
            raise AssertionError("the table after the restart differs from "
                                 "the donor's copy")
        if lost != summary["lost_client_futures"] or not lost:
            raise AssertionError(f"{lost} futures lost, summary "
                                 f"{summary['lost_client_futures']}")
        if not v.ok:
            raise AssertionError("the checker failed after the restart")
        if kernels.stats_block.launches != kvs.rt.step_idx:
            raise AssertionError("stats_block launches != KVS rounds")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_observed(torch, np, kernels, types, KVS, port, card):
    """The obs context, per-op tracing, the watchdog and the bounded
    retry at the bench shape: ops wedged on a frozen replica are
    reported once, dumped, retried on healthy replicas and resolve."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="hermes_observed_")
    try:
        cfg = port.kvs_cfg(trace_sample=64, op_timeout_rounds=8,
                           op_retry_limit=2)
        kvs = KVS(cfg, record="array", device=port.device)
        log = os.path.join(tmp, "run.jsonl")
        obs = kvs.rt.attach_obs(port.Observability(
            path=log, trace_steps=True,
            flight_dir=os.path.join(tmp, "flight")))
        # recorded like the traced store: the pair differs by the obs
        # context and the sampler alone
        plain = KVS(port.kvs_cfg(), record="array", device=port.device)
        kernels.stats_block.launches = 0
        for i, store in enumerate((kvs, plain)):  # one untimed wave each
            _wave_timed(torch, np, store, types, 290 + i,
                        port.wave_puts // 2)
        waves = {"traced": [], "untraced": []}
        for i, (label, store) in enumerate((
                ("traced", kvs), ("untraced", plain),
                ("untraced", plain), ("traced", kvs))):
            waves[label].append(_wave_timed(torch, np, store, types,
                                            300 + i, port.wave_puts // 2))
        kvs.freeze(7)
        futs = [kvs.put(7, s, 3000 + s, [s, 7])
                for s in range(OBSERVED_WEDGED)]
        # wedged past the timeout, each op is reported, dumped, salvaged
        # off the frozen coordinator and re-enqueued on a healthy one
        for _ in range(4 * cfg.op_timeout_rounds):
            kvs.step()
            if kvs.retried_ops >= OBSERVED_WEDGED:
                break
        kvs.remove(7)  # the retried ops' quorum no longer waits on 7
        if not kvs.run_until(futs, 256):
            raise AssertionError("the wedged futures never resolved")
        for _ in range(8):
            kvs.step()
        v = kvs.rt.check()
        obs.close()
        with open(log) as f:
            recs = [json.loads(ln) for ln in f]
        stuck = [r for r in recs if r.get("name") == "stuck_op"]
        retries = [r for r in recs if r.get("name") == "op_retry"]
        dumped = [port.flightrec.load(p) for p in obs.flight.dumps]
        dumped_keys = sorted(d["key"] for p in dumped
                             for d in p["extra"]["diags"])
        kinds = [f.result().kind for f in futs]
        ts = [r["t"] for r in recs]
        rate = {k: [port.wave_puts // 2 / s for s in v]
                for k, v in waves.items()}
        rounds = kvs.rt.step_idx + plain.rt.step_idx
        emit({"phase": "observed", "nvidia_smi": card,
              "records": len(recs), "spans": sum(
                  r["kind"] == "span_end" for r in recs),
              "op_spans": len(port.canonical_span_bytes(recs).splitlines()),
              "stuck_op_events": len(stuck), "flight_dumps": len(dumped),
              "retries": len(retries), "retried_ops": kvs.retried_ops,
              "retry_targets": sorted({r["target"] for r in retries}),
              "kinds": sorted(set(kinds)), "check_ok": v.ok,
              "traced_wave_s": waves["traced"],
              "untraced_wave_s": waves["untraced"],
              "traced_writes_per_s": rate["traced"],
              "untraced_writes_per_s": rate["untraced"],
              "traced_vs_untraced": (statistics.median(rate["traced"])
                                     / statistics.median(rate["untraced"])),
              "rounds": rounds,
              "stats_block_launches": kernels.stats_block.launches})
        want_keys = list(range(3000, 3000 + OBSERVED_WEDGED))
        if sorted(r["key"] for r in stuck) != want_keys or any(
                r["replica"] != 7 for r in stuck):
            raise AssertionError(f"stuck_op events for keys "
                                 f"{sorted(r['key'] for r in stuck)}")
        if dumped_keys != want_keys or any(
                p["reason"] != "stuck_op" for p in dumped):
            raise AssertionError(f"flight archives hold keys {dumped_keys}")
        if len(retries) != OBSERVED_WEDGED or any(
                r["target"] == 7 for r in retries):
            raise AssertionError(f"retries {retries[:4]}")
        if set(kinds) != {"put"} or not v.ok:
            raise AssertionError(f"futures {set(kinds)}, checker {v.ok}")
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise AssertionError("the run log's t values decrease")
        if kernels.stats_block.launches != rounds:
            raise AssertionError("stats_block launches != KVS rounds")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# The failure detector, fault schedules, live resize and degraded mode
# --------------------------------------------------------------------------

CHAOS_ROUNDS = 64
CHAOS_CONFIRM = 2  # the detector's confirm window, rounds
# bench-a's lease is 8 rounds and the ring 2 deep: replica 5, frozen at 2,
# is removed by the detector around round 14 (until then it holds every
# commit back: Hermes waits for every live replica's ack); replica 1, cut
# off at 22 but still running, around round 33; both come back at the
# heal of round 54.  The skew of replica 2 lapses inside the confirm
# window (suspect, then clear).  The crashes come while every live
# replica is unfrozen: a crash while commits are held back would leave
# one stuck key per held write, for the replay scan to take 256 a scan
CHAOS_SCHEDULE = """
@2 freeze 5
@6 hb_skew 2 skew=12 until=8
@18 crash_restart 3
@20 remove 6
@22 partition 1 until=40
@26 join 6 donor=0
@30 thaw 5
@36 crash_restart 2
@44 freeze 7
@50 thaw 7
@54 heal
"""
CHAOS_KINDS = ("freeze", "thaw", "join", "crash_restart", "hb_skew",
               "partition")
DETECT_ORDER = ("off", "on", "on", "off")
DETECT_ROUNDS = 30  # a window's rounds (cut from 60: PERF.md §4)
# rounds between two restarts: 4 + 3 * 8 + 3 rounds (cut from 6 for the
# fleet and serving phases' room, PERF.md §4)
DRILL_SPACING = 3
RESIZE_HOLD = 8
RESIZE_SESSIONS = 16384  # a replica; the reads shape's 65,536, cut (PERF §4)
RESIZE_RETIRED_PUTS = 4  # per-op puts sent to each replica while retired
DEGRADED_FLOOR = 5
DEGRADED_FROZEN = (4, 5, 6, 7)  # 4 of 8 healthy: under the floor
DEGRADED_OPS = 16384


def _quiesce_drain(rt, settled=None, limit=256):
    """Rounds with new intake paused until nothing is in flight and
    ``settled()`` holds (bench-a's streams wrap, so a drain to the streams'
    end never comes).  A key a crashed coordinator left INVALID waits for
    the replay scan (every 32nd round, once it is ``replay_age`` rounds
    old), so ``settled`` is every key VALID there."""
    rt.quiesce = True
    n = 0
    while (rt._inflight_count() or (settled and not settled())) \
            and n < limit:
        rt.step_once()
        n += 1
    rt.quiesce = False
    rt.flush_pipeline()
    return n


def _recorded_split(recorder):
    """(completion rows, maybe_w rows) the recorder holds: a crash folds
    its in-flight updates in as maybe_w rows (code -1)."""
    maybe = sum(int((c["code"] == -1).sum()) for c in recorder._chunks)
    return recorder.n_recorded - maybe, maybe


def _all_valid(ch, rt):
    K = rt.cfg.n_keys
    rows = ch.fst.copies(rt.fs.table.bank, K)
    sst = ch.fst._bank_to_i32(rows[..., 4:8])[..., 0]
    return bool(((sst & 7) == ch.types.VALID).all())


def _checking_joins(torch, ch, rt, joins):
    """Wrap ``rt.join`` (the schedule's joins, the heal's and the crash
    restarts') so that each join holds the joiner's new copy against its
    donor's: vpts, pts and value bytes equal; each row's state the donor's
    with WRITE, TRANS and REPLAY folded to INVALID, stamped this round."""
    join = rt.join
    T = ch.types

    def checked(replica, from_replica):
        join(replica, from_replica)
        jv, jb = rt.copy_of(replica)
        dv, db = rt.copy_of(from_replica)
        js = ch.fst._bank_to_i32(jb[:, 4:8])[:, 0]
        ds = ch.fst._bank_to_i32(db[:, 4:8])[:, 0]
        dstate = ds & 7
        folded = torch.where((dstate == T.WRITE) | (dstate == T.TRANS)
                             | (dstate == T.REPLAY), T.INVALID, dstate)
        same = (torch.equal(jv, dv) and torch.equal(jb[:, 0:4], db[:, 0:4])
                and torch.equal(jb[:, 8:], db[:, 8:])
                and torch.equal(js & 7, folded)
                and bool((ch.fst.sst_step(js) == rt.step_idx).all()))
        joins.append({"replica": replica, "donor": from_replica,
                      "round": rt.step_idx, "equal": same,
                      "folded": int((folded != dstate).sum())})

    rt.join = checked


def phase_chaos(torch, counters, ch, card, sharded=False):
    """bench-a at depth 2, recorded, the detector attached
    (``confirm_steps=2``), through ``CHAOS_SCHEDULE`` for 64 rounds, healed
    and quiesced: the checker passes, every key is VALID, the device op
    counters equal the recorded completions (a crash's lost in-flight
    updates are maybe_w rows beside them, at most its lost ops), the
    pipelined detector fetched nothing synchronously, and each kernel's
    launches equal the rounds as declared.  ``sharded``: the same on the
    sharded engine with ``mega_round=True``; each join's copy is held
    against its donor's."""
    cfg = ch.cfg(pipeline_depth=2, mega_round=sharded)
    if sharded:
        rt = ch.FastRuntime(cfg, backend="sharded", record="array",
                            group=ch.LocalGroup(ch.device))
    else:
        rt = ch.FastRuntime(cfg, record="array", device=ch.device)
    obs = rt.attach_obs(ch.Observability())
    rt.attach_membership(ch.MembershipService(cfg,
                                              confirm_steps=CHAOS_CONFIRM))
    joins = []
    if sharded:
        _checking_joins(torch, ch, rt, joins)
    runner = ch.chaos.ChaosRunner(rt, ch.chaos.Schedule.parse(CHAOS_SCHEDULE))
    for w in counters.values():
        w.launches = 0
    ch.sync()
    t0 = time.perf_counter()
    # heal at the end; the drain to the streams' end is left out (they
    # wrap): the quiesce drain below settles the cluster instead
    res = runner.run(CHAOS_ROUNDS, heal=True, drain_steps=0)
    ch.sync()
    wall = time.perf_counter() - t0
    drained = _quiesce_drain(rt, lambda: _all_valid(ch, rt))
    launches = {name: w.launches for name, w in counters.items()}
    want = sharded_expected_launches(cfg, 0, rt.step_idx, rt.n_copies)
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded, maybe_w = _recorded_split(rt.recorder)
    valid = _all_valid(ch, rt)
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    names = [r["name"] for r in obs.records if r.get("kind") == "event"]
    kinds = sorted({e["kind"] for e in runner.log})
    detector = [(e.step, e.kind, e.replica) for e in rt.membership.events]
    out = {"phase": "chaos-sharded-mega" if sharded else "chaos",
           "nvidia_smi": card, "rounds": CHAOS_ROUNDS,
           "us_per_round": wall / CHAOS_ROUNDS * 1e6,
           "drain_rounds": drained, "executed": runner.log,
           "membership_events": detector,
           "suspects": names.count("suspect"),
           "suspect_clears": names.count("suspect_clear"),
           "membership_fetch": names.count("membership_fetch"),
           "lost_ops": res["lost_ops"], "device_ops": device_ops,
           "recorded_ops": recorded, "maybe_w_rows": maybe_w,
           "launches": {k: launches[k] for k in want},
           "all_keys_valid": valid, "check_ok": v.ok,
           "keys_checked": v.keys_checked, "check_s": check_s}
    if sharded:
        out["copies"] = rt.n_copies
        out["joins"] = joins
    emit(out)
    missing = [k for k in CHAOS_KINDS if k not in kinds]
    if missing or not any(k == "remove" for _, k, _ in detector):
        raise AssertionError(f"the executed log lacks {missing} (detector "
                             f"events {detector})")
    if out["membership_fetch"]:
        raise AssertionError(f"{out['membership_fetch']} synchronous "
                             "membership fetches in a pipelined run")
    if not v.ok:
        raise AssertionError(f"linearizability check failed: "
                             f"{[f.reason[:200] for f in v.failures[:3]]}")
    if rt._inflight_count() or not valid:
        raise AssertionError("the healed store did not converge to "
                             "all-VALID")
    if device_ops != recorded or maybe_w > res["lost_ops"]:
        raise AssertionError(f"device op counters {device_ops} != recorded "
                             f"completions {recorded} (maybe_w {maybe_w}, "
                             f"lost {res['lost_ops']})")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"kernel launches {launches} in the chaos run, "
                             f"want {want}")
    if sharded and (len(joins) < 3 or not all(j["equal"] for j in joins)):
        raise AssertionError(f"a joiner's copy differs from its donor's: "
                             f"{joins}")
    return out


def phase_detect_cost(torch, ch, card):
    """What the detector costs: bench-a at depth 2 with completions
    harvested, one runtime without a detector and one with,
    ``ch.rounds``-round windows in turns off on on off; host us/round of
    each window and a
    profiled window's device busy share of each setting."""
    cfg = ch.cfg(pipeline_depth=2)
    rts = {}
    obs = {}
    for name in ("off", "on"):
        rt = ch.FastRuntime(cfg, device=ch.device)
        # both carry an obs context (the fetch count reads it), so the
        # pair differs by the detector alone
        obs[name] = rt.attach_obs(ch.Observability())
        if name == "on":
            rt.attach_membership(ch.MembershipService(cfg))
        rt.run(4)
        rts[name] = rt
    us = {"off": [], "on": []}
    for name in DETECT_ORDER:
        wall, _, _ = timed_window(torch, rts[name], ch.rounds)
        us[name].append(wall / ch.rounds * 1e6)
    busy = {}
    for name, rt in rts.items():
        b = ch.device_busy(torch, lambda rt=rt: rt.run(SHARDED_PROFILED),
                           "detect-cost", (rt,))
        busy[name] = {"busy_share": b["busy_s"] / b["wall_s"],
                      "device_us_per_round":
                          b["busy_s"] / SHARDED_PROFILED * 1e6,
                      "profiled_us_per_round":
                          b["wall_s"] / SHARDED_PROFILED * 1e6}
    for rt in rts.values():
        rt.flush_pipeline()
    fetches = sum(r.get("name") == "membership_fetch"
                  for r in obs["on"].records)
    out = {"phase": "detect-cost", "nvidia_smi": card,
           "order": " ".join(DETECT_ORDER), "rounds_per_window": ch.rounds,
           "us_per_round": us, "busy": busy,
           "median_us_per_round": {k: statistics.median(v)
                                   for k, v in us.items()},
           "membership_fetch": fetches,
           "harvested_round": rts["on"].harvested_ages[0],
           "rounds": rts["on"].step_idx}
    out["on_over_off"] = (out["median_us_per_round"]["on"]
                          / out["median_us_per_round"]["off"])
    emit(out)
    if fetches:
        raise AssertionError(f"{fetches} synchronous membership fetches")
    if rts["on"].step_idx - rts["on"].harvested_ages[0] > 2:
        raise AssertionError("the detector's ages lag the ring")
    return out


def phase_drill(torch, kernels, ch, card):
    """``run_rolling_restart`` on bench-a at depth 2, recorded: every
    replica crash-restarted, ``DRILL_SPACING`` rounds apart, under load;
    then a quiesce drain and the checker.  Each restart's host seconds
    (the call, ending in a device sync)."""
    cfg = ch.cfg(pipeline_depth=2)
    rt = ch.FastRuntime(cfg, record="array", device=ch.device)
    restart = ch.recovery.restart_replica
    restart_s = []

    def timed_restart(*args, **kwargs):
        t0 = time.perf_counter()
        out = restart(*args, **kwargs)
        ch.sync()
        restart_s.append(time.perf_counter() - t0)
        return out

    kernels.stats_block.launches = 0
    ch.recovery.restart_replica = timed_restart
    try:
        t0 = time.perf_counter()
        res = ch.elastic.run_rolling_restart(rt, spacing=DRILL_SPACING,
                                             heal=False)
        ch.sync()
        wall = time.perf_counter() - t0
    finally:
        ch.recovery.restart_replica = restart
    drained = _quiesce_drain(rt, lambda: _all_valid(ch, rt))
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded, maybe_w = _recorded_split(rt.recorder)
    valid = _all_valid(ch, rt)
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    out = {"phase": "drill", "nvidia_smi": card, "steps": res["steps"],
           "spacing": DRILL_SPACING, "restarts": res["restarts"],
           "lost_ops": res["lost_ops"], "dip": res["dip"],
           "restart_s": restart_s, "wall_s": wall,
           "us_per_round": wall / rt.step_idx * 1e6,
           "drain_rounds": drained, "rounds": rt.step_idx,
           "device_ops": device_ops, "recorded_ops": recorded,
           "maybe_w_rows": maybe_w, "all_keys_valid": valid,
           "check_ok": v.ok, "check_s": check_s,
           "stats_block_launches": kernels.stats_block.launches}
    emit(out)
    if res["restarts"] != cfg.n_replicas or len(restart_s) != cfg.n_replicas:
        raise AssertionError(f"{res['restarts']} restarts, want "
                             f"{cfg.n_replicas}")
    if not v.ok or rt._inflight_count() or not valid:
        raise AssertionError(f"checker {v.ok}, in flight "
                             f"{rt._inflight_count()}, all VALID {valid}")
    if device_ops != recorded or maybe_w > res["lost_ops"]:
        raise AssertionError(f"device op counters {device_ops} != recorded "
                             f"completions {recorded}")
    if kernels.stats_block.launches != rt.step_idx:
        raise AssertionError("stats_block launches != drill rounds")
    return out


def phase_resize(torch, np, kernels, ch, card):
    """The KVS at the reads shape (``RESIZE_SESSIONS`` a replica, recorded,
    ``min_healthy_for_writes=5``): ``rolling_resize`` with ``hold_steps=8``
    under a ``submit_drill_mix`` standing load sized as the reference CLI
    sizes it; per-op puts sent to each replica while it is retired come
    back ``rejected``; the load then completes, nothing stranded.  Then
    degraded mode: four replicas frozen (4 healthy, under the floor), a
    mixed batch on replica 0's sessions returns every write ``C_REJECTED``
    and answers every get; thawed, writes commit again; the trace shows
    ``degraded`` then ``degraded_clear``; the checker passes."""
    cfg = ch.kvs_cfg(n_sessions=RESIZE_SESSIONS,
                     min_healthy_for_writes=DEGRADED_FLOOR)
    kvs = ch.KVS(cfg, record="array", device=ch.device)
    obs = kvs.rt.attach_obs(ch.Observability())
    kernels.stats_block.launches = 0
    R, S = cfg.n_replicas, cfg.n_sessions
    rounds_est = R * (2 * RESIZE_HOLD + 6) + 24  # hermes_tpu/cli.py's
    n_ops = rounds_est * R * S
    bf, submit_s = _timed(torch, lambda: ch.elastic.submit_drill_mix(
        kvs, n_ops, seed=ch.seed))
    shrink = kvs.shrink
    retired_kinds = []

    def shrink_and_probe(replica, *args, **kwargs):
        shrink(replica, *args, **kwargs)
        retired_kinds.extend(
            kvs.put(replica, s, s, [replica, s]).result().kind
            for s in range(RESIZE_RETIRED_PUTS))

    kvs.shrink = shrink_and_probe
    t0 = time.perf_counter()
    res = ch.elastic.rolling_resize(kvs, hold_steps=RESIZE_HOLD)
    ch.sync()
    drill_s = time.perf_counter() - t0
    drill_rounds = kvs.rt.step_idx
    done_in_drill = bf.done_count()
    load_ok, load_s = _timed(torch, lambda: kvs.run_batch(bf))
    kvs.flush()
    codes = np.asarray(bf.code)
    # degraded mode
    for r in DEGRADED_FROZEN:
        kvs.freeze(r)
    # half gets, half puts; the gets all fit replica 0's idle sessions
    n_deg = min(DEGRADED_OPS, 2 * S)
    rng = np.random.default_rng(ch.seed + 1)
    dk = rng.integers(0, cfg.n_keys, n_deg).astype(np.int64)
    dkind = np.where(np.arange(n_deg) % 2 == 0, ch.KVS.GET,
                     ch.KVS.PUT).astype(np.int32)
    dval = rng.integers(0, 1 << 20, (n_deg, cfg.value_words - 2),
                        dtype=np.int64).astype(np.int32)
    degraded = kvs.degraded()
    dbf = kvs.submit_batch(dkind, dk, dval)
    shed_at_submit = int((dbf.code == ch.C_REJECTED).sum())
    dbf_done = kvs.run_batch(dbf, 64)
    gets = dkind == ch.KVS.GET
    answered = int((dbf.code[gets] == ch.types.C_READ).sum())
    for r in DEGRADED_FROZEN:
        kvs.rt.thaw(r)
    after = kvs.submit_batch(np.full(n_deg // 2, ch.KVS.PUT, np.int32),
                             dk[~gets], dval[~gets])
    after_ok = kvs.run_batch(after, 64)
    kvs.flush()
    trace = [r["name"] for r in obs.records
             if r.get("name", "").startswith("degraded")]
    t0 = time.perf_counter()
    v = kvs.rt.check()
    check_s = time.perf_counter() - t0
    out = {"phase": "resize", "nvidia_smi": card, "sessions": S,
           "hold_steps": RESIZE_HOLD, "resizes": res["resizes"],
           "cycles": res["cycles"], "dip": res["dip"],
           "rejected_ops": kvs.rejected_ops,
           "retired_put_kinds": sorted(set(retired_kinds)),
           "load_submitted": n_ops, "load_submit_s": submit_s,
           "load_done_in_drill": done_in_drill,
           "load_done": bf.done_count(), "load_rejected":
               int((codes == ch.C_REJECTED).sum()),
           "drill_s": drill_s, "drill_rounds": drill_rounds,
           "us_per_round": drill_s / drill_rounds * 1e6,
           "load_finish_s": load_s, "rounds": kvs.rt.step_idx,
           "degraded_before_batch": degraded, "degraded_batch": n_deg,
           "degraded_shed": shed_at_submit, "shed_writes": kvs.shed_writes,
           "degraded_gets_answered": answered,
           "writes_after_thaw": int((after.code == ch.types.C_WRITE).sum()),
           "degraded_trace": trace, "check_ok": v.ok, "check_s": check_s,
           "stats_block_launches": kernels.stats_block.launches}
    emit(out)
    if res["resizes"] != R or not load_ok or bf.done_count() != n_ops:
        raise AssertionError(f"{res['resizes']} resizes; {bf.done_count()} "
                             f"of {n_ops} load ops done")
    if done_in_drill < n_ops // 2:
        raise AssertionError("the standing load did not run under the "
                             "drill")
    if (retired_kinds != ["rejected"] * (R * RESIZE_RETIRED_PUTS)
            or kvs.rejected_ops != len(retired_kinds) or out["load_rejected"]):
        raise AssertionError(f"ops to retired replicas {retired_kinds[:4]}, "
                             f"rejected_ops {kvs.rejected_ops}")
    if (not degraded or shed_at_submit != int((~gets).sum()) or not dbf_done
            or answered != int(gets.sum())):
        raise AssertionError("degraded mode did not shed every write and "
                             "answer every get")
    if not after_ok or out["writes_after_thaw"] != n_deg // 2:
        raise AssertionError("writes did not commit after the thaw")
    if trace != ["degraded", "degraded_clear"] or kvs.degraded():
        raise AssertionError(f"degraded trace {trace}")
    if not v.ok:
        raise AssertionError("the checker failed after the resize drill")
    if kernels.stats_block.launches != kvs.rt.step_idx:
        raise AssertionError("stats_block launches != KVS rounds")
    return out


# -- range migration and the fleet -----------------------------------------

MIGRATE_STAGES = ("fence", "drain", "snapshot", "transfer", "restore",
                  "flip")
# the migrate drill's standing mix, in rounds of R x S ops: about half
# of it still queued when the fence falls (the drill steps 4 rounds)
MIGRATE_LIVE_ROUNDS = 8
FLEET_GROUPS = 4
FLEET_MIX_OPS = 262144  # ops of the fleet's mix, and of its standing batch
FLEET_MOVE = 65536  # fleet keys moved from group 0 to group 3
FLEET_CHAOS_ROUNDS = 64
FLEET_CHAOS_SEED = 2  # draws crashes in groups 0 and 2 (1 and 3 emptied)
FLEET_CHAOS_OPS = 8192  # fleet-wide ops submitted each chaos round
FLEET_BENCH_ROUNDS = 20


def _metered(counters, rts):
    """Wrap each runtime's ``dispatch_round``: the launches each kernel
    made while that runtime's rounds were dispatched, one dict a
    runtime (the counters are global; this attributes them)."""
    per = [dict.fromkeys(counters, 0) for _ in rts]
    for rt, got in zip(rts, per):
        def metered(*args, _dispatch=rt.dispatch_round, _got=got, **kwargs):
            before = {n: w.launches for n, w in counters.items()}
            out = _dispatch(*args, **kwargs)
            for n, w in counters.items():
                _got[n] += w.launches - before[n]
            return out

        rt.dispatch_round = metered
    return per


def _launches_match(cfg, rounds, got):
    """``got`` (one runtime's metered launches) against
    ``expected_launches`` over its rounds [0, rounds); kernels the round
    does not run must have 0."""
    want = expected_launches(cfg, 0, rounds)
    return all(got[k] == want.get(k, 0) for k in got), want


def _stage_clock(mg, src, dst):
    """Patch the hooks ``migrate_range`` goes through so that each stage
    ends in a device sync and a mark: start (``migrate_range`` called),
    fence (``fence_slots``), drain (the drain rounds, the flush and
    ``salvage_slots``), snapshot (the normalize and ``save_range``),
    transfer (read back, re-map, re-mint: until the destination's
    ``write_rows``), restore (the rows, the version re-anchor,
    ``record_migration``), flip (until ``migrate_range`` returns).
    Returns (marks, unpatch)."""
    marks = []
    saved = []

    def mark(name):
        mg.sync()
        marks.append((name, time.perf_counter()))

    def patch(obj, attr, before=None, after=None):
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn if attr in vars(obj) else None))

        def hooked(*args, **kwargs):
            if before is not None:
                before(*args)
            out = fn(*args, **kwargs)
            if after is not None:
                after(*args)
            return out

        setattr(obj, attr, hooked)

    patch(mg.migrate_mod, "migrate_range", before=lambda *a: mark("start"),
          after=lambda *a: mark("flip"))
    patch(src, "fence_slots", after=lambda *a: mark("fence"))
    patch(src, "salvage_slots", after=lambda *a: mark("drain"))
    patch(mg.snapshot, "save_range", after=lambda *a: mark("snapshot"))
    patch(mg.snapshot, "write_rows",
          before=lambda rt, *a: rt is dst.rt and mark("transfer"))
    patch(dst.rt.recorder, "record_migration",
          after=lambda *a: mark("restore"))

    def unpatch():
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)

    return marks, unpatch


def _timed_steps(sync, kvs):
    """Wrap ``kvs.step``: each round's host seconds, ending in a device
    sync, appended to the returned list."""
    seconds = []
    step = kvs.step

    def timed():
        t0 = time.perf_counter()
        n = step()
        sync()
        seconds.append(time.perf_counter() - t0)
        return n

    kvs.step = timed
    return seconds


def _stage_seconds(marks):
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


def _copy_rows_equal(torch, fst, kvs, lo, hi):
    """Every table copy of ``kvs`` equal to copy 0 over [lo, hi)."""
    K = kvs.cfg.n_keys
    v = fst.copies(kvs.rt.fs.table.vpts, K)[:, lo:hi]
    b = fst.copies(kvs.rt.fs.table.bank, K)[:, lo:hi]
    return all(torch.equal(v[j], v[0]) and torch.equal(b[j], b[0])
               for j in range(1, v.shape[0]))


def _tables_equal(torch, fst, a, b):
    """Two runtimes' tables equal over every copy's key rows (an archive
    holds no drop row)."""
    K = a.cfg.n_keys
    return (torch.equal(fst.copies(a.fs.table.vpts, K),
                        fst.copies(b.fs.table.vpts, K))
            and torch.equal(fst.copies(a.fs.table.bank, K),
                            fst.copies(b.fs.table.bank, K)))


def _payload_rows(fst, kvs, keys, replica=0):
    """The payload words (the value words after the two uid words) of
    ``replica``'s copy at ``keys``, as lists."""
    bank = kvs.rt.copy_of(replica)[1]
    rows = fst._bank_to_i32(bank[list(keys)]).cpu().numpy()
    return [r[fst.BANK_VAL + 2:].tolist() for r in rows]


def phase_migrate(torch, np, counters, mg, card):
    """``migration_drill`` at the KVS bench shape (8 replicas, 2^20 keys,
    ``value_words=8``, 65,536 sessions a replica, recorded): a seed load
    of R x S ops and a standing mix of ``MIGRATE_LIVE_ROUNDS`` x R x S
    from ``submit_drill_mix``, the middle third ``[K/3, 2K/3)`` moved
    under the mix.  Each stage's host
    seconds (ending in a device sync), the drain's rounds, the rows
    moved, the ops rejected at the fence, salvaged, rejected and lost.
    Requires: the destination's reads at lo, the midpoint and hi-1 equal
    the source's last committed rows, a source get at lo ``rejected``,
    both checkers green, each store's ``stats_block`` launches equal to
    its rounds.  Then the same move on the sharded engine (8 copies of
    K+1 rows) with replica 1 of the source frozen across it and a
    standing mix below the range: the donor is the lowest live, unfrozen
    copy, every destination copy equals its copy 0 over the range.  Each
    store's rounds are timed one by one (``round_s``, host seconds ending
    in a device sync)."""
    cfg = mg.kvs_cfg()
    K, R, S = cfg.n_keys, cfg.n_replicas, cfg.n_sessions
    lo, hi = K // 3, 2 * K // 3
    load = R * S
    out = {"phase": "migrate", "nvidia_smi": card, "lo": lo, "hi": hi,
           "load_ops": load, "live_ops": MIGRATE_LIVE_ROUNDS * load}
    totals = dict.fromkeys(counters, 0)
    mg.reset_peak_memory()
    for backend in ("batched", "sharded"):
        src = mg.KVS(cfg, backend=backend, record="array", device=mg.device)
        dst = mg.KVS(cfg, backend=backend, record="array", device=mg.device)
        per = _metered(counters, [src.rt, dst.rt])
        round_s = [_timed_steps(mg.sync, src), _timed_steps(mg.sync, dst)]
        marks, unpatch = _stage_clock(mg, src, dst)
        t0 = time.perf_counter()
        try:
            if backend == "batched":
                # the drill's own loads; its post-flip checks raise
                res = mg.elastic.migration_drill(
                    cfg, record="array", lo=lo, hi=hi, load_ops=load,
                    live_ops=MIGRATE_LIVE_ROUNDS * load, seed=mg.seed,
                    check=False, src=src, dst=dst, device=mg.device)
                probe = [lo, (lo + hi) // 2, hi - 1]
                reads = res["dst_read_values"]
            else:
                seed_bf = mg.elastic.submit_drill_mix(
                    src, load, seed=mg.seed, read_frac=0.0)
                if not src.run_batch(seed_bf):
                    raise AssertionError("sharded seed load did not drain")
                standing = mg.elastic.submit_drill_mix(
                    src, load // 4, seed=mg.seed + 1, hi=lo)
                src.step()
                src.freeze(1)
                res = mg.migrate_mod.migrate_range(src, dst, lo, hi)
                src.rt.thaw(1)
                if not src.run_batch(standing):
                    raise AssertionError("the standing mix stranded ops")
                probe = [lo, (lo + hi) // 2, hi - 1]
                gets = [dst.get(r, 7, k) for r in range(R) for k in probe]
                if not dst.run_until(gets):
                    raise AssertionError("sharded destination reads stalled")
                reads = [g.result().value for g in gets]
                if any(g.result().kind != "get" for g in gets):
                    raise AssertionError("sharded destination reads failed")
                rej = src.get(0, 0, lo)
                if rej.result().kind != "rejected":
                    raise AssertionError("the source served a moved key")
        finally:
            unpatch()
        wall = time.perf_counter() - t0
        stages = _stage_seconds(marks)
        want_rows = _payload_rows(mg.fst, src, probe)
        t1 = time.perf_counter()
        checks = [src.rt.check(), dst.rt.check()]
        check_s = time.perf_counter() - t1
        rounds = [src.rt.step_idx, dst.rt.step_idx]
        matched = [_launches_match(cfg, n, got)
                   for n, got in zip(rounds, per)]
        for got in per:
            for k in totals:
                totals[k] += got[k]
        row = {"rows": res["rows"], "stages_s": stages,
               "stage_order": [m[0] for m in marks[1:]],
               "drain_rounds": res["drain_rounds"],
               "drained": res["drained"],
               "rejected_at_fence": res["rejected_at_fence"],
               "salvaged": res["salvaged"], "wall_s": wall,
               "src_rounds": rounds[0], "dst_rounds": rounds[1],
               "round_s": round_s,
               "round_us_median": statistics.median(round_s[0]) * 1e6,
               "launches": per, "check_ok": [v.ok for v in checks],
               "keys_checked": [v.keys_checked for v in checks],
               "check_s": check_s, "probe": probe,
               "dst_reads_equal_src_rows":
                   reads[:len(probe)] == want_rows}
        if backend == "batched":
            row.update(live_rejected=res["live_rejected"],
                       live_lost=res["live_lost"],
                       live_done=res["live_done"])
        else:
            row.update(copies=dst.rt.n_copies, frozen_source_replica=1,
                       dst_copies_equal=_copy_rows_equal(torch, mg.fst, dst,
                                                         lo, hi),
                       dst_reads_by_replica_equal=reads == want_rows * R)
        out[backend] = row
        if list(stages) != list(MIGRATE_STAGES):
            raise AssertionError(f"{backend}: stages {list(stages)}")
        if not row["dst_reads_equal_src_rows"]:
            raise AssertionError(f"{backend}: destination reads {reads} != "
                                 f"source rows {want_rows}")
        if not all(v.ok for v in checks):
            raise AssertionError(f"{backend}: a checker failed")
        if not all(ok for ok, _ in matched):
            raise AssertionError(f"{backend}: launches {per} != rounds "
                                 f"{rounds}")
        if backend == "sharded" and not (
                row["dst_copies_equal"] and row["dst_reads_by_replica_equal"]
                and res["drained"] and res["salvaged"] == 0):
            raise AssertionError(f"sharded move: {row}")
        del src, dst
    out["launches"] = totals
    out["peak_memory_bytes"] = mg.peak_memory()
    emit(out)
    return out


def phase_fleet(torch, np, counters, fl, card):
    """``Fleet`` of ``FLEET_GROUPS`` groups at the KVS bench shape
    (recorded; group 3 on the mega round and with ``fl.move`` spare slots
    beyond its 2^20-key range), on the card: a ``--fleet-ops``-style mix
    of ``fl.mix_ops`` ops over every group's range through
    ``submit_batch``/``run_batch``; ``Fleet.migrate`` of ``fl.move`` keys
    from group 0 to group 3 under a standing batch; a seeded
    ``fleet_schedules`` run of ``FLEET_CHAOS_ROUNDS`` rounds crashing and
    restarting replicas of groups 0 and 2 only, ``fl.chaos_ops`` ops
    submitted each round; every group's checker and ``verify_fleet``; a
    save/load round trip into a temporary directory; then
    ``run_fleet_cells`` (bench-a's shape, ``FLEET_BENCH_ROUNDS`` rounds a
    dispatch).  Requires: checkers and ``verify_fleet`` green, groups 1
    and 3 never fenced or crashed, the reloaded tables and router equal
    the saved ones, each group's launches equal to its rounds (group 3's
    mega kernels too)."""
    import tempfile

    base = fl.kvs_cfg()
    K = base.n_keys
    fcfg = fl.FleetConfig(
        groups=FLEET_GROUPS, base=base,
        overrides=(None, None, None,
                   {"mega_round": True, "n_keys": K + fl.move}))
    fl.reset_peak_memory()
    t_all = time.perf_counter()
    fleet = fl.Fleet(fcfg, device=fl.device, record="array")
    per = _metered(counters, fleet.runtimes())
    rng = np.random.default_rng(fl.seed)
    u = base.value_words - 2

    def mix(n):
        keys = rng.integers(0, fcfg.total_keys, size=n).astype(np.int64)
        kinds = np.where(rng.random(n) < base.workload.read_frac,
                         fleet.GET, fleet.PUT).astype(np.int32)
        vals = rng.integers(0, 1 << 20, size=(n, u)).astype(np.int32)
        return kinds, keys, vals

    out = {"phase": "fleet", "nvidia_smi": card, "groups": FLEET_GROUPS,
           "fleet_keys": fcfg.total_keys, "mix_ops": fl.mix_ops}
    t0 = time.perf_counter()
    fb = fleet.submit_batch(*mix(fl.mix_ops))
    mix_ok = fleet.run_batch(fb)
    fl.sync()
    out["mix_s"] = time.perf_counter() - t0
    out["mix_rounds"] = [g.rt.step_idx for g in fleet.groups]
    out["mix_codes"] = {int(c): int(n) for c, n in
                        zip(*np.unique(fb.code, return_counts=True))}
    # the move, under a standing batch
    standing = fleet.submit_batch(*mix(fl.mix_ops))
    mlo = K // 2
    mhi = mlo + fl.move
    t0 = time.perf_counter()
    moved = fleet.migrate(mlo, mhi, 3)
    fl.sync()
    out["migrate_s"] = time.perf_counter() - t0
    standing_ok = fleet.run_batch(standing)
    out["migrate"] = {k: v for k, v in moved.items() if k != "dest_slots"}
    out["standing_rejected"] = int((standing.code == fl.C_REJECTED).sum())
    probe = [mlo, mhi - 1]
    g0_rows = _payload_rows(fl.fst, fleet.groups[0].kvs, probe)
    gets = [fleet.get(0, k) for k in probe]
    fleet.run_until(gets)
    moved_reads_ok = ([g.result().value for g in gets] == g0_rows
                      and fleet.router.owner(mlo) == 3
                      and fleet.router.owner(mlo - 1) == 0
                      and fleet.router.owner(mhi) == 0)
    # chaos: crashes in groups 0 and 2 only
    spec = fl.chaos.ChaosSpec(p_freeze=0.0, p_thaw=0.0, p_join=0.0,
                              p_crash=0.06, p_skew=0.0,
                              min_healthy=base.n_replicas - 2)
    scheds = fl.fleet_schedules(fcfg, FLEET_CHAOS_SEED, FLEET_CHAOS_ROUNDS,
                                spec)
    scheds[1] = scheds[3] = fl.chaos.Schedule([])
    runner = fl.FleetChaosRunner(fleet, scheds, spec=spec)
    touched = []
    trickle = []

    def on_step(step):
        for g in (1, 3):
            rt = fleet.groups[g].rt
            touched.append(bool(rt.frozen.any())
                           or int(rt.live[0]) != rt.cfg.full_mask)
        trickle.append(fleet.submit_batch(*mix(fl.chaos_ops)))

    runner.on_step = on_step
    t0 = time.perf_counter()
    res = runner.run(FLEET_CHAOS_ROUNDS, heal=True)
    trickle_ok = all(fleet.run_batch(b) for b in trickle)
    fl.sync()
    out["chaos_s"] = time.perf_counter() - t0
    executed = json.loads(runner.log_json())
    out["chaos"] = {"lost_ops": res["lost_ops"], "drained": res["drained"],
                    "executed": [[(e["step"], e["kind"],
                                   e.get("replica")) for e in log]
                                 for log in executed],
                    "trickle_ops": fl.chaos_ops * len(trickle)}
    t0 = time.perf_counter()
    verdict = fleet.check()
    out["check_s"] = time.perf_counter() - t0
    out["check"] = verdict
    out["rounds"] = [g.rt.step_idx for g in fleet.groups]
    matched = [_launches_match(g.cfg, g.rt.step_idx, got)
               for g, got in zip(fleet.groups, per)]
    out["launches"] = per
    out["expected_launches"] = [w for _, w in matched]
    # snapshot scope round trip
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fleet.save(d)
        out["save_s"] = time.perf_counter() - t0
        f2 = fl.Fleet(fcfg, device=fl.device)
        t0 = time.perf_counter()
        f2.load(d)
        fl.sync()
        out["load_s"] = time.perf_counter() - t0
        reload_equal = (
            np.array_equal(f2.router.rr._owner, fleet.router.rr._owner)
            and np.array_equal(f2.router._local, fleet.router._local)
            and all(_tables_equal(torch, fl.fst, a.rt, b.rt)
                    for a, b in zip(fleet.groups, f2.groups)))
        del f2
    out["reload_equal"] = reload_equal
    out["drive_s"] = time.perf_counter() - t_all
    out["peak_memory_bytes"] = fl.peak_memory()
    del fleet
    # bench cells (bench-a's device-generated streams)
    bcfg = fl.FleetConfig(groups=FLEET_GROUPS, base=fl.cfg(),
                          overrides=(None, None, None, {"mega_round": True}))
    before = {n: w.launches for n, w in counters.items()}
    cells = fl.run_fleet_cells(bcfg, rounds=FLEET_BENCH_ROUNDS,
                               device=fl.device)
    bench_launches = {n: w.launches - before[n]
                      for n, w in counters.items()}
    n_chunks = 1 + 2 * 2  # warm-up, alone, concurrent (chunks=2 each)
    bench_rounds = n_chunks * FLEET_BENCH_ROUNDS
    want_bench = {"stats_block": FLEET_GROUPS * bench_rounds,
                  "mega_route": bench_rounds, "mega_apply": bench_rounds,
                  "mega_replay": sum(1 for s in range(bench_rounds)
                                     if s % bcfg.base.replay_scan_every
                                     == 0)}
    out["bench"] = cells
    out["bench_launches"] = bench_launches
    out["bench_concurrent_writes_per_s"] = \
        cells["concurrent"]["writes_per_sec"]
    out["bench_summed_alone_writes_per_s_not_a_capacity_on_one_card"] = \
        cells["aggregate_writes_per_sec"]
    emit(out)
    if not (mix_ok and standing_ok and trickle_ok):
        raise AssertionError("a fleet batch stranded ops")
    if not moved_reads_ok:
        raise AssertionError("the moved keys do not read group 0's rows "
                             "through group 3")
    crashed = {g for g, log in enumerate(executed)
               if any(e["kind"] == "crash_restart" for e in log)}
    if crashed != {0, 2} or any(touched) or executed[1] or executed[3]:
        raise AssertionError(f"chaos crashed groups {crashed}; groups 1/3 "
                             f"touched {any(touched)}")
    if not (verdict["ok"] and verdict["fleet_invariants"] == "ok"):
        raise AssertionError(f"fleet checks failed: {verdict}")
    if not reload_equal:
        raise AssertionError("the reloaded fleet differs from the saved one")
    if not all(ok for ok, _ in matched):
        raise AssertionError(f"fleet launches {per} != rounds "
                             f"{out['rounds']}")
    if bench_launches != want_bench:
        raise AssertionError(f"bench launches {bench_launches}, want "
                             f"{want_bench}")
    return out



# --------------------------------------------------------------------------
# The reference phases engine (core/phases.py, core/step.py,
# runtime.Runtime), its transports and the TCP driver
# --------------------------------------------------------------------------

PHASE_CONFIGS = (1, 3)  # the BASELINE configs the phases phase runs
PHASES_WARMUP = 8  # rounds before the sync-free and profiled windows
PHASES_SYNC_ROUNDS = 4  # rounds run under the sync check
PHASES_PROFILED = 5
PHASES_SHARDED_ROUNDS = 32  # rounds held equal to the batched backend
PHASES_DRAIN_LIMIT = 20000
# the round each config's card run is held to the CPU port's at: config
# 1 drained (None), config 3 after 256 rounds (its drain takes thousands
# of rounds, each some 0.1 s on the CPU at this width; cut from 512:
# PERF.md section 4).  Config 3's recorded drain on the card stays whole
PHASES_CPU_AT = {1: None, 3: 256}
# the wire matrix of tests/test_netchaos.py::test_sim_engine_wire_matrix_
# checked (op, src, dst, from, until, param) and a partition of replica
# 1's outbound side that the heal at round WIRE_HEAL_AT ends
WIRE_MATRIX = (("drop", 0, 2, 2, 12, 0), ("delay", 1, -1, 4, 16, 2),
               ("dup", 2, -1, 6, 14, 0), ("reorder", 0, 1, 3, 18, 3),
               ("corrupt", 2, 0, 5, 15, 0), ("partition", 1, -1, 20, 80, 0))
WIRE_HEAL_AT = 40
WIRE_SEED = 7
CHAOS_WIRE_SEED = 5  # Schedule.random's seed for the wire schedule
CHAOS_WIRE_ROUNDS = 64
CHAOS_WIRE_SPEC = dict(p_wire=0.12, p_partition=0.03)
TCP_RANKS = 3
TCP_TIMEOUT_S = 600
TCP_FAULTS = "corrupt:0:1:4:16;drop:2:0:6:12"
TCP_FAULT_SLACK = 40  # rounds past the clean drain for the faulted run


def baseline_cfg(config, n, scale=1.0):
    """BASELINE config ``n`` at ``scale``: the port's
    ``acceptance._cfg`` (1: 3 replicas, YCSB-A uniform; 2: 5 replicas,
    RMW; 3: 7 replicas, YCSB-A Zipfian 0.99; 4 and 5: 8 replicas), 2^20
    keys, 1,024 sessions, 128 ops at 1.0.  ``config`` is unused."""
    from hermes_tpu_torch import acceptance

    return acceptance._cfg(n, scale)


def state_digest(rs):
    """sha256 of every leaf of a ReplicaState (its host bytes, shape and
    dtype), one hex digest a part."""
    import hashlib

    out = {}
    for part, leaves in zip(rs._fields, rs):
        h = hashlib.sha256()
        for x in leaves:
            a = x.cpu().numpy()
            h.update(f"{a.shape}{a.dtype}".encode())
            h.update(a.tobytes())
        out[part] = h.hexdigest()
    return out


def _wire(ph, R):
    w = ph.FaultingTransport(ph.SimTransport(R), R, seed=WIRE_SEED)
    for op, src, dst, lo, hi, param in WIRE_MATRIX:
        w.add(op, src, dst, lo, hi, param)
    return w


def sim_wire_drive(ph, record=False):
    """The wire matrix with a partition/heal cycle on the sim engine at
    config 1, drained; then a seeded ChaosRunner schedule with wire verbs
    through ``wire=`` (the detector attached), healed, drained.  Returns
    both runs' results (digests, fault logs, the executed log)."""
    cfg = ph.cfg(1)
    R = cfg.n_replicas
    wire = _wire(ph, R)
    rt = ph.Runtime(cfg, backend="sim", transport=wire, device=ph.device,
                    record="array" if record else False)
    rounds = 0
    while rounds < PHASES_DRAIN_LIMIT:
        if rt.step_idx == WIRE_HEAL_AT:
            wire.heal(rt.step_idx)
        if rt.step_idx > WIRE_HEAL_AT and int(rt.pending_sessions()) == 0 \
                and wire.pending() == 0:
            break
        rt.step_once()
        rounds += 1
    matrix = dict(rounds=rt.step_idx, digest=state_digest(rt.rs),
                  fault_log=wire.fault_log_json(),
                  counters=dict(wire.counters), rt=rt, wire=wire)
    spec = ph.chaos.ChaosSpec(**CHAOS_WIRE_SPEC)
    sched = ph.chaos.Schedule.random(cfg, CHAOS_WIRE_SEED, CHAOS_WIRE_ROUNDS,
                                     spec=spec)
    cwire = ph.FaultingTransport(ph.SimTransport(R), R, seed=CHAOS_WIRE_SEED)
    crt = ph.Runtime(cfg, backend="sim", transport=cwire, device=ph.device,
                     record="array" if record else False)
    crt.attach_membership(ph.MembershipService(cfg, confirm_steps=2))
    runner = ph.chaos.ChaosRunner(crt, sched, spec=spec, wire=cwire)
    res = runner.run(CHAOS_WIRE_ROUNDS, drain_steps=PHASES_DRAIN_LIMIT,
                     check=record)
    chaos_run = dict(rounds=crt.step_idx, digest=state_digest(crt.rs),
                     fault_log=cwire.fault_log_json(),
                     events=runner.log_json(), result=res, rt=crt,
                     wire=cwire, schedule=sched.format())
    return matrix, chaos_run


def cpu_reference(path, scale=1.0):
    """The CPU port's runs the card's phases are held against, written
    as JSON to ``path``: each BASELINE config of PHASE_CONFIGS drained on
    the batched backend, or run to its PHASES_CPU_AT round (rounds, state
    digest), and the two sim-wire drives (digests, fault logs, the
    executed chaos log)."""
    import torch

    from hermes_tpu_torch import chaos, config
    from hermes_tpu_torch.chaos.net import FaultingTransport
    from hermes_tpu_torch.membership import MembershipService
    from hermes_tpu_torch.runtime import Runtime
    from hermes_tpu_torch.transport.sim import SimTransport

    torch.set_num_threads(4)
    ph = SimpleNamespace(cfg=lambda n: baseline_cfg(config, n, scale),
                         device="cpu", Runtime=Runtime, chaos=chaos,
                         FaultingTransport=FaultingTransport,
                         SimTransport=SimTransport,
                         MembershipService=MembershipService)
    out = {"phases": {}}
    t0 = time.perf_counter()
    for n in PHASE_CONFIGS:
        rt = Runtime(ph.cfg(n), backend="batched", device="cpu")
        for _ in range(PHASES_DRAIN_LIMIT):
            if rt.step_idx == PHASES_CPU_AT[n] or \
                    int(rt.pending_sessions()) == 0:
                break
            rt.step_once()
        else:
            raise AssertionError(f"config {n} did not drain on the CPU")
        out["phases"][str(n)] = dict(rounds=rt.step_idx,
                                     digest=state_digest(rt.rs))
        del rt
    matrix, chaos_run = sim_wire_drive(ph)
    keep = ("rounds", "digest", "fault_log")
    out["sim_wire"] = {k: matrix[k] for k in keep}
    out["chaos_wire"] = {k: chaos_run[k] for k in keep + ("events",
                                                          "schedule")}
    out["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)


def start_cpu_reference(scale=1.0):
    """``cpu_reference`` in a child process (it runs beside the card's
    phases); returns (process, output path)."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="hermes_phases_"),
                        "cpu.json")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.cpu_reference(sys.argv[2], "
            "float(sys.argv[3]))")
    proc = subprocess.Popen([sys.executable, "-c", code, HERE, path,
                             str(scale)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, path


def wait_cpu_reference(proc, path, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the CPU reference runs failed:\n{err[-4000:]}")
    with open(path) as f:
        return json.load(f)


def _all_replicas_converged(torch, types, rs):
    """Every key VALID and every replica's table equal to replica 0's."""
    t = rs.table
    return bool((t.state == types.VALID).all()) and all(
        bool((x == x[:1]).all()) for x in (t.ver, t.fc, t.val))


@contextlib.contextmanager
def cuda_sync_check(torch):
    """Inside: any host sync with the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _launch_snapshot(counters):
    return {name: w.launches for name, w in counters.items()}


def phase_phases(torch, ph, card, n):
    """BASELINE config ``n`` on ``Runtime(backend="batched")``: recorded
    and drained (checker, counters against the recorded completions,
    convergence; the state at the PHASES_CPU_AT round, or the final one,
    kept for ``compare_cpu``), then an unrecorded runtime for the
    numbers: host us a round over the rounds up to that state, ending in
    a sync, and its state there equal to the recorded run's; rounds
    under the sync check; a profiled window."""
    cfg = ph.cfg(n)
    ph.reset_peak_memory()
    rt = ph.Runtime(cfg, backend="batched", record="array", device=ph.device)
    cpu_at = PHASES_CPU_AT.get(n)
    held = None  # (round, digest) the CPU port's run is held to
    t0 = time.perf_counter()
    for _ in range(PHASES_DRAIN_LIMIT):
        if rt.step_idx == cpu_at:
            held = (rt.step_idx, state_digest(rt.rs))
        if int(rt.pending_sessions()) == 0:
            break
        rt.step_once()
    else:
        raise AssertionError(f"config {n} did not drain")
    ph.sync()
    recorded_s = time.perf_counter() - t0
    rounds = rt.step_idx
    c = rt.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    recorded = rt.recorder.n_recorded
    converged = _all_replicas_converged(torch, ph.types, rt.rs)
    digest = state_digest(rt.rs)
    if held is None:
        held = (rounds, digest)
    t0 = time.perf_counter()
    v = rt.check()
    check_s = time.perf_counter() - t0
    peak = ph.peak_memory()
    del rt

    # the timed window: the rounds up to the held state, which the
    # unrecorded run must reach too
    timed = ph.Runtime(cfg, backend="batched", device=ph.device)
    ph.sync()
    t0 = time.perf_counter()
    timed.run(held[0])
    ph.sync()
    host_s = time.perf_counter() - t0
    same = state_digest(timed.rs) == held[1]
    del timed

    probe = ph.Runtime(cfg, backend="batched", device=ph.device)
    probe.run(PHASES_WARMUP)
    ph.sync()
    with ph.sync_check():
        probe.run(PHASES_SYNC_ROUNDS)
    ph.sync()
    busy = ph.device_busy(torch, lambda: probe.run(PHASES_PROFILED),
                          f"phases-config{n}")
    del probe
    out = {"phase": f"phases-config{n}", "card": card,
           "replicas": cfg.n_replicas, "keys": cfg.n_keys,
           "sessions": cfg.n_sessions, "ops_per_session": cfg.ops_per_session,
           "rounds_to_drain": rounds, "recorded_drain_s": recorded_s,
           "timed_rounds": held[0],
           "host_us_per_round": host_s / held[0] * 1e6,
           "device_us_per_round": _per(busy["busy_s"],
                                       PHASES_PROFILED / 1e6),
           "cuda_kernels_per_round": busy["launches"] / PHASES_PROFILED,
           "device_busy_share": _per(busy["busy_s"], busy["wall_s"]),
           "busy_by": busy["busy_by"],
           "profiled_us_per_round": busy["wall_s"] / PHASES_PROFILED * 1e6,
           "top_device_us_per_round": [
               [name, us / PHASES_PROFILED, cnt / PHASES_PROFILED]
               for us, cnt, name in busy["top"]],
           "peak_memory_bytes": peak, "device_ops": device_ops,
           "recorded_ops": recorded, "converged": converged,
           "check_ok": v.ok, "keys_checked": v.keys_checked,
           "check_s": check_s, "sync_free_rounds": PHASES_SYNC_ROUNDS,
           "unrecorded_equal_to_recorded": same, "digest": digest,
           "cpu_held_round": held[0], "cpu_held_digest": held[1]}
    emit(out)
    if not v.ok:
        raise AssertionError(f"config {n}: linearizability check failed: "
                             f"{[f.reason[:200] for f in v.failures[:3]]}")
    if device_ops != recorded:
        raise AssertionError(f"config {n}: device op counters {device_ops} "
                             f"!= recorded completions {recorded}")
    if not converged:
        raise AssertionError(f"config {n}: the replicas did not converge")
    if not same:
        raise AssertionError(f"config {n}: recording changed the state")
    return out


# the phases-graph cells: (name, BASELINE config, backend)
PHASES_GRAPH_CELLS = (("config1", 1, "batched"), ("config3", 3, "batched"),
                      ("config1-sharded", 1, "sharded"))
PHASES_GRAPH_ROUNDS = 32  # rounds a graphed and an eager runtime run together
# round: (method, arguments) of the membership changes between them
PHASES_GRAPH_EVENTS = {6: ("freeze", (1,)), 12: ("thaw", (1,)),
                       18: ("remove", (2,)), 24: ("join", (2, 0))}
PHASES_GRAPH_TIMED = 40  # graphed rounds of the host-us window
PHASES_EAGER_TIMED = 8  # eager rounds of theirs
PHASES_SCAN_ROUNDS = 4  # rounds a compiled chunk
PHASES_SCAN_CHUNKS = 3
PHASES_SCAN_FROM = 5  # the chunks' first round: not a multiple of 4
PHASES_LAUNCH_CALLS = 2  # a graphed phases round: the graph's launch and
# the ring slot's copy


def phases_runtime(ph, n, backend, **kw):
    """``Runtime`` of BASELINE config ``n`` on ``backend`` on the card."""
    group = ph.LocalGroup(ph.device) if backend == "sharded" else None
    return ph.Runtime(ph.cfg(n), backend=backend, group=group,
                      device=ph.device, **kw)


def phases_graph_pair(torch, make):
    """A graphed runtime and one whose compiled round runs under
    ``Compiled.eager()`` (the round function called each round, with the
    same binding, ring and step) from ``make()``, driven together over
    ``PHASES_GRAPH_ROUNDS`` rounds through ``PHASES_GRAPH_EVENTS``: every
    state leaf (the table's drop rows left out) and completion column
    equal every round, the graphed one one capture and a replay a later
    round.  Returns both."""
    graphed, eager = make(), make()
    for s in range(PHASES_GRAPH_ROUNDS):
        if s in PHASES_GRAPH_EVENTS:
            act, args = PHASES_GRAPH_EVENTS[s]
            for rt in (graphed, eager):
                getattr(rt, act)(*args)
        cg = graphed.step_once()
        with eager._step.eager():
            ce = eager.step_once()
        if not _same_leaves(torch, _flat(cg), _flat(ce)):
            raise AssertionError(f"graphed and eager phases completions "
                                 f"differ at round {s}")
        if not _same_leaves(torch, _flat(graphed.rs), _flat(eager.rs)):
            raise AssertionError(f"graphed and eager phases states differ "
                                 f"after round {s}")
    comp = graphed._step
    if (comp.captures, comp.replays, comp.rebinds) != (
            1, PHASES_GRAPH_ROUNDS - 1, 0) or int(comp.step) != \
            PHASES_GRAPH_ROUNDS:
        raise AssertionError(f"{comp.captures} captures, {comp.replays} "
                             f"replays, {comp.rebinds} rebinds, step "
                             f"{int(comp.step)} in {PHASES_GRAPH_ROUNDS} "
                             f"rounds")
    return graphed, eager


def phases_graph_timing(ph, rt, eager):
    """Host us a round over ``PHASES_GRAPH_TIMED`` (graphed) or
    ``PHASES_EAGER_TIMED`` (``eager``: under ``Compiled.eager()``) rounds
    ending in a sync, device us a round (``ph.queued_s``: ten rounds
    queued behind a spin kernel, CUDA events; None where they cannot be
    queued), their busy share, and the host launch calls of one round
    (``ph.launch_calls``) with the compiled round's own count of what that
    round was (``round_calls``: replays, warm-ups and captures)."""
    rounds = PHASES_EAGER_TIMED if eager else PHASES_GRAPH_TIMED
    with rt._step.eager() if eager else contextlib.nullcontext():
        rt.run(2)
        ph.sync()
        t0 = time.perf_counter()
        rt.run(rounds)
        ph.sync()
        host_us = (time.perf_counter() - t0) / rounds * 1e6
        dev_s = ph.queued_s(lambda: rt.run(1), inner=10,
                            spin_cycles=1 << 26)
        comp = rt._step
        before = (comp.replays, comp.warmups, comp.captures)
        calls = ph.launch_calls(rt.step_once)
        after = (comp.replays, comp.warmups, comp.captures)
    dev_us = None if dev_s is None else dev_s * 1e6
    return {"host_us_per_round": host_us, "device_us_per_round": dev_us,
            "busy_share": None if dev_us is None else dev_us / host_us,
            "host_launch_calls": sum(calls.values()),
            "launch_calls": calls, "timed_rounds": rounds,
            "round_calls": dict(zip(("replays", "warmups", "captures"),
                                    (a - b for a, b in zip(after, before))))}


def check_graphed_phases_round(name, timing):
    """A graphed phases round (``phases_graph_timing``) is one replay of
    its graph by the compiled round's own count, so it makes
    ``PHASES_LAUNCH_CALLS`` host launch calls; the profiler's count may
    not exceed them (a lost record can only lower it)."""
    got = timing["round_calls"]
    if got != {"replays": 1, "warmups": 0, "captures": 0}:
        raise AssertionError(f"a graphed phases round ({name}) was not one "
                             f"replay: {got}")
    calls = timing["host_launch_calls"]
    if calls > PHASES_LAUNCH_CALLS:
        raise AssertionError(f"a graphed phases round ({name}) made {calls} "
                             f"host launch calls, want <= "
                             f"{PHASES_LAUNCH_CALLS}")


def launch_calls(run):
    """The host's launch calls of ``run()`` by API (torch.profiler's host
    API records, the sentinel's two taken off ``cudaLaunchKernel``)."""
    from hermes_tpu_torch import profiling

    calls = profiling._trace(run)["launch_calls"]
    calls["cudaLaunchKernel"] = calls.get("cudaLaunchKernel", 0) - 2
    return {k: v for k, v in calls.items() if v}


def phases_scan_equal(torch, ph, n, backend):
    """``PHASES_SCAN_CHUNKS`` compiled chunks of ``PHASES_SCAN_ROUNDS``
    rounds (``build_step_scan``, or ``build_step_sharded_scan`` over the
    runtime's group) from round ``PHASES_SCAN_FROM`` against as many
    graphed rounds of a runtime: every state leaf equal; the chunk
    captured once and stepped on the device."""
    from hermes_tpu_torch.core import step as step_lib

    loop, chunked = (phases_runtime(ph, n, backend) for _ in range(2))
    rounds = PHASES_SCAN_ROUNDS * PHASES_SCAN_CHUNKS
    loop.step_idx = chunked.step_idx = PHASES_SCAN_FROM
    loop.run(rounds)
    cfg = chunked.cfg
    chunk = (step_lib.build_step_scan(cfg, PHASES_SCAN_ROUNDS)
             if backend == "batched" else step_lib.build_step_sharded_scan(
                 cfg, chunked.group, PHASES_SCAN_ROUNDS))
    ctl = chunked._ctl()
    for _ in range(PHASES_SCAN_CHUNKS):
        chunk(chunked.rs, chunked.stream, ctl)
    if not _same_leaves(torch, _flat(loop.rs), _flat(chunked.rs)):
        raise AssertionError(f"config {n} {backend}: the compiled chunks "
                             "differ from the round loop")
    if (chunk.captures, chunk.replays) != (1, PHASES_SCAN_CHUNKS - 1) or \
            int(chunk.step) != PHASES_SCAN_FROM + rounds:
        raise AssertionError(f"the chunk: {chunk.captures} captures, "
                             f"{chunk.replays} replays, step "
                             f"{int(chunk.step)}")
    return True


def phase_phases_graph(torch, ph, card):
    """The compiled phases round against the eager one for each of
    ``PHASES_GRAPH_CELLS`` at full width (``phases_graph_pair``), then
    each one's host and device us a round, busy share and host launch
    calls graphed and eager in this call (``phases_graph_timing``), and
    the compiled chunks against the round loop (``phases_scan_equal``).
    A graphed round is one replay (``check_graphed_phases_round``).
    Returns the rows by cell."""
    out = {}
    for name, n, backend in PHASES_GRAPH_CELLS:
        t0 = time.perf_counter()
        graphed, eager = phases_graph_pair(
            torch, lambda: phases_runtime(ph, n, backend))
        row = {"identical": True, "rounds": PHASES_GRAPH_ROUNDS,
               "captures": graphed._step.captures,
               "replays": graphed._step.replays,
               "graphed": phases_graph_timing(ph, graphed, False),
               "eager": phases_graph_timing(ph, eager, True)}
        del graphed, eager
        row["scan_equal"] = phases_scan_equal(torch, ph, n, backend)
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        emit(dict({"phase": "phases-graph", "cell": name, "card": card},
                  **row))
        check_graphed_phases_round(name, row["graphed"])
        torch.cuda.empty_cache()
    return out


def _states_equal(torch, a, b):
    return all(torch.equal(x, y) for pa, pb in zip(a, b)
               for x, y in zip(pa, pb))


def phase_phases_sharded(torch, ph, card):
    """Config 1 on ``Runtime(backend="sharded")`` over a ``LocalGroup`` on
    the device: equal to the batched backend after each of the first
    PHASES_SHARDED_ROUNDS rounds, then drained, checked and converged,
    and equal to the batched backend on the round it drained."""
    cfg = ph.cfg(1)
    sh = ph.Runtime(cfg, backend="sharded", group=ph.LocalGroup(ph.device),
                    record="array", device=ph.device)
    ba = ph.Runtime(cfg, backend="batched", device=ph.device)
    for s in range(PHASES_SHARDED_ROUNDS):
        sh.step_once()
        ba.step_once()
        if not _states_equal(torch, sh.rs, ba.rs):
            raise AssertionError(f"sharded != batched after round {s}")
    ph.sync()
    t0 = time.perf_counter()
    if not sh.drain(PHASES_DRAIN_LIMIT):
        raise AssertionError("the sharded backend did not drain")
    ph.sync()
    drain_s = time.perf_counter() - t0
    ba.run(sh.step_idx - ba.step_idx)
    equal = _states_equal(torch, sh.rs, ba.rs)
    del ba
    v = sh.check()
    c = sh.counters()
    device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"] + c["n_abort"])
    out = {"phase": "phases-sharded", "card": card,
           "rounds_equal_to_batched": PHASES_SHARDED_ROUNDS,
           "rounds_to_drain": sh.step_idx, "drain_s": drain_s,
           "check_ok": v.ok, "device_ops": device_ops,
           "recorded_ops": sh.recorder.n_recorded,
           "converged": _all_replicas_converged(torch, ph.types, sh.rs),
           "equal_to_batched_at_drain": equal}
    emit(out)
    if not (v.ok and out["converged"] and equal
            and device_ops == out["recorded_ops"]):
        raise AssertionError(f"phases-sharded failed: {out}")
    return out


def phase_sim_wire(torch, ph, card):
    """Config 1 on ``Runtime(backend="sim")`` over ``FaultingTransport(
    SimTransport(3))``: the wire matrix (drop, delay, duplicate, reorder,
    corrupt under CRC) and a partition of replica 1's outbound side healed
    at WIRE_HEAL_AT, recorded and drained; then a seeded ChaosRunner
    schedule with wire verbs and the detector.  Checkers green, nothing
    applied past the CRC; each run's fault log, executed log and final
    state are held to the CPU port's by ``compare_cpu``."""
    t0 = time.perf_counter()
    matrix, chaos_run = sim_wire_drive(ph, record=True)
    ph.sync()
    seconds = time.perf_counter() - t0
    rt, wire = matrix["rt"], matrix["wire"]
    v = rt.check()
    c = wire.counters
    res = chaos_run["result"]
    kinds = sorted({e["kind"] for e in json.loads(chaos_run["events"])})
    out = {"phase": "sim-wire", "card": card, "seconds": seconds,
           "matrix_rounds": matrix["rounds"], "check_ok": v.ok,
           "converged": _all_replicas_converged(torch, ph.types, rt.rs),
           "wire_counters": dict(c),
           "fault_log_bytes": len(matrix["fault_log"]),
           "chaos_rounds": chaos_run["rounds"], "chaos_kinds": kinds,
           "chaos_drained": res.get("drained"),
           "chaos_check_ok": res.get("checked_ok"),
           "chaos_wire_counters": dict(chaos_run["wire"].counters),
           "membership_events": [
               (e.kind, e.replica, e.step)
               for e in chaos_run["rt"].membership.events]}
    emit(out)
    wire_ops = {"wire_drop", "wire_delay", "wire_dup", "wire_reorder",
                "wire_corrupt", "wire_partition", "wire_heal"}
    if not (v.ok and out["converged"] and wire_ops <= set(c)
            and c["wire_corrupt_dropped"] == c["wire_corrupt"]
            and not c.get("wire_corrupt_applied")
            and res.get("drained") and res.get("checked_ok")
            and set(kinds) & {"netdrop", "netdelay", "netdup", "netreorder",
                              "netcorrupt"}):
        raise AssertionError(f"sim-wire failed: {out}")
    keep = ("rounds", "digest", "fault_log")
    return out, {"sim_wire": {k: matrix[k] for k in keep},
                 "chaos_wire": {k: chaos_run[k] for k in keep + (
                     "events", "schedule")}}


def _free_ports(socket, n):
    """The first base port of ``n`` consecutive ports free on loopback."""
    for base in range(29800, 32000, 16):
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} free consecutive ports on loopback")


def _tcp_start(ph, tmp, tag, steps, base, extra=()):
    """Start TCP_RANKS processes of ``python -m
    hermes_tpu_torch.distributed`` on ``ph.device`` over loopback, ranks
    listening from port ``base``, at config 1's shape: (processes, their
    result files, start time)."""
    cfg = ph.cfg(1)
    wl = cfg.workload
    args = ["--n-ranks", str(TCP_RANKS), "--steps", str(steps),
            "--base-port", str(base), "--n-keys", str(cfg.n_keys),
            "--n-sessions", str(cfg.n_sessions),
            "--ops-per-session", str(cfg.ops_per_session),
            "--replay-slots", str(cfg.replay_slots),
            "--value-words", str(cfg.value_words),
            "--replay-age", str(cfg.replay_age),
            "--read-frac", str(wl.read_frac), "--rmw-frac", str(wl.rmw_frac),
            "--seed", str(wl.seed), "--device", ph.device, *extra]
    env = dict(os.environ, PYTHONPATH=ph.root, OMP_NUM_THREADS="1")
    outs = [os.path.join(tmp, f"{tag}{r}.pkl") for r in range(TCP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hermes_tpu_torch.distributed", "--rank",
         str(r), "--out", outs[r], *args], env=env, cwd=ph.root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(TCP_RANKS)]
    return procs, outs, time.perf_counter()


def _tcp_finish(ph, procs, outs, t0):
    """Wait for a run of ``_tcp_start``: (verdict, per-rank results,
    whole-run seconds)."""
    errs = []
    try:
        for p in procs:
            _o, e = p.communicate(timeout=TCP_TIMEOUT_S)
            errs.append(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    bad = [(r, p.returncode, errs[r][-2000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"tcp ranks failed: {bad}")
    verdict, results = ph.combine_and_check(outs)
    return verdict, results, seconds


def _tcp_verdict(ph, np, steps, verdict, results, seconds):
    """One TCP run's row: the checker, the ranks' tables equal, every
    session done (``ok`` all three), rates, CRC drops and wire
    counters."""
    equal = all(np.array_equal(results[0][k], r[k]) for r in results[1:]
                for k in ("table_state", "table_ver", "table_fc",
                          "table_val"))
    done = all(bool((r["sess_status"] == ph.types.S_DONE).all())
               for r in results)
    return {"steps": steps, "seconds": seconds, "check_ok": verdict.ok,
            "tables_equal": equal, "all_sessions_done": done,
            "ok": verdict.ok and equal and done,
            "rounds_per_s": [r["rounds_per_s"] for r in results],
            "rank_seconds": [r["seconds"] for r in results],
            "corrupt_dropped": [r["corrupt_dropped"] for r in results],
            "wire": [r["wire"] for r in results],
            "devices": [r["device"] for r in results]}


def phase_tcp(torch, ph, card, drain_rounds):
    """Config 1 as TCP_RANKS processes of the TCP driver sharing the
    device, over loopback, for ``drain_rounds`` rounds (config 1's drain
    on the batched backend, which the lockstep mesh reproduces) plus 8:
    the combined history checks green, the ranks' tables are equal, every
    session ends S_DONE, no clean frame fails its CRC.  Beside it, at
    the same time on other ports, the same with the adversary's
    corruption and drop windows (TCP_FAULT_SLACK rounds past the drain):
    every corrupted frame is dropped by the CRC, green again."""
    import socket
    import tempfile

    import numpy as np

    out = {"phase": "tcp", "card": card, "ranks": TCP_RANKS}
    base = _free_ports(socket, 2 * TCP_RANKS)
    with tempfile.TemporaryDirectory(prefix="hermes_tcp_") as tmp:
        # the two meshes run at once, on disjoint ports (PERF.md section 4)
        runs = (("clean", drain_rounds + 8, ()),
                ("faults", drain_rounds + TCP_FAULT_SLACK,
                 ("--wire-seed", "5", "--wire-faults", TCP_FAULTS)))
        started = []
        try:
            for i, (tag, steps, extra) in enumerate(runs):
                started.append(_tcp_start(ph, tmp, tag, steps,
                                          base + i * TCP_RANKS, extra))
            for (tag, steps, _), run_procs in zip(runs, started):
                verdict, results, seconds = _tcp_finish(ph, *run_procs)
                out[tag] = _tcp_verdict(ph, np, steps, verdict, results,
                                        seconds)
                if not out[tag]["ok"]:
                    emit(out)
                    raise AssertionError(f"tcp {tag} run failed: "
                                         f"{out[tag]}")
        finally:
            for procs, _outs, _t0 in started:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
    emit(out)
    clean, faults = out["clean"], out["faults"]
    if any(clean["corrupt_dropped"]):
        raise AssertionError("a clean TCP frame failed its CRC")
    w = faults["wire"][1]["counters"]
    if not w.get("wire_corrupt") or \
            w.get("wire_corrupt_dropped") != w["wire_corrupt"] or \
            w.get("wire_corrupt_applied"):
        raise AssertionError(f"the corruption windows were not all caught "
                             f"by the CRC: {w}")
    return out


def compare_cpu(card_runs, cpu):
    """The card's runs against the CPU port's (``cpu_reference``): every
    final state digest and drain round, the fault logs and the executed
    chaos log byte for byte."""
    eq = {}
    for n, got in card_runs["phases"].items():
        want = cpu["phases"][str(n)]
        eq[f"config{n}"] = (got["cpu_held_digest"] == want["digest"]
                            and got["cpu_held_round"] == want["rounds"])
    for name in ("sim_wire", "chaos_wire"):
        got, want = card_runs[name], cpu[name]
        for k in got:
            eq[f"{name}.{k}"] = got[k] == want[k]
    out = {"phase": "phases-cpu", "cpu_seconds": cpu["seconds"],
           "equal": eq}
    if not all(eq.values()):  # which parts of each differing digest
        out["digest_parts_equal"] = {
            name: {p: run["digest"][p] == cpu_run["digest"].get(p)
                   for p in run["digest"]}
            for name, run, cpu_run in (
                [("sim_wire", card_runs["sim_wire"], cpu["sim_wire"]),
                 ("chaos_wire", card_runs["chaos_wire"], cpu["chaos_wire"])]
                + [(f"config{n}", {"digest": r["cpu_held_digest"]},
                    cpu["phases"][str(n)])
                   for n, r in card_runs["phases"].items()])}
    emit(out)
    if not all(eq.values()):
        raise AssertionError(f"the card's phases engine differs from the "
                             f"CPU port's: {eq}")
    return out


def run_phases_engine(torch, ph, counters, card):
    """The phases engine's phases, with the CPU reference runs beside
    them in a child process: phases-graph, phases (each of
    PHASE_CONFIGS), phases-sharded, sim-wire, tcp, then the comparison
    with the CPU.  The hand kernels must not launch across them."""
    before = _launch_snapshot(counters)
    t0 = time.perf_counter()
    proc, path = start_cpu_reference(ph.scale)
    try:
        graphed = phase_phases_graph(torch, ph, card)
        runs = {n: phase_phases(torch, ph, card, n) for n in PHASE_CONFIGS}
        sharded = phase_phases_sharded(torch, ph, card)
        wire, logs = phase_sim_wire(torch, ph, card)
        tcp = phase_tcp(torch, ph, card, runs[1]["rounds_to_drain"])
        cpu = wait_cpu_reference(proc, path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        import shutil

        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    compare_cpu(dict(phases=runs, **logs), cpu)
    after = _launch_snapshot(counters)
    moved = {k: after[k] - before[k] for k in after}
    emit({"phase": "phases-engine", "seconds": time.perf_counter() - t0,
          "hand_kernel_launches": moved})
    if any(moved.values()):
        raise AssertionError(f"the phases engine launched hand kernels: "
                             f"{moved}")
    return dict(graph=graphed, phases=runs, sharded=sharded, sim_wire=wire,
                tcp=tcp, launches=moved)

# --------------------------------------------------------------------------
# The serving front end: Frontend and ColumnarFrontend over a KVS on the
# card, the socket servers and the shm one-store plane
# --------------------------------------------------------------------------

SERVE_OPS = 4000  # open-loop requests of one serve run
SERVE_RATE = 24_000.0  # a virtual second: 24 arrivals a 1,000-us round
SERVE_DEADLINE_US = 4_000
SERVE_SEED = 19
SERVE_STORM = (5, 60)  # Schedule.overload_storm seed, steps
# an envelope the open loop overruns: the store takes 32 ops at a time,
# so the intake queue fills and the shed ladder, the quotas, the buckets
# and the deadlines all act
SERVE_ENVELOPE = dict(tenant_rate_per_s=12_000.0, tenant_burst=64.0,
                      tenant_quota=48, queue_cap=192, store_inflight_cap=32,
                      hot_keys=(0, 1, 2, 3), round_us=1000)
# tests/test_serving.py's store, at depth 2: the card against the CPU port
SERVE_SMALL = dict(n_replicas=3, n_keys=64, n_sessions=4, replay_slots=6,
                   ops_per_session=96, value_words=6, replay_age=6,
                   replay_scan_every=4, rebroadcast_every=2, lease_steps=6,
                   pipeline_depth=2)
COLUMNAR_OPS = 1 << 21  # cut from 2^22 (PERF.md section 4)
# arrivals a 1,000-us virtual round: the lane budget (3/4 of the 65,536
# sessions of each of 8 replicas); an op holds its lane about one round
COLUMNAR_PER_ROUND = 393216
COLUMNAR_SEED = 23
# rounds of arrivals of the traced columnar soak: ~3 store rounds, ~2,000
# CUDA kernels, under the ~3,000 at which a trace comes back short
COLUMNAR_TRACED = 2
COLUMNAR_ENVELOPE = dict(tenant_rate_per_s=1e12, tenant_burst=1e12,
                         tenant_quota=1 << 22, queue_cap=1 << 21,
                         resp_meta_cap=1 << 22, round_us=1000)
ONE_STORE_WORKERS = 2
# run_serve_bench's n: the latency point's requests (its p99 the 4th
# largest), 2n at the throughput point, n / 4 for the capacity probe
# (cut from 2,000: PERF.md section 4)
SOCKET_N = 400


@contextlib.contextmanager
def frontend_sync_free(torch, on_card, store, runner=None):
    """Inside: a host sync with the card raises anywhere but in the
    store's own rounds (``step``, ``flush``, ``rt.flush_pipeline``: the
    harvest; a fleet's ``step`` and ``flush``) and the chaos runner's
    tick, which run with the check off.
    So the serving front end itself reads nothing back from the card."""
    if not on_card:
        yield
        return
    saved = []

    def exempt(obj, attr):
        saved.append((obj, attr, vars(obj).get(attr)))
        fn = getattr(obj, attr)

        def unchecked(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        setattr(obj, attr, unchecked)

    # a Fleet's step and flush are its groups' rounds and harvests
    pipeline = () if hasattr(store, "groups") else (
        (store.rt, "flush_pipeline"),)
    for obj, attr in ((store, "step"), (store, "flush"), *pipeline,
                      (runner, "tick")):
        if obj is not None:
            exempt(obj, attr)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def serve_drive(torch, sv, cfg, device, groups=0):
    """One ``run_open_loop`` over a recorded KVS (or, with ``groups``, a
    recorded ``Fleet`` of that many groups of ``cfg``) under an overload
    storm (``ChaosRunner(load=arrivals)``, over group 0's store for a
    fleet: the storm acts on the arrivals alone): (summary, store, wall
    seconds)."""
    if groups:
        store = sv.Fleet(sv.FleetConfig(groups=groups, base=cfg),
                         record="array", device=device)
        target = store.groups[0].kvs
    else:
        store = target = sv.KVS(cfg, record="array", device=device)
    arrivals = sv.ShapedArrivals(SERVE_RATE, SERVE_OPS, SERVE_SEED)
    runner = sv.chaos.ChaosRunner(
        target, sv.chaos.Schedule.overload_storm(*SERVE_STORM),
        load=arrivals)
    scfg = sv.ServingConfig(**SERVE_ENVELOPE)
    on_card = str(device).startswith("cuda")
    sv.sync()
    t0 = time.perf_counter()
    with frontend_sync_free(torch, on_card, store, runner):
        res = sv.run_open_loop(
            store, scfg, sv.MixSpec(tenants=4), rate_per_s=SERVE_RATE,
            n=SERVE_OPS, seed=SERVE_SEED, deadline_us=SERVE_DEADLINE_US,
            chaos_runner=runner, arrivals=arrivals)
    sv.sync()
    return res, store, time.perf_counter() - t0


def phase_serve(torch, sv, card):
    """The serving front end at the reads shape on the card: two recorded
    open-loop runs under an overload storm, each held to
    ``verify_serving`` (inside ``run_open_loop``), the checker and counter
    conservation (the ops the front end handed the store = the device op
    counters = the recorded completions), one response log between them;
    then the same drive at ``SERVE_SMALL`` on the card and on the CPU
    port: one response log.  No host sync outside the store's rounds."""
    sv.kernels.stats_block.launches = 0
    t0 = time.perf_counter()
    runs, rounds = [], 0
    for _ in range(2):
        res, store, wall = serve_drive(torch, sv, sv.kvs_cfg(), sv.device)
        fe = res["_frontend"]
        c = store.rt.counters()
        device_ops = int(c["n_read"] + c["n_write"] + c["n_rmw"]
                         + c["n_abort"])
        tc = time.perf_counter()
        v = store.rt.check()
        rounds += store.rt.step_idx
        runs.append(dict(
            sha=res["response_log_sha"], rounds=store.rt.step_idx,
            wall_s=wall, host_us_per_round=wall / store.rt.step_idx * 1e6,
            answered_per_s=res["ops_offered"] / wall,
            completed_per_s=res["completed"] / wall,
            check_ok=v.ok, check_s=time.perf_counter() - tc,
            issued=sum(fe._lane_seq.values()), device_ops=device_ops,
            recorded=store.rt.recorder.n_recorded,
            summary={k: res[k] for k in (
                "sent", "statuses", "admitted", "completed", "retry_after",
                "shed", "deadline", "lost", "rejected", "p50_latency_us",
                "p99_latency_us", "virtual_seconds")}))
        del store, res, fe
    small = {}
    for dev in dict.fromkeys((str(sv.device), "cpu")):
        cfg = sv.HermesConfig(**SERVE_SMALL)
        res, store, _ = serve_drive(torch, sv, cfg, dev)
        if dev == str(sv.device):
            rounds += store.rt.step_idx
        small[str(dev)] = dict(sha=res["response_log_sha"],
                               check_ok=store.rt.check().ok,
                               rounds=store.rt.step_idx)
    launches = sv.kernels.stats_block.launches
    emit({"phase": "serve", "nvidia_smi": card, "runs": runs,
          "small": small, "stats_block_launches": launches,
          "rounds": rounds, "seconds": time.perf_counter() - t0})
    a, b = runs
    if a["sha"] != b["sha"] or a["summary"] != b["summary"]:
        raise AssertionError("two serve runs on the card gave different "
                             "response logs")
    if len({r["sha"] for r in small.values()}) != 1:
        raise AssertionError(f"the card's small serve run differs from the "
                             f"CPU port's: {small}")
    for r in runs + list(small.values()):
        if not r["check_ok"]:
            raise AssertionError("serve: the checker failed")
    for r in runs:
        if not r["issued"] == r["device_ops"] == r["recorded"]:
            raise AssertionError(f"serve: ops issued {r['issued']}, device "
                                 f"ops {r['device_ops']}, recorded "
                                 f"{r['recorded']}")
        s = r["summary"]
        if not (s["retry_after"] and s["deadline"] and s["completed"]):
            raise AssertionError(f"serve: the envelope did not act: {s}")
    if launches != rounds:
        raise AssertionError(f"stats_block launches {launches} != serve "
                             f"rounds {rounds}")
    return dict(launches={"stats_block": launches})


SERVE_FLEET_GROUPS = 2


def phase_serve_fleet(torch, sv, card):
    """The serve phase's drive through a ``Fleet`` of
    ``SERVE_FLEET_GROUPS`` groups at the reads shape behind ``Frontend``:
    the mix spans every group, ``verify_serving`` (inside the drive) and
    ``verify_fleet``, every group's checker, no write the client saw
    commit lost from the groups' histories, the ops handed to the fleet =
    the groups' device op counters = their recorded completions, the
    envelope acting; then the drive at ``SERVE_SMALL`` on the card and on
    the CPU port: one response log.  No host sync outside the groups'
    rounds; ``stats_block`` once a group round."""
    import numpy as np

    sv.kernels.stats_block.launches = 0
    t0 = time.perf_counter()
    res, fleet, wall = serve_drive(torch, sv, sv.kvs_cfg(), sv.device,
                                   groups=SERVE_FLEET_GROUPS)
    fe = res["_frontend"]
    mix = sv.make_mix(sv.MixSpec(tenants=4), fe.n_keys, SERVE_OPS,
                      SERVE_SEED, value_words=fe.u)
    gids, _ = fleet.router.locate(np.asarray(mix["key"], np.int64))
    spanned = sorted(set(np.asarray(gids).tolist()))
    counters = [g.rt.counters() for g in fleet.groups]
    device_ops = sum(int(c["n_read"] + c["n_write"] + c["n_rmw"]
                         + c["n_abort"]) for c in counters)
    recorded = sum(g.rt.recorder.n_recorded for g in fleet.groups)
    issued = sum(fe._lane_seq.values())
    rounds = [g.rt.step_idx for g in fleet.groups]
    tc = time.perf_counter()
    verdicts = fleet.check()
    invariants = sv.verify_fleet(fleet)
    aborted = set()
    for g in fleet.groups:
        aborted |= set(g.rt.recorder.aborted_uids)
    uids = sv.committed_uids(fe, res["_server"])
    lost = sv.lin.committed_write_lost(
        uids, [o for g in fleet.groups for o in g.rt.history_ops()],
        aborted)
    check_s = time.perf_counter() - tc
    summary = {k: res[k] for k in (
        "sent", "statuses", "admitted", "completed", "retry_after", "shed",
        "deadline", "lost", "rejected", "p50_latency_us", "p99_latency_us",
        "virtual_seconds")}
    sha = res["response_log_sha"]
    del fleet, fe, res
    all_rounds = sum(rounds)
    small = {}
    for dev in dict.fromkeys((str(sv.device), "cpu")):
        r, f, _ = serve_drive(torch, sv, sv.HermesConfig(**SERVE_SMALL), dev,
                              groups=SERVE_FLEET_GROUPS)
        small[dev] = dict(sha=r["response_log_sha"],
                          check_ok=f.check()["ok"],
                          rounds=[g.rt.step_idx for g in f.groups])
        if dev == str(sv.device):
            all_rounds += sum(small[dev]["rounds"])
    launches = sv.kernels.stats_block.launches
    emit({"phase": "serve-fleet", "nvidia_smi": card,
          "groups": SERVE_FLEET_GROUPS, "spanned": spanned, "sha": sha,
          "wall_s": wall, "rounds": rounds,
          "host_us_per_round": wall / max(rounds) * 1e6,
          "answered_per_s": summary["sent"] / wall,
          "completed_per_s": summary["completed"] / wall,
          "issued": issued, "device_ops": device_ops, "recorded": recorded,
          "client_committed_uids": len(uids), "committed_write_lost": lost,
          "group_verdicts": verdicts["groups"], "invariants": invariants,
          "check_s": check_s, "summary": summary, "small": small,
          "stats_block_launches": launches,
          "seconds": time.perf_counter() - t0})
    if spanned != list(range(SERVE_FLEET_GROUPS)):
        raise AssertionError(f"serve-fleet: the mix spanned groups "
                             f"{spanned}")
    if not verdicts["ok"] or lost:
        raise AssertionError(f"serve-fleet: checker {verdicts}, committed "
                             f"writes lost {lost[:4]}")
    if not uids:
        raise AssertionError("serve-fleet: no write the client saw commit")
    if not issued == device_ops == recorded:
        raise AssertionError(f"serve-fleet: ops issued {issued}, device ops "
                             f"{device_ops}, recorded {recorded}")
    if not (summary["retry_after"] and summary["deadline"]
            and summary["completed"]):
        raise AssertionError(f"serve-fleet: the envelope did not act: "
                             f"{summary}")
    if len({r["sha"] for r in small.values()}) != 1 or not all(
            r["check_ok"] for r in small.values()):
        raise AssertionError(f"serve-fleet: the card's small run differs "
                             f"from the CPU port's: {small}")
    if launches != all_rounds:
        raise AssertionError(f"stats_block launches {launches} != the "
                             f"groups' rounds {all_rounds}")
    return dict(launches={"stats_block": launches})


def columnar_drive(torch, sv, store, n=None):
    """One unrecorded ``run_columnar_soak`` of ``n`` (``COLUMNAR_OPS``)
    ops at ``COLUMNAR_PER_ROUND`` arrivals a round over ``store``:
    (summary, wall seconds, the lanes holding an op in each round)."""
    busy = []
    round_once = store.rt.step_once  # the KVS's round at depth 1
    nop = sv.types.OP_NOP

    def counted():
        busy.append(int((store._kindarr != nop).sum()))
        return round_once()

    store.rt.step_once = counted
    scfg = sv.ServingConfig(**COLUMNAR_ENVELOPE)
    on_card = str(sv.device).startswith("cuda")
    sv.sync()
    t0 = time.perf_counter()
    with frontend_sync_free(torch, on_card, store):
        res = sv.run_columnar_soak(
            store, scfg, sv.MixSpec(tenants=4),
            rate_per_s=COLUMNAR_PER_ROUND / 1e-3,
            n=COLUMNAR_OPS if n is None else n, seed=COLUMNAR_SEED,
            deadline_us=0)
    sv.sync()
    wall = time.perf_counter() - t0
    del store.rt.step_once
    return res, wall, busy


def phase_serve_columnar(torch, sv, counters, card):
    """The columnar data plane at the reads shape, unrecorded, at a rate
    that keeps most lanes busy: once on the fused round, once with
    ``mega_round=True``.  Each passes ``verify_columnar`` (inside the
    soak), answers every request, and launches each kernel of its round
    once a round (``mega_replay`` on the replay-scan rounds).  On the
    card a second, shorter soak of ``COLUMNAR_TRACED`` arrival rounds
    over a fresh store runs under ``torch.profiler``: the device time a
    round and the card's idle share while the front end feeds it."""
    on_card = str(sv.device).startswith("cuda")
    out, total = [], dict.fromkeys(counters, 0)
    for mega_round in (False, True):
        cfg = sv.kvs_cfg(mega_round=mega_round)
        for w in counters.values():
            w.launches = 0
        t0 = time.perf_counter()
        store = sv.KVS(cfg, device=sv.device)
        res, wall, busy = columnar_drive(torch, sv, store)
        launches = {n: w.launches for n, w in counters.items()}
        rounds = store.rt.step_idx
        want = expected_launches(cfg, 0, rounds)
        lanes = cfg.n_replicas * cfg.n_sessions
        answered = sum(res["statuses"].values())
        row = dict(mega_round=mega_round, ops=res["ops_offered"],
                   answered=answered, statuses=res["statuses"],
                   rounds=rounds, wall_s=wall,
                   ops_per_s=answered / wall,
                   host_us_per_round=wall / rounds * 1e6,
                   lanes=lanes, busy_mean=sum(busy) / max(1, len(busy)),
                   busy_peak=max(busy, default=0),
                   busy_share_mean=sum(busy) / max(1, len(busy)) / lanes,
                   launches={k: launches[k] for k in want})
        del store, res
        if on_card:
            row["traced"] = trace_columnar(torch, sv, cfg)
        row["seconds"] = time.perf_counter() - t0
        emit(dict({"phase": "serve-columnar-mega" if mega_round
                   else "serve-columnar", "nvidia_smi": card}, **row))
        if answered != row["ops"] or \
                row["statuses"].get("ok", 0) != answered:
            raise AssertionError(f"serve-columnar: {row['statuses']}")
        if {k: launches[k] for k in want} != want or any(
                launches[k] for k in counters if k not in want):
            raise AssertionError(f"serve-columnar launches {launches}, "
                                 f"want {want}")
        for k in counters:
            total[k] += launches[k]
        out.append(row)
    return dict(launches=total, runs=out)


def trace_columnar(torch, sv, cfg):
    """A columnar soak of ``COLUMNAR_TRACED`` rounds of arrivals over a
    fresh store (built before the timing), timed by the CUDA events its
    compiled rounds record (``device_busy``): device us a round, and the
    card's busy and idle shares of the wall time; then another soak
    traced by torch.profiler for its kernels by name (a report).  Raises
    if a request went unanswered."""
    store = sv.KVS(cfg, device=sv.device)
    got = []
    prof = device_busy(torch, lambda: got.append(columnar_drive(
        torch, sv, store, n=COLUMNAR_TRACED * COLUMNAR_PER_ROUND)),
        "serve-columnar", (store.rt,))
    res, _wall, lanes = got[0]
    rounds = len(lanes)
    answered = sum(res["statuses"].values())
    if answered != res["ops_offered"]:
        raise AssertionError(f"serve-columnar traced: {res['statuses']}")
    share = prof["busy_s"] / prof["wall_s"]
    return dict(ops=res["ops_offered"], rounds=rounds,
                wall_s=prof["wall_s"],
                host_us_per_round=prof["wall_s"] / rounds * 1e6,
                device_us_per_round=prof["busy_s"] / rounds * 1e6,
                cuda_kernels_per_round=prof["launches"] / rounds,
                device_busy_share=share, device_idle_share=1.0 - share,
                top_device_us_per_round=[
                    [name, us / rounds, cnt / rounds]
                    for us, cnt, name in prof["top"]])


def serve_host(socket):
    """What the serving plane needs of the host: SO_REUSEPORT (two
    listeners on one port) and the size of /dev/shm."""
    from hermes_tpu_torch.transport.tcp import serving_listener

    a = serving_listener("127.0.0.1", 0, reuseport=True)
    b = serving_listener("127.0.0.1", a.getsockname()[1], reuseport=True)
    a.close()
    b.close()
    st = os.statvfs("/dev/shm")
    return dict(so_reuseport=True, dev_shm_bytes=st.f_blocks * st.f_frsize,
                dev_shm_free_bytes=st.f_bavail * st.f_frsize)


def phase_serve_socket(torch, sv, card):
    """``run_serve_bench``'s latency and throughput points through a real
    localhost ``TcpRpcServer`` at ``host_cfg(mode, on_card=True)``:
    client-socket p50/p99 and ops/s; every request answered, every cell
    without error, ``stats_block`` once a store round."""
    sv.kernels.stats_block.launches = 0
    t0 = time.perf_counter()
    out = sv.run_serve_bench(n=SOCKET_N, device=sv.device,
                             scenarios=False, columnar=False)
    cells = dict(out["cells"], capacity_probe=out["capacity_probe"])
    launches = sv.kernels.stats_block.launches
    rounds = sum(c["rounds"] for c in cells.values())
    keep = ("ops", "answered", "wall_s", "ops_per_sec", "statuses",
            "p50_us", "p99_us", "p50_all_us", "p99_all_us", "rate_per_s",
            "window", "pipeline_depth", "rounds", "error")
    emit({"phase": "serve-socket", "nvidia_smi": card,
          "cells": {n: {k: c.get(k) for k in keep} for n, c in cells.items()},
          "latency_p50_improves": out["latency_p50_improves"],
          "device": out["device"], "stats_block_launches": launches,
          "rounds": rounds, "seconds": time.perf_counter() - t0})
    for n, c in cells.items():
        if c["error"] is not None or c["answered"] != c["ops"]:
            raise AssertionError(f"serve-socket cell {n}: answered "
                                 f"{c['answered']} of {c['ops']}, error "
                                 f"{c['error']}")
    if out.get("errors"):
        raise AssertionError(f"serve-socket: {out['errors']}")
    if launches != rounds:
        raise AssertionError(f"stats_block launches {launches} != socket "
                             f"cells' rounds {rounds}")
    return dict(launches={"stats_block": launches})


def phase_serve_one_store(torch, sv, card):
    """``run_one_store_cell``: ``ONE_STORE_WORKERS`` shm front-end
    processes (no torch in them) feeding one store on the card, client
    processes driving closed-loop columnar batches.  Every row answered
    exactly once (the owner's rows in = rows out = the clients' rows, the
    front end's requests = responses), no error."""
    import socket

    host = serve_host(socket)
    emit({"phase": "serve-host", **host})
    sv.kernels.stats_block.launches = 0
    t0 = time.perf_counter()
    c = sv.run_one_store_cell(ONE_STORE_WORKERS, device=sv.device)
    launches = sv.kernels.stats_block.launches
    rows = c["clients"] * (c["ops"] // c["clients"] + c["batch"])
    emit({"phase": "serve-one-store", "nvidia_smi": card, **c,
          "rows_sent": rows, "stats_block_launches": launches,
          "seconds": time.perf_counter() - t0})
    if c["error"] is not None:
        raise AssertionError(f"serve-one-store: {c['error']}")
    if not _one_store_rows_once(c):
        raise AssertionError(f"serve-one-store: rows not answered exactly "
                             f"once: {c}")
    if launches != c["rounds"]:
        raise AssertionError(f"stats_block launches {launches} != one-store "
                             f"rounds {c['rounds']}")
    return dict(launches={"stats_block": launches})


WORKER_CELLS = (1, 2, 4)  # run_columnar_worker_cell's worker counts
ONE_STORE_WIDE = 4  # the one-store cell beside serve-one-store's 2


def _one_store_rows_once(c):
    """Whether a one-store cell answered every row exactly once."""
    ipc = c["ipc"]
    rows = c["clients"] * (c["ops"] // c["clients"] + c["batch"])
    return (c["answered"] == c["ops"] == sum(c["statuses"].values())
            and ipc["rows_in"] == ipc["rows_out"] == rows
            and c["requests"] == c["responses"] == rows
            and not ipc["dead_drop_rows"] and not ipc["dead_workers"])


def phase_serve_workers(torch, sv, card):
    """The serving cells of the accept-sharded planes:
    ``run_columnar_worker_cell`` at ``WORKER_CELLS`` worker processes
    (each a private store on ``sv.device``), the columnar loopback cell
    (``measure_columnar_floor``, this process) and ``run_one_store_cell``
    at ``ONE_STORE_WIDE`` torch-free shm workers feeding one store here.
    Every row answered, no cell carrying an error, the topology labels
    (``private-store-per-worker``, ``one-store``); each cell's ops/s.
    ``stats_block`` once a round of the one-store cell's store."""
    t0 = time.perf_counter()
    cells = {}
    for w in WORKER_CELLS:
        cells[f"columnar_workers_{w}"] = sv.run_columnar_worker_cell(
            w, device=sv.device)
    sv.kernels.stats_block.launches = 0
    loopback = sv.measure_columnar_floor(device=sv.device)
    floor_launches = sv.kernels.stats_block.launches
    cells["columnar_loopback"] = loopback
    sv.kernels.stats_block.launches = 0
    wide = sv.run_one_store_cell(ONE_STORE_WIDE, device=sv.device)
    launches = sv.kernels.stats_block.launches
    cells[f"one_store_workers_{ONE_STORE_WIDE}"] = wide
    keep = ("workers", "clients", "ops", "answered", "batch", "wall_s",
            "ops_per_sec", "topology", "rounds", "statuses", "error")
    emit({"phase": "serve-workers", "nvidia_smi": card,
          "cells": {n: {k: c.get(k) for k in keep} for n, c in cells.items()},
          "one_store_ipc": wide.get("ipc"),
          "stats_block_launches": floor_launches + launches,
          "seconds": time.perf_counter() - t0})
    for n, c in cells.items():
        if c.get("error") is not None or \
                c.get("answered", c["ops"]) != c["ops"]:
            raise AssertionError(f"serve-workers cell {n}: {c}")
    for w in WORKER_CELLS:
        c = cells[f"columnar_workers_{w}"]
        if c["topology"] != "private-store-per-worker" or \
                not c["ops_per_sec"]:
            raise AssertionError(f"serve-workers: columnar_workers_{w} "
                                 f"{c}")
    if not (loopback["ops_per_sec"] > 0
            and loopback["retried"] < loopback["ops"]):
        raise AssertionError(f"serve-workers: the loopback cell {loopback}")
    if wide["topology"] != "one-store" or not _one_store_rows_once(wide):
        raise AssertionError(f"serve-workers: one_store_workers_"
                             f"{ONE_STORE_WIDE}: rows not answered exactly "
                             f"once, or the label: {wide}")
    if launches != wide["rounds"] or not floor_launches:
        raise AssertionError(f"stats_block launches {launches} != one-store "
                             f"rounds {wide['rounds']} (loopback "
                             f"{floor_launches})")
    return dict(launches={"stats_block": floor_launches + launches},
                cells=cells)


def run_serving(torch, sv, counters, card):
    """The six serving phases; the kernels line's ``serve_*_launches``."""
    return {"serve": phase_serve(torch, sv, card)["launches"],
            "serve_columnar": phase_serve_columnar(
                torch, sv, counters, card)["launches"],
            "serve_socket": phase_serve_socket(torch, sv, card)["launches"],
            "serve_one_store": phase_serve_one_store(
                torch, sv, card)["launches"],
            "serve_fleet": phase_serve_fleet(torch, sv, card)["launches"],
            "serve_workers": phase_serve_workers(
                torch, sv, card)["launches"]}


# --------------------------------------------------------------------------
# The census, the acceptance runs, the entry points and the lock sanitizer
# --------------------------------------------------------------------------

#: BASELINE configs run at full width on the card, and at scale 0.01 on
#: the card and on the CPU port (their counters must be equal)
ACCEPTANCE_CONFIGS = (1, 2, "2r", 3, "3c", 4, 5)
ACCEPTANCE_SMALL = 0.01
ACCEPTANCE_SMALL_CONFIGS = (1, 2, 3, 4, 5)
PROBE_TIMEOUT_S = 180.0


def _census_diff(a, b, keys):
    return {k: (a.get(k), b.get(k)) for k in keys if a.get(k) != b.get(k)}


def phase_census(torch, ac, card):
    """The op census of one round of bench-a, bench-a-mega, sharded and
    sharded-mega at the bench shape on the card (``obs.profile.measure``:
    aten ops, sparse ops, collectives, hand-kernel calls and, from
    torch.profiler, ``kernel_total``), and the read and heap censuses;
    held to ``op_budget.json`` (its ``card`` section too), and the aten
    census equal to the CPU port's at the gate's cut shape (the census
    does not depend on the shape).  Returns the hand-kernel calls of the
    four rounds by name."""
    t0 = time.perf_counter()
    prof = ac.prof
    got = prof.measure(ac.device)
    cpu = prof.measure("cpu")
    budget, card_budget = prof.load_budget()
    failures = prof.check_budget(got, budget)
    if ac.on_card:
        if sorted(card_budget) != sorted(prof.ENGINES):
            failures.append(f"op_budget.json's card section covers "
                            f"{sorted(card_budget)}, want {prof.ENGINES}")
        failures += prof.check_card(got, card_budget)
    diffs = {}
    for sec, cen in got.items():
        keys = (set(cen) | set(cpu[sec])) - {"kernel_total"} \
            if sec in prof.ENGINES else set(budget[sec])
        d = _census_diff(cen, cpu[sec], sorted(keys))
        if d:
            diffs[sec] = d
    calls = {}
    for sec in prof.ENGINES:
        for k, v in got[sec].items():
            if k.startswith("kernel:"):
                calls[k[7:]] = calls.get(k[7:], 0) + v
    emit({"phase": "census", "seconds": time.perf_counter() - t0,
          "shape": prof.census_shape(prof.gate_cfg(small=not ac.on_card)),
          "census": {sec: {k: v for k, v in cen.items() if k != "aten_ops"}
                     for sec, cen in got.items()},
          "budget_failures": failures, "cpu_diff": diffs,
          "hand_kernel_calls": calls, "nvidia_smi": card})
    if failures or diffs:
        raise AssertionError(f"census: budget {failures}, against the CPU "
                             f"port {diffs}")
    return calls


#: the tags of the audited sites of the round (core/faststep.py,
#: core/kernels.py, core/megaround.py) that every gate config must report
AUDIT_TAGS = ("replay-mark-dup-oob-dropped",
              "pts-mint-ver-bounded-by-watermark",
              "winner-row-dup-writes-identical",
              "stats-ctr-hist-grid-accumulate", "mega-route-unique-targets",
              "mega-apply-two-phase-revisit", "mega-replay-stream-accumulate")
ANALYZE_ROUNDS = 8  # rounds of the --analyze run (round 0 scans)
#: the --analyze run's command line: bench-a-mega's shape on the CLI's
#: host stream (4 ops a session, wrapped)
ANALYZE_ARGV = ("--replicas", "8", "--keys", str(1 << 20), "--value-words",
                "8", "--sessions", "65536", "--lane-budget", "49152",
                "--replay-slots", "256", "--ops-per-session", "4",
                "--wrap-stream", "--arb-mode", "sort", "--chain-writes",
                "128", "--mega-round", "--steps", str(ANALYZE_ROUNDS))


GATES_PORTED = ("obs-overhead", "pipeline", "chaos", "elastic", "netchaos",
                "fleet", "serving", "heap", "durability")
GATE_TIMEOUT_S = 300  # one gate's limit in the runner
# obs-overhead-bench: chunks of 20 rounds a run and interleaved reps a
# variant (cut from 2 and 9, PERF.md §4)
OBS_BENCH_CHUNKS, OBS_BENCH_REPS = 1, 5
MEGA = ("mega_route", "mega_apply", "mega_replay")
# the bars of the gates' tracked cells (hermes_tpu_torch/checks/): the
# columnar floor is 50 x the JAX package's pinned scalar cell of 351.8
# ops/s (a CPU host's figure, not the card's)
COLUMNAR_FLOOR_OPS = 50 * 351.8
ONE_STORE_FLOOR_X = 2.0
SCALEOUT_X = 3.0


def gate_floors(summary):
    """The gates' tracked cells of a runner summary: the serving gate's
    floors (the ``gates`` block's cells) and the fleet gate's scale-out
    cells (its report); a failed bar's message, or None."""
    reports = {r["gate"]: r.get("report") or {} for r in summary["results"]}
    out, bad = {}, []
    serving = summary["gates"].get("serving")
    if serving is not None:
        col = serving.get("columnar_floor", {})
        one = serving.get("one_store_floor", {})
        out.update(
            columnar_floor_ops_per_s=col.get("ops_per_sec"),
            columnar_floor_required=col.get("required_ops_per_sec"),
            scalar_ops_per_s=col.get("current_scalar_ops_per_sec"),
            columnar_vs_scalar=col.get("speedup_vs_current_scalar"),
            one_store_ops_per_s=one.get("ops_per_sec"),
            loopback_ops_per_s=one.get("loopback_ops_per_sec"),
            one_store_ratio=one.get("speedup_vs_loopback"),
            shm_replay_identical=serving.get("shm_replay_identical"),
            one_store_kill_leg=serving.get("one_store_kill_leg"))
        if (col.get("ops_per_sec") or 0) < COLUMNAR_FLOOR_OPS:
            bad.append(f"columnar floor {col}")
        if (one.get("speedup_vs_loopback") or 0) < ONE_STORE_FLOOR_X:
            bad.append(f"one-store floor {one}")
    if "fleet" in reports:
        cells = reports["fleet"].get("scaleout", {})
        out.update(
            scaleout_x=cells.get("scaleout_x"),
            fleet_summed_alone_writes_per_s_not_a_capacity_on_one_card=(
                cells.get("aggregate_writes_per_sec")),
            fleet_concurrent_writes_per_s=(
                cells.get("concurrent", {}).get("writes_per_sec")))
        if (cells.get("scaleout_x") or 0) < SCALEOUT_X:
            bad.append(f"scaleout_x {cells.get('scaleout_x')}")
    return out, ("; ".join(bad) or None)


#: gates with no timed bar: run by a runner of their own beside the
#: phases engine (``start_gates``); the timed ones (obs-overhead's host
#: bound, the fleet's scale-out, the serving floors) and durability (it
#: holds the card's free memory across its killed child) run alone after
GATES_BESIDE = ("pipeline", "chaos", "elastic", "netchaos", "heap")


def start_gates(gt, gates):
    """Start the port's runner on ``gates`` (``gt.device``, with
    ``gt.runner_args``) as a process of its own, in a session of its own
    (``stop_gates`` kills the group); returns its handle."""
    import tempfile

    out = tempfile.mkdtemp(prefix="chip_smoke_gates_")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hermes_tpu_torch.gates", "--device",
         gt.device, "--only", ",".join(gates), "--out", out,
         "--timeout", str(GATE_TIMEOUT_S), *gt.runner_args],
        cwd=gt.root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    return SimpleNamespace(proc=proc, out=out, gates=tuple(gates),
                           t0=time.perf_counter())


def stop_gates(run) -> None:
    """Kill a runner still running (the smoke failed before it ended)."""
    import shutil

    if run.proc.poll() is None:
        os.killpg(run.proc.pid, 9)
        run.proc.wait()
    shutil.rmtree(run.out, ignore_errors=True)


def _gates_summary(run):
    """Wait for a runner; ``(its summary, exit code, seconds)``."""
    try:
        stdout, stderr = run.proc.communicate(
            timeout=GATE_TIMEOUT_S * len(run.gates) + 60)
    except subprocess.TimeoutExpired:
        stop_gates(run)
        raise
    seconds = time.perf_counter() - run.t0
    summary_path = os.path.join(run.out, "gates_summary.json")
    if not os.path.exists(summary_path):
        raise AssertionError(f"the gate runner exited {run.proc.returncode} "
                             f"with no summary\n{stdout[-2000:]}"
                             f"\n{stderr[-3000:]}")
    with open(summary_path) as f:
        return json.load(f), run.proc.returncode, seconds


def phase_gates(torch, gt, card, beside=None):
    """The gates of ``gt.gates`` through the port's runner on
    ``gt.device`` (with ``gt.runner_args``: none on the card), each
    green, each launching ``stats_block`` (the heap gate also the mega
    kernels) when ``gt.device`` is the card, the tracked cells of the
    serving and fleet gates at their bars (``gate_floors``); then the
    obs-overhead timing at ``gt.obs_shape``.  ``beside``: a runner
    started earlier (``start_gates``) on some of the gates, which this
    waits for; the others run now.  Returns the launches by kernel,
    summed over the gates."""
    runs = [] if beside is None else [beside]
    runs.append(start_gates(gt, [g for g in gt.gates
                                 if beside is None or g not in beside.gates]))
    try:
        results, cells, rcs, seconds = [], {}, [], {}
        for run in runs:
            summary, rc, secs = _gates_summary(run)
            results += summary["results"]
            cells.update(summary["gates"])
            rcs.append(rc)
            seconds[",".join(run.gates)] = secs
        summary = dict(results=results, gates=cells)
        gates, total = {}, {}
        for r in results:
            rep = r.get("report", {})
            launches = rep.get("launches", {})
            gates[r["gate"]] = {"ok": r["ok"], "seconds": r["seconds"],
                                "device": rep.get("device"),
                                "launches": launches}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        floors, missed = gate_floors(summary)
        emit({"phase": "gates", "nvidia_smi": card, "seconds": seconds,
              "gates": gates, "floors": floors})
        bad = [g for g, r in gates.items() if not r["ok"]]
        if bad or any(rcs):
            tails = {r["gate"]: (r.get("report", {}).get("error")
                                 or r.get("stderr_tail", "")[-1500:])
                     for r in results if not r["ok"]}
            raise AssertionError(f"gates {bad} failed (runner exits "
                                 f"{rcs}): {tails}")
        want = [g for run in runs for g in run.gates]
        if [r["gate"] for r in results] != want or sorted(want) != sorted(
                gt.gates):
            raise AssertionError(f"the runners ran {list(gates)}, want "
                                 f"{list(gt.gates)}")
        if missed:
            raise AssertionError(f"gate cells under their bars: {missed}")
        for g, r in gates.items():
            if r["device"] != torch.device(gt.device).type:
                raise AssertionError(f"gate {g} ran on {r['device']}")
            if gt.device == "cuda":
                need = ("stats_block",) + (MEGA if g == "heap" else ())
                idle = [k for k in need if not r["launches"].get(k)]
                if idle:
                    raise AssertionError(f"gate {g} launched no {idle}")
        bench = os.path.join(runs[-1].out, "obs_overhead_bench.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "hermes_tpu_torch.checks.obs_overhead",
             "--device", gt.device, "--shape", gt.obs_shape,
             "--chunks", str(OBS_BENCH_CHUNKS), "--reps",
             str(OBS_BENCH_REPS), "--out",
             bench], cwd=gt.root, capture_output=True, text=True,
            timeout=GATE_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=gt.root))
        if p.returncode != 0 or not os.path.exists(bench):
            raise AssertionError(f"obs-overhead at the {gt.obs_shape} shape "
                                 f"exited {p.returncode}\n{p.stdout[-2000:]}"
                                 f"\n{p.stderr[-3000:]}")
        with open(bench) as f:
            rep = json.load(f)
        emit({"phase": "obs-overhead-bench", "nvidia_smi": card,
              "shape": rep["shape"], "rounds": rep["rounds"],
              "reps": rep["reps"], "overhead_frac": rep["overhead_frac"],
              "ratio": (rep["wall_s_instrumented"]
                        / rep["wall_s_uninstrumented"]),
              "median_s_on": rep["wall_s_instrumented"],
              "median_s_off": rep["wall_s_uninstrumented"],
              "times_on": rep["times_instrumented"],
              "times_off": rep["times_uninstrumented"],
              "commits": rep["commits"], "launches": rep["launches"],
              "seconds": time.perf_counter() - t0})
        return total
    finally:
        for run in runs:
            stop_gates(run)


def _finding_keys(reports):
    out = {}
    for r in reports:
        for f in r["findings"]:
            out[f.key + "|" + f.severity] = \
                out.get(f.key + "|" + f.severity, 0) + f.count
    return out


def phase_analysis(torch, an, counters, card):
    """The static round analysis on the card: the gate's four configs
    (``analysis.gate.gate_configs``: default, bench, bench-rmw and
    bench-mega, at the bench shape) on both engines, fused and split,
    traced with fake tensors on the card's device; no error or warn
    finding, the seven audit tags present with port sites, the four hand
    kernels each one node in the mega programs and ``stats_block`` in
    every program, and every program's finding keys equal to the CPU
    port's.  Then ``python -m hermes_tpu_torch --analyze FILE`` (its
    ``cli.main``, in this process) at bench-a-mega's shape for
    ``ANALYZE_ROUNDS`` rounds: the findings file written, clean, and the
    run's launches those of its rounds.  Returns the run's launches."""
    t0 = time.perf_counter()
    programs, bad, tags, diffs = {}, [], set(), {}
    for cname, cfg in an.gate.gate_configs().items():
        card_reps = an.ana.analyze_config(cfg, device=an.device)
        cpu_reps = an.ana.analyze_config(cfg, device="cpu")
        for r, rc in zip(card_reps, cpu_reps):
            name = f"{cname}:{r['engine']}"
            programs[name] = dict(nodes=r["n_eqns"], seconds=r["seconds"],
                                  trace_seconds=r["trace_seconds"],
                                  kernels=r["kernels"])
            bad += [f"{name} {f.severity} {f.pass_name}/{f.code} {f.site}"
                    for f in r["findings"] if f.severity in an.ana.GATING]
            bad += [f"{name} site {f.site}" for f in r["findings"]
                    if not f.file.startswith("hermes_tpu_torch/")]
            tags |= {f.audit for f in r["findings"] if f.audit}
            want = ({"stats_block": 1} if not cfg.use_mega_round
                    or r["engine"].endswith("split") else None)
            if want is not None and r["kernels"] != want:
                bad.append(f"{name} kernel nodes {r['kernels']}")
            elif want is None and set(r["kernels"]) != set(counters):
                bad.append(f"{name} kernel nodes {r['kernels']}")
            a, b = _finding_keys([r]), _finding_keys([rc])
            if a != b or r["n_eqns"] != rc["n_eqns"]:
                diffs[name] = dict(nodes=(r["n_eqns"], rc["n_eqns"]),
                                   keys={k: (a.get(k), b.get(k))
                                         for k in set(a) | set(b)
                                         if a.get(k) != b.get(k)})
    missing = sorted(set(AUDIT_TAGS) - tags)
    t_run = time.perf_counter()
    before = _launch_snapshot(counters)
    for w in counters.values():
        w.launches = 0
    out = os.path.join(an.tmp, "analysis_findings.jsonl")
    with contextlib.redirect_stdout(an.io.StringIO()) as text:
        rc = an.cli.main(["--analyze", out, "--device", an.device,
                          *ANALYZE_ARGV])
    launches = {k: w.launches for k, w in counters.items()}
    for k, w in counters.items():
        w.launches = before[k] + launches[k]
    want = expected_launches(SimpleNamespace(
        use_mega_round=True, replay_scan_every=an.cfg_scan), 0,
        ANALYZE_ROUNDS)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    head = [r for r in recs if r.get("record") == "program"]
    said = [line for line in text.getvalue().splitlines()
            if line.startswith("analysis:")]
    emit({"phase": "analysis", "seconds": time.perf_counter() - t0,
          "programs": programs, "audit_tags": sorted(tags),
          "missing_tags": missing, "gating_or_siteless": bad,
          "cpu_diff": diffs, "run": dict(
              rc=rc, seconds=time.perf_counter() - t_run, said=said,
              program=head, launches=launches, want=want),
          "nvidia_smi": card})
    if bad or missing or diffs:
        raise AssertionError(f"analysis: {bad}, missing tags {missing}, "
                             f"against the CPU port {diffs}")
    if (rc != 0 or len(head) != 1 or said != [
            f"analysis: 0 gating finding(s) -> {out}"]
            or head[0]["by_severity"]["error"]
            or head[0]["by_severity"]["warn"]):
        raise AssertionError(f"--analyze run: rc {rc}, {said}, {head}")
    if launches != {k: want.get(k, 0) for k in counters}:
        raise AssertionError(f"--analyze run launched {launches} in "
                             f"{ANALYZE_ROUNDS} rounds, want {want}")
    return launches


def phase_acceptance(torch, ac, counters, card):
    """BASELINE configs ``ACCEPTANCE_CONFIGS`` through
    ``acceptance.run_config`` at ``ac.scale`` (full width on the card:
    2^20 keys, 1,024 sessions, 128 ops, recorded, ``check_keys=512``):
    each drained and checked, config 4's stall detected, ``stats_block``
    launched once a round and no mega kernel; wall seconds (host clock
    ending in the checker, which syncs), rounds and counters of each.
    Then configs 1-5 at scale 0.01 on ``ac.device`` and on the CPU port:
    equal counters and rounds.  Returns the launches over the first
    part."""
    made = []
    base = ac.acceptance.FastRuntime

    class Kept(base):
        """The scenario's runtime, kept for its round count."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    ac.acceptance.FastRuntime = Kept
    t_all = time.perf_counter()
    start = _launch_snapshot(counters)
    rows = []
    try:
        for n in ac.configs:
            before = _launch_snapshot(counters)
            t0 = time.perf_counter()
            c, v = ac.acceptance.run_config(n, scale=ac.scale,
                                            max_steps=ac.max_steps,
                                            device=ac.device)
            ac.sync()
            wall = time.perf_counter() - t0
            rounds = made[-1].step_idx
            moved = {k: w.launches - before[k] for k, w in counters.items()}
            row = dict(config=n, seconds=wall, rounds=rounds,
                       us_per_round=wall / rounds * 1e6, counters=c,
                       checked_ok=v.ok, keys_checked=v.keys_checked,
                       launches=moved)
            emit({"phase": "acceptance", **row})
            rows.append(row)
            made.clear()
            if not (c["drained"] and v.ok):
                raise AssertionError(f"config {n}: drained "
                                     f"{c['drained']}, checker {v.ok}")
            if n == 4 and not c["failure_detected"]:
                raise AssertionError("config 4: the stall was not detected")
            if (moved["stats_block"] != rounds
                    or any(moved[k] for k in moved if k != "stats_block")):
                raise AssertionError(f"config {n}: launches {moved} in "
                                     f"{rounds} rounds")
        launched = {k: w.launches - start[k] for k, w in counters.items()}
        small = {}
        for n in ACCEPTANCE_SMALL_CONFIGS:
            here = ac.acceptance.run_config(n, scale=ACCEPTANCE_SMALL,
                                            device=ac.device)
            r_here = made[-1].step_idx
            cpu = ac.acceptance.run_config(n, scale=ACCEPTANCE_SMALL,
                                           device="cpu")
            r_cpu = made[-1].step_idx
            made.clear()
            small[n] = dict(counters=here[0], rounds=r_here,
                            equal=here[0] == cpu[0] and r_here == r_cpu)
            if not small[n]["equal"] or not (here[1].ok and cpu[1].ok):
                raise AssertionError(
                    f"config {n} at scale {ACCEPTANCE_SMALL}: "
                    f"{here[0]} in {r_here} rounds here, {cpu[0]} in "
                    f"{r_cpu} on the CPU port")
    finally:
        ac.acceptance.FastRuntime = base
    emit({"phase": "acceptance-small", "scale": ACCEPTANCE_SMALL,
          "configs": small,
          "seconds_all": time.perf_counter() - t_all, "nvidia_smi": card})
    return dict(rows=rows, launches=launched)


def phase_graft(torch, ac, counters, card):
    """The entry points: ``probe.probe_backend`` (a child process makes a
    CUDA context under a bound), then ``graft.entry()``'s round once on
    ``ac.device`` and once on the CPU port from the same inputs: every
    state leaf and completion column equal, the hand kernels launched as
    often as the CPU run called them."""
    t0 = time.perf_counter()
    ok, info = ac.probe.probe_backend(PROBE_TIMEOUT_S, device=ac.device)
    if not ok:
        raise AssertionError(f"probe_backend: {info}")
    before = _launch_snapshot(counters)
    old = os.environ.get("HERMES_ENTRY_PROBE")
    os.environ["HERMES_ENTRY_PROBE"] = "0"  # probed just above
    try:
        fn, ex = ac.graft.entry(ac.device)
        fs, comp = fn(*ex)
        ac.sync()
    finally:
        if old is None:
            os.environ.pop("HERMES_ENTRY_PROBE")
        else:
            os.environ["HERMES_ENTRY_PROBE"] = old
    moved = {k: w.launches - before[k] for k, w in counters.items()}
    fn_c, ex_c = ac.graft.entry("cpu")
    with ac.dispatch.count_hand_kernels() as calls:
        fs_c, comp_c = fn_c(*ex_c)
    a = ac.convert.fast_state_to_numpy(fs)
    b = ac.convert.fast_state_to_numpy(fs_c)
    bad = [f"{part}.{f}" for part in ("table", "sess", "replay", "meta")
           for f in getattr(a, part)._fields
           if not (getattr(getattr(a, part), f)
                   == getattr(getattr(b, part), f)).all()]
    bad += [f"comp[{i}]" for i, (x, y) in enumerate(zip(_flat(comp),
                                                       _flat(comp_c)))
            if not torch.equal(x.cpu(), y.cpu())]
    emit({"phase": "graft", "seconds": time.perf_counter() - t0,
          "probe": info, "launches": moved, "cpu_calls": calls,
          "differs": bad})
    if bad:
        raise AssertionError(f"graft entry: {bad} differ from the CPU port")
    if ac.on_card and {k: v for k, v in moved.items() if v} != calls:
        raise AssertionError(f"graft entry launched {moved}, the CPU run "
                             f"called {calls}")
    return moved


#: a lock's hold p99 may reach this many mean store rounds of its drive:
#: the servers' pumps hold their lock for one store round, and rounds
#: differ (the replay-scan rounds, a fresh store's first rounds; the
#: socket cell's mean spreads its measured wall over its warm-up's rounds
#: too); a lock held across rounds (a send or a wait under it) goes far
#: beyond
LOCKLINT_HOLD_ROUNDS = 10


def _locks_over(rep, wall_s, rounds):
    """The bound on a lock's hold p99 (``LOCKLINT_HOLD_ROUNDS`` mean store
    rounds of the drive) and the locks whose hold p99 exceeds it."""
    bound = LOCKLINT_HOLD_ROUNDS * wall_s / max(1, rounds) * 1e6
    return bound, {n: st.get("hold_p99_us") for n, st in rep["locks"].items()
                   if (st.get("hold_p99_us") or 0) > bound}


def phase_locklint(torch, sv, ac, counters, card):
    """The socket serving drives under ``HERMES_LOCKLINT=1`` (every
    ``make_lock`` lock an ObsLock, minted fresh), their stores on
    ``sv.device`` at the serving phases' shapes: the serve-socket phase's
    throughput cell (``run_socket_cell`` at ``host_cfg("throughput")``,
    a ``TcpRpcServer``, ``SOCKET_N`` closed-loop requests, window 64),
    then the serve-columnar phase's store behind a ``ColumnarTcpServer``
    (``hostlint.leg_soak``: ``COLUMNAR_OPS // COLUMNAR_PER_ROUND // 2``
    batches of ``COLUMNAR_PER_ROUND`` requests over TCP after one warm-up
    batch).  Both at half the depth they had before the gates phase came
    (2 x ``SOCKET_N`` requests, all the batches): the serve-socket phase
    drives the same cell at 2 x ``SOCKET_N`` and serve-columnar the same
    store over all of ``COLUMNAR_OPS``.  Each: every request answered, no
    lock-order cycle, every lock's hold p99 within
    ``LOCKLINT_HOLD_ROUNDS`` mean store rounds of its drive, no mega
    kernel launched."""
    from hermes_tpu_torch.serving import bench

    t0 = time.perf_counter()
    before = _launch_snapshot(counters)
    env = ac.concurrency.LOCKLINT_ENV
    old = os.environ.get(env)
    os.environ[env] = "1"
    try:
        graph = ac.lockgraph.reset_global()
        scfg = sv.ServingConfig(tenant_rate_per_s=1e6, tenant_burst=1e5,
                                tenant_quota=64, queue_cap=256)
        cell = bench.run_socket_cell(
            bench.host_cfg("throughput", str(sv.device).startswith("cuda")),
            scfg, sv.MixSpec(name="uniform"), SOCKET_N, mode="closed",
            window=64, seed=bench.scenario_seed(), device=sv.device)
        rep = graph.report()
        socket_bound, socket_over = _locks_over(rep, cell["wall_s"],
                                                cell["rounds"])
        socket = dict(ops=cell["ops"], answered=cell["answered"],
                      error=cell["error"], rounds=cell["rounds"],
                      wall_s=cell["wall_s"], cycles=len(rep["cycles"]),
                      n_edges=rep["n_edges"], locks=rep["locks"],
                      hold_bound_us=socket_bound, over=socket_over,
                      findings=[f.message for f in graph.findings()])
        col = ac.hostlint.leg_soak(
            batches=COLUMNAR_OPS // COLUMNAR_PER_ROUND // 2, warmup=1,
            max_hold_p99_us=None, device=sv.device, cfg=sv.kvs_cfg(),
            scfg=sv.ServingConfig(**COLUMNAR_ENVELOPE),
            rows=COLUMNAR_PER_ROUND)
        col["hold_bound_us"], col["over"] = _locks_over(
            col, col["wall_s"], col["rounds"])
    finally:
        if old is None:
            os.environ.pop(env)
        else:
            os.environ[env] = old
        ac.lockgraph.reset_global()
    moved = {k: w.launches - before[k] for k, w in counters.items()}
    emit({"phase": "locklint", "seconds": time.perf_counter() - t0,
          "nvidia_smi": card, "launches": moved, "socket": socket,
          "columnar_tcp": col})
    if socket["error"] is not None or socket["answered"] != socket["ops"]:
        raise AssertionError(f"locklint socket drive: answered "
                             f"{socket['answered']} of {socket['ops']}, "
                             f"error {socket['error']}")
    for name, r in (("socket", socket), ("columnar_tcp", col)):
        if r["cycles"] or r["over"] or not r["locks"]:
            raise AssertionError(f"locklint {name}: {r['cycles']} cycles, "
                                 f"holds over {r['hold_bound_us']} us "
                                 f"{r['over']}, locks {list(r['locks'])}, "
                                 f"findings {r['findings']}")
    if not col["ok"]:
        raise AssertionError(f"locklint columnar_tcp: {col}")
    if any(moved[k] for k in moved if k != "stats_block"):
        raise AssertionError(f"locklint launched {moved}")
    return moved


def run_acceptance_slice(torch, ac, counters, card):
    """acceptance and graft; the kernels line's ``acceptance_launches``
    and ``graft_launches``.  (The census runs first of all phases, the
    locklint phase after the serving phases.)"""
    return {"acceptance_launches": phase_acceptance(
                torch, ac, counters, card)["launches"],
            "graft_launches": phase_graft(torch, ac, counters, card)}


#: the phases ``--census-each`` traces a round after, in the smoke's order
CENSUS_EACH_PHASES = (
    "phase_census", "phase_kernels", "phase_sanitizer", "phase_probe",
    "phase_reference", "phase_main", "phase_ab", "phase_checked",
    "phase_sharded", "phase_checked_sharded", "phase_kvs", "phase_reads",
    "phase_values", "phase_durable", "phase_restart", "phase_observed",
    "phase_chaos", "phase_detect_cost", "phase_drill", "phase_resize",
    "phase_migrate", "phase_fleet", "phase_phases", "phase_phases_sharded",
    "phase_sim_wire", "phase_tcp", "run_phases_engine", "phase_serve",
    "phase_serve_columnar", "phase_serve_socket", "phase_serve_one_store",
    "phase_locklint", "phase_acceptance", "phase_graft")


def round_kernels(torch, cfg, backend="batched"):
    """One round of ``cfg`` on a fresh state, traced until two
    torch.profiler traces agree (``profiling._trace``, the sentinel left
    out): (its CUDA kernels by name, its host launch calls by API); the
    hand kernels' launch counters put back."""
    from hermes_tpu_torch import profiling
    from hermes_tpu_torch.obs import profile as prof

    dev = torch.device("cuda", torch.cuda.current_device())
    last = None
    with prof._launches_kept():
        for _ in range(10):
            args = prof._round_args(cfg, backend, dev, None)
            out = profiling._trace(
                lambda: prof._run_round(cfg, backend, *args))
            got = (out["names"], out["launch_calls"])
            if last is not None and got == last:
                return got
            last = got
    raise RuntimeError("torch.profiler gave no two agreeing traces of a "
                       "round")


def census_after_each_phase(torch, path):
    """Wrap every phase of ``CENSUS_EACH_PHASES`` so that a bench-a
    round is traced (``round_kernels``) and counted (``count_ops``) after
    it: one ``census-each`` line each, and a JSONL record in ``path``
    with the kernels and launch calls by name and the global torch
    settings."""
    from hermes_tpu_torch.config import bench_cfg

    t_start = time.perf_counter()
    open(path, "w").close()

    from hermes_tpu_torch.obs import profile as prof

    cfg = bench_cfg("a")
    dev = torch.device("cuda", torch.cuda.current_device())

    def trace(after):
        names, calls = round_kernels(torch, cfg)
        args = prof._round_args(cfg, "batched", dev, None)
        aten = prof.count_ops(lambda mode: prof._run_round(
            cfg, "batched", *args))["aten_total"]
        line = {"phase": "census-each", "after": after,
                "kernel_total": sum(names.values()),
                "launch_calls": sum(calls.values()), "aten_total": aten,
                "t": time.perf_counter() - t_start}
        emit(line)
        settings = dict(
            deterministic=torch.are_deterministic_algorithms_enabled(),
            sync_debug_mode=torch.cuda.get_sync_debug_mode(),
            grad_enabled=torch.is_grad_enabled(),
            num_threads=torch.get_num_threads(),
            default_dtype=str(torch.get_default_dtype()),
            hermes_env={k: v for k, v in os.environ.items()
                        if k.startswith("HERMES")})
        with open(path, "a") as f:
            f.write(json.dumps(dict(line, settings=settings, kernels=names,
                                    launch_apis=calls)) + "\n")

    def wrap(fn, name):
        def traced(*a, **k):
            try:
                return fn(*a, **k)
            finally:
                trace(name)
        return traced

    for name in CENSUS_EACH_PHASES:
        globals()[name] = wrap(globals()[name], name)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the "
                                 "PyTorch/CUDA port on one card.")
    ap.add_argument("--kernels", default=None, metavar="NAME,...",
                    help="run only the device, build and kernels phases, "
                    "for these kernels, and print no result line")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="with --kernels: time the kernels of the "
                    "hermes_tpu_torch in DIR (another checkout, e.g. the "
                    "parent commit's) instead of the one beside this "
                    "script; the one-operation rule is not held there")
    ap.add_argument("--census-each", default=None, metavar="FILE",
                    help="after every phase, trace the CUDA kernels of one "
                    "bench-a round: a census-each line each, their names "
                    "and counts in FILE (JSONL)")
    ns = ap.parse_args(argv)
    only = ns.kernels.split(",") if ns.kernels else None
    if ns.census_each is not None and only is not None:
        ap.error("--census-each runs the whole smoke: not with --kernels")
    if ns.root is not None and only is None:
        ap.error("--root needs --kernels")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(ns.root) if ns.root else HERE)
    try:
        from hermes_tpu_torch import build, config, convert, table_probe
        from hermes_tpu_torch.analysis import fixture_kernels as fk
        from hermes_tpu_torch.core import faststep as fst
        from hermes_tpu_torch.core import kernels, types
        from hermes_tpu_torch.core import megaround as mega
        from hermes_tpu_torch.core import probe_kernels as pk
        import numpy as np

        from hermes_tpu_torch.checker import linearizability as lin
        from hermes_tpu_torch.core import layouts
        from hermes_tpu_torch.workload import ycsb
        from hermes_tpu_torch.kvs import KVS
        from hermes_tpu_torch.runtime import FastRuntime
        from hermes_tpu_torch.core.group import LocalGroup
        from hermes_tpu_torch import snapshot
        from hermes_tpu_torch.chaos import recover_store, restart_replica
        from hermes_tpu_torch.obs import (Observability,
                                          canonical_span_bytes, flightrec)
        from hermes_tpu_torch.wal import crashdrive, replay
        from hermes_tpu_torch import chaos as chaos_lib, elastic
        from hermes_tpu_torch import kvs as kvs_mod
        from hermes_tpu_torch.chaos import recovery
        from hermes_tpu_torch.membership import MembershipService
        from hermes_tpu_torch import fleet as fleet_lib
        from hermes_tpu_torch.elastic import migrate as migrate_mod
    except ImportError as e:
        print(f"chip_smoke: cannot import the port next to this script "
              f"({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    beside = None  # the runner of the gates run beside the phases engine
    try:
        if ns.census_each is not None:
            census_after_each_phase(torch, ns.census_each)
        card = nvidia_smi()
        emit({"phase": "device", "nvidia_smi": card,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})
        t0 = time.perf_counter()
        secs = build.build_cuda_all()
        emit({"phase": "build", "sources": secs["release"],
              "checked_sources": secs["checked"],
              "broken_sources": secs["broken"],
              "seconds": time.perf_counter() - t0})
        counters = {"stats_block": kernels.stats_block,
                    "mega_route": mega.mega_route,
                    "mega_apply": mega.mega_apply,
                    "mega_replay": mega.mega_replay}
        if only is None:
            # first of all phases: the profiler keeps fewer of a round's
            # device records as the process ages (PERF.md section 6)
            from hermes_tpu_torch import acceptance, concurrency, graft, probe
            from hermes_tpu_torch.analysis import hostlint, lockgraph
            from hermes_tpu_torch.core import dispatch
            from hermes_tpu_torch.obs import profile as prof

            ac = SimpleNamespace(
                device="cuda", on_card=True, sync=torch.cuda.synchronize,
                prof=prof, acceptance=acceptance, configs=ACCEPTANCE_CONFIGS,
                scale=1.0, max_steps=20000, probe=probe, graft=graft,
                convert=convert, dispatch=dispatch, hostlint=hostlint,
                lockgraph=lockgraph, concurrency=concurrency)
            census_calls = phase_census(torch, ac, card)
        port = SimpleNamespace(config=config, fst=fst, mega=mega, pk=pk,
                               probe=table_probe, fk=fk, kernels=kernels,
                               types=types, FastRuntime=FastRuntime)
        rows = phase_kernels(torch, port, only,
                             ONE_OPERATION if ns.root is None else ())
        if only is not None:
            missing = sorted(set(only) - set(rows))
            if missing:
                raise ValueError(f"no kernel named {missing}")
            emit({"kernels": list(rows.values())})
            print(card, flush=True)
            return 0
        path_launches = phase_sanitizer(torch, port)
        path_launches.update(phase_probe(torch, table_probe, card))
        phase_reference(torch, config, fst, convert, ycsb)
        phase_reference(torch, config, fst, convert, ycsb, mega_round=True)
        main, fused_rt = phase_main(torch, counters, config, FastRuntime,
                                    card)
        main_mega, mega_rt = phase_main(torch, counters, config,
                                        FastRuntime, card, mega_round=True,
                                        fused=main)
        phase_ab(torch, main, fused_rt, main_mega, mega_rt)
        del fused_rt, mega_rt
        for name, row in rows.items():
            row["launches"] = (
                path_launches[name] if name in path_launches
                else (main if name == "stats_block"
                      else main_mega)["launches"][name])
        phase_checked(torch, counters, config, FastRuntime, types)
        phase_checked(torch, counters, config, FastRuntime, types,
                      mega_round=True)
        torch.cuda.empty_cache()
        sh = SimpleNamespace(
            cfg=lambda mega_round=False: config.bench_cfg(
                "a", over=dict(mega_round=mega_round)),
            config=config, FastRuntime=FastRuntime, LocalGroup=LocalGroup,
            device="cuda", mega=mega, fst=fst, port=port,
            rounds=MAIN_ROUNDS, device_busy=device_busy,
            check_kernel=check_kernel,
            reset_peak_memory=torch.cuda.reset_peak_memory_stats,
            peak_memory=torch.cuda.max_memory_allocated)
        sharded, _ = phase_sharded(torch, counters, sh, card)
        sharded_mega, sites = phase_sharded(torch, counters, sh, card,
                                            mega_round=True)
        for name, row in rows.items():
            if name in counters:
                row["sharded_launches"] = (
                    sharded if name == "stats_block"
                    else sharded_mega)["launches"][name]
            if name in sites:
                site = sites[name]
                tag = ("sharded_site" if name == "mega_apply"
                       else "sharded_copy")
                row.update({f"{tag}_ms": site["call_us"] / 1e3,
                            f"{tag}_queued_ms": site["queued_us"] and
                            site["queued_us"] / 1e3,
                            f"{tag}_plain_ms": site["plain_call_us"] / 1e3,
                            f"{tag}_bound_ms": site["bound_us"] / 1e3})
                row["max_abs_err"] = max(row["max_abs_err"],
                                         site["max_abs_err"])
        phase_checked_sharded(torch, counters, sh, types)
        from hermes_tpu_torch.core import graphs
        from hermes_tpu_torch import profiling

        gr = SimpleNamespace(
            cfg=sh.cfg, FastRuntime=FastRuntime, LocalGroup=LocalGroup,
            KVS=KVS, kvs_cfg=lambda **over: _kvs_cfg(config, **over),
            graphs=graphs, profiling=profiling, np=np, fst=fst)
        graphed = phase_graph(torch, gr, counters, card)
        for name, row in rows.items():
            if name in counters:
                row["graph_launches"] = graphed[
                    "bench-a-mega"].get(name, 0)
        phase_kvs(torch, kernels, config, KVS)
        phase_reads(torch, np, kernels, types, config, KVS, lin, card, sh)
        phase_values(torch, np, kernels, types, config, KVS, layouts, ycsb,
                     card)
        store = SimpleNamespace(
            root=HERE, shape="bench", device="cuda",
            wave_puts=DURABLE_WAVE_PUTS,
            kvs_cfg=lambda **over: _kvs_cfg(config, **over),
            snapshot=snapshot, replay=replay,
            crashdrive=crashdrive, recover_store=recover_store,
            restart_replica=restart_replica, Observability=Observability,
            flightrec=flightrec, canonical_span_bytes=canonical_span_bytes)
        phase_durable(torch, np, kernels, types, KVS, store, card)
        phase_restart(torch, np, kernels, types, KVS, store, card)
        phase_observed(torch, np, kernels, types, KVS, store, card)
        torch.cuda.empty_cache()
        ch = SimpleNamespace(
            cfg=lambda **over: config.bench_cfg("a", over=over),
            kvs_cfg=lambda **over: _kvs_cfg(config, **over),
            device="cuda", FastRuntime=FastRuntime, LocalGroup=LocalGroup,
            KVS=KVS, C_REJECTED=kvs_mod.C_REJECTED, chaos=chaos_lib,
            recovery=recovery, elastic=elastic,
            MembershipService=MembershipService,
            Observability=Observability, fst=fst, types=types,
            sync=torch.cuda.synchronize, device_busy=device_busy,
            rounds=DETECT_ROUNDS, seed=0)
        chaos_runs = {
            "chaos": phase_chaos(torch, counters, ch, card),
            "chaos_sharded_mega": phase_chaos(torch, counters, ch, card,
                                              sharded=True)}
        for name, row in rows.items():
            for tag, run in chaos_runs.items():
                if name in run["launches"]:
                    row[f"{tag}_launches"] = run["launches"][name]
        phase_detect_cost(torch, ch, card)
        phase_drill(torch, kernels, ch, card)
        phase_resize(torch, np, kernels, ch, card)
        torch.cuda.empty_cache()
        store_mem = dict(reset_peak_memory=torch.cuda.reset_peak_memory_stats,
                         peak_memory=torch.cuda.max_memory_allocated)
        mg = SimpleNamespace(
            kvs_cfg=lambda **over: _kvs_cfg(config, **over), device="cuda",
            KVS=KVS, elastic=elastic, migrate_mod=migrate_mod,
            snapshot=snapshot, fst=fst, sync=torch.cuda.synchronize,
            seed=0, **store_mem)
        migrated = phase_migrate(torch, np, counters, mg, card)
        torch.cuda.empty_cache()
        fl = SimpleNamespace(
            kvs_cfg=lambda **over: _kvs_cfg(config, **over),
            cfg=lambda **over: config.bench_cfg("a", over=over),
            device="cuda", Fleet=fleet_lib.Fleet,
            FleetConfig=config.FleetConfig,
            FleetChaosRunner=fleet_lib.FleetChaosRunner,
            fleet_schedules=fleet_lib.fleet_schedules,
            run_fleet_cells=fleet_lib.run_fleet_cells, chaos=chaos_lib,
            fst=fst, C_REJECTED=kvs_mod.C_REJECTED,
            sync=torch.cuda.synchronize, seed=0, move=FLEET_MOVE,
            mix_ops=FLEET_MIX_OPS, chaos_ops=FLEET_CHAOS_OPS, **store_mem)
        fleet_run = phase_fleet(torch, np, counters, fl, card)
        for name, row in rows.items():
            if name in counters:
                row["migrate_launches"] = migrated["launches"][name]
                row["fleet_launches"] = sum(g[name]
                                            for g in fleet_run["launches"])
                row["fleet_bench_launches"] = \
                    fleet_run["bench_launches"][name]
        torch.cuda.empty_cache()
        from hermes_tpu_torch.chaos.net import FaultingTransport
        from hermes_tpu_torch.distributed import combine_and_check
        from hermes_tpu_torch.runtime import Runtime
        from hermes_tpu_torch.transport.sim import SimTransport

        ph = SimpleNamespace(
            cfg=lambda n: baseline_cfg(config, n), scale=1.0,
            device="cuda", root=HERE, Runtime=Runtime, LocalGroup=LocalGroup,
            types=types, sync=torch.cuda.synchronize,
            reset_peak_memory=torch.cuda.reset_peak_memory_stats,
            peak_memory=torch.cuda.max_memory_allocated,
            device_busy=device_busy,
            sync_check=lambda: cuda_sync_check(torch),
            queued_s=profiling.queued_s, launch_calls=launch_calls,
            FaultingTransport=FaultingTransport, SimTransport=SimTransport,
            chaos=chaos_lib, MembershipService=MembershipService,
            combine_and_check=combine_and_check)
        # the gates without a timed bar run beside the phases engine (no
        # verdict of its rests on a time) in a runner of their own
        gt = SimpleNamespace(device="cuda", root=HERE, gates=GATES_PORTED,
                             obs_shape="bench", runner_args=())
        beside = start_gates(gt, GATES_BESIDE)
        engine = run_phases_engine(torch, ph, counters, card)
        for name, row in rows.items():
            if name in counters:
                row["phases_engine_launches"] = engine["launches"][name]
        torch.cuda.empty_cache()
        from hermes_tpu_torch import serving
        from hermes_tpu_torch.serving import bench as serve_bench
        from hermes_tpu_torch.serving import soak as serve_soak
        from hermes_tpu_torch.workload import openloop

        sv = SimpleNamespace(
            kvs_cfg=lambda **over: _kvs_cfg(config, **over),
            HermesConfig=config.HermesConfig, device="cuda", KVS=KVS,
            kernels=kernels, types=types, chaos=chaos_lib,
            ShapedArrivals=openloop.ShapedArrivals, MixSpec=openloop.MixSpec,
            ServingConfig=serving.ServingConfig,
            run_open_loop=serving.run_open_loop,
            run_columnar_soak=serve_soak.run_columnar_soak,
            run_serve_bench=serve_bench.run_serve_bench,
            run_one_store_cell=serve_bench.run_one_store_cell,
            run_columnar_worker_cell=serve_bench.run_columnar_worker_cell,
            measure_columnar_floor=serve_soak.measure_columnar_floor,
            Fleet=fleet_lib.Fleet, FleetConfig=config.FleetConfig,
            verify_fleet=fleet_lib.verify_fleet, lin=lin,
            committed_uids=serve_soak.committed_uids,
            make_mix=openloop.make_mix, sync=torch.cuda.synchronize)
        served = run_serving(torch, sv, counters, card)
        served["locklint"] = phase_locklint(torch, sv, ac, counters, card)
        for name, row in rows.items():
            for tag, got in served.items():
                if name in got:
                    row[f"{tag}_launches"] = got[name]
        torch.cuda.empty_cache()
        sliced = run_acceptance_slice(torch, ac, counters, card)
        sliced["census_calls"] = census_calls
        # after every profiled phase: it runs no profiler, and the kernels
        # phase's exact profiler counts come right after the census in a
        # young process
        import io
        import tempfile

        from hermes_tpu_torch import cli
        from hermes_tpu_torch import analysis as ana
        from hermes_tpu_torch.analysis import gate

        an = SimpleNamespace(
            ana=ana, gate=gate, cli=cli, io=io, device="cuda",
            tmp=tempfile.mkdtemp(prefix="chip_smoke_analysis_"),
            cfg_scan=config.HermesConfig().replay_scan_every)
        sliced["analysis_launches"] = phase_analysis(torch, an, counters,
                                                     card)
        # after every profiled phase: run between the census and the
        # kernels phase, the gates' processes left this process's
        # profiler keeping 7 records of 20 launches (PERF.md section 6)
        torch.cuda.empty_cache()
        sliced["gates_launches"] = phase_gates(torch, gt, card, beside)
        for name, row in rows.items():
            for tag, got in sliced.items():
                if name in got:
                    row[tag] = got[name]
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    except Exception:
        traceback.print_exc()
        if beside is not None:
            stop_gates(beside)
        return 1
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
