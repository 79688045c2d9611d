"""Shared constants: key states, op codes, session states.

Key states mirror the reference per-key state machine
Valid/Invalid/Write/Replay (BASELINE.json:5) plus Trans, the transient state a
coordinator's pending write enters when a higher-timestamp INV supersedes it
(Hermes paper §3; SURVEY.md §3.1).  Everything is int32 — the TPU-friendly
scalar type — and replica sets are int32 bitmaps (<=32 replicas).
"""

from __future__ import annotations

# --- Per-key states (key-state table `state` column) ---------------------
VALID = 0  # readable; the only state that serves local reads / admits writes
INVALID = 1  # a newer write's INV was applied; awaiting its VAL
WRITE = 2  # this replica coordinates a pending write for the key
TRANS = 3  # pending local write superseded by a higher-ts INV; still completes
REPLAY = 4  # failure recovery: re-broadcasting the last INV with the same ts

# --- Op codes (workload streams / session ops) ---------------------------
OP_NOP = 0  # padding; completes immediately
OP_READ = 1
OP_WRITE = 2
OP_RMW = 3

# --- Session status ------------------------------------------------------
S_IDLE = 0  # ready to load the next op from its stream
S_READ = 1  # read pending (stalls while the key is not Valid)
S_ISSUE = 2  # update loaded but not yet issued (key not Valid, or lost local arbitration)
S_INFL = 3  # update issued: INV broadcast, gathering acks
S_DONE = 4  # op stream exhausted

# --- Write-kind flag (embedded in the timestamp tie-break) ---------------
# Plain writes must beat concurrent RMWs from the same base version so that an
# aborted RMW's timestamp can never dominate a surviving update at any replica
# (otherwise the aborted value could become readable via VAL/replay).  The
# Hermes tie-break is lexicographic; we encode (ver, flag, cid) with flag=1
# for plain writes, 0 for RMWs.  See core/timestamps.py and SURVEY.md §3.3.
FLAG_RMW = 0
FLAG_WRITE = 1

# --- Completion codes (per-step session completion records) --------------
C_NONE = 0
C_READ = 1  # read completed, value in the completion record
C_WRITE = 2  # write committed (linearization point: quorum of live acks)
C_RMW = 3  # RMW committed
C_RMW_ABORT = 4  # RMW aborted (no effect; YCSB-F conflict path, BASELINE.json:8)
C_NOP = 5
