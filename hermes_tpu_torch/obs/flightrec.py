"""Crash flight recorder: a copy of ``hermes_tpu/obs/flightrec.py``.

An always-on bounded ring of the run's recent obs records plus the last
few harvested Meta counter summaries and the run's config fingerprint
(``snapshot.config_fingerprint``, the identity the snapshot manifest
checks).  Recording costs one deque append per obs record (the recorder
tees off the exporter inside ``Observability``); nothing is written to
disk until a trigger fires:

  * checker red       — ``FastRuntime.check``;
  * ``StuckOpError``  — the KVS stuck-op watchdog, dumped BEFORE the
    raise so the archive holds the wedged op's diagnostics;
  * a refused WAL replay (``wal/replay.py``);
  * SIGTERM           — opt-in handler (``install_sigterm``) for soaks.

The dump is ONE self-checking JSON archive: ``{"payload": {...},
"sha256": <hex>}`` where the checksum covers the canonical payload
bytes.  ``load`` re-derives and verifies it: a truncated or tampered
archive is refused loudly.  The format is the JAX package's, so an
archive dumped by either package loads in the other's ``load``.

The dump directory resolves per trigger: an explicit ``dump_dir`` on
the recorder, else the ``HERMES_FLIGHT_DIR`` environment variable, else
no auto-dump (the ring stays readable in memory and ``dump(path)`` works
manually).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import signal
import time
from typing import List, Optional

#: Environment variable naming the auto-dump directory — exported by
#: scripts/run_gates.py so every gate subprocess's triggers land their
#: archives where the summary can collect them.
FLIGHT_DIR_ENV = "HERMES_FLIGHT_DIR"


def _canon(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


class FlightArchiveError(ValueError):
    """A flight dump failed its checksum or structure check."""


class FlightRecorder:
    """Bounded black box: recent obs records + last-N Meta summaries +
    config fingerprint, dumped as one checksummed archive on demand."""

    def __init__(self, capacity: int = 512, meta_keep: int = 8,
                 dump_dir: Optional[str] = None):
        if capacity < 1 or meta_keep < 1:
            raise ValueError("capacity and meta_keep must be >= 1")
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.metas: collections.deque = collections.deque(maxlen=meta_keep)
        self.config_sha: Optional[str] = None
        self.dump_dir = dump_dir
        self.dumps: List[str] = []  # paths written by this recorder

    # -- feeding -------------------------------------------------------------

    def record(self, record: dict) -> None:
        """One obs record into the ring (called by the exporter tee)."""
        self.events.append(record)

    def note_meta(self, summary: dict) -> None:
        """One harvested Meta counter summary (runtime counters() polls
        feed this — the last few device-truth snapshots ride the dump)."""
        self.metas.append(dict(summary))

    def set_config(self, cfg) -> None:
        """Stamp the run's config identity (snapshot.config_fingerprint)."""
        from hermes_tpu_torch.snapshot import config_fingerprint

        self.config_sha = config_fingerprint(cfg)

    # -- dumping -------------------------------------------------------------

    def payload(self, reason: str, extra: Optional[dict] = None) -> dict:
        p = dict(
            flight_recorder=1,
            reason=reason,
            config_sha256=self.config_sha,
            n_events=len(self.events),
            events=list(self.events),
            meta_summaries=list(self.metas),
        )
        if extra:
            p["extra"] = extra
        return p

    def dump(self, path: str, reason: str,
             extra: Optional[dict] = None) -> str:
        """Write one checksummed archive; returns the path."""
        payload = self.payload(reason, extra)
        archive = dict(payload=payload,
                       sha256=hashlib.sha256(_canon(payload)).hexdigest())
        with open(path, "w") as f:
            json.dump(archive, f, indent=1, sort_keys=True)
            f.write("\n")
        self.dumps.append(path)
        return path

    def auto_dump(self, reason: str,
                  extra: Optional[dict] = None) -> Optional[str]:
        """Trigger entry point: dump into the resolved directory, or
        return None when no directory is configured (ring stays in
        memory for a manual dump).  The filename carries the reason and
        a monotonic nanosecond stamp so two triggers in one process
        never clobber each other."""
        d = self.dump_dir or os.environ.get(FLIGHT_DIR_ENV)
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        name = f"flight_{reason}_{os.getpid()}_{time.monotonic_ns()}.json"
        return self.dump(os.path.join(d, name), reason, extra)


def load(path: str) -> dict:
    """Read one archive back, verifying its checksum; returns the
    payload.  Raises FlightArchiveError on any mismatch — corruption is
    refused, never silently returned as data."""
    with open(path) as f:
        archive = json.load(f)
    if not isinstance(archive, dict) or "payload" not in archive \
            or "sha256" not in archive:
        raise FlightArchiveError(f"{path}: not a flight archive")
    want = archive["sha256"]
    got = hashlib.sha256(_canon(archive["payload"])).hexdigest()
    if want != got:
        raise FlightArchiveError(
            f"{path}: checksum mismatch (archive says {want[:12]}.., "
            f"payload hashes to {got[:12]}..)")
    return archive["payload"]


def install_sigterm(flight: FlightRecorder, extra: Optional[dict] = None):
    """Install a SIGTERM handler that dumps the black box before
    deferring to the previous disposition.  Returns a zero-arg restore
    callable; a long run installs it around its loop so an operator
    kill still leaves a post-mortem."""
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        flight.auto_dump("sigterm", extra)
        signal.signal(signal.SIGTERM, prev if prev is not None
                      else signal.SIG_DFL)
        signal.raise_signal(signal.SIGTERM)

    signal.signal(signal.SIGTERM, _handler)

    def restore():
        signal.signal(signal.SIGTERM, prev if prev is not None
                      else signal.SIG_DFL)

    return restore
