"""The finding records of the analysis, in the reference's shape
(``hermes_tpu/analysis/passes.py:Finding``), the baseline currency of the
``analysis`` gate (``key_counts``, ``diff_baseline``, ``load_baseline``,
the reference's ``hermes_tpu/analysis/__init__.py``), and the findings the
kernel matrix makes from what the bound-checked build records
(``core/dispatch.CheckedBuild``):

* ``oob-block-store`` / ``oob-block-load`` (error): a guarded access left
  its extent; the finding names the kernel and the ``.cu`` file and line of
  the guard site;
* ``ref-read-before-init`` (error): with every output poisoned before the
  launch, an output escaped its declared bound: the kernel read or
  accumulated into memory it never initialised (or left it unwritten);
* ``guard-skipped`` (info), the counterpart of the reference's
  ``pallas-skipped``: an access that no guard wraps, declared in the source
  with ``HG_UNGUARDED`` and named here; or the plain version standing in
  on the CPU, where no guarded build runs.  Never silent.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, List, Optional

from hermes_tpu_torch import build

ERROR, WARN, INFO = "error", "warn", "info"
GATING = (ERROR, WARN)  # severities that fail a gate
SEV_RANK = {ERROR: 2, WARN: 1, INFO: 0}
PASS_NAME = "refhazard"


@dataclasses.dataclass
class Finding:
    """One analysis fact, keyed without its line number so that moving
    code does not change the key."""

    pass_name: str
    code: str
    severity: str
    message: str
    file: str = "<unknown>"
    line: int = 0
    fn: str = "<unknown>"
    op: str = ""
    engine: str = ""
    audit: Optional[str] = None
    count: int = 1

    @property
    def key(self) -> str:
        return "|".join((self.engine, self.pass_name, self.code, self.file,
                         self.fn, self.op))

    @property
    def site(self) -> str:
        return f"{self.file}:{self.line}"

    def record(self) -> dict:
        """Run-log JSONL payload (kind="analysis")."""
        return dict(record="finding", pass_=self.pass_name, code=self.code,
                    severity=self.severity, engine=self.engine,
                    site=self.site, fn=self.fn, op=self.op, audit=self.audit,
                    count=self.count, message=self.message, key=self.key)


def _source(lib: str) -> str:
    return f"hermes_tpu_torch/csrc/{lib}.cu"


def _entry_line(lib: str, entry: str) -> int:
    """The source line (1-based) of ``hermes_<entry>`` in ``csrc/<lib>.cu``,
    0 if it has none."""
    text = (build.CSRC / f"{lib}.cu").read_text().splitlines()
    for i, line in enumerate(text, 1):
        if f"hermes_{entry}(" in line:
            return i
    return 0


def guard_findings(chk, engine: str = "") -> List[Finding]:
    """The findings of one ``CheckedBuild`` block: one per launch whose
    guards fired, one per declared unguarded access it reached."""
    out = []
    for v in chk.violations:
        kind = "store" if v["store"] else "load"
        out.append(Finding(
            pass_name=PASS_NAME, code=f"oob-block-{kind}", severity=ERROR,
            file=_source(v["lib"]), line=v["line"], fn=v["kernel"], op=kind,
            engine=engine, count=v["count"],
            message=f"{v['entry']}: a {kind} in {v['kernel']} at index "
                    f"{v['index']} leaves its extent {v['extent']} "
                    f"({v['count']} guarded accesses out of extent in this "
                    f"launch, each skipped)"))
    for u in chk.unguarded:
        out.append(Finding(
            pass_name=PASS_NAME, code="guard-skipped", severity=INFO,
            file=_source(u["lib"]), line=u["line"], fn=u["kernel"],
            op="unguarded", engine=engine,
            message=f"{u['entry']}: {u['what']} is not bound-checked: no "
                    f"guard can wrap it"))
    return out


def plain_finding(engine: str, fn: str) -> Finding:
    """The info finding of an analysis that ran a plain version on the CPU:
    no guarded build ran, so no access was bound-checked."""
    return Finding(
        pass_name=PASS_NAME, code="guard-skipped", severity=INFO, fn=fn,
        op="plain", engine=engine,
        message=f"{fn}: the plain version ran on the CPU: outputs were held "
                f"to their declared bounds, but no access was bound-checked "
                f"(the guarded build runs on the card only)")


def uninit_finding(engine: str, fn: str, lib: str, out_index: int,
                   violation: dict) -> Finding:
    """``ref-read-before-init``: output ``out_index`` of the kernel ``fn``
    (entry point ``hermes_<fn>`` of ``csrc/<lib>.cu``, the finding's site)
    escaped its declared bound in a run whose outputs were poisoned
    first."""
    return Finding(
        pass_name=PASS_NAME, code="ref-read-before-init", severity=ERROR,
        file=_source(lib), line=_entry_line(lib, fn), fn=fn,
        op=f"out{out_index}", engine=engine,
        message=f"{fn}: output {out_index}, poisoned before the launch, "
                f"holds {violation['concrete']} outside its declared bound "
                f"{violation['abstract']} ({violation['kind']}): the kernel "
                f"read or kept memory it never initialised")


def findings_of(reports: Iterable[dict]) -> List[Finding]:
    out: List[Finding] = []
    for r in reports:
        out.extend(r["findings"])
    return out


def key_counts(findings: Iterable[Finding]) -> dict:
    """Stable multiset of gating finding keys (the baseline currency).  The
    key leads with the finding's ``engine`` field: callers analyzing
    several configs stamp it ``"<config>:<engine>"`` first (as the gate
    does), so a finding grandfathered at one shape cannot silently excuse
    the same site at another."""
    counts: dict = {}
    for f in findings:
        if f.severity not in GATING:
            continue
        counts[f.key] = counts.get(f.key, 0) + f.count
    return counts


def diff_baseline(measured: dict, baseline: dict) -> tuple:
    """(new, stale): keys exceeding their grandfathered count, and baseline
    keys the code no longer produces (stale entries are reported but do
    not fail the gate; ``--update`` prunes them)."""
    new = {k: c - baseline.get(k, 0) for k, c in measured.items()
           if c > baseline.get(k, 0)}
    stale = {k: c for k, c in baseline.items() if measured.get(k, 0) < c}
    return new, stale


def load_baseline(path) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return {}
    g = doc.get("grandfathered", {})
    return {k: (v["count"] if isinstance(v, dict) else int(v))
            for k, v in g.items()}


def export_findings(path: str, reports: Iterable[dict],
                    extra: Optional[dict] = None) -> None:
    """Write analysis reports as run-log JSONL (``{"t": ..., "kind":
    "analysis", ...}``): one ``program`` record per report (with its
    ``n_eqns``, the graph nodes of a round, or ``n_sites``, the guard sites
    of a kernel cell), one record per finding, in the reference's
    schema."""
    t0 = time.perf_counter()
    extra = extra or {}
    with open(path, "w") as fp:
        def write(rec):
            fp.write(json.dumps({"t": round(time.perf_counter() - t0, 6),
                                 "kind": "analysis", **extra, **rec}) + "\n")
        for r in reports:
            size = {k: r[k] for k in ("n_eqns", "n_sites") if k in r}
            write(dict(record="program", engine=r["engine"], **size,
                       proved=r["proved"],
                       n_findings=len(r["findings"]),
                       by_severity={s: sum(1 for f in r["findings"]
                                           if f.severity == s)
                                    for s in (ERROR, WARN, INFO)}))
            for f in r["findings"]:
                write(f.record())
