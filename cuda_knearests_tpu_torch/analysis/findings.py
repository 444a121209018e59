"""Typed findings and the zero-findings-vs-baseline gate.

Counterpart of ``cuda_knearests_tpu/analysis/findings.py``.  Every
analysis engine of the port emits the same record, so one gate, one
renderer and one baseline mechanism serve them all.  A finding's
*fingerprint* is line-number-free (rule id + file + a hash of the stripped
source line or contract subject): unrelated edits that shift line numbers
must not churn a baseline.

The baseline (``analysis/baseline.json`` of THIS package) lists the
fingerprints of accepted findings; the gate fails on any finding not in
it.  The committed baseline holds no fingerprint: every intentional
pattern is waived at its site with a reasoned marker (``# kntpu-ok:
<rule> -- why`` / ``# noqa: BLE001 -- why``), so the baseline only grows
under explicit ``--write-baseline`` review.  The reference's baseline and
``equivalence.json`` describe the JAX package's tree, not this one's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Iterable, List, Optional, Tuple

# Version of the analysis subsystem (the reference's): bump on any
# rule/contract change so a stamped artifact is traceable to the exact
# gate a tree passed.
ANALYSIS_VERSION = "2.2.0"

# Schema of the committed baseline file.  Bumped whenever the fingerprint
# law changes (occurrence indexing, subject hashing, ...): a baseline
# written under an older law could silently accept findings it never
# reviewed, so the gate REFUSES stale-schema baselines with a typed
# finding instead of diffing against them (see schema_finding).
BASELINE_SCHEMA = 2

_BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "baseline.json")

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding, shared by both engines.

    rule: stable rule/contract id (e.g. 'broad-except', 'hbm-model').
    severity: 'error' | 'warning' | 'info' (info never gates).
    path: repo-relative file for lint findings; a route label
          (e.g. 'route:adaptive') for contract findings.
    line: 1-based line for lint findings, 0 for contracts.
    message: what is wrong, concretely.
    hint: how to fix or waive it.
    subject: the stripped source line (lint) or contract subject key
             (contracts) -- the stable half of the fingerprint.
    """

    rule: str
    severity: str
    path: str
    line: int
    message: str
    hint: str = ""
    subject: str = ""

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(self.subject.encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{h}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule}] {self.severity}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def gating(findings: Iterable[Finding]) -> List[Finding]:
    """The findings that participate in the zero-vs-baseline gate ('info'
    is telemetry, never a failure)."""
    return [f for f in findings if f.severity != "info"]


def indexed_fingerprints(findings: Iterable[Finding]
                         ) -> List[Tuple[Finding, str]]:
    """(finding, occurrence-indexed fingerprint) pairs for the gate.

    The base fingerprint is line-free (stable under edits above the site),
    which makes IDENTICAL source lines in one file collide -- blessing one
    `except Exception:` must not silently accept every future duplicate.
    Duplicates get `#1`, `#2`, ... suffixes in (line-)order, so a baseline
    accepts exactly the COUNT it blessed: adding one more identical hazard
    produces an unaccepted `#n` and the gate fires."""
    seen: dict = {}
    out = []
    for f in sorted(gating(findings), key=lambda f: (f.path, f.line, f.rule)):
        base = f.fingerprint
        n = seen.get(base, 0)
        seen[base] = n + 1
        out.append((f, base if n == 0 else f"{base}#{n}"))
    return out


def load_baseline(path: Optional[str] = None) -> dict:
    path = path or _BASELINE_PATH
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        # a missing baseline means 'no accepted findings', not an error --
        # the gate is simply at its strictest
        return {"version": ANALYSIS_VERSION, "schema": BASELINE_SCHEMA,
                "fingerprints": []}
    if not isinstance(data.get("fingerprints"), list):
        raise ValueError(f"malformed baseline {path}: 'fingerprints' must "
                         f"be a list")
    return data


def schema_finding(baseline: dict, path: Optional[str] = None
                   ) -> Optional[Finding]:
    """The typed refusal for a stale-schema baseline (None when current).

    A baseline written under an older fingerprint law cannot be diffed
    against -- its accepted set might silently cover findings it never
    reviewed -- so the gate fails with THIS finding instead of passing."""
    schema = baseline.get("schema")
    if schema == BASELINE_SCHEMA:
        return None
    path = path or _BASELINE_PATH
    return Finding(
        rule="baseline-schema", severity="error",
        path=os.path.relpath(path, os.getcwd()) if os.path.isabs(path)
        else path, line=0,
        message=f"baseline schema {schema!r} != current {BASELINE_SCHEMA}: "
                f"its accepted fingerprints were written under a different "
                f"fingerprint law and cannot gate this tree",
        hint="re-bless with --write-baseline (review the diff: every "
             "previously-accepted finding must be re-justified)",
        subject=f"baseline-schema:{schema!r}")


def save_baseline(findings: Iterable[Finding],
                  path: Optional[str] = None) -> str:
    path = path or _BASELINE_PATH
    data = {
        "version": ANALYSIS_VERSION,
        "schema": BASELINE_SCHEMA,
        "fingerprints": sorted(fp for _, fp in
                               indexed_fingerprints(findings)),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def analysis_stamp() -> dict:
    """The traceability stamp a measured artifact carries: which gate
    version and which accepted-findings set the tree was checked against.
    Cheap: reads two files, runs nothing."""
    return {"analysis_version": ANALYSIS_VERSION,
            "analysis_baseline": baseline_hash(),
            "analysis_equivalence": equivalence_hash()}


def baseline_hash(path: Optional[str] = None) -> str:
    """Short content hash of this package's baseline (``"none"`` when it
    has none), so a stamped artifact is traceable to the exact
    accepted-findings set of the tree it ran on."""
    path = path or _BASELINE_PATH
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:12]
    except FileNotFoundError:
        return "none"


def equivalence_hash() -> str:
    """Short content hash of the committed cross-route equivalence
    certificates (this package's analysis/equivalence.json; ``"none"``
    when absent), so a stamped artifact is traceable to the exact
    certified route matrix of the tree it ran on.  Cheap: reads one file,
    runs nothing."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "equivalence.json")
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:12]
    except FileNotFoundError:
        return "none"


def diff_vs_baseline(findings: Iterable[Finding],
                     baseline: Optional[dict] = None
                     ) -> Tuple[List[Finding], List[str]]:
    """(new findings not in the baseline, stale baseline fingerprints no
    longer observed).  The gate fails on the first list; the second is
    reported so a baseline that has drifted clean can be re-tightened."""
    baseline = baseline if baseline is not None else load_baseline()
    accepted = set(baseline.get("fingerprints", []))
    pairs = indexed_fingerprints(findings)
    new = [f for f, fp in pairs if fp not in accepted]
    seen = {fp for _, fp in pairs}
    stale = sorted(fp for fp in accepted if fp not in seen)
    return new, stale
