"""Engine 2 driver: walk the source tree, run every registered rule.

Counterpart of ``cuda_knearests_tpu/analysis/lint.py``.  Pure host work --
``ast`` parsing only, no torch import, so the lint half of the gate costs
milliseconds and can never touch a device.  The scope defaults to this
package plus the ``scripts/torch_*.py`` it added; it never includes the
JAX package or its scripts.  Tests and fixtures are exercised *by* the
gate's own test corpus instead of being linted, and ``chip_smoke.py``, the
card's acceptance script, stays out of scope as the tests do.
"""

from __future__ import annotations

import glob
import os
from typing import Iterable, List, Optional

from . import concurrency  # noqa: F401 -- registers the discipline rules
from .findings import Finding
from .rules import all_rules, build_context

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Default lint scope, relative to the repo root: the package, and the
# scripts matching SCRIPT_GLOB under scripts/.
DEFAULT_SCOPE = ("cuda_knearests_tpu_torch",)
SCRIPT_GLOB = "torch_*.py"


def _iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
    return sorted(out)


def lint_paths(paths: Optional[Iterable[str]] = None,
               root: Optional[str] = None) -> List[Finding]:
    """Run every registered rule over ``paths`` (files or directories;
    default: the package + its ``scripts/torch_*.py``).  Findings report repo-relative
    paths so fingerprints are stable across checkouts."""
    root = root or _REPO_ROOT
    # explicit paths (fixture corpora, one-off files) opt into every rule;
    # the default full-tree sweep respects each rule's path scope
    respect_filters = paths is None
    if paths is None:
        paths = [os.path.join(root, p) for p in DEFAULT_SCOPE]
        paths += sorted(glob.glob(os.path.join(root, "scripts",
                                               SCRIPT_GLOB)))
    findings: List[Finding] = []
    rules = all_rules()
    for fpath in _iter_py_files(paths):
        rel = os.path.relpath(fpath, root)
        if rel.startswith(".."):
            rel = fpath  # outside the repo (test fixtures): absolute is fine
        rel = rel.replace(os.sep, "/")
        try:
            with open(fpath, encoding="utf-8") as f:
                source = f.read()
            ctx = build_context(rel, source)
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(Finding(
                rule="parse-error", severity="error", path=rel, line=0,
                message=f"could not parse: {type(e).__name__}: {e}",
                subject=rel))
            continue
        for r in rules:
            if not respect_filters or r.applies_to(rel):
                findings.extend(r.check(ctx))
    # nested loops re-visit the same call once per enclosing loop; a frozen
    # dataclass dedupes exact repeats while preserving order
    findings = list(dict.fromkeys(findings))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
