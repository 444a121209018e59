"""``python -m cuda_knearests_tpu_torch.analysis`` -- the one-command gate.

Counterpart of ``cuda_knearests_tpu/analysis/cli.py``.  Runs all four
engines over the port (the contract checker, the hazard lint, the
kntpu-verify dataflow verifier and the kntpu-proto protocol model
checker), compares against this package's committed baseline, and exits
non-zero on any new finding.  The whole run is card-free: every engine
passes ``device='cpu'`` explicitly and the contract engine reports a CUDA
context or a kernel launch as an ``env-backend`` finding, so, unlike the
reference, nothing needs pinning and no environment variable is touched.

Exit codes: 0 clean; 1 contract/verifier violation(s) or a stale-schema
baseline; 2 new lint finding(s); 3 both.  ``--write-baseline`` re-blesses
the current findings, ``--write-equivalence`` the cross-route
certificates (both reviewed actions, never automatic).

``--json`` emits one machine-readable document on stdout (stable schema
:data:`JSON_SCHEMA`, the reference's keys) so CI can render findings as
annotations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .contracts import FAULTS as CONTRACT_FAULTS
from .findings import (ANALYSIS_VERSION, Finding, analysis_stamp,
                       baseline_hash, diff_vs_baseline, load_baseline,
                       save_baseline, schema_finding)
from .proto import FAULTS as PROTO_FAULTS
from .verify import FAULTS as VERIFY_FAULTS

FAULTS = CONTRACT_FAULTS + VERIFY_FAULTS + PROTO_FAULTS

# Schema version of the --json output document.  Bump on any key change:
# the CI annotation renderer keys off this.
JSON_SCHEMA = 1


def _run(engine: str, paths: Optional[List[str]],
         fault: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    if engine in ("lint", "all"):
        from .lint import lint_paths

        findings.extend(lint_paths(paths))
    if engine in ("contracts", "all") and paths is None:
        # an explicit --paths run is a lint-scope override; contracts have
        # no path scope, so they only join full runs
        from .contracts import run_contracts

        findings.extend(run_contracts(fault=fault))
    if engine in ("verify", "all") and paths is None:
        from .verify import run_verify

        findings.extend(run_verify(fault=fault))
    if engine in ("proto", "all") and paths is None:
        from .proto import run_proto

        findings.extend(run_proto(fault=fault))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--engine",
                    choices=("contracts", "lint", "verify", "proto", "all"),
                    default="all", help="which engine(s) to run")
    ap.add_argument("--paths", nargs="+", default=None, metavar="PATH",
                    help="lint these files/dirs instead of the default "
                         "scope (skips the contract engine; every rule "
                         "applies regardless of its path scope -- the "
                         "fixture-corpus mode)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the committed "
                         "analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="re-bless the current findings as the baseline "
                         "and exit 0 (review the diff before committing)")
    ap.add_argument("--write-equivalence", action="store_true",
                    help="regenerate and commit the cross-route "
                         "equivalence certificates "
                         "(analysis/equivalence.json); review which pairs "
                         "changed before committing")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as one JSON object on stdout")
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="seed one deliberate contract violation (self-"
                         "test; also via KNTPU_ANALYSIS_FAULT)")
    args = ap.parse_args(argv)
    if args.engine == "contracts" and args.paths:
        # --paths is a lint-scope override; combining it with the contract
        # engine would run ZERO checks and report a false 'clean'
        ap.error("--paths scopes the lint engine only; it cannot be "
                 "combined with --engine contracts (contracts always run "
                 "over the full route matrix)")
    if args.paths:
        # a typo'd or wrong-cwd path must not become a permanently-green
        # zero-checks run (the same false-clean class as the guards below)
        missing = [p for p in args.paths if not os.path.exists(p)]
        if missing:
            ap.error(f"--paths entries do not exist: {missing}")
        from .lint import _iter_py_files

        if not _iter_py_files(args.paths):
            ap.error(f"--paths matched no .py files: {args.paths}")
    # a seeded self-test whose fault is never injected would report a
    # false 'detector fired / tree clean' -- so the check is per ENGINE:
    # each fault seeds exactly one engine (contracts or verify), and THAT
    # engine must be part of this invocation, not just any seedable one
    # (a contracts-only run with a verify fault would otherwise pass
    # clean with the fault silently ignored)
    running = set()
    if args.paths is None:
        if args.engine in ("contracts", "all"):
            running.add("contracts")
        if args.engine in ("verify", "all"):
            running.add("verify")
        if args.engine in ("proto", "all"):
            running.add("proto")

    def _fault_engine(fault: str) -> str:
        if fault in CONTRACT_FAULTS:
            return "contracts"
        if fault in VERIFY_FAULTS:
            return "verify"
        return "proto"

    if args.fault and _fault_engine(args.fault) not in running:
        ap.error(f"--fault {args.fault} seeds the "
                 f"{_fault_engine(args.fault)} engine, which this "
                 f"invocation does not run (drop --paths / use --engine "
                 f"{_fault_engine(args.fault)}|all)")
    env_fault = os.environ.get("KNTPU_ANALYSIS_FAULT")
    if env_fault and env_fault in FAULTS \
            and _fault_engine(env_fault) not in running:
        print(f"warning: KNTPU_ANALYSIS_FAULT={env_fault} seeds the "
              f"{_fault_engine(env_fault)} engine, which is not running "
              f"in this invocation; no fault was seeded", file=sys.stderr)
    elif env_fault and env_fault not in FAULTS and not running:
        print("warning: KNTPU_ANALYSIS_FAULT is set but no seedable engine "
              "is running in this invocation; no fault was seeded",
              file=sys.stderr)

    if args.write_equivalence:
        from . import equiv

        path = equiv.save_certificates(equiv.build_certificates())
        print(f"equivalence certificates written: {path}")
        return 0
    findings = _run(args.engine, args.paths, args.fault)

    if args.write_baseline:
        path = save_baseline(findings, args.baseline)
        print(f"baseline written: {path} "
              f"({len([f for f in findings if f.severity != 'info'])} "
              f"accepted findings)")
        return 0

    baseline = load_baseline(args.baseline)
    stale_schema = schema_finding(baseline, args.baseline)
    if stale_schema is not None:
        # a stale-schema baseline cannot gate: refuse (typed finding, rc 1)
        # instead of silently diffing against fingerprints written under a
        # different law
        findings = findings + [stale_schema]
        baseline = {"fingerprints": []}
    new, stale = diff_vs_baseline(findings, baseline)
    contract_fail = any(f.path.startswith("route:") for f in new) \
        or stale_schema is not None
    lint_fail = any(not f.path.startswith("route:") for f in new
                    if f.rule != "baseline-schema")

    if args.as_json:
        print(json.dumps({
            "schema": JSON_SCHEMA,
            **analysis_stamp(),
            "engine": args.engine,
            "findings": [{**f.to_json(), "fingerprint": f.fingerprint}
                         for f in findings],
            "new": [f.fingerprint for f in new],
            "stale_baseline": stale,
            "counts": {
                "error": sum(1 for f in findings if f.severity == "error"),
                "warning": sum(1 for f in findings
                               if f.severity == "warning"),
                "info": sum(1 for f in findings if f.severity == "info"),
                "new": len(new),
            },
            "ok": not (contract_fail or lint_fail),
        }, indent=2))
    else:
        for f in findings:
            marker = "NEW " if f in new else ("      " if f.severity == "info"
                                              else "base  ")
            print(f"{marker}{f.render()}")
        if stale:
            print(f"note: {len(stale)} baseline fingerprint(s) no longer "
                  f"observed -- tighten the baseline with --write-baseline")
        n_info = sum(1 for f in findings if f.severity == "info")
        print(f"kntpu-check v{ANALYSIS_VERSION} "
              f"(baseline {baseline_hash(args.baseline)}): "
              f"{len(new)} new finding(s), "
              f"{len(findings) - n_info} gating total, {n_info} info")
    if contract_fail and lint_fail:
        return 3
    if contract_fail:
        return 1
    if lint_fail:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
