"""Protocol model checking and the conformance binding.

Counterpart of ``cuda_knearests_tpu/analysis/proto.py``.  Two halves, both
host-only, executing none of the program (the chaos campaign and the
SIGKILL drills SAMPLE interleavings; this engine COVERS them):

* **Model exploration** -- every declared protocol model
  (:mod:`.models`: replication-commit, migration-handover,
  mesh-snapshot-replay, drr-admission, autoscale) is explored by
  exhaustive BFS over all action interleavings with the crash/fault event
  enabled at every state, checking the invariants the drills can only
  spot-check.  A violation gates with the MINIMAL action trace.  Two
  seeded self-test faults prove the detector fires:
  ``KNTPU_ANALYSIS_FAULT=torn-commit`` (the ack fires off the primary's
  apply alone: the record never reached the log) and
  ``ack-before-commit`` (the ack guard is gone) each explore the weakened
  model and must produce its counterexample.

* **Conformance binding** -- so the models cannot rot: the protocol
  action sites of this package's serve/fleet/{replica,elastic,frontdoor,
  tenants,admission,autoscale}.py and pod/reshard.py (:data:`SCOPE`)
  carry ``# proto: <model>.<action>`` annotations.  The AST pass proves
  the claim set complete in both directions: every *trigger call* (a call
  whose dotted name matches the protocol-primitive registry --
  ``.handover``, ``.commit_mutation``, ``.log.append``, ``.drr.select``,
  ...) must be claimed by an annotation on its line, in its enclosing
  def, or inside the def it resolves to (``proto-leak`` otherwise); every
  annotation must name a live model action (``stale-claim`` otherwise);
  and every model ``code_action`` must be claimed by at least one site
  (``stale-claim``: a model transition no code performs).  The third
  seeded fault, ``unclaimed-action``, erases the
  ``migration-handover.handover`` claims and must yield both findings.

The runtime third of the binding lives outside this engine: protocol
methods record (model, action) events through utils/prototrace.py, and
the chaos and fleet campaigns reconcile the drained trace against the
models' language with :func:`.models.conform` (their manifests stamp
``proto_version`` and ``proto_models_ok``).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import models as _models
from .findings import Finding

FAULTS = ("torn-commit", "ack-before-commit", "unclaimed-action")

_FAULT_ENV = "KNTPU_ANALYSIS_FAULT"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The protocol surface: every file whose code performs transitions of a
# declared model, resolved against the checkout this package lives in.
# The conformance claim set is anchored here, where the protocols are
# implemented.
SCOPE = (
    "cuda_knearests_tpu_torch/serve/fleet/replica.py",
    "cuda_knearests_tpu_torch/serve/fleet/elastic.py",
    "cuda_knearests_tpu_torch/serve/fleet/frontdoor.py",
    "cuda_knearests_tpu_torch/serve/fleet/tenants.py",
    "cuda_knearests_tpu_torch/serve/fleet/admission.py",
    "cuda_knearests_tpu_torch/serve/fleet/autoscale.py",
    "cuda_knearests_tpu_torch/pod/reshard.py",
)

_ANNOT_RE = re.compile(r"#\s*proto:\s*([a-z0-9-]+)\.([a-z_][a-z0-9_-]*)")

# Protocol-primitive registry: dotted-name patterns that MARK a call as a
# protocol transition, each with the (model, action) claims that satisfy
# it.  A leading '.' means dotted-suffix match (`self.drr.select` matches
# ".drr.select" but stdlib `select.select` does not); a bare name matches
# a direct call or any attribute access of that name.  Deliberately
# conservative: generic verbs (.apply, .append alone) are NOT triggers --
# the model-coverage direction (every code_action claimed somewhere)
# keeps their definitions annotated instead.
TRIGGERS: Tuple[Tuple[str, Tuple[Tuple[str, str], ...]], ...] = (
    ("commit_mutation", (("replication-commit", "append"),)),
    (".log.append", (("replication-commit", "append"),)),
    (".log.records.append", (("replication-commit", "append"),)),
    ("failover", (("replication-commit", "failover"),
                  ("mesh-snapshot-replay", "restore"))),
    ("handover", (("migration-handover", "handover"),)),
    (".abort", (("migration-handover", "abort"),)),
    ("force_rebalance", (("migration-handover", "start"),)),
    ("maybe_rebalance", (("migration-handover", "start"),)),
    ("on_insert", (("migration-handover", "insert"),)),
    ("on_delete", (("migration-handover", "insert"),)),
    (".pump", (("migration-handover", "pump"),)),
    ("write_snapshot", (("mesh-snapshot-replay", "snapshot"),)),
    ("snapshot_tenant", (("mesh-snapshot-replay", "snapshot"),)),
    ("load_snapshot", (("mesh-snapshot-replay", "restore"),)),
    (".drr.select", (("drr-admission", "rotate"),)),
    ("try_take", (("drr-admission", "enqueue"),)),
    (".ready.append", (("drr-admission", "enqueue"),)),
    ("add_replica", (("autoscale", "scale_up"),)),
    ("remove_replica", (("autoscale", "scale_down"),)),
    ("brown_down", (("autoscale", "brown_down"),)),
    ("brown_up", (("autoscale", "brown_up"),)),
)


def _fault() -> Optional[str]:
    return os.environ.get(_FAULT_ENV) or None


def _fail(findings: List[Finding], rule: str, route: str, message: str,
          hint: str = "", subject: str = "") -> None:
    findings.append(Finding(rule=rule, severity="error",
                            path=f"route:{route}", line=0, message=message,
                            hint=hint, subject=subject or message))


def _info(findings: List[Finding], rule: str, route: str, message: str,
          subject: str = "") -> None:
    findings.append(Finding(rule=rule, severity="info",
                            path=f"route:{route}", line=0, message=message,
                            subject=subject or message))


# -- half 1: exhaustive model exploration -------------------------------------

def check_models(fault: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for name, exp in _models.explore_all().items():
        if exp.ok:
            _info(findings, "proto-model", f"proto-{name}",
                  f"explored {exp.n_states} states / {exp.n_transitions} "
                  f"transitions exhaustively, all invariants hold "
                  f"({_models.healthy_models()[name].scope})",
                  subject=f"explored:{name}")
        else:
            v = exp.violations[0]
            _fail(findings, "proto-model", f"proto-{name}",
                  f"protocol model violated: {v.render()}",
                  hint="the model or an invariant drifted from the "
                       "protocol it declares; fix the protocol bug it "
                       "found (the trace is minimal) or correct the model "
                       "deliberately, never by weakening the invariant",
                  subject=f"violated:{name}:{v.invariant}")
    if fault in ("torn-commit", "ack-before-commit"):
        mutant, want_inv = _models.MUTANTS[fault]
        exp = _models.explore(mutant)
        if exp.violations:
            v = exp.violations[0]
            _fail(findings, "proto-model", f"proto-{mutant.name}",
                  f"seeded fault {fault!r}: {v.render()}",
                  hint="self-test: the weakened commit guard must be "
                       "caught by the exhaustive exploration",
                  subject=f"fault:{fault}:{v.invariant}")
        else:
            _fail(findings, "proto-model", f"proto-{mutant.name}",
                  f"seeded fault {fault!r} explored CLEAN: the "
                  f"{want_inv!r} invariant no longer catches its known-"
                  f"violating mutant -- the detector itself regressed",
                  subject=f"fault-missed:{fault}")
    return findings


# -- half 2: the conformance AST pass -----------------------------------------

@dataclasses.dataclass(frozen=True)
class _Def:
    qualname: str
    name: str
    path: str
    lineno: int
    end_lineno: int


@dataclasses.dataclass(frozen=True)
class _TriggerCall:
    path: str
    lineno: int
    end_lineno: int
    dotted: str
    method: str
    candidates: Tuple[Tuple[str, str], ...]
    enclosing: Optional[str]          # qualname of the enclosing def


@dataclasses.dataclass(frozen=True)
class Claim:
    model: str
    action: str
    path: str
    lineno: int


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        else:
            # tunnel through container lookups: self.quota[t].try_take
            # is the try_take protocol call regardless of the key
            node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _trigger_match(dotted: str) -> Optional[Tuple[Tuple[str, str], ...]]:
    for pat, candidates in TRIGGERS:
        if pat.startswith("."):
            if dotted.endswith(pat):
                return candidates
        elif dotted == pat or dotted.endswith("." + pat):
            return candidates
    return None


class _ScopeVisitor(ast.NodeVisitor):
    """Collect defs (with spans) and protocol trigger calls, qualname-
    aware."""

    def __init__(self, path: str):
        self.path = path
        self.stack: List[str] = []
        self.def_spans: List[Tuple[str, int, int]] = []
        self.defs: List[_Def] = []
        self.calls: List[_TriggerCall] = []

    def _qual(self) -> str:
        return ".".join(self.stack)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_def(self, node) -> None:
        self.stack.append(node.name)
        self.defs.append(_Def(
            qualname=self._qual(), name=node.name, path=self.path,
            lineno=node.lineno, end_lineno=node.end_lineno or node.lineno))
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted:
            candidates = _trigger_match(dotted)
            if candidates is not None:
                self.calls.append(_TriggerCall(
                    path=self.path, lineno=node.lineno,
                    end_lineno=node.end_lineno or node.lineno,
                    dotted=dotted,
                    method=dotted.rsplit(".", 1)[-1],
                    candidates=candidates,
                    enclosing=self._qual() or None))
        self.generic_visit(node)


def scan_scope(paths: Sequence[str] = SCOPE, root: Optional[str] = None
               ) -> Tuple[List[_Def], List[_TriggerCall], List[Claim],
                          List[Finding]]:
    """Parse the protocol surface: (defs, trigger calls, annotations,
    parse-error findings)."""
    root = root or _REPO_ROOT
    defs: List[_Def] = []
    calls: List[_TriggerCall] = []
    claims: List[Claim] = []
    findings: List[Finding] = []
    for rel in paths:
        fpath = os.path.join(root, rel)
        try:
            with open(fpath, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, SyntaxError, ValueError) as e:
            _fail(findings, "proto-leak", "proto-conformance",
                  f"protocol surface file {rel} could not be parsed "
                  f"({type(e).__name__}: {e}): the conformance claim set "
                  f"cannot be proven complete",
                  subject=f"parse:{rel}")
            continue
        v = _ScopeVisitor(rel)
        v.visit(tree)
        defs.extend(v.defs)
        calls.extend(v.calls)
        for i, text in enumerate(source.splitlines(), start=1):
            for m in _ANNOT_RE.finditer(text):
                claims.append(Claim(model=m.group(1), action=m.group(2),
                                    path=rel, lineno=i))
    return defs, calls, claims, findings


def check_conformance(fault: Optional[str] = None) -> List[Finding]:
    defs, calls, claims, findings = scan_scope()
    known = _models.healthy_models()
    if fault == "unclaimed-action":
        # seeded fault: the handover site lost its annotations -- the
        # exact shape of a refactor that moves/renames the protocol
        # method and silently detaches it from the model
        claims = [c for c in claims
                  if (c.model, c.action) != ("migration-handover",
                                             "handover")]

    # 2a. every annotation names a live model action
    live: Set[Tuple[str, str]] = set()
    for c in claims:
        m = known.get(c.model)
        if m is None:
            _fail(findings, "stale-claim", "proto-conformance",
                  f"{c.path}:{c.lineno}: '# proto: {c.model}.{c.action}' "
                  f"names unknown model {c.model!r} (declared: "
                  f"{sorted(known)})",
                  subject=f"unknown-model:{c.path}:{c.model}.{c.action}")
        elif c.action not in m.vocabulary:
            _fail(findings, "stale-claim", "proto-conformance",
                  f"{c.path}:{c.lineno}: '# proto: {c.model}.{c.action}' "
                  f"claims an action outside {c.model!r}'s vocabulary "
                  f"{m.vocabulary}",
                  hint="the model lost this action or the site claims the "
                       "wrong transition; reconcile deliberately",
                  subject=f"dead-action:{c.path}:{c.model}.{c.action}")
        else:
            live.add((c.model, c.action))

    # 2b. every trigger call is claimed: on its own line(s), by its
    # enclosing def, or inside the def it resolves to by method name
    # (claims propagate one call level: calling an annotated protocol
    # method needs no re-claim)
    claim_lines: Dict[str, List[Claim]] = {}
    for c in claims:
        claim_lines.setdefault(c.path, []).append(c)

    def _claims_in_span(path: str, lo: int, hi: int
                        ) -> Set[Tuple[str, str]]:
        return {(c.model, c.action) for c in claim_lines.get(path, ())
                if lo <= c.lineno <= hi}

    def_by_qual = {(d.path, d.qualname): d for d in defs}
    defs_by_name: Dict[str, List[_Def]] = {}
    for d in defs:
        defs_by_name.setdefault(d.name, []).append(d)

    for call in calls:
        want = set(call.candidates)
        if _claims_in_span(call.path, call.lineno, call.end_lineno) & want:
            continue
        enc = def_by_qual.get((call.path, call.enclosing))
        if enc is not None and _claims_in_span(
                enc.path, enc.lineno, enc.end_lineno) & want:
            continue
        resolved = any(
            _claims_in_span(d.path, d.lineno, d.end_lineno) & want
            for d in defs_by_name.get(call.method, ()))
        if resolved:
            continue
        wants = " or ".join(f"{m}.{a}" for m, a in sorted(want))
        _fail(findings, "proto-leak", "proto-conformance",
              f"{call.path}:{call.lineno}: protocol call "
              f"'{call.dotted}(...)' is reachable but claimed by no "
              f"'# proto:' annotation (needs {wants}): a protocol "
              f"transition the declared models cannot account for",
              hint="annotate the call line, its enclosing def, or the "
                   "protocol method it resolves to with '# proto: "
                   "<model>.<action>'",
              subject=f"leak:{call.path}:{call.dotted}")

    # 2c. every model code_action is claimed somewhere (models-cannot-rot:
    # a declared transition no source site performs is a model that
    # drifted from the tree it certifies)
    for name in sorted(known):
        m = known[name]
        for action in m.code_actions:
            if (name, action) not in live:
                _fail(findings, "stale-claim", "proto-conformance",
                      f"model {name!r} declares code action {action!r} "
                      f"but no '# proto: {name}.{action}' annotation "
                      f"exists on the protocol surface: the model claims "
                      f"a transition the code no longer performs",
                      hint="re-annotate the site that performs it, or "
                           "remove the action from the model "
                           "deliberately",
                      subject=f"unclaimed:{name}.{action}")
    n_sites = len(calls)
    _info(findings, "proto-conformance", "proto-conformance",
          f"{n_sites} protocol trigger call(s) and {len(claims)} "
          f"annotation(s) across {len(SCOPE)} surface files reconciled "
          f"against {len(known)} models",
          subject="conformance-summary")
    return findings


# -- engine entry -------------------------------------------------------------

def run_proto(fault: Optional[str] = None) -> List[Finding]:
    """Run both protocol gates.  ``fault`` (or KNTPU_ANALYSIS_FAULT)
    seeds one deliberate violation; other engines' faults are ignored
    here (they seed engines 1 and 3)."""
    from .contracts import FAULTS as CONTRACT_FAULTS
    from .verify import FAULTS as VERIFY_FAULTS

    fault = fault if fault is not None else _fault()
    if fault is not None and fault not in FAULTS:
        if fault in CONTRACT_FAULTS + VERIFY_FAULTS:
            fault = None
        else:
            raise ValueError(
                f"unknown analysis fault {fault!r}: expected one of "
                f"{CONTRACT_FAULTS + VERIFY_FAULTS + FAULTS}")
    findings = check_models(fault)
    findings += check_conformance(fault)
    return findings
