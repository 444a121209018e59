"""Concurrency-discipline lint rules (engine 2 registry, engine-4 layer 3).

Counterpart of ``cuda_knearests_tpu/analysis/concurrency.py``: the same
three rules over this package's threaded paths, with the port's blocking
calls (``torch.cuda.synchronize``, ``.synchronize()``, ``.item()``,
``dispatch.fetch``) beside the reference's.

The fleet grew threads: the obs emitter/sampler daemons, the dispatch
stats registry, the tuned-plan store, the watchdog, the serve transports.
The protocol models (analysis/models.py) cover the DISTRIBUTED
interleavings; these rules cover the SHARED-MEMORY ones, statically,
with the same registry/waiver machinery as the TPU-hazard rules:

* ``unguarded-shared-mutable`` -- within a class that guards writes to an
  attribute with a ``with self.<lock>:`` block somewhere, every OTHER
  write to that same attribute outside the lock (and outside
  ``__init__``, where the object is not yet shared) is a torn-state
  hazard.  Lock ownership is *inferred from the guarded writes
  themselves*: the first guarded write declares the discipline, the rule
  holds the class to it.  Deliberate lock-free writes (double-checked
  flags, monotonic counters) carry a reasoned
  ``# kntpu-ok: unguarded-shared-mutable -- <why>`` waiver.
* ``lock-order`` -- lexically nested ``with``-lock blocks contribute
  edges to a per-file lock-order graph; a cycle (A taken under B and B
  taken under A) is the classic ABBA deadlock and gates as an error.
  Lock expressions are recognized by name (a dotted chain whose last
  segment mentions ``lock``/``mutex``/``cond``), the repo's naming
  convention for every threading primitive it holds.
* ``blocking-under-lock`` -- a call that can block indefinitely
  (``time.sleep``, subprocess waits, transport ``recv``/``readline``,
  ``select.select``, device syncs like ``torch.cuda.synchronize`` /
  ``.item()`` / ``dispatch.fetch``) while lexically inside a ``with``-lock block
  stalls every thread contending that lock for the duration.  Bounded
  or intentional holds carry a reasoned waiver.

All three are conservative by construction: they reason only about what
is lexically visible (the same soundness stance as the jit-scoped rules
-- "sound on what it sees, silent elsewhere, never guessing"), and the
committed baseline holds ZERO findings of each -- real finds were fixed
at introduction time and banked as lint fixtures.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .findings import Finding
from .rules import FileContext, _dotted, _mk, rule

_THREADED_PATHS = (
    "cuda_knearests_tpu_torch/runtime/",
    "cuda_knearests_tpu_torch/serve/",
    "cuda_knearests_tpu_torch/obs/",
    "cuda_knearests_tpu_torch/tune/",
    "cuda_knearests_tpu_torch/pod/",
    "cuda_knearests_tpu_torch/fuzz/",
    "cuda_knearests_tpu_torch/utils/",
    "cuda_knearests_tpu_torch/oracle.py",
)

_LOCK_NAME_HINTS = ("lock", "mutex", "cond")


def _lock_name(expr: ast.AST) -> Optional[str]:
    """The normalized lock identity of a with-item expression, or None.

    ``self._lock`` and ``cls._lock`` normalize to ``_lock`` so methods of
    one class agree; module-level ``_REG_LOCK`` stays as-is.  A trailing
    ``.acquire()`` call is not a with-item; ``with lock:`` is the repo
    idiom."""
    name = _dotted(expr)
    if not name:
        return None
    last = name.rsplit(".", 1)[-1].lower()
    if not any(h in last for h in _LOCK_NAME_HINTS):
        return None
    parts = name.split(".")
    if parts[0] in ("self", "cls") and len(parts) > 1:
        return ".".join(parts[1:])
    return name


def _with_locks(node: ast.With) -> List[str]:
    out = []
    for item in node.items:
        ln = _lock_name(item.context_expr)
        if ln is not None:
            out.append(ln)
    return out


def _walk_no_nested_defs(body) -> Iterator[ast.AST]:
    """Statements/expressions lexically in this block, not descending into
    nested function/class definitions (their bodies run later, under
    whatever locks hold *then*)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# -- unguarded-shared-mutable -------------------------------------------------

def _attr_writes(node: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(attr-name, node) for every `self.X = ...` / `self.X += ...` store
    in the given statement tree."""
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    for t in targets:
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            yield t.attr, node


@rule("unguarded-shared-mutable", "warning",
      "attribute written under a lock in one method, without it in another",
      path_filter=_THREADED_PATHS)
def _r_unguarded_shared_mutable(ctx: FileContext) -> Iterator[Finding]:
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # pass 1: which attrs does this class write under which lock?
        guarded: Dict[str, Set[str]] = {}
        for m in methods:
            for node in ast.walk(m):
                if not isinstance(node, ast.With):
                    continue
                locks = _with_locks(node)
                if not locks:
                    continue
                for stmt in _walk_no_nested_defs(node.body):
                    for attr, _ in _attr_writes(stmt):
                        guarded.setdefault(attr, set()).update(locks)
        if not guarded:
            continue
        # pass 2: writes to those attrs outside any with-lock block
        for m in methods:
            if m.name == "__init__":
                continue  # pre-publication: the object is not shared yet
            lock_spans: List[Tuple[int, int]] = [
                (n.lineno, n.end_lineno or n.lineno)
                for n in ast.walk(m)
                if isinstance(n, ast.With) and _with_locks(n)]
            for node in ast.walk(m):
                for attr, stmt in _attr_writes(node):
                    if attr not in guarded:
                        continue
                    ln = stmt.lineno
                    if any(a <= ln <= b for a, b in lock_spans):
                        continue
                    if ctx.waived("unguarded-shared-mutable", stmt):
                        continue
                    locks = "/".join(sorted(guarded[attr]))
                    yield _mk(
                        ctx, "unguarded-shared-mutable", "warning", stmt,
                        f"{cls.name}.{attr} is written under {locks} "
                        f"elsewhere in this class but without it in "
                        f"{m.name}(): a concurrent writer can tear or "
                        f"lose this update",
                        f"take `with self.{locks}:` around the write, or "
                        f"waive a deliberate lock-free write with "
                        f"`# kntpu-ok: unguarded-shared-mutable -- <why>`")


# -- lock-order ---------------------------------------------------------------

@rule("lock-order", "error",
      "inconsistent lock acquisition order (ABBA deadlock shape)",
      path_filter=_THREADED_PATHS)
def _r_lock_order(ctx: FileContext) -> Iterator[Finding]:
    # edges: (outer, inner) -> the with node that witnessed inner-under-outer
    edges: Dict[Tuple[str, str], ast.With] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.With):
            continue
        outers = _with_locks(node)
        if not outers:
            continue
        for inner_node in _walk_no_nested_defs(node.body):
            if not isinstance(inner_node, ast.With):
                continue
            for inner in _with_locks(inner_node):
                for outer in outers:
                    if inner != outer:
                        edges.setdefault((outer, inner), inner_node)
    for (a, b), witness in sorted(edges.items(),
                                  key=lambda kv: kv[1].lineno):
        if (b, a) in edges and a < b:  # report each cycle once
            other = edges[(b, a)]
            if (ctx.waived("lock-order", witness)
                    or ctx.waived("lock-order", other)):
                continue
            yield _mk(
                ctx, "lock-order", "error", witness,
                f"lock order cycle: {a} -> {b} here but {b} -> {a} at "
                f"line {other.lineno} -- two threads taking the pair in "
                f"opposite orders deadlock",
                "pick one global acquisition order for this lock pair "
                "and restructure the later taker; a provably-single-"
                "threaded path can waive with "
                "`# kntpu-ok: lock-order -- <why>`")


# -- blocking-under-lock ------------------------------------------------------

# dotted names (exact) and attribute suffixes that can block indefinitely;
# `.join` is deliberately absent (str.join false positives dwarf the
# thread-join signal -- the watchdog joins with timeouts anyway)
_BLOCKING_EXACT = {
    "time.sleep", "select.select", "jax.device_get",
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.call", "torch.cuda.synchronize",
}
_BLOCKING_ATTRS = {
    "communicate", "recv", "readline", "block_until_ready", "wait",
    "acquire", "get_nowait_or_block", "fetch", "synchronize", "item",
}


@rule("blocking-under-lock", "warning",
      "indefinitely-blocking call while holding a lock",
      path_filter=_THREADED_PATHS)
def _r_blocking_under_lock(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.With):
            continue
        locks = _with_locks(node)
        if not locks:
            continue
        held = "/".join(sorted(locks))
        for inner in _walk_no_nested_defs(node.body):
            if not isinstance(inner, ast.Call):
                continue
            name = _dotted(inner.func)
            attr = (inner.func.attr
                    if isinstance(inner.func, ast.Attribute) else "")
            blocking = (name in _BLOCKING_EXACT
                        or attr in _BLOCKING_ATTRS)
            if not blocking:
                continue
            if ctx.waived("blocking-under-lock", inner):
                continue
            yield _mk(
                ctx, "blocking-under-lock", "warning", inner,
                f"{name or attr}() can block indefinitely while "
                f"holding {held}: every thread contending the lock "
                f"stalls for the duration",
                "move the blocking call outside the critical section "
                "(copy state under the lock, block after release), or "
                "waive a bounded hold with "
                "`# kntpu-ok: blocking-under-lock -- <why>`")
