"""Hazard lint rules of the port (engine 2's pluggable registry).

Counterpart of ``cuda_knearests_tpu/analysis/rules.py``.  Each rule is a
pure function over one parsed file (:class:`FileContext`) yielding
:class:`~.findings.Finding` records.  Registration is by decorator, so a
new hazard class is one function + one decorator -- no driver changes.

Waivers are *in-source and reasoned*, never positional: a line carrying
``# kntpu-ok: <rule-id> -- <why>`` is exempt from exactly that rule, and
broad-except keeps the ``# noqa: BLE001 -- <why>`` convention.  A waiver
without the rule id or without its reason does not count -- the marker is
the audit trail.

The framework-neutral rules (``wide-dtype``, ``broad-except``,
``bare-valueerror``, ``bare-timing``) keep the reference's logic, their
path scopes re-rooted at ``cuda_knearests_tpu_torch/``.  The three rules
the reference aims at JAX constructs keep their ids and are aimed at
their torch counterparts:

* ``tracer-leak`` -- host-forcing calls (``np.*``, ``.item()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float()``/``int()``/
  ``bool()`` of a torch expression) lexically inside a function
  decorated ``torch.compile`` or ``torch.jit.script``, where each one is
  a graph break or a compile error.  Helpers only *called* from such code
  are invisible to static analysis: the rule is sound on decorated
  functions and silent elsewhere, never guessing.
* ``host-sync-loop`` -- a device readback per iteration of a host loop:
  ``.item()``, ``.cpu()`` / ``.to("cpu")`` (and the ``.numpy()`` /
  ``.tolist()`` chains on them), ``torch.cuda.synchronize``,
  ``.synchronize()``, ``dispatch.fetch``, and ``np.asarray(x)`` /
  ``np.array(x)`` of a bare name or attribute (the reference's heuristic:
  the argument may be a tensor).  ``.numpy()`` and ``.tolist()`` alone
  also act on numpy arrays, so only the forms that are provably torch
  fire.
* ``jnp-in-loop`` -- a torch constructor (``torch.tensor``,
  ``as_tensor``, ``zeros``, ``ones``, ``full``, ``empty``, ``arange``,
  ``*_like``) with a ``device=`` argument inside a host loop: one device
  allocation and upload per iteration.

Statement loops (``for``/``while``) outside the compiled functions run
per iteration on the host; comprehensions are ignored.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from .findings import Finding

# -- waiver markers -----------------------------------------------------------

# both marker forms REQUIRE a non-empty rationale after `--`: an unreasoned
# marker is not a waiver, it is a finding (the reason is the audit trail)
_WAIVER_RE = re.compile(r"#\s*kntpu-ok:\s*([a-z0-9-]+)\s*--\s*\S")
_BLE_RE = re.compile(r"#\s*noqa:\s*BLE001\s*--\s*\S")

# The package the path scopes below are rooted at.
_PKG = "cuda_knearests_tpu_torch/"


@dataclasses.dataclass
class FileContext:
    """One parsed source file plus the derived indexes rules share."""

    path: str            # repo-relative path (what findings report)
    tree: ast.Module
    lines: List[str]     # raw source lines (1-based access via line())
    jit_spans: List[Tuple[int, int]]   # (start, end) lines of compiled defs
    waivers: Dict[int, Set[str]]       # line -> waived rule ids
    ble_lines: Set[int]                # lines carrying `# noqa: BLE001`

    def line(self, n: int) -> str:
        return self.lines[n - 1] if 0 < n <= len(self.lines) else ""

    def in_jit(self, node: ast.AST) -> bool:
        ln = getattr(node, "lineno", 0)
        return any(a <= ln <= b for a, b in self.jit_spans)

    def waived(self, rule: str, node: ast.AST) -> bool:
        ln = getattr(node, "lineno", 0)
        return rule in self.waivers.get(ln, set())


def _is_compiler(node: ast.AST) -> bool:
    """`torch.compile` / `torch.jit.script` / `torch.jit.trace` (or
    `jit.script` / `jit.trace` from ``from torch import jit``) as an
    expression."""
    name = _dotted(node)
    return name in ("torch.compile", "torch.jit.script", "torch.jit.trace",
                    "jit.script", "jit.trace")


def _is_jit_decorator(dec: ast.AST) -> bool:
    if _is_compiler(dec):
        return True
    if isinstance(dec, ast.Call):
        # torch.compile(mode=...) and functools.partial(torch.compile, ...)
        if _is_compiler(dec.func):
            return True
        f = dec.func
        if (isinstance(f, ast.Attribute) and f.attr == "partial"
                and dec.args and _is_compiler(dec.args[0])):
            return True
    return False


def build_context(path: str, source: str) -> FileContext:
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    jit_spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_jit_decorator(d) for d in node.decorator_list):
                jit_spans.append((node.lineno, node.end_lineno or node.lineno))
    waivers: Dict[int, Set[str]] = {}
    ble_lines: Set[int] = set()
    for i, text in enumerate(lines, start=1):
        for m in _WAIVER_RE.finditer(text):
            waivers.setdefault(i, set()).add(m.group(1))
        if _BLE_RE.search(text):
            ble_lines.add(i)
    return FileContext(path=path, tree=tree, lines=lines, jit_spans=jit_spans,
                       waivers=waivers, ble_lines=ble_lines)


# -- registry -----------------------------------------------------------------

RuleFn = Callable[[FileContext], Iterator[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    severity: str
    summary: str
    check: RuleFn
    # path substrings the rule applies to (None = everywhere in scope);
    # measurement scripts legitimately sync/allocate in loops, so the
    # hot-loop rules scope to the package
    path_filter: Optional[Tuple[str, ...]] = None

    def applies_to(self, path: str) -> bool:
        if self.path_filter is None:
            return True
        return any(s in path for s in self.path_filter)


_REGISTRY: Dict[str, Rule] = {}


def rule(rule_id: str, severity: str, summary: str,
         path_filter: Optional[Tuple[str, ...]] = None):
    def deco(fn: RuleFn) -> RuleFn:
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate lint rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(rule_id=rule_id, severity=severity,
                                  summary=summary, check=fn,
                                  path_filter=path_filter)
        return fn
    return deco


def all_rules() -> List[Rule]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def _mk(ctx: FileContext, r_id: str, severity: str, node: ast.AST,
        message: str, hint: str) -> Finding:
    ln = getattr(node, "lineno", 0)
    return Finding(rule=r_id, severity=severity, path=ctx.path, line=ln,
                   message=message, hint=hint,
                   subject=ctx.line(ln).strip())


def _dotted(node: ast.AST) -> str:
    """'np.float64'-style dotted name for an Attribute/Name chain ('' if
    the expression is not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _loops_outside_jit(ctx: FileContext) -> Iterator[ast.AST]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.For, ast.While)) and not ctx.in_jit(node):
            yield node


def _calls_in_loop(loop: ast.AST) -> Iterator[ast.Call]:
    """Calls executed per iteration: the loop body/orelse, excluding nested
    function definitions (defining a closure per iteration is cheap; the
    hazard is *calling* per iteration)."""
    stack = list(getattr(loop, "body", [])) + list(getattr(loop, "orelse", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _method(call: ast.Call) -> str:
    """The method name of an ``x.m(...)`` call ('' otherwise)."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def _is_to_cpu(call: ast.Call) -> bool:
    """``x.cpu()`` or ``x.to("cpu")`` / ``x.to(device="cpu")``."""
    m = _method(call)
    if m == "cpu":
        return True
    if m != "to":
        return False
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    return bool(args) and isinstance(args[0], ast.Constant) \
        and args[0].value == "cpu"


def _torch_readbacks(calls: List[ast.Call]) -> Iterator[Tuple[ast.Call, str]]:
    """(call, name) for every provably-torch host readback among
    ``calls``: ``.item()``, ``.cpu()`` / ``.to("cpu")`` and the
    ``.numpy()`` / ``.tolist()`` chains on them (reported once, at the
    outer call), ``torch.cuda.synchronize`` and ``.synchronize()``.
    ``.numpy()`` / ``.tolist()`` on anything else may be numpy and are
    not reported."""
    inner: Set[int] = set()
    for call in calls:
        if _method(call) in ("numpy", "tolist") \
                and isinstance(call.func.value, ast.Call) \
                and _is_to_cpu(call.func.value):
            inner.add(id(call.func.value))
    for call in calls:
        if id(call) in inner:
            continue
        m = _method(call)
        name = _dotted(call.func)
        if m in ("numpy", "tolist"):
            if isinstance(call.func.value, ast.Call) \
                    and _is_to_cpu(call.func.value):
                yield call, f".{_method(call.func.value)}().{m}"
        elif _is_to_cpu(call):
            yield call, f".{m}"
        elif m == "item" and not call.args:
            yield call, ".item"
        elif name == "torch.cuda.synchronize" or m == "synchronize":
            yield call, name or ".synchronize"


# -- rules --------------------------------------------------------------------

@rule("tracer-leak", "error",
      "host-forcing call (np.*/.item()/.cpu()/float()) inside compiled code")
def _r_tracer_leak(ctx: FileContext) -> Iterator[Finding]:
    """Inside a function decorated ``torch.compile`` / ``torch.jit.script``,
    ``np.*`` calls, the readbacks (``.item()``, ``.cpu()``, ``.numpy()``,
    ``.tolist()``) and the Python scalar builtins applied to a torch
    expression force a concrete value out of the graph: a graph break (a
    host sync and a recompile key per value) under ``torch.compile``, a
    compile error under ``torch.jit.script``.  Host values are resolved
    BEFORE the compiled boundary in this package, so any of them inside a
    compiled def is suspect.  The package compiles no function today: the
    rule is sound and silent."""
    np_exempt = {"np.dtype", "np.float32", "np.int32", "np.bool_"}
    calls = [n for n in ast.walk(ctx.tree)
             if isinstance(n, ast.Call) and ctx.in_jit(n)]
    forced = {id(c): name for c, name in _torch_readbacks(calls)}
    for node in calls:
        if ctx.waived("tracer-leak", node):
            continue
        name = _dotted(node.func)
        if id(node) in forced:
            yield _mk(ctx, "tracer-leak", "error", node,
                      f"{forced[id(node)]}() inside a compiled function "
                      f"forces a device value to the host (a graph break)",
                      "keep the value on the device, or read it back "
                      "through dispatch.fetch outside the compiled function")
        elif name.startswith("np.") and name not in np_exempt:
            yield _mk(ctx, "tracer-leak", "error", node,
                      f"{name}() inside a compiled function operates on "
                      f"host values, not graph tensors",
                      "use the torch twin, or hoist the host computation "
                      "outside the compiled boundary")
        elif name in ("float", "int", "bool") and node.args:
            # len()/shape arithmetic is static and fine; a direct cast of
            # a torch expression is the leak
            if "torch" in ast.dump(node.args[0]):
                yield _mk(ctx, "tracer-leak", "error", node,
                          f"{name}() applied to a torch expression forces "
                          f"a device sync (a graph break)",
                          "keep the value on the device, or read it back "
                          "through dispatch.fetch outside the compiled "
                          "function")


@rule("wide-dtype", "warning",
      "np.float64/np.int64 widening without an intent marker",
      path_filter=(_PKG + "ops/", _PKG + "parallel/", _PKG + "utils/",
                   _PKG + "api.py", _PKG + "cluster/", _PKG + "oracle.py",
                   _PKG + "mxu/", _PKG + "pod/"))
def _r_wide_dtype(ctx: FileContext) -> Iterator[Finding]:
    """f64/i64 on the host is silent 2x width -- fine when chosen (margin
    certificates accumulate in f64 deliberately; cell linearizations need
    i64 headroom), a wasteful accident otherwise, and a surprise when such
    an array is staged to a device that computes f32/i32.  Every widening
    must carry a reasoned waiver so the intent is auditable."""
    wide = {"np.float64", "np.int64"}
    for node in ast.walk(ctx.tree):
        name = ""
        if isinstance(node, ast.Attribute):
            name = _dotted(node)
        if name in wide and not ctx.waived("wide-dtype", node):
            yield _mk(ctx, "wide-dtype", "warning", node,
                      f"{name} widens beyond the engine's f32/i32 device "
                      f"dtypes",
                      "downcast if the width is accidental, or mark the "
                      "line `# kntpu-ok: wide-dtype -- <why>` if the host-"
                      "side precision/headroom is intentional")


def _maybe_device_arg(call: ast.Call) -> bool:
    """Heuristic for np.asarray/np.array in a loop: a bare name/attribute
    argument may be a device tensor (the implicit-sync hazard); literals
    and nested host calls are not, and an explicit readback inside the
    argument already makes the sync visible (and is flagged itself)."""
    if not call.args:
        return False
    arg = call.args[0]
    dump = ast.dump(arg)
    if "'cpu'" in dump or "'fetch'" in dump:
        return False  # explicit readback: its own finding covers it
    return isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript))


@rule("host-sync-loop", "warning",
      "host sync (.item()/.cpu()/synchronize/fetch/np.asarray) in a host "
      "loop",
      path_filter=(_PKG,))
def _r_host_sync_loop(ctx: FileContext) -> Iterator[Finding]:
    """A device readback inside a per-class/per-chip/per-supercell host
    loop serializes the loop on device round trips.  Loops that MUST read
    back per iteration (bounded per-class diagnostics) carry a reasoned
    waiver."""
    for loop in _loops_outside_jit(ctx):
        calls = list(_calls_in_loop(loop))
        forced = {id(c): name for c, name in _torch_readbacks(calls)}
        for call in calls:
            if ctx.waived("host-sync-loop", call):
                continue
            name = _dotted(call.func)
            if id(call) in forced:
                yield _mk(ctx, "host-sync-loop", "warning", call,
                          f"{forced[id(call)]}() inside a host loop is a "
                          f"device round trip per iteration",
                          "hoist the readback out of the loop (one batched "
                          "dispatch.fetch), or waive with "
                          "`# kntpu-ok: host-sync-loop -- <why>`")
            elif name in ("dispatch.fetch", "_dispatch.fetch"):
                yield _mk(ctx, "host-sync-loop", "warning", call,
                          f"{name}() inside a host loop is one counted "
                          f"host round trip per iteration",
                          "batch the tensors of every iteration into one "
                          "fetch after the loop, or waive with "
                          "`# kntpu-ok: host-sync-loop -- <why>`")
            elif name in ("np.asarray", "np.array") \
                    and _maybe_device_arg(call):
                yield _mk(ctx, "host-sync-loop", "warning", call,
                          f"{name}() inside a host loop is a device round "
                          f"trip per iteration when its argument is a "
                          f"CUDA tensor",
                          "hoist the readback out of the loop (one batched "
                          "dispatch.fetch), or waive with "
                          "`# kntpu-ok: host-sync-loop -- <why>`")


@rule("broad-except", "error",
      "broad `except Exception` without a `# noqa: BLE001` rationale")
def _r_broad_except(ctx: FileContext) -> Iterator[Finding]:
    """The failure taxonomy (utils/memory.py) exists so fault policy keys
    on typed kinds, not swallowed strings; an unmarked broad except hides
    faults from it.  The marker convention:
    `except Exception:  # noqa: BLE001 -- <why swallowing is safe>`."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        name = _dotted(node.type) if node.type is not None else ""
        broad = node.type is None or name in ("Exception", "BaseException")
        if not broad:
            continue
        if node.lineno in ctx.ble_lines or ctx.waived("broad-except", node):
            continue
        # catching broadly to RE-RAISE (wrapped/classified) is the taxonomy
        # pattern itself (utils/memory.wrap_device_error), not a swallow
        if any(isinstance(n, ast.Raise) for n in ast.walk(node)):
            continue
        what = "bare except:" if node.type is None else f"except {name}:"
        yield _mk(ctx, "broad-except", "error", node,
                  f"{what} without a taxonomy marker swallows faults the "
                  f"supervisor's retry/quarantine policy keys on",
                  "narrow to the exception types the site can actually "
                  "handle, or append `# noqa: BLE001 -- <why swallowing "
                  "is safe>` (utils/watchdog.py convention)")


@rule("bare-valueerror", "error",
      "bare ValueError raise on an input-validation path (use the typed "
      "input-contract taxonomy)",
      path_filter=(_PKG + "io.py", _PKG + "api.py", _PKG + "parallel/",
                   _PKG + "serve/", _PKG + "cluster/", _PKG + "mxu/",
                   _PKG + "pod/"))
def _r_bare_valueerror(ctx: FileContext) -> Iterator[Finding]:
    """The input front door (io.validate_or_raise) exists so that illegal
    input is refused with the TYPED taxonomy (utils/memory.py
    InputContractError subclasses, kind='invalid-input') that the CLI's
    rc-5 path, the supervisor's FailureRecord, and classify_fault_text all
    key on.  A bare ``raise ValueError(...)`` on these paths silently
    opts the refusal out of all three.  Raises that are genuinely not
    input validation (internal invariants, runtime topology contracts)
    carry a reasoned ``# kntpu-ok: bare-valueerror -- <why>`` waiver."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Raise) and node.exc is not None):
            continue
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        if _dotted(exc) != "ValueError":
            continue
        if ctx.waived("bare-valueerror", node):
            continue
        yield _mk(ctx, "bare-valueerror", "error", node,
                  "bare ValueError on an input-validation path bypasses "
                  "the typed input-contract taxonomy (no kind stamp, no "
                  "rc-5 mapping, no 'invalid-input' classification)",
                  "raise the matching utils.memory InputContractError "
                  "subclass (InvalidShapeError/NonFiniteInputError/"
                  "InvalidKError/...), or waive a non-input raise with "
                  "`# kntpu-ok: bare-valueerror -- <why>`")


@rule("bare-timing", "error",
      "bare time.time()/perf_counter() timing in serve/runtime (use "
      "obs.spans / utils.stopwatch so timing stays observable)",
      path_filter=(_PKG + "serve/", _PKG + "runtime/"))
def _r_bare_timing(ctx: FileContext) -> Iterator[Finding]:
    """The obs layer exists so every serving/runtime timing is a span:
    named, attributed, decomposable, exportable.  A bare ``time.time()`` /
    ``perf_counter()`` stopwatch on these paths re-fragments that
    accounting -- the measurement exists but no trace, histogram, or
    flight-recorder ring ever sees it.  ``time.monotonic`` (the
    injected-clock default) and ``time.sleep`` stay legal: they drive
    event loops, they don't measure.  Genuinely out-of-band timing carries
    a reasoned ``# kntpu-ok: bare-timing -- <why>`` waiver."""
    bad = {"time.time", "time.perf_counter", "time.perf_counter_ns",
           "perf_counter", "perf_counter_ns"}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name not in bad or ctx.waived("bare-timing", node):
            continue
        yield _mk(ctx, "bare-timing", "error", node,
                  f"{name}() on a serve/runtime path times outside the "
                  f"obs layer: no span, no histogram, no flight record",
                  "time the region with obs.spans.span(...) (or "
                  "obs.spans.now() for raw timestamps / utils.stopwatch "
                  "for phase timers), or waive with "
                  "`# kntpu-ok: bare-timing -- <why>`")


_TORCH_CTORS = {"tensor", "as_tensor", "zeros", "ones", "full", "empty",
                "arange", "eye", "linspace", "zeros_like", "ones_like",
                "full_like", "empty_like"}


@rule("jnp-in-loop", "warning",
      "torch device-tensor construction inside a host loop",
      path_filter=(_PKG,))
def _r_jnp_in_loop(ctx: FileContext) -> Iterator[Finding]:
    """Each torch constructor with a ``device=`` argument allocates a
    device buffer (and uploads, for ``tensor`` / ``as_tensor``) -- per
    host-loop iteration that is a launch and allocation storm.  Bounded
    prepare-time loops carry reasoned waivers; steady-state paths must
    batch."""
    for loop in _loops_outside_jit(ctx):
        for call in _calls_in_loop(loop):
            if ctx.waived("jnp-in-loop", call):
                continue
            name = _dotted(call.func)
            mod, _, attr = name.rpartition(".")
            if mod == "torch" and attr in _TORCH_CTORS \
                    and any(kw.arg == "device" for kw in call.keywords):
                yield _mk(ctx, "jnp-in-loop", "warning", call,
                          f"{name}(..., device=...) inside a host loop "
                          f"allocates one device buffer per iteration",
                          "build one batched tensor outside the loop, or "
                          "waive a bounded prepare-time loop with "
                          "`# kntpu-ok: jnp-in-loop -- <why>`")
