"""Device-event attribution: a ``torch.profiler`` capture -> spans, scopes
and kernel libraries.

Counterpart of ``cuda_knearests_tpu/obs/attribution.py``, redesigned for
the Chrome trace ``torch.profiler`` writes.  ``obs/device.py`` captures
one window; this module is the pure-parsing half (it touches no device):

* :func:`load_chrome_trace` / :func:`chrome_events` -- read the capture.
* :func:`rebase` -- map the profiler's microsecond axis onto the span
  tracer's wall-clock axis through the capture-anchor annotation
  (``kntpu.capture:<id>``, a ``record_function`` whose host wall time the
  capturer recorded), and classify every event:

    - ``exec``   -- device work.  On a capture that saw CUDA activity: the
      GPU-side ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events, each
      carrying ``args.correlation``.  On a CPU-only capture: the top-level
      ``cpu_op`` events (no other op of their thread encloses them), on a
      lane stamped ``cpu:<thread>``.
    - ``launch`` -- a host-side ``cuda_runtime`` / ``cuda_driver`` call
      (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with the
      correlation id of the device work it issued.
    - ``scope``  -- a ``user_annotation`` named ``kntpu:*``
      (``utils/profiling.annotate``; never its ``gpu_user_annotation``
      mirror on the device lane).
    - ``op``     -- any other host ``cpu_op`` (names the PyTorch kernels).
    - ``anchor`` -- the capture window annotation itself.
    - ``other``  -- profiler plumbing (ignored).

* :data:`MODULE_REGISTRY` / :func:`register_executable` -- the port builds
  nothing per shape, so the registry's entries are the kernel libraries:
  ``ops/_build.load_all`` registers each library it builds or loads (with
  the ``nvcc`` seconds of a build), and :func:`library_of` resolves a
  captured kernel's demangled name to its library.
* :func:`attribute` -- mount each exec event into the host span timeline.
  A kernel runs asynchronously, often after the span that launched it has
  closed, so each GPU event is joined to its launch by correlation id and
  attributed at the launch's host timestamp: to the innermost host span
  and the innermost ``kntpu:*`` scope open at that instant.  Only events
  with no launch record (copies the allocator issues, say) fall back to
  their own midpoint.  Events no span covers come back ``unattributed``;
  the capture harness asserts there are none (its umbrella window span
  covers the window).
* :func:`decomposition` -- device ms by module (kernel library, else the
  PyTorch op that launched it), scope and span.
* :func:`mount` / :func:`write_spill` -- attributed events in the span
  event schema (``obs/spans.py``), so ``obs/export.py`` merges them into
  one host+device Perfetto timeline (device events ride a ``device:*``
  thread lane of the capturing process).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

from . import spans as _spans

#: Prefix of the capture-window anchor annotation (obs/device.py opens a
#: ``record_function(CAPTURE_PREFIX + capture_id)`` around the window and
#: records its host wall time: the clock join).
CAPTURE_PREFIX = "kntpu.capture:"

#: Prefix of the engine's named profiler scopes (``utils/profiling.annotate``
#: call sites: ``kntpu:adaptive-solve``, ``kntpu:mxu-select``, ...).
SCOPE_PREFIX = "kntpu:"

#: Safety margin (seconds) when window-filtering events: profiler event
#: close timestamps can trail the anchor's exit by scheduler noise.
WINDOW_EPS_S = 0.050

#: Lane of a CPU-only capture's exec events (``cpu:<thread>``).
CPU_LANE = "cpu"

_GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: Host calls that issue device work: in a complete capture each has a
#: kernel, copy or memset event with its correlation id.
DEVICE_WORK_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpy",
                     "cudaMemcpyAsync", "cudaMemset", "cudaMemsetAsync")


# -- kernel-library registry --------------------------------------------------

_REG_LOCK = threading.Lock()
#: library name -> {"module", "label", "compile_s", "flops",
#: "bytes_accessed"}: fed by ops/_build.load_all, read by attribution when
#: a captured kernel resolves to that library.
MODULE_REGISTRY: Dict[str, dict] = {}


def register_executable(module: Optional[str], label: str = "",
                        compile_s: Optional[float] = None,
                        flops: Optional[float] = None,
                        bytes_accessed: Optional[float] = None) -> None:
    """Record one kernel library's identity (and, where known, the
    ``nvcc`` seconds that built it and a cost census).  Keyed by the
    library name (``csrc/<module>.cu``)."""
    if not module:
        return
    with _REG_LOCK:
        ent = MODULE_REGISTRY.setdefault(str(module), {"module": str(module)})
        if label:
            ent["label"] = str(label)
        if compile_s is not None:
            ent["compile_s"] = round(float(compile_s), 6)
        if flops is not None:
            ent["flops"] = float(flops)
        if bytes_accessed is not None:
            ent["bytes_accessed"] = float(bytes_accessed)


def executable_info(module: Optional[str]) -> Optional[dict]:
    if not module:
        return None
    with _REG_LOCK:
        ent = MODULE_REGISTRY.get(module)
        return dict(ent) if ent is not None else None


# The package's kernels live in anonymous namespaces of csrc/*.cu; the
# demangled name is "void (anonymous namespace)::<name>[<T>](<args>)".
_KERNEL_NAME = re.compile(
    r"(?:void\s+)?\(anonymous namespace\)::(\w+)(?:<[^(]*>)?\(([^,)]*)")
_KERNEL_LIBRARY = {"supercell_topk_kernel": "supercell_topk",
                   "blocked_topk_kernel": "blocked_topk",
                   "fold_kernel": "mxu_select_split",
                   "direct_kernel": "mxu_select_split"}


def library_of(kernel_name: str) -> Optional[str]:
    """The ``csrc`` library a captured kernel's demangled name belongs to,
    or None for a kernel that is not the package's.  The selections'
    ``select_kernel`` and ``prep_kernel`` exist in several libraries and
    resolve by their argument types: bf16 operands for
    ``mxu_select_bf16``, a uint64 pool for ``mxu_select_split``, else
    ``mxu_select``."""
    m = _KERNEL_NAME.match(kernel_name)
    if m is None:
        return None
    name, first_arg = m.group(1), m.group(2)
    if name in _KERNEL_LIBRARY:
        return _KERNEL_LIBRARY[name]
    if name == "select_kernel":
        if "bfloat16" in first_arg:
            return "mxu_select_bf16"
        if "unsigned long" in first_arg:
            return "mxu_select_split"
        return "mxu_select"
    if name == "prep_kernel":
        return "mxu_select_bf16" if "bfloat16" in kernel_name \
            else "mxu_select"
    return None


# -- capture parsing ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    """One captured profiler event, rebased onto the span wall axis.
    ``module`` names an exec event's owner (a kernel library, the PyTorch
    op that launched it, or the op itself on a CPU-only capture);
    ``correlation`` joins GPU work to its host launch."""

    name: str
    t0: float          # wall seconds (same axis as span events' ``t0``)
    dur_ms: float
    pid: int
    tid: str
    kind: str          # 'exec' | 'launch' | 'scope' | 'op' | 'anchor' | 'other'
    module: Optional[str] = None
    correlation: Optional[int] = None

    @property
    def t1(self) -> float:
        return self.t0 + self.dur_ms / 1e3

    @property
    def midpoint(self) -> float:
        return self.t0 + self.dur_ms / 2e3


def load_chrome_trace(path: str) -> dict:
    """A capture's Chrome trace-event document (gzipped or plain JSON)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:  # type: ignore[operator]
        return json.loads(f.read().decode("utf-8"))


def chrome_events(doc: dict) -> List[dict]:
    """The complete ('X') events of a Chrome trace document."""
    return [ev for ev in doc.get("traceEvents", [])
            if isinstance(ev, dict) and ev.get("ph") == "X"]


def saw_device_activity(raw_events: List[dict]) -> bool:
    """True when the capture holds GPU-side kernel, copy or memset
    events (CUDA activity was recorded)."""
    return any(raw.get("cat") in _GPU_CATS for raw in raw_events)


def _pid(raw: dict) -> int:
    try:
        return int(raw.get("pid", 0))
    except (TypeError, ValueError):  # the profiler's own lanes ("Spans")
        return -1


def _correlation(raw: dict) -> Optional[int]:
    c = (raw.get("args") or {}).get("correlation")
    return int(c) if isinstance(c, (int, float)) else None


def _top_level_ops(raw_events: List[dict]) -> set:
    """Indices of the ``cpu_op`` events no other op of their (pid, tid)
    encloses."""
    lanes: Dict[tuple, list] = {}
    for i, raw in enumerate(raw_events):
        if raw.get("cat") == "cpu_op":
            lanes.setdefault((raw.get("pid"), raw.get("tid")), []).append(i)
    top = set()
    for idx in lanes.values():
        idx.sort(key=lambda i: (float(raw_events[i].get("ts", 0.0)),
                                -float(raw_events[i].get("dur", 0.0))))
        end = float("-inf")
        for i in idx:
            ts = float(raw_events[i].get("ts", 0.0))
            if ts >= end:
                top.add(i)
                end = ts + float(raw_events[i].get("dur", 0.0))
    return top


def _classify(raw: dict, gpu: bool, top_level: bool) -> str:
    """An event's kind (see the module docstring); ``gpu``: the capture
    saw CUDA activity; ``top_level``: a cpu_op no other op encloses."""
    name, cat = str(raw.get("name", "")), raw.get("cat")
    if name.startswith(CAPTURE_PREFIX):
        return "anchor"
    if cat in _GPU_CATS:
        return "exec"
    if cat in _LAUNCH_CATS and _correlation(raw) is not None:
        return "launch"
    if name.startswith(SCOPE_PREFIX) and cat != "gpu_user_annotation":
        return "scope"
    if cat == "cpu_op":
        return "exec" if top_level and not gpu else "op"
    return "other"


def rebase(raw_events: List[dict], anchor_wall: float,
           capture_id: str) -> Tuple[List[DeviceEvent], int]:
    """(window events on the wall axis, count dropped as outside-window).

    The anchor annotation ``kntpu.capture:<capture_id>`` appears in the
    capture at its own profiler timestamp; the capturer recorded the host
    wall clock at the instant it opened that annotation, and the offset
    joins the axes.  Exec, launch and scope events whose midpoint -- a GPU
    event's launch's, where it has one -- falls outside the anchor
    interval (work from before the window that the session still saw) are
    dropped and counted, never attributed.  A GPU kernel outside the
    package's libraries takes as its module the innermost host op that
    launched it (``torch:<op>``)."""
    anchor_name = CAPTURE_PREFIX + capture_id
    # the host-side annotation: its device-lane mirror runs on GPU time
    anchor = next((ev for ev in raw_events
                   if str(ev.get("name", "")) == anchor_name
                   and ev.get("cat") != "gpu_user_annotation"), None)
    if anchor is None:
        raise ValueError(
            f"capture anchor {anchor_name!r} not found in the trace "
            f"({len(raw_events)} events): the profiler did not record "
            f"the window annotation")
    gpu = saw_device_activity(raw_events)
    top = _top_level_ops(raw_events) if not gpu else set()
    a_ts = float(anchor["ts"])
    a_dur_s = float(anchor.get("dur", 0.0)) / 1e6
    lo = anchor_wall - WINDOW_EPS_S
    hi = anchor_wall + a_dur_s + WINDOW_EPS_S
    events: List[DeviceEvent] = []
    for i, raw in enumerate(raw_events):
        kind = _classify(raw, gpu, i in top)
        name = str(raw.get("name", ""))
        tid = str(raw.get("tid", ""))
        module = None
        if kind == "exec":
            if raw.get("cat") in _GPU_CATS:
                module = library_of(name)
                if module is None and raw.get("cat") != "kernel":
                    module = str(raw["cat"])
            else:
                module, tid = name, f"{CPU_LANE}:{tid}"
        events.append(DeviceEvent(
            name=name,
            t0=anchor_wall + (float(raw.get("ts", 0.0)) - a_ts) / 1e6,
            dur_ms=float(raw.get("dur", 0.0)) / 1e3, pid=_pid(raw), tid=tid,
            kind=kind, module=module, correlation=_correlation(raw)))
    # a GPU event is in the window when its launch is: the device's clock,
    # converted to the host's, can drift from it over a long process
    launched = {ev.correlation: ev.midpoint for ev in events
                if ev.kind == "launch"}
    out: List[DeviceEvent] = []
    outside = 0
    for ev in events:
        at = (launched.get(ev.correlation, ev.midpoint)
              if ev.kind == "exec" else ev.midpoint)
        if ev.kind in ("exec", "scope", "launch") and not lo <= at <= hi:
            outside += 1
            continue
        out.append(ev)
    return _name_torch_kernels(out), outside


def _name_torch_kernels(events: List[DeviceEvent]) -> List[DeviceEvent]:
    """Give each GPU kernel outside the package's libraries the innermost
    host op enclosing its launch as its module (``torch:<op>``, or
    ``torch`` when no op encloses it)."""
    launches = {ev.correlation: ev for ev in events if ev.kind == "launch"}
    ops = [ev for ev in events if ev.kind == "op"]
    out = []
    for ev in events:
        if ev.kind == "exec" and ev.module is None:
            launch = launches.get(ev.correlation)
            enclosing = [] if launch is None else [
                op for op in ops if op.tid == launch.tid
                and op.t0 <= launch.midpoint <= op.t1]
            ev = dataclasses.replace(ev, module=(
                "torch:" + min(enclosing, key=lambda op: op.dur_ms).name
                if enclosing else "torch"))
        out.append(ev)
    return out


def unmatched_launches(events: List[DeviceEvent]) -> List[DeviceEvent]:
    """The window's launches of device work (:data:`DEVICE_WORK_CALLS`)
    whose kernel, copy or memset the capture lacks: events the profiler
    dropped.  Empty for a complete capture."""
    done = {e.correlation for e in events if e.kind == "exec"}
    return [e for e in events if e.kind == "launch"
            and e.name in DEVICE_WORK_CALLS and e.correlation not in done]


# -- attribution --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Attribution:
    """One exec event mounted into the host timeline.  ``joined`` says
    how: 'correlation' (at its launch's host timestamp) or 'midpoint'
    (its own; no launch record, or a CPU-only capture's host op).
    ``lag_ms``: a joined event's start less its launch's, on the rebased
    axis -- queueing, plus any offset of the device's clock from the
    host's."""

    event: DeviceEvent
    span_name: str
    span_depth: int
    trace_id: Optional[str]
    scope: Optional[str]          # innermost kntpu:* named region
    signature: Optional[dict]     # MODULE_REGISTRY entry (or None)
    joined: str = "midpoint"
    lag_ms: Optional[float] = None


def attribute(events: List[DeviceEvent], host_events: List[dict]
              ) -> Tuple[List[Attribution], List[DeviceEvent]]:
    """Mount every exec event into the host span timeline.

    Host spans are finished span-schema event dicts (an obs/spans
    Collector's output).  Each exec event is placed at its launch's host
    timestamp (the midpoint of the ``cuda_runtime`` call with its
    correlation id), else at its own midpoint, and lands in the innermost
    host span open there -- deepest nesting level, then latest start,
    which is unique because same-thread spans strictly nest -- and the
    innermost ``kntpu:*`` scope.  Returns (attributed, unattributed); the
    capture harness asserts the second list is EMPTY."""
    spans = [e for e in host_events
             if e.get("kind") == "span"
             and isinstance(e.get("t0"), (int, float))]
    scopes = [e for e in events if e.kind == "scope"]
    launches = {e.correlation: e for e in events if e.kind == "launch"}
    attributed: List[Attribution] = []
    unattributed: List[DeviceEvent] = []
    for ev in events:
        if ev.kind != "exec":
            continue
        launch = (launches.get(ev.correlation)
                  if ev.correlation is not None else None)
        at = launch.midpoint if launch is not None else ev.midpoint
        cands = [s for s in spans
                 if s["t0"] <= at <= s["t0"] + s["dur_ms"] / 1e3]
        if not cands:
            unattributed.append(ev)
            continue
        best = max(cands, key=lambda s: (s["depth"], s["t0"]))
        enclosing = [sc for sc in scopes if sc.t0 <= at <= sc.t1]
        scope = (min(enclosing, key=lambda sc: sc.dur_ms).name
                 if enclosing else None)
        attributed.append(Attribution(
            event=ev, span_name=str(best["name"]),
            span_depth=int(best["depth"]),
            trace_id=best.get("trace_id"), scope=scope,
            signature=executable_info(ev.module),
            joined="correlation" if launch is not None else "midpoint",
            lag_ms=(None if launch is None
                    else (ev.t0 - launch.t0) * 1e3)))
    return attributed, unattributed


def _top(acc: Dict[str, float], cap: int) -> Dict[str, float]:
    """Largest ``cap`` buckets (ms, rounded), the tail folded into
    ``"...other"``: rows stay bounded however many kernels a solve runs."""
    items = sorted(acc.items(), key=lambda kv: -kv[1])
    out = {k: round(v, 4) for k, v in items[:cap]}
    rest = sum(v for _, v in items[cap:])
    if rest > 0:
        out["...other"] = round(rest, 4)
    return out


def decomposition(attributed: List[Attribution],
                  unattributed: List[DeviceEvent],
                  cap: int = 12,
                  events: Optional[List[DeviceEvent]] = None) -> dict:
    """The ``device_time_decomposition`` stamp: measured device ms by
    module (kernel library or launching op), named scope and host span,
    how many events joined by correlation and the range of their
    launch-to-start lag, and per registered library its
    build provenance, executions (its events in the window) and, where
    the registry holds a cost census, achieved GFLOP/s.  ``events`` is
    accepted for the reference's signature; each exec event here is one
    execution already."""
    by_module: Dict[str, float] = {}
    by_scope: Dict[str, float] = {}
    by_span: Dict[str, float] = {}
    runs: Dict[str, int] = {}
    modules: Dict[str, dict] = {}
    total = 0.0
    for a in attributed:
        ms = a.event.dur_ms
        total += ms
        mod = a.event.module or "<unknown-module>"
        by_module[mod] = by_module.get(mod, 0.0) + ms
        runs[mod] = runs.get(mod, 0) + 1
        by_scope[a.scope or "<no-scope>"] = \
            by_scope.get(a.scope or "<no-scope>", 0.0) + ms
        by_span[a.span_name] = by_span.get(a.span_name, 0.0) + ms
        if a.signature and mod not in modules:
            modules[mod] = {k: a.signature[k] for k in
                            ("label", "compile_s", "flops",
                             "bytes_accessed") if k in a.signature}
    for mod, info in modules.items():
        ms = by_module.get(mod, 0.0)
        info["executions"] = runs.get(mod, 0)
        if ms > 0 and isinstance(info.get("flops"), (int, float)):
            info["achieved_gflops"] = round(
                info["flops"] * info["executions"] / (ms / 1e3) / 1e9, 3)
    lags = [a.lag_ms for a in attributed if a.lag_ms is not None]
    return {
        "device_total_ms": round(total, 4),
        "events": len(attributed),
        "unattributed": len(unattributed),
        "joined_by_correlation": len(lags),
        **({"launch_to_start_ms": {"min": round(min(lags), 4),
                                   "max": round(max(lags), 4)}}
           if lags else {}),
        "by_module": _top(by_module, cap),
        "by_scope": _top(by_scope, cap),
        "by_span": _top(by_span, cap),
        **({"modules": modules} if modules else {}),
    }


# -- mounting into the merged timeline ---------------------------------------

def mount(attributed: List[Attribution], job: str = "device") -> List[dict]:
    """Attributed device events as span-schema event dicts: one child
    span per exec event, parented under the host span it attributed to,
    on a ``device:*`` thread lane of THIS process -- obs/export.py merges
    them into the same Perfetto timeline as the host spans with zero
    special-casing (they validate against the same schema)."""
    out = []
    for a in attributed:
        ev = a.event
        attrs: dict = {"joined": a.joined}
        if ev.module:
            attrs["module"] = ev.module
        if ev.correlation is not None:
            attrs["correlation"] = ev.correlation
        if a.scope:
            attrs["scope"] = a.scope
        if a.signature and a.signature.get("label"):
            attrs["signature"] = a.signature["label"]
        out.append({"v": _spans.SCHEMA, "kind": "span", "name": ev.name,
                    "t0": ev.t0, "dur_ms": round(ev.dur_ms, 6),
                    "depth": a.span_depth + 1, "parent": a.span_name,
                    "pid": os.getpid(), "job": job,
                    "tid": f"device:{ev.tid}", "trace_id": a.trace_id,
                    "attrs": attrs})
    return out


def write_spill(events: List[dict], path: str) -> str:
    """Append span-schema events to a ``trace_*.jsonl`` spill (the shape
    obs/export.py globs), creating directories as needed."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path
