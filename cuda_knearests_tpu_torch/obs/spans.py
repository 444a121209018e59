"""Structured span tracer: one event schema for every timing of the engine.

Counterpart of ``cuda_knearests_tpu/obs/spans.py``, the whole module.

* :func:`span` -- a nested, attributed timing region with a stable event
  schema (:data:`SCHEMA`): name, wall-anchored t0, dur_ms, nesting depth and
  parent, (pid, process job tag), thread, optional ``trace_id``, attrs.
* Near-zero cost when disabled: tracing is off unless a sink is registered
  (or the caller forces a span for its own timing).  The disabled path
  allocates nothing -- ``span()`` returns one shared no-op singleton.
* Sinks are plain callables fed one finished-event dict each: the
  in-memory :class:`Collector` and the :class:`JsonlSink` trace spill.  A
  sink that raises is ignored: observability never takes the engine down.
* Every event carries ``pid`` and the process ``job`` tag
  (:func:`set_process_tag`), and timestamps are anchored to the wall
  clock, so spills of several processes merge onto one timeline.
* ``trace_id`` rides a request end to end: the serving wire carries it,
  the daemon stamps it on its queue and execute spans, and the reply
  echoes it.

Pure Python: nothing here touches a device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

#: Event schema version (the ``v`` key of every event); bump on any key
#: change -- consumers of the spilled events key on it.
SCHEMA = 1

# Wall anchor: perf_counter gives monotonic durations, the anchor maps its
# axis onto wall-clock seconds so events from different processes land on
# one mergeable timeline.
_ANCHOR_WALL = time.time()
_ANCHOR_PERF = time.perf_counter()

_lock = threading.Lock()
_sinks: List[Callable[[dict], None]] = []   # empty == tracing disabled
_tls = threading.local()
_proc_tag: Dict[str, Any] = {"job": ""}


def now() -> float:
    """The tracer's clock (``perf_counter``): the ONE sanctioned timing
    source of the serving code."""
    return time.perf_counter()


def wall(t_perf: float) -> float:
    """Wall-clock seconds of a :func:`now` timestamp (the cross-process
    merge axis)."""
    return _ANCHOR_WALL + (t_perf - _ANCHOR_PERF)


def enabled() -> bool:
    return bool(_sinks)


def add_sink(sink: Callable[[dict], None]) -> None:
    with _lock:
        if sink not in _sinks:
            _sinks.append(sink)


def remove_sink(sink: Callable[[dict], None]) -> None:
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)


def set_process_tag(job: str) -> None:
    """Tag every subsequent event of THIS process with a job label --
    supervisor workers use ``worker:<label>``, fleet replica children
    ``replica:<pid>`` -- the (pid, job) pair that names the process on a
    merged timeline."""
    _proc_tag["job"] = str(job)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def set_trace_id(trace_id: Optional[str]) -> None:
    """Thread-local default ``trace_id`` for spans that don't carry an
    explicit one (the serve request lifecycle sets it per request)."""
    _tls.trace_id = trace_id


def current_trace_id() -> Optional[str]:
    return getattr(_tls, "trace_id", None)


def _feed(event: dict) -> None:
    for sink in list(_sinks):
        try:
            sink(event)
        except Exception:  # noqa: BLE001 -- a broken sink must never take the engine down; tracing is best-effort by contract
            pass


class _NullSpan:
    """The disabled fast path: one shared, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    t0 = 0.0
    t1 = 0.0

    @property
    def dur_ms(self) -> float:
        return 0.0


_NULL = _NullSpan()


class Span:
    """One live span (use via ``with``).  After exit, ``t0``/``t1``/
    ``dur_ms`` stay readable -- the serve decomposition reads them even
    when no sink is listening (``force=True``)."""

    __slots__ = ("name", "attrs", "trace_id", "t0", "t1", "_parent",
                 "_depth")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 trace_id: Optional[str]):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.t0 = 0.0
        self.t1 = 0.0
        self._parent = ""
        self._depth = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __enter__(self) -> "Span":
        st = _stack()
        self._parent = st[-1] if st else ""
        self._depth = len(st)
        st.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        if et is not None:
            self.attrs["error"] = et.__name__
        if _sinks:
            _feed(self._event())
        return False

    def _event(self) -> dict:
        return {"v": SCHEMA, "kind": "span", "name": self.name,
                "t0": wall(self.t0), "dur_ms": round(self.dur_ms, 6),
                "depth": self._depth, "parent": self._parent,
                "pid": os.getpid(), "job": _proc_tag["job"],
                "tid": threading.current_thread().name,
                "trace_id": (self.trace_id if self.trace_id is not None
                             else current_trace_id()),
                "attrs": self.attrs}


def span(name: str, force: bool = False, trace_id: Optional[str] = None,
         **attrs):
    """Open a span.  Disabled (no sinks) and unforced: returns the shared
    no-op singleton -- no allocation, no timing.  ``force=True`` times the
    region regardless (the serve decomposition's always-on stopwatch),
    feeding sinks only when some are registered."""
    if not _sinks and not force:
        return _NULL
    return Span(name, attrs, trace_id)


def emit(name: str, t0: float, t1: float, trace_id: Optional[str] = None,
         **attrs) -> None:
    """Record a RETROSPECTIVE span from two :func:`now` timestamps -- for
    intervals that cannot be a ``with`` block (a request's queue wait ends
    inside the executor, not where it began).  No-op when disabled."""
    if not _sinks:
        return
    _feed({"v": SCHEMA, "kind": "span", "name": name, "t0": wall(t0),
           "dur_ms": round((t1 - t0) * 1e3, 6),
           "depth": len(_stack()), "parent": "", "pid": os.getpid(),
           "job": _proc_tag["job"],
           "tid": threading.current_thread().name,
           "trace_id": trace_id, "attrs": attrs})


def event(name: str, trace_id: Optional[str] = None, **attrs) -> None:
    """Record an instant event (dur 0).  No-op when disabled."""
    if not _sinks:
        return
    t = time.perf_counter()
    _feed({"v": SCHEMA, "kind": "event", "name": name, "t0": wall(t),
           "dur_ms": 0.0, "depth": len(_stack()), "parent": "",
           "pid": os.getpid(), "job": _proc_tag["job"],
           "tid": threading.current_thread().name,
           "trace_id": trace_id, "attrs": attrs})


class Collector:
    """In-memory sink: appends every event to ``self.events``."""

    def __init__(self) -> None:
        self.events: List[dict] = []

    def __call__(self, ev: dict) -> None:
        self.events.append(ev)


class capture:
    """``with capture() as events:`` -- collect every event inside the
    block (the obs smoke and the tests run solves under this)."""

    def __enter__(self) -> List[dict]:
        self._col = Collector()
        add_sink(self._col)
        return self._col.events

    def __exit__(self, *exc) -> None:
        remove_sink(self._col)


class JsonlSink:
    """File sink: one JSON line per event, flushed per line so the spill
    survives a SIGKILL (the data is in the kernel after flush): the
    per-process trace file."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def __call__(self, ev: dict) -> None:
        self._f.write(json.dumps(ev) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            remove_sink(self)
            self._f.close()
        except Exception:  # noqa: BLE001 -- closing a trace sink is best-effort teardown
            pass


def start_file_trace(path: str) -> JsonlSink:
    """Open + register a :class:`JsonlSink`; returns it (call ``close()``
    to stop)."""
    sink = JsonlSink(path)
    add_sink(sink)
    return sink


def start_file_trace_from_env(tag: str = "") -> Optional[JsonlSink]:
    """When ``KNTPU_TRACE_DIR`` is set, start spilling this process's
    spans into ``<dir>/trace_<tag>_<pid>.jsonl``.  The serving main calls
    this, so one exported variable turns on tracing of the run."""
    d = os.environ.get("KNTPU_TRACE_DIR", "")
    if not d:
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "-"
                   for c in (tag or "proc"))
    return start_file_trace(
        os.path.join(d, f"trace_{safe}_{os.getpid()}.jsonl"))


def validate_event(ev: dict) -> Optional[str]:
    """Schema check of one event dict: returns None when well-formed,
    else a one-line reason."""
    required = ("v", "kind", "name", "t0", "dur_ms", "depth", "parent",
                "pid", "job", "tid", "trace_id", "attrs")
    for key in required:
        if key not in ev:
            return f"missing key {key!r}"
    if ev["v"] != SCHEMA:
        return f"schema version {ev['v']!r} != {SCHEMA}"
    if ev["kind"] not in ("span", "event", "metrics"):
        return f"unknown kind {ev['kind']!r}"
    if not isinstance(ev["name"], str) or not ev["name"]:
        return "empty name"
    if not isinstance(ev["dur_ms"], (int, float)) or ev["dur_ms"] < 0:
        return f"negative dur_ms {ev['dur_ms']!r}"
    if not isinstance(ev["depth"], int) or ev["depth"] < 0:
        return f"bad depth {ev['depth']!r}"
    if not isinstance(ev["attrs"], dict):
        return "attrs not a dict"
    return None
