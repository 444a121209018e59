"""Metrics registry: bounded counters, gauges and histograms, and one
snapshot.

Counterpart of ``cuda_knearests_tpu/obs/metrics.py``: :class:`Counter`,
:class:`Gauge`, :class:`Histogram`, :func:`percentile_fields`,
:class:`MetricsRegistry`, :func:`metrics_snapshot`,
:class:`JsonlEmitter` and :func:`watchdog_stall_tripped`.

* :class:`Histogram` has FIXED geometric buckets with exact count, sum,
  min and max and interpolated percentiles: O(1) memory at any request
  count, so an open-loop session at sustained load observes every latency
  into ~100 ints instead of a growing list.
* :class:`MetricsRegistry` / :data:`REGISTRY` is the process-wide name ->
  instrument table, plus *providers* (callables returning a dict) through
  which subsystem-owned counters join the snapshot.
* :func:`metrics_snapshot` is the one document: registry, providers, the
  ``runtime/dispatch`` host-boundary counters and the kernel counters
  (``dispatch.kernel_stats``: kernel builds, library loads, class-kernel
  launches), which stand where the reference reports its executable
  cache, and the tuned-plan store's counters (``tuned_plans``).  The
  serving wire's ``metrics`` command and the ``--metrics-jsonl`` emitter
  both return it.

Pure Python: nothing here touches a device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence

#: Snapshot schema version (the ``v`` key); bump on any key change.
SCHEMA = 1


def _geometric_bounds(lo: float, hi: float, n: int) -> tuple:
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


#: Default latency ladder: 0.05 ms .. 120 s over 96 geometric buckets
#: (~17% bucket width -> interpolated percentiles within a few percent).
DEFAULT_MS_BUCKETS = _geometric_bounds(0.05, 120_000.0, 96)


class Counter:
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v: float = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket histogram with exact extrema and interpolated
    percentiles.  Values at or below ``bounds[0]`` land in bucket 0,
    beyond ``bounds[-1]`` in the overflow bucket (whose percentile
    interpolation is clamped by the exact observed max)."""

    __slots__ = ("name", "bounds", "counts", "count", "total", "vmin",
                 "vmax", "_lock")

    def __init__(self, name: str = "", bounds: Sequence[float] = ()):
        self.name = name
        self.bounds = tuple(bounds) or DEFAULT_MS_BUCKETS
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v
            lo, hi = 0, len(self.bounds)
            while lo < hi:                       # first bound >= v
                mid = (lo + hi) // 2
                if self.bounds[mid] < v:
                    lo = mid + 1
                else:
                    hi = mid
            self.counts[lo] += 1

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile (q in [0, 1]); None when empty."""
        with self._lock:
            if not self.count or self.vmin is None or self.vmax is None:
                return None
            rank = q * self.count
            cum = 0.0
            for i, c in enumerate(self.counts):
                if not c:
                    continue
                if cum + c >= rank:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else self.vmax)
                    frac = (rank - cum) / c
                    v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    return float(min(max(v, self.vmin), self.vmax))
                cum += c
            return float(self.vmax)

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        out = {"count": count, "sum": round(total, 6),
               "min": vmin, "max": vmax}
        for label, q in (("p50", 0.5), ("p99", 0.99), ("p999", 0.999)):
            p = self.percentile(q)
            out[label] = round(p, 6) if p is not None else None
        return out


def percentile_fields(hist: Histogram, digits: int = 3) -> dict:
    """{"p50": .., "p99": ..} rounded -- the bench-row stamp form."""
    out = {}
    for label, q in (("p50", 0.5), ("p99", 0.99)):
        p = hist.percentile(q)
        out[label] = round(p, digits) if p is not None else None
    return out


class MetricsRegistry:
    """Process-wide name -> instrument table + snapshot providers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._providers: Dict[str, Callable[[], dict]] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str,
                  bounds: Sequence[float] = ()) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(name, bounds)
            return self._hists[name]

    def register_provider(self, name: str,
                          fn: Callable[[], dict]) -> None:
        """Attach a subsystem's own counters to the snapshot: ``fn``
        returns a plain dict, merged under ``providers.<name>`` at
        snapshot time.  A provider that raises reports its error instead
        of killing the snapshot."""
        with self._lock:
            self._providers[name] = fn

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            providers = dict(self._providers)
        out = {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(hists.items())},
        }
        provided = {}
        for name, fn in sorted(providers.items()):
            try:
                provided[name] = fn()
            except Exception as e:  # noqa: BLE001 -- one broken provider must not kill the whole snapshot; its error IS the datum
                provided[name] = {"error": f"{type(e).__name__}: {e}"}
        out["providers"] = provided
        return out


#: The process-wide registry (daemons and load generators write here; the
#: ``metrics`` wire command reads it).
REGISTRY = MetricsRegistry()


def metrics_snapshot() -> dict:
    """The unified metrics document: registry instruments and providers,
    the ``runtime/dispatch`` counters (``dispatch``), the kernel counters
    (``kernels``) and the active tuned-plan store's (``tuned_plans``, {}
    when none is active).  Top-level keys: ``v``, ``ts``, ``pid``,
    ``counters``, ``gauges``, ``histograms``, ``providers``, ``dispatch``,
    ``kernels``, ``tuned_plans``."""
    out = {"v": SCHEMA, "ts": round(time.time(), 6), "pid": os.getpid(),
           **REGISTRY.snapshot()}
    try:
        from ..runtime import dispatch as _dispatch

        out["dispatch"] = _dispatch.stats_dict()
        out["kernels"] = _dispatch.kernel_stats()
        out["tuned_plans"] = _dispatch.tuned_plan_stats()
    except Exception as e:  # noqa: BLE001 -- the snapshot must land even if the dispatch layer is mid-teardown
        out["dispatch"] = {"error": f"{type(e).__name__}: {e}"}
        out["kernels"] = {}
        out["tuned_plans"] = {}
    return out


class JsonlEmitter(threading.Thread):
    """Periodic snapshot emitter: one JSON line per period to ``path``
    (the ``--metrics-jsonl`` flag of the serve/fleet mains).  Daemon
    thread; ``stop()`` writes one final snapshot so short sessions still
    produce at least one line."""

    def __init__(self, path: str, period_s: float = 1.0,
                 snapshot_fn: Optional[Callable[[], dict]] = None):
        super().__init__(daemon=True, name="kntpu-metrics-emitter")
        self.path = path
        self.period_s = max(0.05, float(period_s))
        self.snapshot_fn = snapshot_fn or metrics_snapshot
        self._halt = threading.Event()  # NOT _stop: Thread.join() calls a private self._stop() internally
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def _emit(self) -> None:
        try:
            snap = self.snapshot_fn()
        except Exception as e:  # noqa: BLE001 -- a failed snapshot becomes an error line, never a dead emitter
            snap = {"v": SCHEMA, "error": f"{type(e).__name__}: {e}"}
        with self._lock:
            if self._f.closed:        # stop() already closed the file
                return
            self._f.write(json.dumps(snap) + "\n")
            self._f.flush()

    def run(self) -> None:
        while not self._halt.wait(self.period_s):
            self._emit()

    def stop(self) -> None:
        """Final snapshot + close.  Joins the emitter thread first so a
        mid-_emit run never races the close (and the closed-file guard
        in _emit covers a stop() racing an unjoinable caller)."""
        self._halt.set()
        if self.is_alive():
            self.join(timeout=10.0)
        self._emit()                  # final snapshot (short sessions)
        with self._lock:
            self._f.close()


def watchdog_stall_tripped(tag: str) -> None:
    """The watchdog's trip path: count the stall where every other
    counter lives (called from ``utils/watchdog.py`` right before exit)."""
    REGISTRY.counter("watchdog.stalls").inc()
    REGISTRY.gauge("watchdog.last_stall_ts").set(time.time())
    _ = tag  # the tag rides the flight-recorder event, not the counter
