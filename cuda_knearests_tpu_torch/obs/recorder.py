"""Flight recorder: the last events of a dying process, bounded.

Counterpart of ``cuda_knearests_tpu/obs/recorder.py``.  The recorder keeps
a bounded in-memory ring of recent span events plus metric deltas and,
when armed with a spill path, mirrors every event to a line-flushed
``.jsonl`` file, so the evidence survives a kill the process never sees:

* the ring feeds the watchdog's stall artifact (``utils/watchdog.py``
  writes ``FLIGHT.dump()`` next to the faulthandler tracebacks), and
* the spill feeds the supervisor: on any worker failure it reads the
  file's tail into ``FailureRecord.flight_tail``, so a killed worker's
  last events are on record (``runtime/supervisor.py``).

Fault injection: :meth:`FlightRecorder.kill_after_events` arms a
deterministic SIGKILL upon the N-th recorded event -- the
``KNTPU_FAULT=abort-after:<label>:<n>`` hook of ``runtime/worker.py``.

Pure Python: nothing here touches a device.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import deque
from typing import IO, Deque, List, Optional

from . import spans as _spans

#: Default ring capacity (events).
DEFAULT_CAPACITY = 256

#: Spill-path env var: the supervisor points each worker attempt at its
#: own file, then harvests the tail on failure.
FLIGHT_FILE_ENV = "KNTPU_FLIGHT_FILE"


class FlightRecorder:
    """Bounded ring of recent events; optionally spilled to a jsonl file
    (line-flushed: survives SIGKILL).  Registers itself as a spans sink
    when armed, so every span and event of the process lands here."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: Deque[dict] = deque(maxlen=self.capacity)
        self.recorded = 0
        self.tag = ""
        self.armed = False
        self._lock = threading.Lock()
        self._spill: Optional[IO[str]] = None
        self._spill_path: Optional[str] = None
        self._kill_after: Optional[int] = None
        self._metric_base: dict = {}

    # -- lifecycle ----------------------------------------------------------

    def arm(self, tag: str = "", spill_path: Optional[str] = None,
            capacity: Optional[int] = None) -> "FlightRecorder":
        """Start recording (idempotent): register as a spans sink, open
        the spill file when given one, and record a ``recorder.arm``
        marker event, so even a process wedged at once leaves a record."""
        with self._lock:
            self.tag = tag or self.tag
            if capacity and capacity != self.capacity:
                self.capacity = int(capacity)
                self.events = deque(self.events, maxlen=self.capacity)
            if spill_path and spill_path != self._spill_path:
                self._close_spill()
                d = os.path.dirname(spill_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._spill = open(spill_path, "a", encoding="utf-8")
                self._spill_path = spill_path
            self.armed = True
        _spans.add_sink(self)
        self._metric_base = self._dispatch_counters()
        self.record(self._event("event", "recorder.arm", {"tag": tag}))
        return self

    def disarm(self) -> None:
        _spans.remove_sink(self)
        with self._lock:
            self.armed = False
            self._close_spill()

    def _close_spill(self) -> None:
        if self._spill is not None:
            try:
                self._spill.close()
            except OSError:
                pass
            self._spill = None  # kntpu-ok: unguarded-shared-mutable -- _close_spill runs only with self._lock held (arm, disarm)
            self._spill_path = None  # kntpu-ok: unguarded-shared-mutable -- _close_spill runs only with self._lock held (arm, disarm)

    def _event(self, kind: str, name: str, attrs: dict) -> dict:
        return {"v": _spans.SCHEMA, "kind": kind, "name": name,
                "t0": time.time(), "dur_ms": 0.0, "depth": 0, "parent": "",
                "pid": os.getpid(), "job": self.tag, "tid": "main",
                "trace_id": None, "attrs": attrs}

    # -- recording ----------------------------------------------------------

    def __call__(self, event: dict) -> None:
        self.record(event)

    def record(self, event: dict) -> None:
        with self._lock:
            if not self.armed:
                return
            self.events.append(event)
            self.recorded += 1
            if self._spill is not None:
                try:
                    self._spill.write(json.dumps(event) + "\n")
                    self._spill.flush()
                except (OSError, TypeError, ValueError):
                    pass          # the spill is best-effort; the ring stays
            kill = (self._kill_after is not None
                    and self.recorded >= self._kill_after)
        if kill:
            # the abort-after fault: die as hard as a device fault would
            os.kill(os.getpid(), signal.SIGKILL)

    @staticmethod
    def _dispatch_counters() -> dict:
        from ..runtime import dispatch as _dispatch

        return dict(_dispatch.stats_dict())

    def metric_delta(self) -> dict:
        """Record (and return) the dispatch-counter delta since the last
        call: the metric half of the ring.  Cheap; the watchdog's trip
        path calls it."""
        now_c = self._dispatch_counters()
        delta = {k: now_c.get(k, 0) - self._metric_base.get(k, 0)
                 for k in now_c}
        self._metric_base = now_c
        ev = self._event("metrics", "dispatch.delta", delta)
        self.record(ev)
        return ev

    def kill_after_events(self, n: int) -> None:
        """Arm the deterministic SIGKILL (fault injection): the process
        dies upon recording its ``n``-th event, counted from process
        start."""
        with self._lock:
            self._kill_after = max(1, int(n))

    # -- reading ------------------------------------------------------------

    def tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = list(self.events)
        return evs if n is None else evs[-int(n):]

    def dump(self) -> dict:
        """The crash-artifact document: the ring's tail and how many
        events it dropped."""
        with self._lock:
            dropped = max(0, self.recorded - len(self.events))
        return {"v": _spans.SCHEMA, "tag": self.tag, "pid": os.getpid(),
                "recorded": self.recorded, "dropped": dropped,
                "events": self.tail()}


#: The process-wide recorder (one per process: the (pid, tag) pair names
#: it on a merged timeline).
FLIGHT = FlightRecorder()


def arm(tag: str = "", spill_path: Optional[str] = None,
        capacity: Optional[int] = None) -> FlightRecorder:
    """Arm the process-wide recorder.  ``spill_path`` defaults to the
    supervisor-provided ``KNTPU_FLIGHT_FILE`` env var."""
    if spill_path is None:
        spill_path = os.environ.get(FLIGHT_FILE_ENV) or None
    return FLIGHT.arm(tag=tag, spill_path=spill_path, capacity=capacity)


def read_spill_tail(path: str, n: int = 64) -> List[dict]:
    """The last ``n`` well-formed events of a spill file (the supervisor's
    harvest on a worker failure).  A missing or corrupt file gives []."""
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return []
    out: List[dict] = []
    for line in lines[-int(n):]:
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue          # a half-written last line (killed mid-write)
        if isinstance(ev, dict):
            out.append(ev)
    return out
