"""One profiler session over a short run of solves, and its reduction.

:func:`capture` runs the solves under ``torch.profiler`` (CPU activity,
and CUDA activity on the card) inside one annotation, the traced window,
and collects the port's spans beside it.  The Chrome trace goes to a
temporary file under ``TMPDIR`` that is read and deleted at once.  The
reductions read device events (kernels, copies, memsets) whose start lies
in the window: their time by kind and by name, the union of their
intervals (the device's busy time), and the idle gaps between them, each
labelled by what the host was doing then: the innermost port span open
and the innermost host operation the profiler saw.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "knnbench.traced_window"
SOLVE = "knnbench.solve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: Host calls that issue device work; in a complete capture each one's
#: correlation id has a kernel, copy or memset event.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpy", "cudaMemcpyAsync",
                "cudaMemset", "cudaMemsetAsync")
#: Entries of each list of ``breakdown``.
TOP = 10
_NAME_CHARS = 120


@dataclasses.dataclass
class Capture:
    """A traced window: the profiler's complete events, the window on the
    profiler's microsecond axis, the wall-clock second its start maps to,
    the port's span events and the solves run inside."""

    events: List[dict]
    t0_us: float
    t1_us: float
    wall0: float
    spans: List[dict]
    solves: int
    _host: Optional[List[dict]] = dataclasses.field(default=None,
                                                    repr=False)

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def device_events(self, cats=DEVICE_CATS) -> List[dict]:
        return [e for e in self.events if e.get("cat") in cats
                and self.t0_us <= float(e["ts"]) < self.t1_us]

    def device_s(self, cats=DEVICE_CATS,
                 match: Callable[[str], bool] = lambda name: True) -> float:
        """Summed device seconds of the window's events of ``cats`` whose
        name ``match`` accepts."""
        return sum(float(e.get("dur", 0.0)) for e in self.device_events(cats)
                   if match(str(e.get("name", "")))) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        window, in microseconds."""
        spans = sorted((float(e["ts"]),
                        min(float(e["ts"]) + float(e.get("dur", 0.0)),
                            self.t1_us))
                       for e in self.device_events())
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the window, in microseconds."""
        out, t = [], self.t0_us
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1_us > t:
            out.append((t, self.t1_us))
        return out

    def dropped(self) -> int:
        """Launches in the window whose device event the capture lacks
        (the profiler drops them in sessions long after a process's
        first)."""
        have = {(e.get("args") or {}).get("correlation")
                for e in self.events if e.get("cat") in DEVICE_CATS}
        return sum(1 for e in self.events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in LAUNCH_CALLS
                   and self.t0_us <= float(e["ts"]) < self.t1_us
                   and (e.get("args") or {}).get("correlation") not in have)

    def _host_ops(self) -> List[dict]:
        if self._host is None:
            self._host = [e for e in self.events
                          if e.get("cat") in HOST_CATS]
        return self._host

    def host_label(self, ts_us: float) -> str:
        """What the host was doing at ``ts_us``: the innermost port span
        then open, and the innermost host operation."""
        wall = self.wall0 + (ts_us - self.t0_us) / 1e6
        open_spans = [s for s in self.spans
                      if s["t0"] <= wall <= s["t0"] + s["dur_ms"] / 1e3]
        span = (max(open_spans, key=lambda s: s["depth"])["name"]
                if open_spans else "no span")
        ops = [e for e in self._host_ops() if float(e["ts"]) <= ts_us
               <= float(e["ts"]) + float(e.get("dur", 0.0))]
        op = (str(min(ops, key=lambda e: float(e.get("dur", 0.0)))["name"])
              if ops else "no op")
        return f"{span} | {op}"[:_NAME_CHARS]

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        by what the host was doing, in seconds."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device_events():
            ops[str(e.get("name", ""))[:_NAME_CHARS]] += float(
                e.get("dur", 0.0)) / 1e6
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            idle[self.host_label((a + b) / 2)] += (b - a) / 1e6
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _load(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(prefix="knnbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return [e for e in doc.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X" and "ts" in e]


def capture(solve: Callable[[], object], solves: int, cuda: bool,
            spans) -> Capture:
    """Run ``solve`` ``solves`` times in one traced window.  ``spans`` is
    the port's span module (its ``Collector``, sinks and wall clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    col = spans.Collector()
    spans.add_sink(col)
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                wall0 = spans.wall(spans.now())
                for _ in range(solves):
                    with record_function(SOLVE):
                        solve()
                if cuda:
                    torch.cuda.synchronize()
    finally:
        spans.remove_sink(col)
    events = _load(prof)
    win: Optional[dict] = next(
        (e for e in events if e.get("name") == WINDOW
         and e.get("cat") != "gpu_user_annotation"), None)
    if win is None:
        raise RuntimeError(f"the profiler's trace lacks the window "
                           f"annotation {WINDOW!r}")
    t0 = float(win["ts"])
    return Capture(events=events, t0_us=t0,
                   t1_us=t0 + float(win.get("dur", 0.0)), wall0=wall0,
                   spans=[e for e in col.events if e.get("kind") == "span"],
                   solves=solves)
