"""The port's spans on the profiler's own timeline, and the device work
each one issued.

While ``torch.profiler`` records, every live span of the port opens a
profiler range named ``kntpu:<span name>``: a ``user_annotation`` event
on the host's thread, stamped by the profiler's clock like the launch
calls beside it.  A device event joins the launch call that issued it by
``args.correlation``, and so the range that was open at the launch,
however late the device ran it.  The ``gpu_user_annotation`` mirrors of
the ranges on the device's lane are not read.  The solves of a traced
window run on one host thread, so a range covers every call made while
it was open.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from .trace import Capture

PREFIX = "kntpu:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Runtime calls that block the host until the device has caught up:
#: explicit waits, the blocking copy, and the frees that synchronize.
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy", "cudaFree",
                  "cudaFreeHost")

Intervals = List[Tuple[float, float]]


def ranges(cap: Capture, span: str) -> Intervals:
    """The (start, end) microseconds of each ``kntpu:<span>`` range that
    starts in the window, in order."""
    name = PREFIX + span
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in cap.events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == name
                  and cap.t0_us <= float(e["ts"]) < cap.t1_us)


def covers(ivs: Intervals, ts: float) -> bool:
    """Whether ``ts`` lies in one of ``ivs``, sorted and disjoint (the
    ranges of one span name on one thread)."""
    i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= ts <= ivs[i][1]


def launch_times(cap: Capture) -> Dict[int, float]:
    """The host time of each launch call, by correlation id."""
    out = {}
    for e in cap.events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = float(e["ts"])
    return out


def kernel_ms(cap: Capture, issued) -> float:
    """Device ms a solve of the window's kernels (as ``kernel_ms`` counts
    them: no copies or memsets) whose launch call's host time ``issued``
    accepts."""
    launched = launch_times(cap)
    us = 0.0
    for e in cap.device_events(("kernel",)):
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is not None and issued(at):
            us += float(e.get("dur", 0.0))
    return us / 1e3 / cap.solves


def overlap_us(a: Intervals, b: Intervals) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def untracked_syncs(cap: Capture) -> List[Tuple[str, str]]:
    """Each host-blocking call (:data:`BLOCKING_CALLS`) inside a
    ``kntpu:knn.solve`` range and outside every ``kntpu:dispatch.fetch``
    range: the call's name and the innermost ``kntpu:`` range open at it
    (its call site)."""
    solve, fetch = ranges(cap, "knn.solve"), ranges(cap, "dispatch.fetch")
    scopes = [e for e in cap.events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(PREFIX)]
    out = []
    for e in cap.events:
        if (e.get("cat") not in LAUNCH_CATS
                or e.get("name") not in BLOCKING_CALLS):
            continue
        ts = float(e["ts"])
        if not covers(solve, ts) or covers(fetch, ts):
            continue
        open_ = [s for s in scopes if float(s["ts"]) <= ts
                 <= float(s["ts"]) + float(s.get("dur", 0.0))]
        inner = min(open_, key=lambda s: float(s.get("dur", 0.0)))
        out.append((str(e["name"]), str(inner["name"])))
    return out
