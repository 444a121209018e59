"""Host time of a window solve from the call to the start of its
readback: each ``knn.solve`` span's start to the start of the first
``dispatch.fetch`` span inside it, the median over the window of a
``--trace 1`` run.  The solve's device work runs behind it; where it
nears ``kernel_ms`` the host sets the solve's pace."""

import bisect
import statistics


def read(ctx):
    solves = [s for s in ctx.window_spans if s.get("name") == "knn.solve"]
    fetch = sorted(s["t0"] for s in ctx.window_spans
                   if s.get("name") == "dispatch.fetch")
    gaps = []
    for s in solves:
        i = bisect.bisect_left(fetch, s["t0"])
        if i < len(fetch) and fetch[i] <= s["t0"] + s["dur_ms"] / 1e3:
            gaps.append((fetch[i] - s["t0"]) * 1e3)
    return statistics.median(gaps) if gaps else None
