"""Host time a window solve blocks in its readback: the ``dispatch.fetch.wait``
spans inside each ``knn.solve`` span (the synchronize, apart from queueing
the copies and the conversion to numpy), summed a solve, the median over
the window of a ``--trace 1`` run (spans on, no profiler)."""

import bisect
import statistics


def read(ctx):
    waits = sorted((s["t0"], s["dur_ms"]) for s in ctx.window_spans
                   if s.get("name") == "dispatch.fetch.wait")
    if not waits:
        return None
    starts = [t for t, _ in waits]
    out = []
    for s in ctx.window_spans:
        if s.get("name") != "knn.solve":
            continue
        lo = bisect.bisect_left(starts, s["t0"])
        hi = bisect.bisect_right(starts, s["t0"] + s["dur_ms"] / 1e3)
        if hi > lo:
            out.append(sum(d for _, d in waits[lo:hi]))
    return statistics.median(out) if out else None
