"""Share of the traced window in which the device is idle (no kernel, copy
or memset) while a ``kntpu:knn.solve`` range is open on the host, in %:
the part of ``device_idle_pct`` that falls inside the program's solves."""

from knnbench import scopes


def read(ctx):
    cap = ctx.device_capture()
    if cap is None or cap.window_s <= 0:
        return None
    solve = scopes.ranges(cap, "knn.solve")
    if not solve:
        return None
    idle = scopes.overlap_us(cap.gaps(), solve)
    return 100.0 * idle / (cap.t1_us - cap.t0_us)
