"""The kernels' share of their byte roofline: the least time the card's
published bandwidth allows a solve's bytes (``roofline.solve_bytes``:
n·d·4 in, n·k·8 out) over the kernels' device time a solve, in %."""

from knnbench import roofline


def read(ctx):
    cap = ctx.device_capture()
    bound = roofline.bound_s(ctx.n, ctx.k, ctx.d, ctx.device_kind)
    if cap is None or bound is None:
        return None
    s = cap.device_s(("kernel",)) / cap.solves
    return 100.0 * bound / s if s > 0 else None
