"""Share of the traced window with no kernel, copy or memset on the card,
from the union of the profiler's device intervals, in %."""


def read(ctx):
    cap = ctx.device_capture()
    if cap is None or cap.window_s <= 0:
        return None
    return 100.0 * (1.0 - cap.busy_s() / cap.window_s)
