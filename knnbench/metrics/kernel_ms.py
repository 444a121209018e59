"""Device time of every kernel the traced solves launched (copies and
memsets excluded), a solve, from the profiler."""


def read(ctx):
    cap = ctx.device_capture()
    if cap is None:
        return None
    s = cap.device_s(("kernel",))
    return s / cap.solves * 1e3 if s > 0 else None
