"""Device time of the kernels launched inside a ``kntpu:solve.adaptive.class``
range (the classes' selection), a traced solve; each kernel joined to its
launch call by correlation id (``knnbench/scopes.py``)."""

from knnbench import scopes


def read(ctx):
    cap = ctx.device_capture()
    if cap is None:
        return None
    classes = scopes.ranges(cap, "solve.adaptive.class")
    if not classes:
        return None
    ms = scopes.kernel_ms(cap, lambda ts: scopes.covers(classes, ts))
    return ms if ms > 0 else None
