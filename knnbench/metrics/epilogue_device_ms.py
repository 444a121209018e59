"""Device time of the kernels launched inside a ``kntpu:knn.solve`` range
but outside every ``kntpu:solve.adaptive.class`` range, a traced solve:
the output buffers' fills, the certificate and the ``where``s (the rest of
``kernel_ms`` beside ``select_device_ms``)."""

from knnbench import scopes


def read(ctx):
    cap = ctx.device_capture()
    if cap is None:
        return None
    solve = scopes.ranges(cap, "knn.solve")
    classes = scopes.ranges(cap, "solve.adaptive.class")
    if not solve or not classes:
        return None
    return scopes.kernel_ms(cap, lambda ts: scopes.covers(solve, ts)
                            and not scopes.covers(classes, ts))
