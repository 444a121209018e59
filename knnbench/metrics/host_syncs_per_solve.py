"""The port's host round trips (``dispatch.stats().host_syncs``) over the
window, a solve."""


def read(ctx):
    if ctx.solves <= 0 or "host_syncs" not in ctx.counters:
        return None
    return ctx.counters["host_syncs"] / ctx.solves
