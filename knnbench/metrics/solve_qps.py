"""Rows answered a second: n x the solves the window completed, over the
window's seconds (host clock)."""


def read(ctx):
    if ctx.solves <= 0 or ctx.elapsed_s <= 0:
        return None
    return ctx.n * ctx.solves / ctx.elapsed_s
