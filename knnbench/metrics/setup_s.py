"""Process start to the first timed solve: imports, the cloud, prepare,
kernel loads (a first run in a checkout compiles them) and warm-up."""


def read(ctx):
    return ctx.setup_s
