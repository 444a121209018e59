"""``torch.cuda.max_memory_allocated()`` from just before prepare to the
end of the window, in GiB."""


def read(ctx):
    if ctx.peak_mem_bytes is None:
        return None
    return ctx.peak_mem_bytes / 2 ** 30
