"""``torch.cuda.max_memory_allocated()`` over the window, in GiB (the peak
is reset when set-up ends; the reference runs after it is read)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
