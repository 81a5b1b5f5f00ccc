"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the mix's inputs, the start mesh and the warm-up."""


def read(ctx):
    return ctx.setup_s
