"""Window seconds over the boots completed in it, each from a fresh mesh to
fingerprint agreement."""


def read(ctx):
    if ctx.unit != "run" or not ctx.units:
        return None
    return ctx.window_s / ctx.units
