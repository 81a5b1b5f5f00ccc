"""Peers times ticks completed in the window, over the window's host-clock
seconds (the window ends in one synchronize). ``.rest`` (a mesh at rest,
paced by the host) and ``.blocked`` (the row-blocked engine, seconds a
tick) are the same quantity with bounds of their own: their runs spread
several times more, and a tenth as much, as a whole-plane tick under
churn."""


def read(ctx):
    if ctx.unit != "tick" or ctx.window_s <= 0:
        return None
    return ctx.n * ctx.units / ctx.window_s
