"""Device seconds a boot to agreement keeps the card busy (the blocked tick 0
and ``sim/runner.py::converge_loop``): the union of the device intervals
over the traced boots, divided by the boots."""


def read(ctx):
    if ctx.unit != "run" or not ctx.trace.units or not ctx.trace.device_ops:
        return None
    return ctx.trace.busy_s() / len(ctx.trace.units)
