"""Device-to-host copies per traced tick: the tick's gates (a Python ``if`` on
a device value in ``phasegraph/exec.py`` / ``blocked.py``, some once a row
block) and its host reads of the state, counted as ``Memcpy DtoH``
operations."""


def read(ctx):
    if ctx.unit != "tick" or not ctx.trace.units or not ctx.trace.device_ops:
        return None
    return sum(1 for op in ctx.trace.device_ops
               if op.name.startswith("Memcpy DtoH")) / len(ctx.trace.units)
