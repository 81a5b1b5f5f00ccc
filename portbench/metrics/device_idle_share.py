"""Percent of the traced window in which no operation ran on the device: 1
minus the union of the kernel, memcpy and memset intervals over the
window's length (``.ticks``, ``.rest``, ``.blocked`` over traced ticks,
``.boot`` over traced boots)."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
