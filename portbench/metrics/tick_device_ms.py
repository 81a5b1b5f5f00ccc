"""Device milliseconds a tick keeps the card busy: the union of the device
intervals over the traced ticks, divided by the ticks (``.dense`` under
churn, ``.rest`` at rest, ``.blocked`` on the row-blocked engine)."""


def read(ctx):
    if ctx.unit != "tick" or not ctx.trace.units or not ctx.trace.device_ops:
        return None
    return ctx.trace.busy_s() / len(ctx.trace.units) * 1e3
