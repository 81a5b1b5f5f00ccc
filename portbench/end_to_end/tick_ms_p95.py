"""The 95th percentile of every window tick's duration on the device
timeline, event to event (idle waits included), in ms. ``.rest`` is the
same quantity for a mesh at rest, with a bound of its own."""

import statistics


def read(ctx):
    if ctx.unit != "tick" or len(ctx.unit_ms) < 2:
        return None
    return statistics.quantiles(ctx.unit_ms, n=20)[18]
