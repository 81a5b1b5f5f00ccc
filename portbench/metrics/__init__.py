"""Per-layer metric readers, one file each, found by the metric's name.

Each ``<metric>.py`` has ``read(ctx) -> float | None`` over a
``trace.Context``; a reader that finds nothing to read returns None and
the metric is left out of the result line. A split name
``<metric>.<part>`` (the same quantity moving another end-to-end metric,
in other cells) is read by ``<metric>.py`` unless it has a file of its
own."""
