"""End-to-end metric readers, one file each, found by the metric's name.

Each ``<metric>.py`` has ``read(ctx) -> float | None`` over a
``run.WindowContext``: the window's units, its host-clock length, each
unit's device-timeline duration, the peak and the set-up time. A split
name ``<metric>.<part>`` (the same quantity with a bound of its own, in
other cells) is read by ``<metric>.py`` unless it has a file of its own."""
