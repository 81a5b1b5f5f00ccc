"""graftconc's runtime half: the lock-order and event-loop sanitizer.

The port of ``kaboodle_tpu/analysis/conc``'s ``sanitizer.py`` (stdlib
only). The static KB5xx rules are not ported.
"""
