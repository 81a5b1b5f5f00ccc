"""Profiler labels of the port: host spans and op scopes under ``kaboodle:``.

The port of ``kaboodle_tpu/telemetry/trace.py::op_scope`` and
``host_span``. Both open a ``torch.profiler.record_function`` range named
``kaboodle:<name>``, which a ``torch.profiler`` capture shows on the host
timeline with the kernels launched inside it; outside a capture a range
costs a few microseconds and changes nothing the program computes. The
Chrome-trace writers of the JAX module are not ported yet.
"""

from __future__ import annotations

import contextlib

import torch


def op_scope(name: str):
    """A ``kaboodle:<name>`` profiler range, usable as a context manager or
    a decorator (the JAX package's ``jax.named_scope`` label)."""
    return torch.profiler.record_function(f"kaboodle:{name}")


@contextlib.contextmanager
def host_span(name: str):
    """Host-side profiler span around a stretch of the runner's loop."""
    with torch.profiler.record_function(f"kaboodle:{name}"):
        yield
