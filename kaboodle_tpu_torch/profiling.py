"""Per-tick tables of a run's metrics (the port of two helpers of
``kaboodle_tpu/profiling.py``).

- :func:`tick_stats` -- stacked per-tick ``TickMetrics`` (from
  ``simulate``) as a NumPy record table, in the JAX package's layout
  (fingerprints as uint32);
- :func:`fleet_tick_stats` -- one ensemble member's table from
  fleet-stacked ``[T, E]`` metrics.

``telemetry/manifest.py::ManifestWriter.write_tick_metrics`` writes these
rows as ``tick`` records. The JAX module's profiler context, warp tables
and ``log_run`` are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.sim.state import TickMetrics

_TICK_DTYPE = [
    ("tick", np.int32),
    ("messages_delivered", np.int32),
    ("converged", bool),
    ("agree_fraction", np.float32),
    ("mean_membership", np.float32),
    ("fingerprint_min", np.uint32),
    ("fingerprint_max", np.uint32),
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tick_stats(metrics: TickMetrics) -> np.ndarray:
    """Stacked per-tick metrics (from ``simulate``) -> structured NumPy table.

    Fields mirror TickMetrics; one row per tick. The fingerprint columns
    are uint32 (the port carries them as int32 bits)."""
    msgs = _host(metrics.messages_delivered)
    out = np.zeros(msgs.shape[0], dtype=_TICK_DTYPE)
    out["tick"] = np.arange(msgs.shape[0])
    out["messages_delivered"] = msgs
    out["converged"] = _host(metrics.converged)
    out["agree_fraction"] = _host(metrics.agree_fraction)
    out["mean_membership"] = _host(metrics.mean_membership)
    for name in ("fingerprint_min", "fingerprint_max"):
        a = _host(getattr(metrics, name))
        out[name] = a.astype(np.int32).view(np.uint32) if a.dtype != np.uint32 else a
    return out


def fleet_tick_stats(metrics: TickMetrics, member: int) -> np.ndarray:
    """One ensemble member's per-tick table from fleet-stacked metrics
    (leaves ``[T, E]``, from ``fleet.simulate_fleet``)."""
    return tick_stats(TickMetrics(**{
        f.name: getattr(metrics, f.name)[:, member] for f in dataclasses.fields(TickMetrics)
    }))
