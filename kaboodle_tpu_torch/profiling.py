"""Tracing and per-tick tables of a run (the port of
``kaboodle_tpu/profiling.py``).

- :func:`leaf_equal` / :func:`state_equal` -- THE bit-exactness predicate
  of every A/B and dryrun gate (``python -m kaboodle_tpu_torch phasegraph``,
  ``chip_smoke.py``'s parity phases): dtype- and shape-exact, NaN == NaN
  on floating leaves, over tensors or arrays;
- :func:`trace` -- a context manager around ``torch.profiler.profile``
  that writes a Chrome trace (``*.pt.trace.json``) into a directory;
- :func:`tick_stats` -- stacked per-tick ``TickMetrics`` (from
  ``simulate``) as a NumPy record table, in the JAX package's layout
  (fingerprints as uint32); :func:`fleet_tick_stats` one ensemble member's
  table and :func:`fleet_run_stats` the ensemble's per-tick summary;
- :func:`warp_stats` / :func:`warp_summary` -- the dense ticks of a warped
  run as a table, and its ratios, safe at every degenerate shape;
- :func:`log_run` -- a one-line-per-tick trace of a run, the simulator
  twin of the reference's RUST_LOG=debug output.

``telemetry/manifest.py::ManifestWriter.write_tick_metrics`` writes
:func:`tick_stats` rows as ``tick`` records.
"""

from __future__ import annotations

import contextlib
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


def leaf_equal(a, b) -> bool:
    """Bit-equality of two leaves (tensors or arrays), NaN == NaN.

    Shape and dtype must match exactly, values bitwise, and on floating
    leaves NaN positions must coincide (the latency EWMA plane carries NaN
    for never-measured edges). One definition for every gate: a lane-local
    copy that drifts redefines what "bit-exact" means for that gate only."""
    av, bv = _host(a), _host(b)
    if av.shape != bv.shape or av.dtype != bv.dtype:
        return False
    if np.issubdtype(av.dtype, np.floating):
        return bool(((av == bv) | (np.isnan(av) & np.isnan(bv))).all())
    return bool((av == bv).all())


def _leaves(obj) -> list:
    """The leaves of a dataclass / tuple / list / dict tree in JAX's order
    (dataclass fields in declaration order, dict keys sorted); ``None``
    is an empty subtree, as in ``jax.tree.leaves``."""
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj) for x in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _leaves(v)]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    return [obj]


def state_equal(a, b) -> bool:
    """:func:`leaf_equal` over two whole trees (states, metrics)."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(leaf_equal(x, y) for x, y in zip(la, lb))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of everything run inside the block.

    The host's ops always, the card's kernels too when one is present; the
    Chrome trace (``<worker>.<time>.pt.trace.json``) is written into
    ``log_dir`` by ``torch.profiler.tensorboard_trace_handler`` (which
    needs no tensorboard package). Open it in Perfetto or
    ``chrome://tracing``. First-build noise included: for clean kernel
    timings run one warmup call before entering."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield


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
    (leaves ``[T, E]``, from ``fleet.simulate_fleet``). For whole-ensemble
    statistics use :func:`fleet_run_stats` or ``fleet/stats.py``."""
    return tick_stats(TickMetrics(**{
        f.name: getattr(metrics, f.name)[:, member] for f in dataclasses.fields(TickMetrics)
    }))


def fleet_run_stats(metrics: TickMetrics) -> np.ndarray:
    """Per-tick ensemble summary of a fleet run, as a NumPy record table.

    One row per tick: converged-member count and the agree-fraction
    mean/min over the ensemble -- the host rendering of
    ``fleet.stats.agree_fraction_trajectory`` (the reductions run on the
    device; only ``[T]`` vectors come to the host)."""
    from kaboodle_tpu_torch.fleet.stats import agree_fraction_trajectory

    traj = {k: _host(v) for k, v in agree_fraction_trajectory(metrics).items()}
    ticks = traj["mean"].shape[0]
    ensemble = metrics.converged.shape[-1]
    out = np.zeros(
        ticks,
        dtype=[
            ("tick", np.int32),
            ("converged_members", np.int32),
            ("agree_fraction_mean", np.float32),
            ("agree_fraction_min", np.float32),
        ],
    )
    out["tick"] = np.arange(ticks)
    out["converged_members"] = np.round(traj["converged_fraction"] * ensemble).astype(np.int32)
    out["agree_fraction_mean"] = traj["mean"]
    out["agree_fraction_min"] = traj["min"]
    return out


def warp_stats(dense_ticks, metrics: TickMetrics | None) -> np.ndarray:
    """Per-dense-tick table of a warped run, tick column = real tick index.

    ``(dense_ticks, metrics)`` come from ``warp.runner.simulate_warped``:
    only the densely executed ticks carry metrics. Strict-leaped spans are
    converged and quiet; hybrid-leaped spans (near-quiescent drain windows)
    are not converged -- armed timers and disagreeing fingerprints persist
    through them -- so a gap between rows means only "nothing the span
    programs cannot model happened": the run's ``WarpLedger`` says what
    each gap was. :func:`tick_stats`' layout with the ``tick`` column
    rewritten to the actual tick indices; ``None`` metrics (everything
    leaped) gives an empty table."""
    if metrics is None:
        return np.zeros(0, dtype=_TICK_DTYPE)
    out = tick_stats(metrics)
    out["tick"] = _host(dense_ticks)
    return out


def warp_summary(dense_ticks, total_ticks: int,
                 metrics: TickMetrics | None = None) -> dict:
    """Ratio-style summary of a warped run, safe at every degenerate shape.

    An already-converged entry state leaps the whole schedule (zero dense
    ticks, ``metrics is None``) and a zero-length schedule runs nothing, so
    every ratio guards its denominator: ``dense_fraction`` /
    ``leaped_fraction`` are 0.0 / 1.0 on an all-leaped run and both 0.0 on
    an empty one, and ``mean_msgs_per_dense_tick`` is 0.0 when no dense
    tick ran."""
    dense = int(_host(dense_ticks).size)
    total = int(total_ticks)
    if dense > total:
        raise ValueError(f"dense_ticks ({dense}) exceeds total_ticks ({total})")
    msgs = int(_host(metrics.messages_delivered).sum()) if metrics is not None else 0
    return {
        "total_ticks": total,
        "dense_ticks": dense,
        "leaped_ticks": total - dense,
        "dense_fraction": dense / total if total else 0.0,
        "leaped_fraction": (total - dense) / total if total else 0.0,
        "messages_delivered": msgs,
        "mean_msgs_per_dense_tick": msgs / dense if dense else 0.0,
    }


def log_run(metrics: TickMetrics, emit=print) -> None:
    """Per-tick one-liners (the RUST_LOG=debug analogue, main.rs:54-58)."""
    for row in tick_stats(metrics):
        emit(
            f"tick {row['tick']:>4}: msgs={row['messages_delivered']:<6} "
            f"agree={row['agree_fraction']:.3f} "
            f"members={row['mean_membership']:.1f} "
            f"fp=[{row['fingerprint_min']:08x},{row['fingerprint_max']:08x}]"
            f"{' CONVERGED' if row['converged'] else ''}"
        )
