"""Rolling the tick: fixed-length runs and convergence-bounded runs.

- :func:`simulate` runs the tick over ``TickInputs`` stacked along a
  leading ``[T]`` axis and returns the final state plus the per-tick
  metrics stacked on ``[T]`` (the JAX package's ``lax.scan``).
- :func:`run_until_converged` ticks the fault-free build until every alive
  peer agrees on the fingerprint, up to ``max_ticks`` (the JAX package's
  ``lax.while_loop``). Agreement is also checked on entry, so a run that
  starts converged returns ``ticks_run == 0`` with its state untouched.
"""

from __future__ import annotations

import dataclasses

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops.hashing import fingerprint_agreement, membership_fingerprint
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics, idle_inputs


def simulate(
    state: MeshState,
    inputs: TickInputs,
    cfg: SwimConfig,
    faulty: bool = True,
) -> tuple[MeshState, TickMetrics]:
    """Run the tick over ``inputs`` stacked along [T]; metrics stacked on [T]."""
    tick = make_tick_fn(cfg, faulty=faulty)
    per_tick = []
    for t in range(inputs.kill.shape[0]):
        state, m = tick(state, inputs.at(t))
        per_tick.append(m)
    metrics = TickMetrics(**{
        f.name: torch.stack([getattr(m, f.name) for m in per_tick])
        for f in dataclasses.fields(TickMetrics)
    })
    return state, metrics


def state_agreement(state: MeshState):
    """Fingerprint agreement of ``state`` as-is, without a tick:
    ``(converged, fp_min, fp_max, n_alive)`` as in the tick's metrics."""
    fp = membership_fingerprint(
        state.state > 0,
        state.id_view if state.id_view is not None else state.identity,
    )
    return fingerprint_agreement(state.alive, fp)


def state_converged(state: MeshState) -> bool:
    """The agreement flag alone (see :func:`state_agreement`)."""
    return bool(state_agreement(state)[0])


def converge_loop(state: MeshState, tick, max_ticks: int) -> tuple[MeshState, int, bool]:
    """Tick with idle inputs until fingerprint agreement or ``max_ticks``.

    Returns ``(final_state, ticks_run, converged)``; convergence is judged
    on end-of-tick state, and on entry."""
    idle = idle_inputs(state.n, device=state.device)
    conv = state_converged(state)
    ticks = 0
    while not conv and ticks < max_ticks:
        state, m = tick(state, idle)
        ticks += 1
        conv = bool(m.converged)
    return state, ticks, conv


def run_until_converged(
    state: MeshState,
    cfg: SwimConfig,
    max_ticks: int = 64,
) -> tuple[MeshState, int, bool]:
    """Tick the fault-free build until fingerprint agreement or ``max_ticks``."""
    return converge_loop(state, make_tick_fn(cfg, faulty=False), max_ticks)
