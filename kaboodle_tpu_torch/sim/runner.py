"""Rolling the tick: fixed-length runs and convergence-bounded runs.

- :func:`simulate` runs the tick over ``TickInputs`` stacked along a
  leading ``[T]`` axis and returns the final state plus the per-tick
  metrics stacked on ``[T]`` (the JAX package's ``lax.scan``).
- :func:`run_until_converged` ticks the fault-free build until every alive
  peer agrees on the fingerprint, up to ``max_ticks`` (the JAX package's
  ``lax.while_loop``). Agreement is also checked on entry, so a run that
  starts converged returns ``ticks_run == 0`` with its state untouched.
- :func:`simulate_with_telemetry` and :func:`run_until_converged_telemetry`
  are the same two runs on the telemetry build of the tick: per-tick (or
  run-total) protocol counters and a flight recorder beside the same state
  trajectory, ``ticks_run`` and ``converged``.
"""

from __future__ import annotations

import dataclasses

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops.hashing import membership_fingerprint
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics, idle_inputs
from kaboodle_tpu_torch.telemetry.counters import ProtocolCounters, add_counters, zero_counters
from kaboodle_tpu_torch.telemetry.recorder import FlightRecorder, init_recorder, record_tick


def _stack(cls, rows):
    """Per-tick dataclasses of 0-d tensors -> one of ``[T]`` tensors."""
    return cls(**{f.name: torch.stack([getattr(r, f.name) for r in rows])
                  for f in dataclasses.fields(cls)})


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
    return state, _stack(TickMetrics, per_tick)


def simulate_with_telemetry(
    state: MeshState,
    inputs: TickInputs,
    cfg: SwimConfig,
    faulty: bool = True,
    recorder_len: int = 0,
) -> tuple[MeshState, TickMetrics, ProtocolCounters, FlightRecorder | None]:
    """:func:`simulate` on the telemetry build of the tick.

    Returns ``(final_state, metrics, counters, recorder)``: per-tick
    ``TickMetrics`` and ``ProtocolCounters`` stacked on ``[T]`` and, with
    ``recorder_len > 0``, a flight recorder holding the last
    ``recorder_len`` ticks (``None`` otherwise). The state trajectory is
    :func:`simulate`'s, bit for bit."""
    tick = make_tick_fn(cfg, faulty=faulty, telemetry=True)
    rec = init_recorder(recorder_len, state.n, device=state.device) if recorder_len else None
    metrics, counters = [], []
    for t in range(inputs.kill.shape[0]):
        state, out = tick(state, inputs.at(t))
        if rec is not None:
            record_tick(rec, state.tick - 1, out)
        metrics.append(out.metrics)
        counters.append(out.counters)
    return state, _stack(TickMetrics, metrics), _stack(ProtocolCounters, counters), rec


def state_agreement(state: MeshState, group=None):
    """Fingerprint agreement of ``state`` as-is, without a tick:
    ``(converged, fp_min, fp_max, n_alive)`` as in the tick's metrics.

    With a row group (``parallel/``), ``state`` is the rank's rows: the row
    fingerprints are the rank's and the agreement is all-reduced, equal on
    every rank."""
    if state.id_view is not None:
        ident = state.id_view
    else:  # every peer's identity: the columns' record hashes
        ident = C.gather_rows(state.identity, group)
    fp = membership_fingerprint(state.state > 0, ident)
    return C.fingerprint_agreement(state.alive, fp, group)


def state_converged(state: MeshState, group=None) -> bool:
    """The agreement flag alone (see :func:`state_agreement`)."""
    return bool(state_agreement(state, group)[0])


def converge_loop(state: MeshState, tick, max_ticks: int,
                  group=None) -> tuple[MeshState, int, bool]:
    """Tick with idle inputs until fingerprint agreement or ``max_ticks``.

    Returns ``(final_state, ticks_run, converged)``; convergence is judged
    on end-of-tick state, and on entry. With a row group the state is the
    rank's rows and the tick the row-sharded one: the entry test and every
    tick's agreement are the whole mesh's, so every rank stops on the same
    tick."""
    idle = idle_inputs(state.state.shape[-2], device=state.device)
    conv = state_converged(state, group)
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


def run_until_converged_telemetry(
    state: MeshState,
    cfg: SwimConfig,
    max_ticks: int = 64,
    recorder_len: int = 32,
) -> tuple[MeshState, int, bool, ProtocolCounters, FlightRecorder]:
    """:func:`run_until_converged` on the telemetry build of the tick.

    Returns ``(final_state, ticks_run, converged, totals, recorder)``:
    run-total ``ProtocolCounters`` (``add_counters`` over the ticks run) and
    the flight recorder of the last ``recorder_len`` ticks. The state,
    ``ticks_run`` and ``converged`` are the plain runner's, including the
    zero-tick return on a mesh that agrees at entry."""
    tick = make_tick_fn(cfg, faulty=False, telemetry=True)
    dev = state.device
    rec = init_recorder(recorder_len, state.n, device=dev)
    totals = zero_counters(dev)
    idle = idle_inputs(state.n, device=dev)
    conv = state_converged(state)
    ticks = 0
    while not conv and ticks < max_ticks:
        state, out = tick(state, idle)
        record_tick(rec, state.tick - 1, out)
        totals = add_counters(totals, out.counters)
        ticks += 1
        conv = bool(out.metrics.converged)
    return state, ticks, conv, totals, rec
