"""Fixed-length and convergence-bounded runs of the blocked-sparse tick.

The port of ``kaboodle_tpu/sparseplane/runner.py``:

- :func:`simulate_sparse` runs the tick over inputs stacked along a leading
  ``[T]`` axis (the JAX ``lax.scan``, a Python loop here) and returns the
  final state plus the per-tick metrics stacked on ``[T]``;
- :func:`run_sparse_until_converged` ticks a fault-free mesh until
  fingerprint agreement (the JAX ``lax.while_loop``), checked on entry too,
  so a mesh converged at entry runs zero ticks. One host fetch a tick: the
  agreement flag.

Each built tick is cached per ``(cfg, spec, faulty)``; a miss counts as a
program built in ``serve/pool.py::program_builds``, which is what the
dryrun's and the bench's ``compiles_steady`` read. Both runs take the
state (and inputs) to the card unless ``device`` names another.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops.hashing import fingerprint_agreement
from kaboodle_tpu_torch.sim.state import resolve_device
from kaboodle_tpu_torch.sparseplane.kernel import make_sparse_tick_fn
from kaboodle_tpu_torch.sparseplane.state import (
    SparseSpec,
    SparseState,
    SparseTickInputs,
    SparseTickMetrics,
    sparse_fingerprint,
    sparse_idle_inputs,
)


@functools.lru_cache(maxsize=None)
def sparse_tick_program(cfg: SwimConfig, spec: SparseSpec, faulty: bool):
    """The built sparse tick of ``(cfg, spec, faulty)``, built once a process."""
    return make_sparse_tick_fn(cfg, spec, faulty)


def sparse_converged(state: SparseState) -> torch.Tensor:
    """Alive rows agree on one membership fingerprint (0-d bool tensor)."""
    return fingerprint_agreement(state.alive, sparse_fingerprint(state))[0]


def simulate_sparse(
    state: SparseState,
    inputs: SparseTickInputs,
    cfg: SwimConfig,
    spec: SparseSpec,
    faulty: bool = True,
    device=None,
) -> tuple[SparseState, SparseTickMetrics]:
    """Run the sparse tick over ``inputs`` stacked along [T]; metrics stacked on [T]."""
    dev = resolve_device(device)
    tick = sparse_tick_program(cfg, spec, faulty)
    state, inputs = state.to(dev), inputs.to(dev)
    per_tick = []
    for t in range(inputs.kill.shape[0]):
        state, m = tick(state, inputs.at(t))
        per_tick.append(m)
    return state, SparseTickMetrics(**{
        f.name: torch.stack([getattr(m, f.name) for m in per_tick])
        for f in dataclasses.fields(SparseTickMetrics)})


def run_sparse_until_converged(
    state: SparseState,
    cfg: SwimConfig,
    spec: SparseSpec,
    max_ticks: int,
    device=None,
) -> tuple[SparseState, int, bool]:
    """Idle-tick a fault-free mesh until fingerprint agreement.

    Returns Python ``(state, ticks_run, converged)`` like
    ``sim.runner.run_until_converged``; a mesh converged at entry runs zero
    ticks."""
    dev = resolve_device(device)
    tick = sparse_tick_program(cfg, spec, False)
    state = state.to(dev)
    idle = sparse_idle_inputs(state.n, device=dev)
    conv = bool(sparse_converged(state))
    ticks = 0
    while not conv and ticks < max_ticks:
        state, m = tick(state, idle)
        ticks += 1
        conv = bool(m.converged)
    return state, ticks, conv
