"""The lockstep SWIM simulator: state, the tick, runs and scenarios.

Names resolve on first access (PEP 562): ``phasegraph.exec`` imports
``sim.state``, which runs this ``__init__``, so importing the runner here
eagerly would close an import cycle.
"""

import importlib

_LAZY = {
    "MeshState": "kaboodle_tpu_torch.sim.state",
    "TickInputs": "kaboodle_tpu_torch.sim.state",
    "TickMetrics": "kaboodle_tpu_torch.sim.state",
    "init_state": "kaboodle_tpu_torch.sim.state",
    "idle_inputs": "kaboodle_tpu_torch.sim.state",
    "make_tick_fn": "kaboodle_tpu_torch.sim.kernel",
    "make_chunked_tick_fn": "kaboodle_tpu_torch.sim.chunked",
    "simulate": "kaboodle_tpu_torch.sim.runner",
    "run_until_converged": "kaboodle_tpu_torch.sim.runner",
    "simulate_with_telemetry": "kaboodle_tpu_torch.sim.runner",
    "run_until_converged_telemetry": "kaboodle_tpu_torch.sim.runner",
    "state_agreement": "kaboodle_tpu_torch.sim.runner",
    "Scenario": "kaboodle_tpu_torch.sim.scenario",
    "baseline_scenario": "kaboodle_tpu_torch.sim.scenario",
    "all_fault_paths_scenario": "kaboodle_tpu_torch.sim.scenario",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
