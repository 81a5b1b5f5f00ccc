"""fleet -- batched ensemble simulation with on-device Monte Carlo statistics.

The port of ``kaboodle_tpu/fleet``: E independent SWIM meshes stacked along
a leading ``[E]`` axis, advanced in lockstep by the dense tick over that
axis, with convergence statistics computed as device reductions. See
fleet/core.py for the design, fleet/stats.py for the statistics and
fleet/bench.py for the sweep and fleet/sharding.py for the ensemble and
``E x peers`` meshes.

Exports resolve lazily (PEP 562), as in the JAX package: ``from
kaboodle_tpu_torch.fleet import X`` loads the owning submodule on first
access.
"""

import importlib

_EXPORTS = {
    # core
    "FleetState": "core",
    "fleet_converge_loop": "core",
    "fleet_idle_inputs": "core",
    "init_fleet": "core",
    "make_fleet_tick_fn": "core",
    "member_state": "core",
    "run_fleet_until_converged": "core",
    "scan_axis_first": "core",
    "simulate_fleet": "core",
    "stack_member_inputs": "core",
    # sharding
    "ENSEMBLE_AXIS": "sharding",
    "fleet_inputs_specs": "sharding",
    "fleet_state_specs": "sharding",
    "fleet_vector_sharding": "sharding",
    "gather_fleet": "sharding",
    "make_fleet_constrainer": "sharding",
    "make_fleet_mesh": "sharding",
    "make_sharded_fleet_tick": "sharding",
    "run_fleet_until_converged_sharded": "sharding",
    "shard_fleet": "sharding",
    "shard_fleet_inputs": "sharding",
    "simulate_fleet_sharded": "sharding",
    # stats
    "agree_fraction_trajectory": "stats",
    "convergence_quantiles": "stats",
    "knob_marginals": "stats",
    "knob_quantiles": "stats",
    "survival_curve": "stats",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'kaboodle_tpu_torch.fleet' has no attribute {name!r}"
        ) from None
    return getattr(importlib.import_module(f"kaboodle_tpu_torch.fleet.{submodule}"), name)


def __dir__():
    return __all__
