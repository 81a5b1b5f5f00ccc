"""Device-mesh sharding for the simulator (the port's scale-out layer).

The JAX package's names (``kaboodle_tpu/parallel/__init__.py``), plus the
port's :func:`gather_state`. Names resolve on first access (PEP 562):
``phasegraph/exec.py`` imports ``parallel.collectives``, and an eager
import of ``mesh`` here would close an import cycle through ``sim``.
"""

import importlib

_MESH = "kaboodle_tpu_torch.parallel.mesh"
_LAZY = {
    name: _MESH
    for name in (
        "PEER_AXIS",
        "constrain_state",
        "gather_state",
        "inputs_specs",
        "make_mesh",
        "make_multihost_mesh",
        "make_sharded_tick",
        "row_matrix_sharding",
        "run_until_converged_sharded",
        "sharded_convergence_check",
        "shard_inputs",
        "shard_state",
        "simulate_sharded",
        "state_specs",
    )
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
