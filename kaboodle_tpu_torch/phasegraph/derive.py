"""Derived tick builds: the ensemble (fleet) tick.

The port of ``kaboodle_tpu/phasegraph/derive.py::make_fleet_tick``. In the
JAX package the fleet tick is ``jax.vmap`` of the dense tick; here it is
the same tick function (``phasegraph/exec.py::make_tick_fn``) given states
whose leaves carry a leading ``[E]`` axis -- no second copy of the
protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph.exec import PALLAS_BATCH_ERROR, make_tick_fn


def make_fleet_tick(
    cfg: SwimConfig, faulty: bool = True, telemetry: bool = False
) -> Callable:
    """The dense tick over the leading ensemble axis, full program only.

    ``fast_path=False``, as in the JAX package: the dispatch would run the
    full program for the whole ensemble whenever any member needs it, which
    on fault scenarios is nearly every tick; the dispatch is bit-exact by
    contract, so member trajectories are unchanged. The hand kernels take
    one mesh, so a config with a ``use_pallas_*`` flag on is refused here
    with the JAX package's ``ValueError``."""
    if cfg.use_pallas_fp or cfg.use_pallas_oldest_k or cfg.use_pallas_suspicion:
        raise ValueError(PALLAS_BATCH_ERROR)
    return make_tick_fn(dataclasses.replace(cfg, fast_path=False), faulty=faulty,
                        program="full", telemetry=telemetry)
