"""Derived tick builds: each engine the port runs, built from the one tick.

The port of ``kaboodle_tpu/phasegraph/derive.py``. Every builder wraps a
function the port already has, so the protocol exists once, under
``phasegraph/``:

==========  ==============================================================
engine      derivation
==========  ==============================================================
dense       ``exec.py``'s full and fused programs under the per-tick
            dispatch (``make_dense_tick``); ``make_fused_tick`` is the
            fused program alone
chunked     the row-blocked program (``make_chunked_tick`` -> blocked.py)
fleet       the dense tick over a leading ensemble axis
            (``make_fleet_tick``): the same tick function given ``[E, ...]``
            leaves, full program only
warp        the span program: k (near-)quiescent ticks as one batched pass
            (``make_warp_leap`` -> span.py)
==========  ==============================================================

The JAX package's ``sharded``, ``serve`` and ``sparse`` engines are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph.blocked import make_chunked_tick_fn
from kaboodle_tpu_torch.phasegraph.exec import PALLAS_BATCH_ERROR, make_tick_fn
from kaboodle_tpu_torch.phasegraph.span import make_leap_fn

# The engines this module builds (the JAX package's names).
ENGINES = ("dense", "fused", "chunked", "fleet", "warp")


def make_dense_tick(cfg: SwimConfig, faulty: bool = True, telemetry: bool = False) -> Callable:
    """The production dense tick: full + fused programs, per-tick dispatch."""
    return make_tick_fn(cfg, faulty=faulty, telemetry=telemetry)


def make_fused_tick(cfg: SwimConfig, faulty: bool = True, telemetry: bool = False) -> Callable:
    """The fused program alone, with no dispatch guard: the caller owns the
    precondition that no tick has a Join broadcast or suspicion activity."""
    return make_tick_fn(cfg, faulty=faulty, telemetry=telemetry, program="fused")


def make_chunked_tick(
    cfg: SwimConfig,
    faulty: bool = True,
    block: int = 1024,
    drop: bool = True,
    boot_union: bool = False,
    telemetry: bool = False,
) -> Callable:
    """The row-blocked (O(block·N)-transient) derivation."""
    return make_chunked_tick_fn(cfg, faulty=faulty, block=block, drop=drop,
                                boot_union=boot_union, telemetry=telemetry)


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


def make_warp_leap(cfg: SwimConfig, k: int, hybrid: bool = False, masked: bool = False) -> Callable:
    """The span / hybrid program: k (near-)quiescent ticks as one pass.

    ``hybrid=True`` is the near-quiescent program (strict span + sterile
    anti-entropy); ``masked=True`` takes a per-member span length
    ``k_m <= k``, so one call advances an ensemble to per-member horizons."""
    return make_leap_fn(cfg, k, hybrid=hybrid, masked=masked)
