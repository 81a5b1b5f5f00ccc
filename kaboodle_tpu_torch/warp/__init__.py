"""Signature-classed event-horizon fast-forward (warp), ported to PyTorch.

The port of ``kaboodle_tpu/warp/``: ``horizon.py`` finds event-free spans
and classes each span's entry state by an on-device activity signature
(one int32[4] fetch); ``leap.py`` / ``phasegraph/span.py`` replay a span
as one batched pass (the strict program under full quiescence, the hybrid
program on armed-timer drain windows up to the earliest expiry), bit-exact
with the dense tick either way; ``runner.py`` interleaves leaps with dense
ticks (one mesh, and the fleet with per-member horizons in one masked
call), with a bounded program cache and a span memo.
"""

from kaboodle_tpu_torch.warp.horizon import (
    ActivityClass,
    decode_signature,
    earliest_timer_expiry,
    make_expiry_fn,
    make_quiescence_fn,
    make_signature_fn,
    next_static_event,
    static_event_ticks,
)
from kaboodle_tpu_torch.warp.leap import make_leap_fn
from kaboodle_tpu_torch.warp.runner import (
    WarpLedger,
    fleet_quiescence_mask,
    fleet_signature,
    leap_cache,
    run_fleet_warped,
    run_warped,
    simulate_warped,
)

__all__ = [
    "ActivityClass",
    "decode_signature",
    "earliest_timer_expiry",
    "make_expiry_fn",
    "make_quiescence_fn",
    "make_signature_fn",
    "next_static_event",
    "static_event_ticks",
    "make_leap_fn",
    "WarpLedger",
    "fleet_quiescence_mask",
    "fleet_signature",
    "leap_cache",
    "run_fleet_warped",
    "run_warped",
    "simulate_warped",
]
