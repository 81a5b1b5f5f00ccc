"""The warp leap under its historical import path (see phasegraph/span.py)."""

from kaboodle_tpu_torch.phasegraph.span import make_leap_fn

__all__ = ["make_leap_fn"]
