"""The row-blocked tick under its historical import path (see phasegraph/blocked.py)."""

from kaboodle_tpu_torch.phasegraph.blocked import make_chunked_tick_fn

__all__ = ["make_chunked_tick_fn"]
