"""The dense SWIM tick under its historical import path (see phasegraph/exec.py)."""

from kaboodle_tpu_torch.phasegraph.exec import make_tick_fn

__all__ = ["make_tick_fn"]
