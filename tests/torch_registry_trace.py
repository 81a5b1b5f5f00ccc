"""One CPU trace of the whole entry-point registry, shared by the IR and rng
lane tests (``test_torch_graftscan.py``, ``test_torch_keyscope.py``) when
they run in one process: each entry's three recorded runs, read by both
lanes (``kaboodle_tpu_torch/analysis/ir/scan.py::trace_registry``)."""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def registry_results() -> dict:
    """``{entry name: EntryResult}`` of every registry entry on the CPU: the
    sharded ones' IR findings from one gloo job of 8 ranks, their graphs
    from one of 1 (as ``python -m kaboodle_tpu_torch.analysis --all``)."""
    from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS
    from kaboodle_tpu_torch.analysis.ir.scan import trace_registry

    return trace_registry(ENTRY_POINTS, "cpu", rng=True)
