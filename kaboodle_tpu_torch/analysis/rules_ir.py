"""KB405 -- the compile-surface budget, the documentation.

The port of the KB405 entry of ``kaboodle_tpu/analysis/rules_ir.py``, for
``--explain KB405`` and ``--list-rules``, with a no-op check (the gate
itself runs under ``python -m kaboodle_tpu_torch.analysis --ir``, from
``analysis/ir/surface.py``). KB401-KB404 walk jaxprs, which the port does
not have: they are not ported.
"""

from __future__ import annotations

from kaboodle_tpu_torch.analysis.core import rule


def _ir_only(mod):
    """KB405 runs the scripted exercise (analysis/ir/surface.py), never on source files."""
    return []


rule(
    "KB405",
    "compile-surface budget exceeded (rebuild debt gate)",
    """
Memoization-based simulators get their speed from a small, stable set of
built programs: warp spans leap through O(log max_span) power-of-two
programs, a lane pool serves every admission mix with one program set. This
rule runs the scripted dense+warp+fleet+serve+sparse exercise
(analysis/ir/surface.py) in a fresh process, counts the programs each
entry-point family builds (misses of the program caches that
`serve.pool.program_builds` counts), and compares them with the committed
`kaboodle_tpu_torch/analysis/ir/surface.json`.

A count above the committed budget is a rebuild regression -- a spurious
cache key, a span-chunking policy that degraded to one program per span
length -- and fails the gate. Raising a committed count requires editing
the budget file WITH a justification; under `--no-baseline-growth` a count
*below* the budget also fails until the smaller number is committed, so
the file is a shrink-only record of how many programs the hot paths may
cost.
""",
)(_ir_only)
