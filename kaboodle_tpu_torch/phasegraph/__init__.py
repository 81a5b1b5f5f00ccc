"""Phase-graph tick IR: one op graph, the planner, and the engines built from it.

The SWIM tick is declared once as a graph of phase ops
(:mod:`~kaboodle_tpu_torch.phasegraph.ops`), each declaring the state
fields it reads and writes, the tick-local values it gives and takes, and
the activity that gates its work. The planner
(:mod:`~kaboodle_tpu_torch.phasegraph.plan`) composes the graph per build
into the program of one engine (``full``, ``fused``, ``span``, ``hybrid``,
``blocked``, ``sparse``), as the JAX package's planner does, plan for plan.

The executable engines check themselves against their planned programs
when they are built: the dense tick (``exec.py``: full + fused under the
per-tick dispatch, its predicate and its stage-probe cuts read off the
plans), the row-blocked tick (``blocked.py``), the leap (``span.py``), the
sparse tick (``sparseplane/kernel.py``) and the warp signature
(``warp/horizon.py``). Importing this package imports the metadata only:
no torch.
"""

from kaboodle_tpu_torch.phasegraph.graph import TickGraph, build_graph
from kaboodle_tpu_torch.phasegraph.ops import PhaseOp
from kaboodle_tpu_torch.phasegraph.plan import Pass, TickProgram, plan

__all__ = [
    "PhaseOp",
    "TickGraph",
    "build_graph",
    "Pass",
    "TickProgram",
    "plan",
]
