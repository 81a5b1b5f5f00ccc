"""Build + validate the tick graph for one static build.

``build_graph`` instantiates the op table for a ``(cfg, faulty, telemetry)``
build and validates its dataflow:

- every tick-local an op ``takes`` was ``given`` by an earlier op (the
  in-tick dataflow is a DAG in execution order);
- every tick-local is given exactly once (no ambiguous producers);
- prologue ops precede tail ops (the dispatch boundary is real);
- ``cut`` labels are unique and live on tail ops (the stage-probe
  truncation points).

The graph is pure metadata; planning (pass grouping, pruning, predicate
derivation) lives in plan.py. The port of
``kaboodle_tpu/phasegraph/graph.py``, with its checks and messages.
"""

from __future__ import annotations

import dataclasses

from kaboodle_tpu_torch.phasegraph.ops import LAYOUTS, PhaseOp, op_table


class GraphError(ValueError):
    """An op table whose declared dataflow is inconsistent."""


@dataclasses.dataclass(frozen=True)
class TickGraph:
    """One build's validated op graph, in execution order."""

    ops: tuple[PhaseOp, ...]
    faulty: bool
    telemetry: bool
    layout: str = "dense"

    def __post_init__(self) -> None:
        if self.layout not in LAYOUTS:
            raise GraphError(
                f"unknown layout {self.layout!r} (expected one of {LAYOUTS})"
            )
        given: set[str] = set()
        names: set[str] = set()
        seen_tail = False
        cuts: set[str] = set()
        for op in self.ops:
            if op.name in names:
                raise GraphError(f"duplicate op {op.name!r}")
            names.add(op.name)
            if op.stage == "tail":
                seen_tail = True
            elif seen_tail:
                raise GraphError(
                    f"{op.name}: prologue op after the dispatch boundary"
                )
            missing = op.takes - given
            if missing:
                raise GraphError(
                    f"{op.name}: takes {sorted(missing)} before any op gives them"
                )
            dup = op.gives & given
            if dup:
                raise GraphError(f"{op.name}: re-gives {sorted(dup)}")
            given |= op.gives
            if op.cut is not None:
                if op.stage != "tail":
                    raise GraphError(f"{op.name}: cut label on a prologue op")
                if op.cut in cuts:
                    raise GraphError(f"{op.name}: duplicate cut label {op.cut!r}")
                cuts.add(op.cut)

    def op(self, name: str) -> PhaseOp:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(name)

    @property
    def prologue(self) -> tuple[PhaseOp, ...]:
        return tuple(op for op in self.ops if op.stage == "prologue")

    @property
    def tail(self) -> tuple[PhaseOp, ...]:
        return tuple(op for op in self.ops if op.stage == "tail")

    @property
    def cut_labels(self) -> tuple[str, ...]:
        return tuple(op.cut for op in self.ops if op.cut is not None)


def build_graph(
    cfg, faulty: bool = True, telemetry: bool = False, layout: str = "dense"
) -> TickGraph:
    """The validated op graph for one static build.

    ``layout`` selects the plane format (``ops.LAYOUTS``): a
    ``blocked_topk`` graph carries the same op vocabulary re-fated for
    [N, K] neighbor blocks plus the ``block_repair`` tail op; dense-only
    ops survive in the table and are pruned (with reasons) by
    ``plan(graph, "sparse")``.
    """
    return TickGraph(
        ops=op_table(cfg, faulty=faulty, telemetry=telemetry, layout=layout),
        faulty=faulty,
        telemetry=telemetry,
        layout=layout,
    )
