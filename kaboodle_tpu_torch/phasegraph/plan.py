"""The planner: compose one tick graph into a derived engine's pass program.

``plan(graph, mode)`` groups the graph's ops into the passes one engine
executes:

- ``full`` — one pass per cond-gated phase, the multi-pass program every
  engine ran before the phase graph existed. This is the reference shape:
  rare-phase ops keep their in-graph activity gates, and each gate that
  carries (S, T) through an identity branch costs a materialized sweep.
- ``fused`` — the 2-pass steady-tick program. Ops with ``mask_rank == 2``
  cannot fold (their write masks need [N, N] intermediates), so the
  planner *prunes* them and derives the **dispatch predicate** from their
  ``pred_term`` declarations: the fused program is only taken on ticks
  where every pruned op is provably inactive. The surviving tail ops fold
  into a draw pass (the A3 target draw) and ONE update pass whose masks
  compose into a single elementwise where chain — no gated identity
  branches, so the whole update is one composed write.
- ``span`` — the warp-leap derivation: inside a quiescent span every op
  whose span fate is ``invariant`` is pruned (horizon.py's quiescence
  predicate conjoins exactly these invariance conditions), ``degenerate``
  ops collapse to the timer-restamp / latency-decay / ledger-fixed-point
  forms, and the leap batches the k surviving draws as one scan.
- ``hybrid`` — the Warp 2.0 near-quiescent derivation: ops whose hybrid
  fate is ``invariant`` are pruned and their ``sig_term`` declarations
  flow into ``pred_terms`` — the activity-signature bits
  (warp/horizon.py) that must be clear for the hybrid span to be exact.
  ``sterile`` ops (anti-entropy) survive in a membership-moving-free
  closed form: timer marks + the kpr ledger carry, provably zero inserts
  under the signature's sterility bits. Everything a strict span runs,
  the hybrid span runs too — a strictly-quiescent state is just the
  hybrid class with no armed timers and agreed fingerprints, so the
  hybrid program is a strict superset that degenerates bit-exactly.
- ``blocked`` — the chunked derivation: the full pass order, each [N, N]
  pass re-expressed as a loop over row blocks (layout, not logic).
- ``sparse`` — the blocked_topk-layout derivation: dense-only ops (sparse
  fate ``absent``) are pruned with reasons, the surviving tail ops group
  into the six sparse passes (expiry / draw / exchange / gossip / repair /
  finish) the [N, K] kernel executes (sparseplane/kernel.py). Requires a
  graph built with ``layout="blocked_topk"``; conversely every other mode
  requires the dense layout.

The executable engines check themselves against these programs at build
(exec.py, blocked.py, span.py, sparseplane/kernel.py and the warp
signature each refuse a plan they have no bodies for), so op presence, pass
grouping, the dispatch predicate, the stage-probe cut labels and the
telemetry pass labels all have one source of truth. The port of
``kaboodle_tpu/phasegraph/plan.py``, plan for plan and error for error.
"""

from __future__ import annotations

import dataclasses

from kaboodle_tpu_torch.phasegraph.graph import GraphError, TickGraph
from kaboodle_tpu_torch.phasegraph.ops import PhaseOp

MODES = ("full", "fused", "span", "blocked", "hybrid", "sparse")


@dataclasses.dataclass(frozen=True)
class Pass:
    """One executable pass: a named group of ops applied together.

    In the fused program a multi-op pass means the ops' write masks are
    FOLDED into one composed elementwise chain (legal only when every op
    has ``mask_rank == 1``); in the full/blocked programs passes execute
    sequentially with their own activity gates.
    """

    name: str
    ops: tuple[PhaseOp, ...]

    @property
    def op_names(self) -> tuple[str, ...]:
        return tuple(op.name for op in self.ops)


@dataclasses.dataclass(frozen=True)
class TickProgram:
    """One derived engine's composed program.

    ``prologue``/``tail`` are the planned pass lists; ``pruned`` maps each
    statically-or-predicate-excluded op to the reason it is absent;
    ``pred_terms`` (fused mode) are the activity symbols whose disjunction
    forms the dispatch predicate — derived from the pruned ops, so adding
    a new rare-phase op to the graph automatically extends the predicate
    that keeps the fused program exact.
    """

    mode: str
    prologue: tuple[Pass, ...]
    tail: tuple[Pass, ...]
    pruned: tuple[tuple[str, str], ...] = ()
    pred_terms: tuple[str, ...] = ()

    @property
    def passes(self) -> tuple[Pass, ...]:
        return self.prologue + self.tail

    def op_names(self) -> tuple[str, ...]:
        return tuple(op.name for p in self.passes for op in p.ops)

    def pass_of(self, op_name: str) -> str:
        for p in self.passes:
            if op_name in p.op_names:
                return p.name
        raise KeyError(op_name)

    def describe(self) -> dict:
        """JSON-able program summary (telemetry trace slices, docs, CLI)."""
        return {
            "mode": self.mode,
            "passes": [
                {"name": p.name, "stage": "prologue" if p in self.prologue else "tail",
                 "ops": list(p.op_names)}
                for p in self.passes
            ],
            "pruned": [{"op": name, "reason": why} for name, why in self.pruned],
            "pred_terms": list(self.pred_terms),
        }


def _single_passes(ops) -> tuple[Pass, ...]:
    return tuple(Pass(op.name, (op,)) for op in ops)


def _plan_full(graph: TickGraph) -> TickProgram:
    return TickProgram(
        mode="full",
        prologue=_single_passes(graph.prologue),
        tail=_single_passes(graph.tail),
    )


def _plan_fused(graph: TickGraph) -> TickProgram:
    pruned: list[tuple[str, str]] = []
    pred: list[str] = []
    draw: list[PhaseOp] = []
    update: list[PhaseOp] = []
    for op in graph.tail:
        if op.mask_rank == 2:
            if op.pred_term is None:
                raise GraphError(
                    f"{op.name}: mask_rank 2 but no pred_term — the op can "
                    "neither fold nor be excluded by the dispatch predicate"
                )
            pruned.append((op.name, f"excluded by dispatch pred ({op.pred_term})"))
            if op.pred_term not in pred:
                pred.append(op.pred_term)
        elif op.gives & {"ping_tgt", "has_ping"}:
            draw.append(op)
        else:
            update.append(op)
    if not draw or not update:
        raise GraphError("fused plan needs a draw op and at least one update op")
    return TickProgram(
        mode="fused",
        prologue=_single_passes(graph.prologue),
        tail=(Pass("draw", tuple(draw)), Pass("update", tuple(update))),
        pruned=tuple(pruned),
        pred_terms=tuple(pred),
    )


def _plan_span(graph: TickGraph) -> TickProgram:
    if graph.faulty:
        raise GraphError(
            "span programs derive from fault-free graphs: a quiescent span "
            "carries no scheduled events by definition (horizon.py)"
        )
    pruned: list[tuple[str, str]] = []
    live: list[PhaseOp] = []
    refresh: list[PhaseOp] = []
    ledger: list[PhaseOp] = []
    for op in graph.ops:
        if op.span == "invariant":
            pruned.append((op.name, "span fixed point (quiescence predicate)"))
        elif op.span == "live":
            live.append(op)
        elif op.name in ("call1", "call2"):
            refresh.append(op)
        else:
            # anti_entropy / counters / finish degenerate to once-per-span
            # closed forms: the ledger fixed point, leap_counters, tick+k.
            ledger.append(op)
    return TickProgram(
        mode="span",
        prologue=(),
        tail=(
            Pass("draw", tuple(live)),
            Pass("refresh", tuple(refresh)),
            Pass("ledger", tuple(ledger)),
        ),
        pruned=tuple(pruned),
    )


def _plan_hybrid(graph: TickGraph) -> TickProgram:
    if graph.faulty:
        raise GraphError(
            "hybrid programs derive from fault-free graphs: a near-quiescent "
            "span carries no scheduled events by definition (horizon.py)"
        )
    pruned: list[tuple[str, str]] = []
    pred: list[str] = []
    live: list[PhaseOp] = []
    refresh: list[PhaseOp] = []
    sterile: list[PhaseOp] = []
    ledger: list[PhaseOp] = []
    for op in graph.ops:
        if op.hybrid == "invariant":
            why = (
                f"excluded by signature bit ({op.sig_term})"
                if op.sig_term is not None
                else "span fixed point (signature sterility terms)"
            )
            pruned.append((op.name, why))
            if op.sig_term is not None and op.sig_term not in pred:
                pred.append(op.sig_term)
        elif op.hybrid == "sterile":
            sterile.append(op)
        elif op.name in ("call1", "call2"):
            refresh.append(op)
        elif op.span == "live":
            live.append(op)
        else:
            # finish (and counters in telemetry graphs) degenerate to
            # once-per-span closed forms, as in the strict span plan.
            ledger.append(op)
    return TickProgram(
        mode="hybrid",
        prologue=(),
        tail=(
            Pass("draw", tuple(live)),
            Pass("refresh", tuple(refresh)),
            Pass("ae", tuple(sterile)),
            Pass("ledger", tuple(ledger)),
        ),
        pruned=tuple(pruned),
        pred_terms=tuple(pred),
    )


def _plan_blocked(graph: TickGraph) -> TickProgram:
    full = _plan_full(graph)
    return dataclasses.replace(full, mode="blocked")


# Per-op pruning reasons for dense-only ops in a blocked_topk graph; ops
# not listed fall back to the generic reason.
_SPARSE_PRUNE_REASONS = {
    "delivery_gate": "counter-draw bernoullis replace the materialized [N, N] gate",
    "manual_targets": "manual pings have no blocked surface yet",
}

# Tail pass each sparse-surviving op belongs to, in kernel execution order.
# A new tail op declared sparse != "absent" MUST be added here — the
# planner refuses to guess, so kernel/plan drift is a build error.
_SPARSE_TAIL_GROUPS = (
    ("expiry", ("suspicion",)),
    ("draw", ("probe_draw",)),
    ("exchange", ("call1", "call2", "calls34")),
    ("gossip", ("anti_entropy",)),
    ("repair", ("block_repair",)),
    ("finish", ("finish",)),
)


def _plan_sparse(graph: TickGraph) -> TickProgram:
    if graph.layout != "blocked_topk":
        raise GraphError(
            "sparse programs derive from blocked_topk graphs: "
            "build_graph(cfg, layout='blocked_topk')"
        )
    pruned: list[tuple[str, str]] = []
    prologue: list[PhaseOp] = []
    group_of = {op: name for name, ops in _SPARSE_TAIL_GROUPS for op in ops}
    grouped: dict[str, list[PhaseOp]] = {name: [] for name, _ in _SPARSE_TAIL_GROUPS}
    for op in graph.ops:
        if op.sparse == "absent":
            pruned.append((
                op.name,
                _SPARSE_PRUNE_REASONS.get(
                    op.name, "dense-only op (sparse fate 'absent')"
                ),
            ))
        elif op.stage == "prologue":
            prologue.append(op)
        elif op.name not in group_of:
            raise GraphError(
                f"{op.name}: sparse fate {op.sparse!r} but no sparse tail "
                "pass claims it (_SPARSE_TAIL_GROUPS)"
            )
        else:
            grouped[group_of[op.name]].append(op)
    tail = tuple(
        Pass(name, tuple(grouped[name]))
        for name, _ in _SPARSE_TAIL_GROUPS
        if grouped[name]
    )
    return TickProgram(
        mode="sparse",
        prologue=_single_passes(prologue),
        tail=tail,
        pruned=tuple(pruned),
    )


def plan(graph: TickGraph, mode: str) -> TickProgram:
    """Compose ``graph`` into the given engine mode's program."""
    if mode not in MODES:
        raise ValueError(f"unknown plan mode {mode!r} (expected one of {MODES})")
    if mode != "sparse" and graph.layout != "dense":
        raise GraphError(
            f"{mode} programs derive from dense-layout graphs; a "
            "blocked_topk graph plans only with mode='sparse'"
        )
    return {
        "full": _plan_full,
        "fused": _plan_fused,
        "span": _plan_span,
        "blocked": _plan_blocked,
        "hybrid": _plan_hybrid,
        "sparse": _plan_sparse,
    }[mode](graph)
