"""KB601-KB605: the keyscope checks over per-entry provenance graphs.

The port of ``kaboodle_tpu/analysis/rng/rules.py``. Per-graph rules follow
the graftscan pass shape -- ``check(graph) -> [Finding]`` with
``ir://<entry>`` pseudo-paths and line-free symbols (one justified
baseline entry covers a finding class and survives unrelated edits).
KB602 additionally has a trace-free registry half: the port's pinned
:data:`KEYSCOPE_STREAMS` table against the live constants of
``phasegraph/rng.py`` (``stream_table``) -- double-entry bookkeeping, so a
renumbering or a swap of two ids trips the lane even when the swapped
streams still record a collision-free set -- and KB604 is a cross-entry
rule over the whole scanned set. The graphs come from
``provenance.py`` (the port's counter-RNG calls, recorded).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from kaboodle_tpu_torch.analysis.core import Finding

if TYPE_CHECKING:  # the rules read graphs; they need no torch to be imported
    from kaboodle_tpu_torch.analysis.rng.provenance import ProvenanceGraph, Sink

# The port's own copy of phasegraph/rng.py's STREAM_* registry. The two are
# compared verbatim on every rng run: ids must be dense from 0, in
# append-only order, and value-identical. A new randomized phase appends to
# BOTH (this tuple and rng.py) -- that dual edit is the mechanical form of
# rng.py's "new phases append, renumbering changes every banked run". Ids
# 0-5 are the sparse tick's (seed, cursor) streams; 6-9 are the dense
# tick's (key, tick) streams.
KEYSCOPE_STREAMS = (
    ("STREAM_PROXY", 0),
    ("STREAM_CHAIN", 1),
    ("STREAM_DRAW", 2),
    ("STREAM_PING", 3),
    ("STREAM_ACK", 4),
    ("STREAM_GOSSIP", 5),
    ("STREAM_TICK_PROXY", 6),
    ("STREAM_TICK_PING", 7),
    ("STREAM_TICK_BERN", 8),
    ("STREAM_TICK_DROP", 9),
)

_STREAMS_PATH = "rng://sparseplane.streams"


# Dense-tick stream id -> the legacy KEY_LAYOUT row name the stream
# replaced. The leap report uses this to keep naming the migrated
# (now counter-keyed) sinks by their warp rows, so WARP_TERMS joins
# survive the re-keying.
TICK_STREAM_ROWS = {6: "proxy", 7: "ping", 8: "bern", 9: "drop"}

# -- KB604: declared cross-engine fates -------------------------------------

# Entries derived from the same op graph whose key-provenance fingerprints
# (sorted sink-descriptor multisets) must be identical: bit-exactness
# between these engines is pinned by the phasegraph dryrun (the port's: python -m kaboodle_tpu_torch phasegraph), and a
# provenance divergence is the compile-time shadow of a numeric diff.
# Entries NOT grouped here have *declared* divergent fates (tick.random
# alone runs the fully randomized phase config; blocked folds per-block
# data onto the row keys -- its own group against its telemetry twin) --
# the groups are the pinned subset, and growing one is a deliberate edit.
CHAIN_GROUPS: tuple[tuple[str, tuple[str, ...]], ...] = (
    # The dense drop-matrix engines: one draw, the KEY_LAYOUT `drop` row.
    (
        "dense-drop",
        (
            "phasegraph.tick.faulty",
            "phasegraph.tick.fused",
            "phasegraph.tick.telemetry",
        ),
    ),
    # Engines whose traced config exercises no randomized phase at all:
    # a draw appearing in ONE of these is a provenance event, not a tweak.
    (
        "dense-drawfree",
        (
            "phasegraph.tick.faultfree",
            "phasegraph.tick.lean",
            "phasegraph.tick.sharded",
            "phasegraph.tick.telemetry.lean",
        ),
    ),
    (
        "blocked",
        ("phasegraph.tick.blocked", "phasegraph.tick.blocked.telemetry"),
    ),
    (
        "fleet",
        (
            "phasegraph.tick.fleet",
            "phasegraph.tick.fleet.sharded",
            "phasegraph.tick.fleet.telemetry",
        ),
    ),
    # The sparse pair must present the full six-stream counter discipline.
    (
        "sparse",
        ("phasegraph.tick.sparse", "phasegraph.tick.sparse.lean"),
    ),
    # Leap/span programs are draw-free by construction (det pick chains);
    # a sink here means the span program started consuming randomness the
    # warp classes cannot model.
    (
        "leap",
        (
            "phasegraph.leap",
            "phasegraph.leap.lean",
            "phasegraph.leap.hybrid",
            "phasegraph.leap.hybrid.lean",
            "phasegraph.leap.fleet",
            "phasegraph.leap.sharded",
        ),
    ),
    (
        "serve-step",
        (
            "phasegraph.serve.step",
            "phasegraph.serve.step.telemetry",
            "phasegraph.serve.step.sharded",
        ),
    ),
)

# -- KB605: leapability vocabulary ------------------------------------------

# KEY_LAYOUT row -> the warp signature terms (warp/horizon.py decode
# vocabulary, plus the runner's pseudo-terms) whose activity the draw
# serves. The leap report joins chain-coupled sinks to these terms so the
# why-dense histogram (warp runner ledger) and the which-draw-blocks
# worklist (this lane) speak the same names.
WARP_TERMS = {
    "proxy": ("any_a2",),  # escalation fan-out: suspicion matured
    "ping": ("probe_draw",),  # every dense tick's probe target pick
    "bern": ("any_join", "missing_alive"),  # delivery/gossip bernoulli field
    "drop": ("delivery_gate",),  # the [N, N] drop matrix (faulty builds)
    "next": (),  # the chain carry itself -- never drawn
}

CLASS_COUNTER = "counter_keyed"
CLASS_CHAIN = "chain_coupled"
CLASS_IMPURE = "impure"


def classify(sink: Sink) -> str:
    """KB605 class of one draw sink.

    ``counter_keyed`` -- provenance bottoms out ONLY in ``prng_key`` on
    argument-derived counters: the draw is a pure function of
    checkpointable ``(seed, cursor)`` state and leaps for free
    (memoization/fast-forwarding, PAPERS.md 2602.10615).
    ``chain_coupled`` -- a carried split-chain key feeds it: reproducing
    tick T's draw requires advancing the chain T times, which is exactly
    what keeps the drain seasons dense (ROADMAP item 2).
    ``impure`` -- const-rooted key material (KB603 fires separately)."""
    roots = sink.node.roots()
    if roots & {"const_key", "const_seed"}:
        return CLASS_IMPURE
    if "carried_key" in roots or not roots:
        return CLASS_CHAIN
    return CLASS_COUNTER


# -- KB601 ------------------------------------------------------------------


def _paths_exclusive(a: tuple, b: tuple) -> bool:
    """True when two sinks sit on mutually exclusive paths -- in the port,
    different recorded runs of the entry (as-is, gates forced true, gates
    forced false: the dense tick's full and fused programs, both drawing
    the ping row, run in different ones) -- so not reuse."""
    branch_a = dict(a)
    for site, bi in b:
        if site in branch_a and branch_a[site] != bi:
            return True
    return False


def check_kb601_key_reuse(graph: ProvenanceGraph) -> list[Finding]:
    """Two reachable draws on one unforked key (or one draw looped).

    Compared within each recorded run (``graph.run_sinks``): sinks of
    different runs carry different ``path`` labels and never clash."""
    out: dict[str, Finding] = {}
    by_node: dict[int, list[Sink]] = {}
    for s in graph.run_sinks or graph.sinks:
        by_node.setdefault(id(s.node), []).append(s)
    for sinks in by_node.values():
        clash = None
        for i, a in enumerate(sinks):
            for b in sinks[i + 1 :]:
                if not _paths_exclusive(a.path, b.path):
                    clash = (a, b)
                    break
            if clash:
                break
        if clash is None:
            continue
        a, b = clash
        symbol = f"reuse:{a.descr()}"
        sites = " + ".join(sorted({a.source.render(), b.source.render()}))
        out[symbol] = Finding(
            f"ir://{graph.entry}",
            "KB601",
            a.source.line,
            f"key {a.descr()} feeds two reachable draws ({sites}) without "
            "an intervening split/fold_in -- identical threefry streams; "
            "fork the key once per consumer",
            symbol,
        )
    for s in graph.run_sinks or graph.sinks:
        if not s.looped:
            continue
        symbol = f"looped:{s.descr()}"
        if symbol in out:
            continue
        out[symbol] = Finding(
            f"ir://{graph.entry}",
            "KB601",
            s.source.line,
            f"loop-invariant key {s.descr()} drawn inside a loop "
            f"({s.source.render()}) -- every iteration redraws the same "
            "stream; fold the iteration counter in first",
            symbol,
        )
    return list(out.values())


# -- KB602 ------------------------------------------------------------------


def check_kb602_stream_collision(graph: ProvenanceGraph) -> list[Finding]:
    """Two folds of one constant onto the same canonical parent.

    Grouping is by parent *descriptor*, one fold per call site: two
    separate ``stream_key`` chains folding one id are two sites that only a
    canonical-name grouping can see side by side."""
    out: dict[str, Finding] = {}
    seen: dict[tuple, list] = {}
    for f in graph.folds:
        if f.const is None or not f.parents:
            continue
        seen.setdefault((f.parents[0].descr(), f.const), []).append(f)
    for (parent_descr, const), folds in seen.items():
        if len(folds) < 2:
            continue
        sites = " + ".join(
            sorted({f.src.render() for f in folds if f.src is not None})
        )
        symbol = f"collide:{parent_descr}:{const}"
        out[symbol] = Finding(
            f"ir://{graph.entry}",
            "KB602",
            folds[0].src.line if folds[0].src else 0,
            f"fold_in constant {const} applied to {parent_descr} at "
            f"{len(folds)} distinct sites ({sites}) -- colliding streams "
            "draw identical randomness; give each phase its own STREAM_* id",
            symbol,
        )
    # Stream-position folds (literal fold onto a counter-seed chain) must
    # use registered ids: an unregistered constant is a phase drawing off
    # the books.
    registered = {v for _, v in KEYSCOPE_STREAMS}
    for f in graph.folds:
        if f.const is None or not f.parents:
            continue
        parent = f.parents[0]
        if parent.kind != "fold" or "counter_seed" not in parent.roots():
            continue
        if f.const in registered:
            continue
        symbol = f"unregistered:{f.const}"
        if symbol in out:
            continue
        out[symbol] = Finding(
            f"ir://{graph.entry}",
            "KB602",
            f.src.line if f.src else 0,
            f"counter-chain fold_in constant {f.const} "
            f"({f.src.render() if f.src else '<unknown>'}) is not a "
            "registered STREAM_* id -- append it to phasegraph/rng.py AND "
            "the KEYSCOPE_STREAMS table of analysis/rng/rules.py",
            symbol,
        )
    return list(out.values())


def check_kb602_stream_registry() -> list[Finding]:
    """The pinned table vs the live phasegraph.rng constants (trace-free).

    Ids must be dense from 0 in append-only order and value-identical to
    ``KEYSCOPE_STREAMS`` -- a swap keeps the draws collision-free and the
    id set unchanged, so only this double-entry comparison catches it."""
    from kaboodle_tpu_torch.phasegraph.rng import stream_table

    out: list[Finding] = []
    live = stream_table()
    pinned = dict(KEYSCOPE_STREAMS)
    for name, want in KEYSCOPE_STREAMS:
        got = live.get(name)
        if got != want:
            out.append(Finding(
                _STREAMS_PATH, "KB602", 0,
                f"{name} is {got!r} live but pinned {want} in KEYSCOPE_STREAMS "
                "-- stream ids renumber banked draws; ids append, they never move",
                f"drift:{name}",
            ))
    for name in sorted(set(live) - set(pinned)):
        out.append(Finding(
            _STREAMS_PATH, "KB602", 0,
            f"live stream {name}={live[name]} is not in the KEYSCOPE_STREAMS "
            "table -- append it (new phases append to both ledgers)",
            f"unpinned:{name}",
        ))
    ids = sorted(live.values())
    if ids != list(range(len(ids))):
        out.append(Finding(
            _STREAMS_PATH, "KB602", 0,
            f"live STREAM_* ids {ids} are not dense from 0 -- gaps or "
            "duplicates mean a collision or a renumbering hazard",
            "not-dense",
        ))
    return out


# -- KB603 ------------------------------------------------------------------


def check_kb603_resume_impurity(graph: ProvenanceGraph) -> list[Finding]:
    """Draws whose provenance does not bottom out in entry arguments.

    A ``const_seed`` (``prng_key(0)`` made inside the call) or ``const_key``
    root means the draw replays identically on every resume regardless of
    the checkpoint -- the exact property sparseplane's counter discipline
    exists to prevent, and a hard gate for item 2's per-row re-keying."""
    out: dict[str, Finding] = {}
    for s in graph.sinks:
        bad = s.node.roots() & {"const_key", "const_seed"}
        if not bad:
            continue
        symbol = f"impure:{s.descr()}"
        if symbol in out:
            continue
        out[symbol] = Finding(
            f"ir://{graph.entry}",
            "KB603",
            s.source.line,
            f"draw {s.descr()} ({s.source.render()}) roots in "
            f"{sorted(bad)} -- key material baked into the program, not the "
            "checkpointable state planes; thread it through the entry "
            "arguments (state key or (seed, cursor) counters)",
            symbol,
        )
    return list(out.values())


# -- KB604 ------------------------------------------------------------------


def check_kb604_chain_divergence(graphs: dict[str, ProvenanceGraph]) -> list[Finding]:
    """Pinned-isomorphic engine groups must fingerprint identically.

    Runs over whatever subset of the registry was scanned; a group with
    fewer than two present members is skipped (scoped ``--entries`` runs
    stay meaningful)."""
    out: list[Finding] = []
    for group_name, members in CHAIN_GROUPS:
        present = [m for m in members if m in graphs]
        if len(present) < 2:
            continue
        ref_name = present[0]
        ref = graphs[ref_name].sink_descrs()
        for other in present[1:]:
            got = graphs[other].sink_descrs()
            if got == ref:
                continue
            missing = sorted(set(ref) - set(got))
            extra = sorted(set(got) - set(ref))
            delta = []
            if missing:
                delta.append(f"missing {missing}")
            if extra:
                delta.append(f"extra {extra}")
            out.append(
                Finding(
                    f"ir://{other}",
                    "KB604",
                    0,
                    f"provenance diverges from '{ref_name}' within pinned "
                    f"group '{group_name}': {'; '.join(delta) or 'multiset mismatch'} "
                    "-- engines derived from one op graph must fork keys "
                    "identically wherever bit-exactness is pinned",
                    f"diverge:{group_name}",
                )
            )
    return out


PER_GRAPH_CHECKS = (
    check_kb601_key_reuse,
    check_kb602_stream_collision,
    check_kb603_resume_impurity,
)
