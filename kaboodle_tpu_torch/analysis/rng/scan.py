"""The keyscope driver: trace, build provenance, rule, bank the leap report.

The port of ``kaboodle_tpu/analysis/rng/scan.py``. :func:`run_rng_scan`
traces every selected registry entry (the IR lane's trace,
``analysis/ir/scan.py::trace_registry``, with the counter-RNG calls
recorded), builds its key-provenance graph, runs the per-graph KB601-KB603
checks, the trace-free KB602 registry comparison and the cross-entry KB604
fingerprint check, and returns ALL findings pre-baseline so the CLI
applies the shared shrink-only plumbing.

The leap report (KB605's artifact, :func:`build_leap_report`) is a
deterministic JSON in the JAX schema (``kaboodle-keyscope-leap/1``)
classifying every draw sink of every engine -- site, shape, leapability
class, ``KEY_LAYOUT`` row, warp signature terms, draw bytes -- joined with
the port's committed costscope ``bytes_accessed`` per entry.
:func:`leap_findings` gates its freshness against the committed
``kaboodle_tpu_torch/analysis/rng/leap.json``. The port's report equals
the JAX package's ``KEYSCOPE_LEAP.json`` in every entry's counts and every
sink's fields but ``site`` (the port's file:line) and the joined bytes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

from kaboodle_tpu_torch.analysis.core import Finding
from kaboodle_tpu_torch.analysis.rng import rules

DEFAULT_LEAP_REPORT = "kaboodle_tpu_torch/analysis/rng/leap.json"
LEAP_SCHEMA = "kaboodle-keyscope-leap/1"
_LEAP_PATH = "rng://leap-report"


@dataclasses.dataclass
class RngScanResult:
    findings: list[Finding]
    graphs: dict
    entries_scanned: int


def run_rng_scan(
    entry_names: Sequence[str] | None = None,
    entries=None,
    device=None,
    progress=None,
    results: dict | None = None,
) -> RngScanResult:
    """Audit the registry's key provenance (or an injected subset) on
    ``device`` (the card unless ``"cpu"``). ``results`` (a
    ``trace_registry`` dict made with ``rng=True``) reuses traces."""
    from kaboodle_tpu_torch.analysis.ir.registry import select_entries
    from kaboodle_tpu_torch.analysis.ir.scan import trace_registry

    chosen = entries if entries is not None else select_entries(entry_names)
    if results is None:
        results = trace_registry(chosen, device, rng=True, progress=progress)
    findings: list[Finding] = list(rules.check_kb602_stream_registry())
    graphs = {}
    for entry in chosen:
        graph = results[entry.name].graph
        graphs[entry.name] = graph
        for check in rules.PER_GRAPH_CHECKS:
            findings.extend(check(graph))
    findings.extend(rules.check_kb604_chain_divergence(graphs))
    findings.sort(key=lambda f: (f.path, f.rule, f.symbol))
    return RngScanResult(findings, graphs, len(chosen))


# -- the leap report ---------------------------------------------------------


def _layout_name(sink) -> str | None:
    """Draw-row name of a sink (None when it has no row identity): a
    split-chain sink by its split-row coordinate (``KEY_LAYOUT[row]``), a
    counter-keyed tick draw by the ``STREAM_TICK_*`` fold nearest the sink;
    the sparse ``(seed, cursor, stream)`` sinks keep a null row."""
    from kaboodle_tpu_torch.phasegraph.ops import KEY_LAYOUT

    roots = sink.node.roots()
    if "carried_key" in roots:
        row = sink.node.layout_row()
        if row is None or row >= len(KEY_LAYOUT):
            return None
        return KEY_LAYOUT[row]
    if "counter_seed" in roots:
        n, seen = sink.node, set()
        while n is not None and id(n) not in seen:
            seen.add(id(n))
            if n.kind == "fold" and isinstance(n.const, int):
                if n.const in rules.TICK_STREAM_ROWS:
                    return rules.TICK_STREAM_ROWS[n.const]
            n = n.parents[0] if n.parents else None
    return None


def _costscope_bytes(costscope_path) -> dict:
    if costscope_path is None:
        return {}
    try:
        from kaboodle_tpu_torch.costscope.baseline import load_baseline

        data = load_baseline(costscope_path)
        if data is None:
            return {}
        return {name: int(rec.get("bytes_accessed", 0)) for name, rec in data["entries"].items()}
    except Exception:
        return {}


def build_leap_report(graphs: dict, costscope_path: str | Path | None = None) -> dict:
    """Deterministic KB605 classification of every sink in ``graphs``.

    No timestamps, no ids: two runs over the same code give the same bytes."""
    cost = _costscope_bytes(costscope_path)
    entries: dict[str, dict] = {}
    totals = {rules.CLASS_CHAIN: 0, rules.CLASS_COUNTER: 0, rules.CLASS_IMPURE: 0,
              "chain_coupled_draw_bytes": 0}
    for name in sorted(graphs):
        graph = graphs[name]
        sinks = []
        counts = {rules.CLASS_CHAIN: 0, rules.CLASS_COUNTER: 0, rules.CLASS_IMPURE: 0}
        for s in sorted(graph.sinks, key=lambda s: (s.source.file, s.source.line, s.descr())):
            cls = rules.classify(s)
            counts[cls] += 1
            totals[cls] += 1
            if cls == rules.CLASS_CHAIN:
                totals["chain_coupled_draw_bytes"] += s.nbytes
            layout = _layout_name(s)
            sinks.append({
                "site": s.source.render(),
                "key": s.descr(),
                "shape": list(s.shape),
                "bit_width": s.bit_width,
                "draw_bytes": s.nbytes,
                "class": cls,
                "roots": sorted(s.node.roots()),
                "layout_row": layout,
                "warp_terms": list(rules.WARP_TERMS.get(layout, ())) if layout else [],
            })
        entries[name] = {
            "sinks": sinks,
            "chain_coupled": counts[rules.CLASS_CHAIN],
            "counter_keyed": counts[rules.CLASS_COUNTER],
            "impure": counts[rules.CLASS_IMPURE],
            "entry_bytes_accessed": cost.get(name, 0),
        }
    return {
        "schema": LEAP_SCHEMA,
        "streams": {name: sid for name, sid in rules.KEYSCOPE_STREAMS},
        "entries": entries,
        "totals": totals,
    }


def write_leap_report(report: dict, path: str | Path = DEFAULT_LEAP_REPORT) -> None:
    Path(path).write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")


def load_leap_report(path: str | Path = DEFAULT_LEAP_REPORT) -> dict | None:
    p = Path(path)
    if not p.exists():
        return None
    data = json.loads(p.read_text())
    if not isinstance(data, dict) or data.get("schema") != LEAP_SCHEMA:
        raise ValueError(f"{p}: not a {LEAP_SCHEMA} report")
    return data


def leap_findings(graphs: dict, path: str | Path = DEFAULT_LEAP_REPORT,
                  costscope_path: str | Path | None = None) -> list[Finding]:
    """KB605 freshness gate: regenerate and diff against the committed copy.

    Only meaningful on a full-registry run; NOT baselineable: a stale
    report is fixed by regenerating it, never by justifying the staleness.
    The chain-coupled total is a ratchet: growth is a finding even on a
    regenerated report."""
    committed = load_leap_report(path)
    if committed is None:
        return [Finding(_LEAP_PATH, "KB605", 0,
                        f"no committed leap report at {path} -- run the rng lane with "
                        "--write-leap and commit it", "missing")]
    live = build_leap_report(graphs, costscope_path=costscope_path)
    findings: list[Finding] = []
    c_chain = int(committed.get("totals", {}).get(rules.CLASS_CHAIN, 0))
    l_chain = int(live["totals"][rules.CLASS_CHAIN])
    if l_chain > c_chain:
        findings.append(Finding(
            _LEAP_PATH, "KB605", 0,
            f"chain-coupled sink total grew {c_chain} -> {l_chain} -- new draw sites fork a "
            "carried key chain; key them through phasegraph.rng counter streams instead of "
            "re-banking the report", "growth"))
    if committed == live:
        return findings
    c_entries, l_entries = committed.get("entries", {}), live["entries"]
    stale = [n for n in sorted(set(c_entries) | set(l_entries))
             if c_entries.get(n) != l_entries.get(n)]
    detail = f"entries differ: {stale[:6]}" if stale else "header/totals differ"
    findings.append(Finding(
        _LEAP_PATH, "KB605", 0,
        f"committed leap report is stale ({detail}) -- the draw sites moved under it; "
        "regenerate with --write-leap and commit", "stale"))
    return findings


def render_leap_report(report: dict) -> str:
    """Human table: per-entry class counts, then every chain-coupled site."""
    lines = ["keyscope leap report -- draw-sink leapability by entry", ""]
    lines.append(f"{'entry':40s} {'chain':>6s} {'counter':>8s} {'impure':>7s} "
                 f"{'entry bytes/dispatch':>21s}")
    for name, rec in sorted(report["entries"].items()):
        lines.append(f"{name:40s} {rec['chain_coupled']:6d} {rec['counter_keyed']:8d} "
                     f"{rec['impure']:7d} {rec['entry_bytes_accessed']:21,d}")
    totals = report["totals"]
    lines.append("")
    lines.append(
        f"totals: {totals[rules.CLASS_CHAIN]} chain-coupled / "
        f"{totals[rules.CLASS_COUNTER]} counter-keyed / {totals[rules.CLASS_IMPURE]} impure "
        f"sinks; {totals['chain_coupled_draw_bytes']:,d} chain-coupled draw bytes per "
        "full-registry dispatch")
    chain_sites: dict[tuple, list] = {}
    for name, rec in sorted(report["entries"].items()):
        for s in rec["sinks"]:
            if s["class"] != rules.CLASS_CHAIN:
                continue
            key = (s["site"], s["layout_row"], tuple(s["warp_terms"]))
            chain_sites.setdefault(key, []).append((name, s["draw_bytes"]))
    lines.append("")
    lines.append("chain-coupled sites (the re-keying worklist):")
    for (site, layout, terms), users in sorted(
            chain_sites.items(), key=lambda kv: (kv[0][0], kv[0][1] or "", kv[0][2])):
        row = f"row={layout}" if layout else "row=?"
        lines.append(f"  {site:28s} {row:10s} terms={','.join(terms) or '-':22s} "
                     f"entries={len(users):2d} draw_bytes={sum(b for _, b in users):,d}")
    return "\n".join(lines)
