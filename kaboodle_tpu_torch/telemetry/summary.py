"""Manifest summarizer / exporter of the port.

The port of ``kaboodle_tpu/telemetry/summary.py``. Reads one or more JSONL
run manifests (telemetry/manifest.py), validates every record against the
schema, and prints a human summary: records by kind, the run records'
headline fields, per-counter totals over the tick records, and the
convergence tail. Ends with the repo's usual compact single-line JSON
(machine consumers take the last line). ``--trace OUT`` additionally
exports the tick records as a Chrome-trace/Perfetto JSON.

    python -m kaboodle_tpu_torch.telemetry.summary run.jsonl
    python -m kaboodle_tpu_torch.telemetry.summary run.jsonl --trace run.trace.json
    python -m kaboodle_tpu_torch.telemetry.summary run.jsonl --check   # schema gate
    python -m kaboodle_tpu_torch.telemetry.summary serve.jsonl --serve-report

Serve manifests (``serve_span`` records) get two extras: ``--trace``
renders per-lane request/leap/spill tracks on the wall-clock timeline
(``--journal DIR`` adds the WAL appends as a sibling track), and
``--serve-report`` prints a per-request waterfall plus a per-phase SLO
table (queue vs compute vs spill attribution).

The pass tables that annotate a trace (``--phase-program``) come from the
planner: ``PHASE_PROGRAMS`` holds, per mode, the ``describe()`` dict of the
plan of the default deterministic telemetry graph (:func:`_phase_program`).
"""

from __future__ import annotations

import argparse
import json
import sys

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph import build_graph, plan
from kaboodle_tpu_torch.telemetry.counters import FIELDS
from kaboodle_tpu_torch.telemetry.manifest import read_manifest


def _phase_program(mode: str):
    """The planned phase-graph program whose passes annotate the trace.

    Built from the default deterministic config's op graph: pass membership
    and pruning are decided by the planner per mode, not per run, so the
    default build's plan is the right annotation for any run of that mode.
    ``span`` plans derive from the fault-free graph by definition (a
    quiescent span carries no scheduled events)."""
    graph = build_graph(SwimConfig(deterministic=True), faulty=(mode != "span"), telemetry=True)
    return plan(graph, mode)


# The ``--phase-program`` tables, one ``describe()`` dict per mode.
PHASE_PROGRAMS = {mode: _phase_program(mode).describe()
                  for mode in ("fused", "full", "span", "blocked")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaboodle_tpu_torch.telemetry.summary",
        description="summarize / export kaboodle telemetry run manifests",
    )
    p.add_argument("paths", nargs="+", metavar="MANIFEST.jsonl")
    p.add_argument("--trace", metavar="OUT.json", default=None,
                   help="export tick records as Chrome-trace/Perfetto JSON")
    p.add_argument("--phase-program", default="fused",
                   choices=("fused", "full", "span", "blocked", "off"),
                   help="with --trace: annotate each run track with per-pass "
                        "slices from the phase-graph plan of this mode "
                        "(default-config graph; 'off' disables the track)")
    p.add_argument("--check", action="store_true",
                   help="schema gate: exit nonzero unless every record "
                        "validates and at least one record exists")
    p.add_argument("--serve-report", action="store_true",
                   help="per-request waterfall + per-phase SLO table from "
                        "serve_span records")
    p.add_argument("--journal", metavar="DIR", default=None,
                   help="with --trace: add the serve WAL in DIR as a "
                        "journal-appends track (seq-ordered)")
    return p


def _pct(sorted_us: list[int], q: float) -> int:
    """Exact sample quantile over a sorted list (host-side, small N)."""
    if not sorted_us:
        return 0
    return sorted_us[min(int(q * len(sorted_us)), len(sorted_us) - 1)]


def serve_report(records: list[dict]) -> dict:
    """Fold ``serve_span`` records into the waterfall + SLO structures.

    Returns ``{"requests": {rid: {"phases": [...], "total_us", "fate"}},
    "phases": {span: {count, total_us, p50/p90/p99/max_us}}, "e2e":
    {...}}`` — per-request phase sequences ordered by ``t0_us``, and the
    per-phase latency attribution the SLO table prints. End-to-end
    latency is first ``t0_us`` to last span end, so queue time counts."""
    by_rid: dict[int, list[dict]] = {}
    for rec in records:
        if rec.get("kind") != "serve_span":
            continue
        rid = int(rec["request_id"])
        if rid < 0:
            continue  # round / advance spans: engine-level, not a request
        by_rid.setdefault(rid, []).append(rec)
    requests: dict[int, dict] = {}
    phase_us: dict[str, list[int]] = {}
    e2e: list[int] = []
    for rid in sorted(by_rid):
        spans = sorted(by_rid[rid], key=lambda r: int(r["t0_us"]))
        phases = []
        fate = None
        for s in spans:
            phases.append({
                "span": s["span"], "t0_us": int(s["t0_us"]),
                "dur_us": int(s["dur_us"]), "pool_n": s.get("pool_n", -1),
                "lane": s.get("lane", -1),
            })
            if s.get("fate"):
                fate = s["fate"]
            if s.get("open"):
                fate = fate or "open"
            phase_us.setdefault(s["span"], []).append(int(s["dur_us"]))
        total = (int(spans[-1]["t0_us"]) + int(spans[-1]["dur_us"])
                 - int(spans[0]["t0_us"]))
        requests[rid] = {"phases": phases, "total_us": total,
                         "fate": fate or "done"}
        e2e.append(total)
    phases_out = {}
    for span, durs in sorted(phase_us.items()):
        durs.sort()
        phases_out[span] = {
            "count": len(durs), "total_us": sum(durs),
            "p50_us": _pct(durs, 0.50), "p90_us": _pct(durs, 0.90),
            "p99_us": _pct(durs, 0.99), "max_us": durs[-1],
        }
    e2e.sort()
    return {
        "requests": requests,
        "phases": phases_out,
        "e2e": {
            "count": len(e2e), "p50_us": _pct(e2e, 0.50),
            "p90_us": _pct(e2e, 0.90), "p99_us": _pct(e2e, 0.99),
            "max_us": e2e[-1] if e2e else 0,
        },
    }


_PHASE_GLYPH = {"queued": "q", "running": "R", "parked": "p",
                "spilling": "s", "spilled": "S"}


def print_serve_report(report: dict, width: int = 48, max_rows: int = 30
                       ) -> None:
    """Render the waterfall (one scaled bar per request) + SLO table."""
    reqs = report["requests"]
    if not reqs:
        print("  serve-report: no request spans")
        return
    t_lo = min(p["t0_us"] for r in reqs.values() for p in r["phases"])
    t_hi = max(p["t0_us"] + p["dur_us"]
               for r in reqs.values() for p in r["phases"])
    scale = max(t_hi - t_lo, 1)
    print(f"  serve-report: {len(reqs)} requests, "
          f"timeline {scale} us")
    for i, (rid, row) in enumerate(sorted(reqs.items())):
        if i >= max_rows:
            print(f"    ... {len(reqs) - max_rows} more requests")
            break
        bar = [" "] * width
        for p in row["phases"]:
            a = (p["t0_us"] - t_lo) * width // scale
            b = (p["t0_us"] + p["dur_us"] - t_lo) * width // scale
            g = _PHASE_GLYPH.get(p["span"], "?")
            for j in range(min(a, width - 1), min(max(b, a + 1), width)):
                bar[j] = g
        seq = ">".join(p["span"] for p in row["phases"])
        print(f"    r{rid:<4} |{''.join(bar)}| "
              f"{row['total_us']:>8} us  {row['fate']:<10} {seq}")
    print("    phase       count   p50_us   p90_us   p99_us   max_us")
    rows = dict(report["phases"])
    rows["e2e"] = report["e2e"]
    for span, st in rows.items():
        print(f"    {span:<10} {st['count']:>6} {st['p50_us']:>8} "
              f"{st['p90_us']:>8} {st['p99_us']:>8} {st['max_us']:>8}")


def load_manifests(paths: list[str]) -> dict[str, list[dict]]:
    """Read + validate every manifest ONCE: path -> its records."""
    return {path: list(read_manifest(path)) for path in paths}


def summarize(records: dict[str, list[dict]]) -> dict:
    """Aggregate loaded manifests into the summary dict the CLI prints."""
    kinds: dict[str, int] = {}
    runs: list[dict] = []
    ticks: list[dict] = []
    warp_spans: list[dict] = []
    warp_blocked: list[dict] = []
    serve_events: list[dict] = []
    serve_rounds: list[dict] = []
    for recs in records.values():
        for rec in recs:
            kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
            if rec["kind"] == "run":
                runs.append(rec)
            elif rec["kind"] == "tick":
                ticks.append(rec)
            elif rec["kind"] == "warp_spans":
                warp_spans.append(rec)
            elif rec["kind"] == "warp_blocked":
                warp_blocked.append(rec)
            elif rec["kind"] == "serve_event":
                serve_events.append(rec)
            elif rec["kind"] == "serve_round":
                serve_rounds.append(rec)
    out: dict = {
        "metric": "telemetry_manifest_summary",
        "manifests": len(records),
        "records": int(sum(kinds.values())),
        "kinds": kinds,
        "runs": [
            {k: r[k] for k in ("metric", "value", "unit", "n_peers", "ticks",
                               "backend", "wall_s") if k in r}
            for r in runs
        ],
    }
    if warp_spans:
        # Warp 2.0 per-class leap counters: one row per signature class
        # (strict / hybrid / fleet), aggregated across manifests.
        classes: dict = {}
        for rec in warp_spans:
            agg = classes.setdefault(
                int(rec["class_key"]),
                {"engine": rec.get("engine", ""),
                 "terms": rec.get("terms", []),
                 "spans": 0, "ticks": 0, "dispatches": 0},
            )
            for f in ("spans", "ticks", "dispatches"):
                agg[f] += int(rec.get(f, 0))
        out["leap_classes"] = {str(k): v for k, v in sorted(classes.items())}
    if warp_blocked:
        # Why-dense attribution: which signature terms kept spans off the
        # leap path (plus the 'scheduled_event' / 'short_span' pseudo-terms),
        # aggregated across manifests. Ticks sum to the dense ticks executed.
        terms: dict = {}
        for rec in warp_blocked:
            agg = terms.setdefault(
                str(rec["term"]), {"spans": 0, "ticks": 0, "members": 0}
            )
            for f in ("spans", "ticks", "members"):
                agg[f] += int(rec.get(f, 0))
        out["warp_blocked"] = dict(sorted(terms.items()))
    if serve_events or serve_rounds:
        # Serve-lane aggregation: request lifecycle counts, completed-run
        # tick stats, and per-engine round totals (chunk vs leap ticks —
        # the continuous-batching split the PERF.md serving section cites).
        by_event: dict[str, int] = {}
        for rec in serve_events:
            ev = rec.get("event", "?")
            by_event[ev] = by_event.get(ev, 0) + 1
        finished = [
            r for r in serve_events
            if r.get("event") in ("converged", "completed", "exhausted")
        ]
        engines: dict[str, dict] = {}
        for rec in serve_rounds:
            agg = engines.setdefault(
                rec.get("engine", "?"), {"rounds": 0, "ticks": 0}
            )
            agg["rounds"] += 1
            agg["ticks"] += int(rec.get("ticks", 0))
        serve: dict = {"events": by_event, "round_engines": engines}
        if finished:
            tr = [int(r["ticks_run"]) for r in finished if "ticks_run" in r]
            serve["finished"] = len(finished)
            serve["converged"] = sum(
                1 for r in finished if r.get("converged")
            )
            if tr:
                serve["mean_ticks_run"] = round(sum(tr) / len(tr), 2)
        out["serve"] = serve
    if ticks:
        ticks.sort(key=lambda r: r["tick"])
        totals = {
            name: int(sum(int(r[name]) for r in ticks if name in r))
            for name in FIELDS
            if any(name in r for r in ticks)
        }
        conv = [r for r in ticks if "converged" in r]
        out["tick_records"] = len(ticks)
        out["tick_span"] = [int(ticks[0]["tick"]), int(ticks[-1]["tick"])]
        out["counter_totals"] = totals
        if conv:
            out["final_converged"] = bool(conv[-1]["converged"])
            first = next((r["tick"] for r in conv if r["converged"]), None)
            out["first_converged_tick"] = int(first) if first is not None else -1
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        records = load_manifests(args.paths)
        summary = summarize(records)
    except (OSError, ValueError) as e:
        print(f"telemetry: {e}", file=sys.stderr)
        return 1
    if args.check and summary["records"] == 0:
        print("telemetry: --check: manifest has no records", file=sys.stderr)
        return 1

    print(f"telemetry: {summary['manifests']} manifest(s), "
          f"{summary['records']} records "
          f"({', '.join(f'{k}:{v}' for k, v in sorted(summary['kinds'].items()))})")
    for run in summary["runs"]:
        bits = " ".join(f"{k}={run[k]}" for k in run)
        print(f"  run: {bits}")
    if "counter_totals" in summary:
        lo, hi = summary["tick_span"]
        print(f"  ticks {lo}..{hi} ({summary['tick_records']} records)")
        for name, v in summary["counter_totals"].items():
            print(f"    {name:<20} {v}")
        if "final_converged" in summary:
            print(f"  first_converged_tick={summary.get('first_converged_tick')}"
                  f" final_converged={summary.get('final_converged')}")

    if "warp_blocked" in summary:
        total = sum(v["ticks"] for v in summary["warp_blocked"].values())
        print(f"  why-dense ({total} dense ticks):")
        for term, agg in sorted(
            summary["warp_blocked"].items(),
            key=lambda kv: -kv[1]["ticks"],
        ):
            share = 100.0 * agg["ticks"] / max(total, 1)
            print(f"    {term:<32} {agg['ticks']:>7} ticks "
                  f"({share:5.1f}%) over {agg['spans']} spans")

    if "serve" in summary:
        s = summary["serve"]
        ev = ", ".join(f"{k}:{v}" for k, v in sorted(s["events"].items()))
        print(f"  serve: {ev}")
        for eng, agg in sorted(s["round_engines"].items()):
            print(f"    {eng}: {agg['rounds']} rounds, {agg['ticks']} ticks")

    if args.serve_report:
        all_recs = [r for recs in records.values() for r in recs]
        report = serve_report(all_recs)
        print_serve_report(report)
        summary["serve_report"] = {
            "requests": len(report["requests"]),
            "phases": report["phases"],
            "e2e": report["e2e"],
        }

    if args.trace:
        from kaboodle_tpu_torch.telemetry.trace import (
            journal_trace_events, serve_trace_events, write_chrome_trace,
        )

        # One Perfetto process track PER MANIFEST: each manifest is its own
        # run, and pooling runs onto one track would corrupt the leap-gap
        # inference (overlapping tick slices, false/masked leaps).
        groups = {
            path: [r for r in recs if r["kind"] == "tick"]
            for path, recs in records.items()
        }
        # The default build's plan annotates any run of that mode: pass
        # membership and pruning are decided per mode, not per run.
        program = (
            None if args.phase_program == "off"
            else PHASE_PROGRAMS[args.phase_program]
        )
        # Serve manifests additionally render the wall-clock service view:
        # per-lane request/leap tracks per manifest (disjoint pid ranges),
        # plus the WAL appends when --journal points at the journal dir.
        extra: list[dict] = []
        for i, (path, recs) in enumerate(records.items()):
            if any(r["kind"] == "serve_span" for r in recs):
                extra.extend(serve_trace_events(recs, pid_base=10 + 20 * i))
        if args.journal:
            from kaboodle_tpu_torch.serve.journal import read_journal_records

            extra.extend(journal_trace_events(
                read_journal_records(args.journal)))
        n = write_chrome_trace(args.trace,
                               {p: rows for p, rows in groups.items() if rows},
                               metadata={"manifests": args.paths},
                               program=program,
                               extra_events=extra)
        print(f"  trace: {n} events -> {args.trace}")
        summary["trace_events"] = n

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
