"""The analysis CLI: ``python -m kaboodle_tpu_torch.analysis [--ir|--conc|--rng|--all]``.

The port of ``kaboodle_tpu/analysis/cli.py``. Exit codes: 0 clean
(baselined findings allowed), 1 findings or baseline violations, 2 usage
or baseline-format error. Four lanes share one UX:

- **AST lane** (graftlint, the default): KB1xx-KB3xx over
  ``kaboodle_tpu_torch/`` (or the paths given). Pure ``ast`` + stdlib: no
  torch, parse speed. Debt file ``kaboodle_tpu_torch/analysis/baseline.json``.
- **conc lane** (``--conc``, or the ``conc`` subcommand): KB501-KB506
  (``analysis/conc/``), the host-concurrency auditor of the serve plane,
  debt file ``kaboodle_tpu_torch/analysis/conc/baseline.json``.
- **IR lane** (graftscan, ``--ir``): KB401-KB404 over the dispatch trace of
  every entry of ``analysis/ir/registry.py`` (``analysis/ir/``), plus KB405,
  the compile-surface budget against ``analysis/ir/surface.json``. Debt
  file ``kaboodle_tpu_torch/analysis/ir/baseline.json``. It prints the
  host syncs (KB402) each entry makes per call, and gates them by site:
  each KB402 entry of the debt file records its syncs per call (``count``:
  as it runs, gates forced true, forced false), and a rise fails the lane.
  The AST lane's debt file records how often each key occurs, likewise.
- **rng lane** (keyscope, ``--rng``, or the ``rng`` subcommand):
  KB601-KB605 over the key provenance recorded at the counter-RNG calls of
  the same trace (``analysis/rng/``), KB602's ``STREAM_*`` register, and
  the leap report (``--leap-report`` / ``--write-leap`` / ``--check-leap``
  against ``analysis/rng/leap.json``). Debt file
  ``kaboodle_tpu_torch/analysis/rng/baseline.json``.

``--all`` runs every lane (AST, conc, IR, rng; the two traced lanes share
one trace) against its own baseline and reports one combined exit code.
The traced lanes run the entries on the card unless ``--device cpu``.
Paths are taken from the working directory: run from the checkout's root.

- ``--no-baseline-growth``: also fail on *stale* baseline entries, on a
  recorded count that fell and, in the IR lane, on a surface count below
  its budget, so the debt only shrinks;
- ``--write-baseline`` / ``--write-surface`` / ``--write-leap``: regenerate
  the file (the baseline with its counts), keeping its reasons;
- ``--explain KBnnn`` / ``--list-rules``: rule documentation;
- ``--entries a,b`` (IR/rng): scan only the named entries (the leap
  report's freshness gate needs the full registry).
"""

from __future__ import annotations

import collections
import pathlib
import sys

from kaboodle_tpu_torch.analysis import core

DEFAULT_TARGETS = ["kaboodle_tpu_torch"]
DEFAULT_CONC_BASELINE = "kaboodle_tpu_torch/analysis/conc/baseline.json"
DEFAULT_IR_BASELINE = "kaboodle_tpu_torch/analysis/ir/baseline.json"
DEFAULT_RNG_BASELINE = "kaboodle_tpu_torch/analysis/rng/baseline.json"

USAGE = """\
usage: python -m kaboodle_tpu_torch.analysis [--conc | --ir | --rng | --all] [options] [paths...]

lanes:
  (none)                 the AST lane (graftlint, KB1xx-KB3xx) over the source
  --conc                 the concurrency lane (graftconc, KB5xx) over the
                         serve scope ('conc' as first arg works too)
  --ir                   KB401-KB404 over the dispatch trace of the registry's
                         entries, and the compile-surface budget (KB405)
  --rng                  key provenance (keyscope, KB6xx) over the same trace
                         ('rng' as first arg works too)
  --all                  every lane against its own baseline; one exit code

options:
  --baseline PATH        baseline file (default: kaboodle_tpu_torch/analysis/
                         baseline.json; ir/, rng/, conc/baseline.json per lane)
  --no-baseline          ignore the baseline entirely
  --no-baseline-growth   also fail on stale baseline entries (and, --ir, on a
                         surface count below its budget)
  --write-baseline       regenerate the baseline from current findings
  --explain KBnnn        print one rule's documentation and exit
  --list-rules           print every rule id + title and exit
  --device DEV           (--ir/--rng/--all) torch device of the traced entries
                         (default: the card; 'cpu' runs them on the host)
  --entries a,b          (--ir/--rng) scan only the named entry points
  --surface PATH         (--ir) surface budget (default:
                         kaboodle_tpu_torch/analysis/ir/surface.json)
  --write-surface        (--ir) regenerate the surface budget file
  --no-surface           (--ir) skip the compile-surface exercise (KB405)
  --leap PATH            (--rng) leap report (default:
                         kaboodle_tpu_torch/analysis/rng/leap.json)
  --leap-report          (--rng) print the leapability report (KB605 table)
  --write-leap           (--rng) regenerate + write the leap report file
  --check-leap           (--rng) fail if the committed leap report is stale
  -h, --help             this message
"""

_VALUED = ("--baseline", "--surface", "--device", "--entries", "--leap")
_FLAGS = ("--no-baseline", "--no-baseline-growth", "--write-baseline", "--write-surface",
          "--no-surface", "--leap-report", "--write-leap", "--check-leap")
_BASE = {"--baseline", "--no-baseline", "--no-baseline-growth", "--write-baseline"}
# The options each lane takes; anything else is a usage error.
_ALLOWED = {
    "ast": _BASE,
    "--conc": _BASE,
    "--ir": _BASE | {"--device", "--entries", "--surface", "--write-surface", "--no-surface"},
    "--rng": _BASE | {"--device", "--entries", "--leap", "--leap-report", "--write-leap",
                      "--check-leap"},
    "--all": {"--no-baseline", "--no-baseline-growth", "--device", "--no-surface"},
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("conc", "rng"):
        argv[0] = "--" + argv[0]
    values: dict[str, str] = {}
    flags: set[str] = set()
    lanes: list[str] = []
    targets: list[str] = []

    core._load_rules()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(USAGE, end="")
            return 0
        if a in _VALUED:
            i += 1
            if i >= len(argv):
                print(f"{a} needs a value", file=sys.stderr)
                return 2
            values[a] = argv[i]
        elif a in _FLAGS:
            flags.add(a)
        elif a in ("--conc", "--ir", "--rng", "--all"):
            lanes.append(a)
        elif a == "--list-rules":
            for rid in sorted(core.REGISTRY):
                print(f"{rid}  {core.REGISTRY[rid].title}")
            return 0
        elif a == "--explain":
            i += 1
            rid = argv[i].upper() if i < len(argv) else ""
            r = core.REGISTRY.get(rid)
            if r is None:
                print(f"unknown rule {rid!r}; try --list-rules", file=sys.stderr)
                return 2
            print(f"{r.id} — {r.title}\n\n{r.explain}")
            return 0
        elif a.startswith("-"):
            print(f"unknown option {a!r}\n{USAGE}", file=sys.stderr, end="")
            return 2
        else:
            targets.append(a)
        i += 1
    if len(set(lanes)) > 1:
        print("--ir/--conc/--rng/--all are exclusive; pick one", file=sys.stderr)
        return 2
    lane = lanes[0] if lanes else "ast"
    extra = sorted((set(values) | flags) - _ALLOWED[lane])
    if extra or (targets and lane not in ("ast", "--conc")):
        print(f"{'the AST lane' if lane == 'ast' else lane} does not take "
              f"{', '.join(extra) or 'paths'}", file=sys.stderr)
        return 2
    if {"--write-surface", "--no-surface"} <= flags:
        print("--write-surface needs the exercise: drop --no-surface", file=sys.stderr)
        return 2
    use_baseline = "--no-baseline" not in flags
    no_growth = "--no-baseline-growth" in flags
    write = "--write-baseline" in flags
    baseline = pathlib.Path(values["--baseline"]) if "--baseline" in values else None
    entries = [e for e in values["--entries"].split(",") if e] if "--entries" in values else None
    device = values.get("--device")
    if lane == "--all":
        return _run_all(use_baseline, no_growth, "--no-surface" not in flags, device)
    if lane in ("ast", "--conc"):
        return _run_ast(lane == "--conc", baseline, use_baseline, no_growth, write, targets)
    if lane == "--ir":
        return _run_ir(baseline or pathlib.Path(DEFAULT_IR_BASELINE), use_baseline, no_growth,
                       write, entries, values.get("--surface"), "--write-surface" in flags,
                       "--no-surface" not in flags, device)
    return _run_rng(baseline or pathlib.Path(DEFAULT_RNG_BASELINE), use_baseline, no_growth,
                    write, entries, values.get("--leap"), "--leap-report" in flags,
                    "--write-leap" in flags, "--check-leap" in flags, device)


def _gate(lane: str, findings, baseline: dict, no_growth: bool, unbaselined: str = "") -> tuple:
    """Print the active findings (and, with ``no_growth``, the stale entries);
    ``(rc, active, suppressed)``. Findings of rule ``unbaselined`` are never
    suppressed by a baseline entry (KB405/KB605: their files are the only
    record)."""
    active = [f for f in findings if f.rule == unbaselined or f.key not in baseline]
    for f in active:
        print(f.render())
    rc = 1 if active else 0
    if no_growth:
        live = {f.key for f in findings if f.rule != unbaselined}
        stale = sorted(k for k in baseline if k not in live)
        for k in stale:
            print(f"stale baseline entry (fixed? delete it): {k}")
        if stale:
            rc = 1
    return rc, active, len(findings) - len(active)


def _load(path: pathlib.Path, use: bool):
    try:
        return core.load_baseline(path) if use else {}
    except core.BaselineError as e:
        print(str(e), file=sys.stderr)
        return None


def _counts(path: pathlib.Path, use: bool):
    """The counts recorded in a baseline :func:`_load` accepted, or None
    (printed) when one is malformed."""
    try:
        return core.load_counts(path) if use else {}
    except core.BaselineError as e:
        print(str(e), file=sys.stderr)
        return None


def _run_ast(conc_mode: bool, baseline_path, use_baseline: bool, no_growth: bool,
             write: bool, targets: list[str]) -> int:
    """The source lanes: graftlint (KB1xx-KB3xx) or graftconc (KB5xx). One
    registry, two debt files; the KB4xx/KB6xx registrations are
    documentation with no-op source checks either way. graftlint also gates
    how often each baselined key occurs (a key names a function, not a
    line)."""
    lane = "graftconc" if conc_mode else "graftlint"
    rules = [core.REGISTRY[rid] for rid in sorted(core.REGISTRY)
             if rid.startswith("KB5") == conc_mode]
    files = core.iter_python_files(targets or DEFAULT_TARGETS)
    findings: list[core.Finding] = []
    for f in files:
        findings.extend(core.analyze_path(f, rules=rules))
    if baseline_path is None:
        baseline_path = pathlib.Path(DEFAULT_CONC_BASELINE if conc_mode else core.DEFAULT_BASELINE)
    baseline = _load(baseline_path, use_baseline)
    recorded = _counts(baseline_path, use_baseline and not conc_mode)
    if baseline is None or recorded is None:
        return 2
    counts = {} if conc_mode else {
        k: (n,) for k, n in collections.Counter(f.key for f in findings).items()}
    if write:
        core.write_baseline(baseline_path, findings, baseline, counts)
        print(f"{lane}: wrote {baseline_path} with {len({x.key for x in findings})} entries",
              file=sys.stderr)
        return 0
    if use_baseline and not conc_mode:
        findings += core.count_findings(counts, recorded, baseline, no_growth)
    rc, active, suppressed = _gate(lane, findings, baseline, no_growth)
    print(f"{lane}: {len(files)} files, {len(active)} findings"
          + (f" ({suppressed} baselined)" if suppressed else ""), file=sys.stderr)
    return rc


def _trace(entries, device, rng: bool):
    """The traced lanes' registry trace, or None (printed) on an unknown entry."""
    from kaboodle_tpu_torch.analysis.ir.registry import select_entries
    from kaboodle_tpu_torch.analysis.ir.scan import trace_registry

    try:
        chosen = select_entries(entries)
    except KeyError as e:
        print(str(e), file=sys.stderr)
        return None, None
    return chosen, trace_registry(chosen, device, rng=rng,
                                  progress=lambda msg: print(msg, file=sys.stderr))


def _run_ir(baseline_path: pathlib.Path, use_baseline: bool, no_growth: bool,
            write_baseline: bool, entries, surface_path, write_surface: bool,
            with_surface: bool, device, traced=None) -> int:
    """The IR lane: trace, audit, gate -- same baseline semantics as AST."""
    from kaboodle_tpu_torch.analysis.ir import scan as ir_scan
    from kaboodle_tpu_torch.analysis.ir import surface as ir_surface

    path = pathlib.Path(surface_path or ir_surface.DEFAULT_SURFACE)
    # Validate both committed files before the trace, so a malformed one
    # fails in milliseconds.
    baseline = _load(baseline_path, use_baseline)
    recorded = _counts(baseline_path, use_baseline)
    if baseline is None or recorded is None:
        return 2
    try:
        committed = ir_surface.load_surface(path)
    except core.BaselineError as e:
        print(str(e), file=sys.stderr)
        return 2
    chosen, results = traced or _trace(entries, device, rng=False)
    if results is None:
        return 2
    measure = (with_surface and not write_baseline) or write_surface
    result = ir_scan.run_scan(entries=chosen, device=device, with_surface=measure,
                              results=results,
                              progress=lambda msg: print(msg, file=sys.stderr))
    if write_baseline:
        core.write_baseline(baseline_path, result.findings, baseline, result.counts)
        print(f"graftscan: wrote {baseline_path} with "
              f"{len({x.key for x in result.findings})} entries", file=sys.stderr)
    if write_surface:
        ir_surface.write_surface(path, result.surface_measured, committed)
        print(f"graftscan: wrote {path}", file=sys.stderr)
    if write_baseline or write_surface:
        return 0
    findings = list(result.findings)
    if use_baseline:
        findings += core.count_findings(result.counts, recorded, baseline, no_growth)
    if with_surface:
        findings.extend(ir_surface.surface_findings(result.surface_measured, committed,
                                                    no_growth=no_growth))
    rc, active, suppressed = _gate("graftscan", findings, baseline, no_growth, "KB405")
    syncs = " ".join(f"{k}={v}" for k, v in result.syncs.items())
    surf = ("; KB405 surface " + ", ".join(f"{k}={v}" for k, v in sorted(
        result.surface_measured.items()))) if result.surface_measured else ""
    print(f"graftscan: KB402 host syncs per call: {syncs}", file=sys.stderr)
    print(f"graftscan: {result.entries_scanned} entry points, {len(active)} findings"
          + (f" ({suppressed} baselined)" if suppressed else "") + surf, file=sys.stderr)
    return rc


def _run_rng(baseline_path: pathlib.Path, use_baseline: bool, no_growth: bool,
             write_baseline: bool, entries, leap_path, leap_report: bool, write_leap: bool,
             check_leap: bool, device, traced=None) -> int:
    """The rng lane: keyscope over the traced registry. KB605 freshness
    findings are not baselineable -- the leap report file is the only
    accepted record of the classification."""
    from kaboodle_tpu_torch.analysis.rng import scan as rng_scan
    from kaboodle_tpu_torch.costscope.baseline import DEFAULT_BASELINE as COSTSCOPE

    leap = pathlib.Path(leap_path or rng_scan.DEFAULT_LEAP_REPORT)
    baseline = _load(baseline_path, use_baseline)
    if baseline is None:
        return 2
    if write_leap and entries:
        print("--write-leap needs the full registry (drop --entries): a partial report "
              "would mark every unscanned entry stale", file=sys.stderr)
        return 2
    chosen, results = traced or _trace(entries, device, rng=True)
    if results is None:
        return 2
    result = rng_scan.run_rng_scan(entries=chosen, results=results)
    if write_baseline:
        core.write_baseline(baseline_path, result.findings, baseline)
        print(f"keyscope: wrote {baseline_path} with "
              f"{len({x.key for x in result.findings})} entries", file=sys.stderr)
    if write_leap:
        rng_scan.write_leap_report(
            rng_scan.build_leap_report(result.graphs, costscope_path=COSTSCOPE), leap)
        print(f"keyscope: wrote {leap}", file=sys.stderr)
    if write_baseline or write_leap:
        return 0
    findings = list(result.findings)
    if check_leap:
        if entries:
            print("keyscope: --check-leap skipped (a scoped --entries run cannot validate "
                  "the full-registry report)", file=sys.stderr)
        else:
            findings.extend(rng_scan.leap_findings(result.graphs, leap, costscope_path=COSTSCOPE))
    rc, active, suppressed = _gate("keyscope", findings, baseline, no_growth, "KB605")
    if leap_report:
        print(rng_scan.render_leap_report(
            rng_scan.build_leap_report(result.graphs, costscope_path=COSTSCOPE)))
    sinks = sum(len(g.sinks) for g in result.graphs.values())
    print(f"keyscope: {result.entries_scanned} entry points, {sinks} draw sinks, "
          f"{len(active)} findings" + (f" ({suppressed} baselined)" if suppressed else ""),
          file=sys.stderr)
    return rc


def _run_all(use_baseline: bool, no_growth: bool, with_surface: bool, device) -> int:
    """``--all``: every lane, own baselines, one combined exit code; cheap
    lanes first, and every lane always runs (one combined report)."""
    results = [
        ("graftlint", _run_ast(False, None, use_baseline, no_growth, False, [])),
        ("graftconc", _run_ast(True, None, use_baseline, no_growth, False, [])),
    ]
    traced = _trace(None, device, rng=True)
    results.append(("graftscan", _run_ir(
        pathlib.Path(DEFAULT_IR_BASELINE), use_baseline, no_growth, False, None, None, False,
        with_surface, device, traced)))
    results.append(("keyscope", _run_rng(
        pathlib.Path(DEFAULT_RNG_BASELINE), use_baseline, no_growth, False, None, None, False,
        False, True, device, traced)))
    rc = max(code for _, code in results)
    summary = " ".join(f"{lane}={code}" for lane, code in results)
    print(f"analysis --all: {summary} -> rc {rc}", file=sys.stderr)
    return rc
