"""The analysis CLI: ``python -m kaboodle_tpu_torch.analysis --conc|--ir|--rng``.

The port's lanes of ``kaboodle_tpu/analysis/cli.py``:

- **conc lane** (``--conc``, or the ``conc`` subcommand): rules KB501-KB506
  (``analysis/conc/rules.py``), the host-concurrency auditor of the port's
  serve plane, over ``kaboodle_tpu_torch/`` (or the paths given), gated
  against its own debt file ``kaboodle_tpu_torch/analysis/conc/
  baseline.json`` (paths are taken from the working directory: run it from
  the checkout's root).
- **IR lane** (``--ir``): KB405 alone, the compile-surface budget
  (``analysis/ir/surface.py``): the scripted exercise's programs built per
  family against ``kaboodle_tpu_torch/analysis/ir/surface.json``. It runs
  on the card unless ``--device cpu``; the exercise keeps the kernel flags
  off, so the counts are the same on both. KB401-KB404 walk jaxprs and have
  no counterpart.
- **rng lane** (``--rng``, or the ``rng`` subcommand): KB602's registry half
  (``analysis/rng/rules.py``), the pinned ``STREAM_*`` table against the
  live ids. KB601, KB603-KB605 and KB602's traced half walk jaxprs and have
  no counterpart.

Exit codes: 0 clean (baselined findings allowed), 1 findings or baseline
violations, 2 usage or baseline-format error.

- ``--no-baseline-growth``: also fail on *stale* baseline entries (conc) or
  on a surface count below its budget (IR), so the debt only shrinks;
- ``--write-baseline`` (conc) / ``--write-surface`` (IR): regenerate the
  file, keeping its reasons;
- ``--explain KBnnn`` / ``--list-rules``: rule documentation.

The JAX package's AST lane (KB1xx-KB3xx; its default, with no lane flag)
and ``--all`` check jit tracing, which the port does not do: they refuse
with one line and exit 2.
"""

from __future__ import annotations

import pathlib
import sys

from kaboodle_tpu_torch.analysis import core

DEFAULT_TARGETS = ["kaboodle_tpu_torch"]
DEFAULT_CONC_BASELINE = "kaboodle_tpu_torch/analysis/conc/baseline.json"

USAGE = """\
usage: python -m kaboodle_tpu_torch.analysis (--conc | --ir | --rng) [options] [paths...]

lanes:
  --conc                 the concurrency lane (graftconc, KB5xx) over the
                         serve scope ('conc' as first arg works too)
  --ir                   the compile-surface budget (KB405) over the scripted
                         exercise; KB401-KB404 walk jaxprs: no counterpart
  --rng                  the STREAM_* register (KB602's registry half; 'rng'
                         as first arg works too); KB601, KB603-KB605 and
                         KB602's traced half walk jaxprs: no counterpart
  (--all and the flagless AST lane check jit tracing: they exit 2)

options:
  --baseline PATH        (--conc) baseline file (default:
                         kaboodle_tpu_torch/analysis/conc/baseline.json)
  --no-baseline          (--conc) ignore the baseline entirely
  --no-baseline-growth   also fail on stale baseline entries (--conc) or on
                         a surface count below its budget (--ir)
  --write-baseline       (--conc) regenerate the baseline from findings
  --surface PATH         (--ir) surface budget (default:
                         kaboodle_tpu_torch/analysis/ir/surface.json)
  --write-surface        (--ir) regenerate the surface budget file
  --no-surface           (--ir) skip the exercise (KB405): nothing is run
  --device DEV           (--ir) torch device of the exercise (default: the
                         card; 'cpu' runs it on the host)
  --explain KBnnn        print one rule's documentation and exit
  --list-rules           print every rule id + title and exit
  -h, --help             this message
"""

_VALUED = ("--baseline", "--surface", "--device")


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
        if a == "--all":
            print("--all (every lane) checks jit tracing, which the port does not do; "
                  "run --conc, --ir or --rng", file=sys.stderr)
            return 2
        if a in _VALUED:
            i += 1
            if i >= len(argv):
                print(f"{a} needs a value", file=sys.stderr)
                return 2
            values[a] = argv[i]
        elif a in ("--no-baseline", "--no-baseline-growth", "--write-baseline",
                   "--write-surface", "--no-surface"):
            flags.add(a)
        elif a in ("--conc", "--ir", "--rng"):
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
    if not lanes:
        print("the AST lane (graftlint, KB1xx-KB3xx) checks jit tracing, which the "
              "port does not do; run with --conc, --ir or --rng", file=sys.stderr)
        return 2
    if len(set(lanes)) > 1:
        print("--conc, --ir and --rng are exclusive; pick one", file=sys.stderr)
        return 2
    lane = lanes[0]
    # The options each lane takes; anything else is a usage error.
    allowed = {
        "--conc": {"--baseline", "--no-baseline", "--no-baseline-growth", "--write-baseline"},
        "--ir": {"--surface", "--device", "--no-baseline-growth", "--write-surface",
                 "--no-surface"},
        "--rng": set(),
    }[lane]
    extra = sorted((set(values) | flags) - allowed)
    if extra or (targets and lane != "--conc"):
        print(f"{lane} does not take {', '.join(extra) or 'paths'}", file=sys.stderr)
        return 2
    no_growth = "--no-baseline-growth" in flags
    if lane == "--conc":
        return _run_conc(pathlib.Path(values.get("--baseline", DEFAULT_CONC_BASELINE)),
                         "--no-baseline" not in flags, no_growth,
                         "--write-baseline" in flags, targets)
    if lane == "--rng":
        return _run_rng()
    if {"--write-surface", "--no-surface"} <= flags:
        print("--write-surface needs the exercise: drop --no-surface", file=sys.stderr)
        return 2
    return _run_ir(values.get("--surface"), "--write-surface" in flags,
                   "--no-surface" not in flags, no_growth, values.get("--device"))


def _run_ir(surface_path: str | None, write_surface: bool, with_surface: bool,
            no_growth: bool, device) -> int:
    """KB405: the scripted exercise's programs built per family, gated on
    the committed surface budget."""
    from kaboodle_tpu_torch.analysis.ir import surface as ir_surface

    if not with_surface:
        print("graftscan: KB405 skipped (--no-surface); KB401-KB404 have no counterpart",
              file=sys.stderr)
        return 0
    path = pathlib.Path(surface_path or ir_surface.DEFAULT_SURFACE)
    try:
        committed = ir_surface.load_surface(path)
    except core.BaselineError as e:
        print(str(e), file=sys.stderr)
        return 2
    measured = ir_surface.measure_surface(device=device)
    if write_surface:
        ir_surface.write_surface(path, measured, committed)
        print(f"graftscan: wrote {path}", file=sys.stderr)
        return 0
    findings = ir_surface.surface_findings(measured, committed, no_growth=no_growth)
    for f in findings:
        print(f.render())
    print(f"graftscan: KB405 {measured}, {len(findings)} findings", file=sys.stderr)
    return 1 if findings else 0


def _run_rng() -> int:
    """KB602's registry half: the pinned stream table vs the live ids."""
    from kaboodle_tpu_torch.analysis.rng.rules import check_kb602_stream_registry

    findings = check_kb602_stream_registry()
    for f in findings:
        print(f.render())
    print(f"keyscope: KB602 registry, {len(findings)} findings", file=sys.stderr)
    return 1 if findings else 0


def _run_conc(
    baseline_path: pathlib.Path,
    use_baseline: bool,
    no_growth: bool,
    write: bool,
    targets: list[str],
) -> int:
    """The graftconc lane: KB5xx over the targets, gated on the baseline."""
    rules = [core.REGISTRY[rid] for rid in sorted(core.REGISTRY) if rid.startswith("KB5")]
    files = core.iter_python_files(targets or DEFAULT_TARGETS)
    findings: list[core.Finding] = []
    for f in files:
        findings.extend(core.analyze_path(f, rules=rules))

    try:
        baseline = core.load_baseline(baseline_path) if use_baseline else {}
    except core.BaselineError as e:
        print(str(e), file=sys.stderr)
        return 2

    if write:
        core.write_baseline(baseline_path, findings, baseline)
        print(
            f"graftconc: wrote {baseline_path} with "
            f"{len({x.key for x in findings})} entries",
            file=sys.stderr,
        )
        return 0

    active = [f for f in findings if f.key not in baseline]
    suppressed = len(findings) - len(active)
    for f in active:
        print(f.render())

    rc = 1 if active else 0
    if no_growth:
        live_keys = {f.key for f in findings}
        stale = sorted(k for k in baseline if k not in live_keys)
        for k in stale:
            print(f"stale baseline entry (fixed? delete it): {k}")
        if stale:
            rc = 1

    print(
        f"graftconc: {len(files)} files, {len(active)} findings"
        + (f" ({suppressed} baselined)" if suppressed else ""),
        file=sys.stderr,
    )
    return rc
