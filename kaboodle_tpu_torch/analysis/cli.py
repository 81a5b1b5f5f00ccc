"""graftconc CLI: ``python -m kaboodle_tpu_torch.analysis --conc``.

The conc lane of ``kaboodle_tpu/analysis/cli.py``: rules KB501-KB506
(``analysis/conc/rules.py``), the host-concurrency auditor of the port's
serve plane, over ``kaboodle_tpu_torch/`` (or the paths given), gated
against its own debt file ``kaboodle_tpu_torch/analysis/conc/baseline.json``
(paths are taken from the working directory: run it from the checkout's
root). ``conc`` as the first argument is the same as ``--conc``.

Exit codes: 0 clean (baselined findings allowed), 1 findings or baseline
violations, 2 usage or baseline-format error.

- default: report every finding whose key is not in the baseline;
- ``--no-baseline-growth``: also fail on *stale* baseline entries (keys
  that no longer match any finding), so the baseline only shrinks;
- ``--write-baseline``: regenerate the baseline, keeping its reasons;
- ``--explain KB5nn`` / ``--list-rules``: rule documentation.

The JAX package's AST (KB1xx-KB3xx; its default, with no lane flag), IR
(``--ir``, KB4xx) and rng (``--rng``, KB6xx) lanes, and ``--all``, check
jit tracing, which the port does not do: they refuse with one line and
exit 2.
"""

from __future__ import annotations

import pathlib
import sys

from kaboodle_tpu_torch.analysis import core

DEFAULT_TARGETS = ["kaboodle_tpu_torch"]
DEFAULT_CONC_BASELINE = "kaboodle_tpu_torch/analysis/conc/baseline.json"

USAGE = """\
usage: python -m kaboodle_tpu_torch.analysis [--conc] [options] [paths...]

options:
  --conc                 the concurrency lane (graftconc, KB5xx) over the
                         serve scope ('conc' as first arg works too); the
                         port has no other lane (--ir, --rng, --all and the
                         flagless AST lane exit 2)
  --baseline PATH        baseline file (default:
                         kaboodle_tpu_torch/analysis/conc/baseline.json)
  --no-baseline          ignore the baseline entirely
  --no-baseline-growth   also fail on stale baseline entries (debt gate)
  --write-baseline       regenerate the baseline from current findings
  --explain KBnnn        print one rule's documentation and exit
  --list-rules           print every rule id + title and exit
  -h, --help             this message
"""

# The JAX lanes that check jit tracing: no counterpart in the port.
_REFUSED = {"--ir": "the IR lane (graftscan, KB4xx)",
            "--rng": "the rng lane (keyscope, KB6xx)",
            "--all": "--all (every lane)"}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("conc", "rng"):
        argv[0] = "--" + argv[0]
    baseline_path: pathlib.Path | None = None
    use_baseline = True
    no_growth = False
    write = False
    conc_mode = False
    targets: list[str] = []

    core._load_rules()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(USAGE, end="")
            return 0
        if a in _REFUSED:
            print(f"{_REFUSED[a]} checks jit tracing, which the port does not do; "
                  "only --conc runs here", file=sys.stderr)
            return 2
        if a == "--baseline":
            i += 1
            if i >= len(argv):
                print("--baseline needs a path", file=sys.stderr)
                return 2
            baseline_path = pathlib.Path(argv[i])
        elif a == "--no-baseline":
            use_baseline = False
        elif a == "--no-baseline-growth":
            no_growth = True
        elif a == "--write-baseline":
            write = True
        elif a == "--conc":
            conc_mode = True
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
    if not conc_mode:
        print("the AST lane (graftlint, KB1xx-KB3xx) checks jit tracing, which the "
              "port does not do; run with --conc", file=sys.stderr)
        return 2
    return _run_conc(baseline_path or pathlib.Path(DEFAULT_CONC_BASELINE), use_baseline,
                     no_growth, write, targets)


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
