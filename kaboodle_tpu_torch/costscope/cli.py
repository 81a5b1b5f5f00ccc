"""``python -m kaboodle_tpu_torch costscope`` -- the cost observatory's front door.

The port of ``kaboodle_tpu/costscope/cli.py``, with its flags and exit
codes (0 clean, 1 findings/regression, 2 usage or format error):

- default: extract the static records of the registry (or an ``--entry``
  subset) on the CPU and gate them against the port's committed
  ``kaboodle_tpu_torch/costscope/baseline.json``; needs no card;
- ``--write-baseline``: re-bank the baseline instead of gating (an
  ``--entry`` subset is merged into it);
- ``--report [--walls PATH]``: the roofline report from the committed
  baseline against the NVIDIA H100's floors, with the walls of a
  JSON-lines file placed against them; no extraction, no card;
- ``--icibench [--dryrun]``: time the two protocol collectives. With
  ``--dryrun``, the CPU sweep on a gloo group of 8 ranks, checks asserted.
  Without it, over the job's ranks (``torchrun``'s, or one) on the card
  by default -- or on ``--device`` -- banking ``MULTICHIP_nccl.json`` on
  the card at a world above one only. No card and no ``--device`` raises:
  there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaboodle_tpu_torch costscope",
        description="dispatch-counted cost records, collective-bytes audit, "
        "H100 roofline gate, collective microbench",
    )
    p.add_argument(
        "--entry",
        action="append",
        default=None,
        help="restrict to registry entries (repeatable / comma-separated); "
        "stale-entry checking is skipped for subsets",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="baseline path (default: kaboodle_tpu_torch/costscope/baseline.json)",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="re-bank the baseline from this run instead of gating",
    )
    p.add_argument(
        "--no-baseline-growth",
        action="store_true",
        help="shrink-only ratchet: stale entries and unbanked improvements "
        "also fail (the CI invocation)",
    )
    p.add_argument("--report", action="store_true", help="roofline report mode")
    p.add_argument(
        "--walls",
        default=None,
        help="report: JSON-lines walls (n_peers, ticks, wall_s, backend) to place",
    )
    p.add_argument("--icibench", action="store_true", help="collective microbench mode")
    p.add_argument(
        "--dryrun",
        action="store_true",
        help="icibench: small deterministic CPU sweep on 8 gloo ranks, no banking",
    )
    p.add_argument("--repeats", type=int, default=3, help="icibench: timing repeats")
    p.add_argument(
        "--device",
        default=None,
        help="icibench: the device (default: the card; 'cpu' runs gloo)",
    )
    p.add_argument("--json", default=None, help="also write the mode's JSON payload here")
    p.add_argument(
        "--manifest",
        default=None,
        help="append per-entry `costscope` records to this kaboodle-telemetry/1 manifest",
    )
    return p


def _entry_names(args) -> list[str] | None:
    if not args.entry:
        return None
    names: list[str] = []
    for chunk in args.entry:
        names.extend(n for n in chunk.split(",") if n)
    return names or None


def _dump_json(path: str | None, payload) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")


def _write_manifest(path: str, measured: dict) -> None:
    from kaboodle_tpu_torch.telemetry.manifest import ManifestWriter

    with ManifestWriter(path) as w:
        for name in sorted(measured):
            rec = measured[name]
            w.write(
                "costscope",
                entry=name,
                flops=rec["flops"],
                bytes_accessed=rec["bytes_accessed"],
                peak_bytes=rec["peak_bytes"],
                ici_bytes=rec["ici_bytes"],
                sharded=rec["sharded"],
            )


def _run_gate(args) -> int:
    from kaboodle_tpu_torch.costscope.baseline import (
        DEFAULT_BASELINE,
        gate_measurements,
        load_baseline,
        write_baseline,
    )
    from kaboodle_tpu_torch.costscope.extract import extract_entries

    path = args.baseline or DEFAULT_BASELINE
    names = _entry_names(args)
    try:
        measured = extract_entries(names)
    except KeyError as e:
        print(f"costscope: unknown entry {e}", file=sys.stderr)
        return 2
    _dump_json(args.json, measured)
    if args.manifest:
        _write_manifest(args.manifest, measured)
    if args.write_baseline:
        if names:
            # Subset re-bank: merge into the existing baseline.
            existing = load_baseline(path)
            merged = dict(existing["entries"]) if existing else {}
            merged.update(measured)
            write_baseline(path, merged)
        else:
            write_baseline(path, measured)
        print(f"costscope: banked {len(measured)} entries -> {path}")
        return 0
    try:
        baseline = load_baseline(path)
    except ValueError as e:
        print(f"costscope: {e}", file=sys.stderr)
        return 2
    failures = gate_measurements(
        measured,
        baseline,
        no_growth=args.no_baseline_growth,
        subset=names is not None,
    )
    for f in failures:
        print(f"costscope: {f}")
    n_shard = sum(1 for r in measured.values() if r["sharded"])
    print(
        f"costscope: {len(measured)} entries gated vs {path} "
        f"({n_shard} sharded), {len(failures)} failure(s)"
    )
    return 1 if failures else 0


def _run_report(args) -> int:
    from kaboodle_tpu_torch.costscope.baseline import DEFAULT_BASELINE, load_baseline
    from kaboodle_tpu_torch.costscope.roofline import (
        load_walls,
        render_report,
        roofline_from_baseline,
    )

    path = args.baseline or DEFAULT_BASELINE
    try:
        baseline = load_baseline(path)
        walls = load_walls(args.walls) if args.walls else []
    except (OSError, ValueError) as e:
        print(f"costscope: {e}", file=sys.stderr)
        return 2
    if baseline is None:
        print(f"costscope: no baseline at {path} -- run the extract first", file=sys.stderr)
        return 2
    names = _entry_names(args)
    if names:
        missing = [n for n in names if n not in baseline["entries"]]
        if missing:
            print(f"costscope: not in baseline: {missing}", file=sys.stderr)
            return 2
        baseline = {**baseline, "entries": {n: baseline["entries"][n] for n in names}}
    report = roofline_from_baseline(baseline, walls)
    print(render_report(report))
    _dump_json(args.json, report)
    return 0


def _icibench_dryrun() -> dict:
    """The CPU sweep on 8 gloo ranks; rank 0's report."""
    import tempfile
    from pathlib import Path

    from kaboodle_tpu_torch.costscope.extract import MESH_DEVICES
    from kaboodle_tpu_torch.costscope.icibench import DRYRUN_SIZES
    from kaboodle_tpu_torch.parallel.worker import start_workers

    case = {"name": "icibench", "kind": "costscope", "icibench": list(DRYRUN_SIZES)}
    with tempfile.TemporaryDirectory() as tmp:
        digests = start_workers(MESH_DEVICES, {"device": "cpu", "timeout_s": 120,
                                               "cases": [case]},
                                str(Path(tmp) / "cases.json")).wait()
    return digests["icibench"][0]["report"]


def _run_icibench(args) -> int:
    from kaboodle_tpu_torch.costscope.icibench import BANK_PATH, HW_SIZES, bank, render, run_sweep

    if args.dryrun:
        report = _icibench_dryrun()
    else:
        import torch.distributed as dist

        from kaboodle_tpu_torch.parallel.mesh import make_mesh

        mine = not dist.is_initialized()
        make_mesh(device=args.device)  # torchrun's ranks, or one; raises with no card
        try:
            report = run_sweep(HW_SIZES, dist.group.WORLD, repeats=args.repeats)
        finally:
            if mine:
                dist.destroy_process_group()
    if report["rank"] != 0:  # rank 0 speaks for the job
        return 0
    print(render(report))
    _dump_json(args.json, report)
    if args.dryrun:
        return 0
    if report["backend"] == "nccl" and report["n_devices"] > 1:
        bank(report, BANK_PATH)
        print(f"icibench: banked -> {BANK_PATH}")
    else:
        print(f"icibench: not multi-card NCCL (backend={report['backend']}, "
              f"ranks={report['n_devices']}) -- nothing banked")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.report and args.icibench:
        print("costscope: pick one of --report / --icibench", file=sys.stderr)
        return 2
    if args.report:
        return _run_report(args)
    if args.icibench:
        return _run_icibench(args)
    return _run_gate(args)


if __name__ == "__main__":
    raise SystemExit(main())
