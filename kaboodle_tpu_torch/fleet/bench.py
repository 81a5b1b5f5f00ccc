"""Sweep front-end: knob grids over the ensemble, one fleet run, one table.

The port of ``kaboodle_tpu/fleet/bench.py`` (``parse_sweep``,
``build_parser``, ``run_sweep``). A sweep spec ``knob=start:stop:steps``
lays a linspace grid over the ensemble: ``E // steps`` members per grid
point (E is trimmed to a multiple of ``steps`` with a note), each member
seeded independently, all advanced by ONE
:func:`kaboodle_tpu_torch.fleet.run_fleet_until_converged`. The statistics
-- overall and per-knob convergence-tick quantiles, converged fractions,
the survival curve -- are device reductions (``fleet/stats.py``); the host
sees the table. ``--seeds-only`` (no knob grid) measures seed sensitivity
at a fixed configuration, e.g. the documented sweep::

    --sweep drop_rate=0:0.3:16 --ensemble 1024
    --ensemble 256 --n 256 --seeds-only

Sweepable knobs are the per-member data (today ``drop_rate``); a static
``SwimConfig`` flag is A/B'd by one sweep per arm (``--deterministic``).
The result is the JAX package's dict; ``backend`` names the device type
(``"cuda"`` or ``"cpu"``). Output contract: a human table on stdout, then
the dict as one compact JSON line, the LAST line; ``--telemetry PATH``
writes it as a run manifest too (one ``run`` record plus one
``sweep_bucket`` record per knob value). Exit code 0 for any completed
measurement: a zero converged fraction is a valid result for a harsh
regime, not a failure. Runs on the card unless ``--device`` names another
(it takes the place of the JAX sweep's ``--platform``). ``--shard
ensemble`` splits the members over the job's ranks
(``fleet/sharding.py``; ``auto`` does so when the job has more than one
rank and E divides), and the line's ``"sharded"`` says which ran::

    python -m kaboodle_tpu_torch fleet --sweep drop_rate=0:0.3:16 --ensemble 1024
    python -m kaboodle_tpu_torch.fleet.bench --ensemble 64 --n 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import init_fleet, run_fleet_until_converged
from kaboodle_tpu_torch.fleet.stats import (
    convergence_quantiles,
    knob_marginals,
    knob_quantiles,
    survival_curve,
)
from kaboodle_tpu_torch.sim.state import resolve_device


def parse_sweep(spec: str):
    """``knob=start:stop:steps`` -> (knob, float32 grid). Only per-member
    knobs are sweepable; see the module docstring."""
    try:
        knob, rng = spec.split("=", 1)
        start_s, stop_s, steps_s = rng.split(":")
        start, stop, steps = float(start_s), float(stop_s), int(steps_s)
    except ValueError:
        raise SystemExit(
            f"bad --sweep spec {spec!r} (want knob=start:stop:steps)"
        ) from None
    if knob != "drop_rate":
        raise SystemExit(
            f"unknown sweep knob {knob!r}; sweepable per-member knobs: drop_rate"
        )
    if steps < 1:
        raise SystemExit("--sweep needs steps >= 1")
    return knob, np.linspace(start, stop, steps, dtype=np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaboodle_tpu_torch fleet",
        description="batched ensemble sweep: E meshes, one run, "
        "convergence statistics on the device",
    )
    p.add_argument("--ensemble", type=int, default=256, metavar="E",
                   help="ensemble members (default 256)")
    p.add_argument("--n", type=int, default=256, help="peers per mesh")
    p.add_argument("--sweep", default=None, metavar="KNOB=A:B:STEPS",
                   help="per-member knob grid, e.g. drop_rate=0:0.3:16")
    p.add_argument("--seeds-only", action="store_true",
                   help="no knob grid: pure seed-sensitivity ensemble")
    p.add_argument("--max-ticks", type=int, default=64)
    p.add_argument("--seed", type=int, default=0, help="base seed (member e "
                   "gets seed + e)")
    p.add_argument("--boot", choices=["broadcast", "gossip", "epidemic"],
                   default="broadcast",
                   help="broadcast (1-tick join avalanche), gossip "
                   "(broadcast-free, Q6 back-dating), epidemic (broadcast-"
                   "free, fresh gossip stamps)")
    p.add_argument("--quantiles", type=float, nargs="*",
                   default=[0.5, 0.9, 0.99])
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic protocol draws (A/B arm pin)")
    p.add_argument("--shard", choices=["auto", "none", "ensemble"], default="auto",
                   help="shard the ensemble axis over the job's ranks (auto: when "
                   "the job has more than one rank and E divides; a one-process "
                   "job runs a one-rank mesh with 'ensemble')")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run there)")
    p.add_argument("--telemetry", nargs="?", const="fleet-telemetry.jsonl",
                   default=None, metavar="PATH",
                   help="write the sweep result as a JSONL run manifest "
                        "(telemetry/manifest.py schema; one 'run' record "
                        "plus one 'sweep_bucket' record per knob value)")
    return p


def _job_ranks() -> int:
    """Ranks of this job: the process group's, or ``torchrun``'s
    ``WORLD_SIZE`` before one is made; 1 for a plain process."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def sweep(args):
    """Build and run the sweep's fleet: ``(line, fleet, conv_tick, done)``,
    ``line`` being :func:`run_sweep`'s dict and the rest the fleet run's
    final state and ``[E]`` outcome (for callers that check members)."""
    ensemble = args.ensemble
    knob_name, grid = (None, None)
    if args.sweep and args.seeds_only:
        # Silently dropping either flag would hand back the wrong
        # measurement: refuse the contradiction.
        raise SystemExit("--sweep and --seeds-only are mutually exclusive")
    if args.sweep:
        knob_name, grid = parse_sweep(args.sweep)
        steps = grid.shape[0]
        if ensemble < steps:
            raise SystemExit(
                f"--ensemble {ensemble} < sweep steps {steps}: need at "
                "least one member per grid point (shrink the grid or grow "
                "the ensemble)")
        if ensemble % steps:
            trimmed = ensemble - ensemble % steps
            print(f"fleet: --ensemble {ensemble} trimmed to {trimmed} "
                  f"(multiple of {steps} grid points)", file=sys.stderr)
            ensemble = trimmed
        knob = np.repeat(grid, ensemble // steps)
    else:
        knob = np.zeros((ensemble,), dtype=np.float32)

    dev = resolve_device(args.device)
    cfg = SwimConfig(
        deterministic=args.deterministic,
        join_broadcast_enabled=args.boot == "broadcast",
        backdate_gossip_inserts=args.boot != "epidemic",
    )
    # Lean state: the fleet resident is E x one mesh; latency EWMA and
    # per-row identity views are statistics-irrelevant here.
    fleet = init_fleet(
        args.n, ensemble,
        seeds=args.seed + np.arange(ensemble, dtype=np.int64),
        drop_rates=knob, device=dev,
        track_latency=False, instant_identity=True,
        ring_contacts=0 if args.boot == "broadcast" else 2,
    )
    faulty = bool(np.any(knob > 0))
    n_dev = _job_ranks()
    sharded = (args.shard == "ensemble"
               or (args.shard == "auto" and n_dev > 1 and ensemble % n_dev == 0))
    if sharded:
        from kaboodle_tpu_torch.fleet.sharding import (
            ENSEMBLE_AXIS,
            gather_fleet,
            make_fleet_mesh,
            run_fleet_until_converged_sharded,
            shard_fleet,
        )
        from kaboodle_tpu_torch.parallel.collectives import gather_rows

        mesh = make_fleet_mesh(device=args.device)
        fleet = shard_fleet(fleet, mesh)
        t0 = time.perf_counter()
        fleet, conv_tick, done = run_fleet_until_converged_sharded(
            fleet, cfg, mesh, max_ticks=args.max_ticks, faulty=faulty)
        # Every rank's members, for the statistics of the whole ensemble.
        group = mesh.get_group(ENSEMBLE_AXIS)
        conv_tick, done = gather_rows(conv_tick, group), gather_rows(done, group)
        fleet = gather_fleet(fleet, mesh)
    else:
        t0 = time.perf_counter()
        fleet, conv_tick, done = run_fleet_until_converged(
            fleet, cfg, max_ticks=args.max_ticks, faulty=faulty)

    qs = tuple(args.quantiles)
    overall_q = convergence_quantiles(conv_tick, done, qs=qs)
    surv = survival_curve(conv_tick, done, max_ticks=args.max_ticks)
    per_knob = None
    if grid is not None:
        values = torch.as_tensor(grid, device=dev)
        knob_t = torch.as_tensor(knob, device=dev)
        marg = knob_marginals(knob_t, values, conv_tick, done)
        kq = knob_quantiles(knob_t, values, conv_tick, done, qs=qs)
        per_knob = (grid, {k: v.cpu().numpy() for k, v in marg.items()}, kq.cpu().numpy())
    # One host fetch at the end: everything above is device-side.
    conv_frac = float(np.mean(done.cpu().numpy()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    qcols = "  ".join(f"p{int(q * 100):<4}" for q in qs)
    print(f"fleet: E={ensemble} N={args.n} boot={args.boot} "
          f"max_ticks={args.max_ticks} backend={dev.type}")
    print(f"{'knob':>10}  {'members':>7}  {'conv%':>6}  {'mean':>6}  {qcols}")
    overall_qv = overall_q.cpu().numpy()

    def qfmt(row):
        return "  ".join(f"{v:5.1f}" for v in row)

    if per_knob is not None:
        values, marg, kqv = per_knob
        for b, v in enumerate(values):
            print(f"{knob_name}={v:<6.3f}  {marg['members'][b]:>7}  "
                  f"{100 * marg['converged_fraction'][b]:>5.1f}%  "
                  f"{marg['mean_conv_tick'][b]:>6.1f}  {qfmt(kqv[b])}")
    print(f"{'ALL':>10}  {ensemble:>7}  {100 * conv_frac:>5.1f}%  "
          f"{'':>6}  {qfmt(overall_qv)}")

    line = {
        "metric": "fleet_convergence_quantiles",
        "ensemble": ensemble,
        "n_peers": args.n,
        "boot": args.boot,
        "sweep": args.sweep if grid is not None else None,
        "faulty": faulty,
        "sharded": bool(sharded),
        "backend": dev.type,
        "converged_fraction": round(conv_frac, 4),
        "quantiles": {f"p{int(q * 100)}": round(float(v), 2)
                      for q, v in zip(qs, overall_qv)},
        "survival_tail": round(float(surv[-1]), 4),
        "max_ticks": args.max_ticks,
        "wall_s": round(wall, 3),
    }
    if per_knob is not None:
        values, marg, kqv = per_knob
        line["per_knob"] = [
            {
                "knob": knob_name,
                "value": round(float(v), 4),
                "members": int(marg["members"][b]),
                "converged_fraction": round(float(marg["converged_fraction"][b]), 4),
                "mean_conv_tick": round(float(marg["mean_conv_tick"][b]), 2),
                "quantiles": {f"p{int(q * 100)}": round(float(x), 2)
                              for q, x in zip(qs, kqv[b])},
            }
            for b, v in enumerate(values)
        ]
    return line, fleet, conv_tick, done


def run_sweep(args) -> dict:
    """Run the sweep ``args`` describe (``build_parser``) and print its
    table; returns the JAX package's result dict (``wall_s`` ends after the
    device has finished, ``backend`` is the device type)."""
    return sweep(args)[0]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    line = run_sweep(args)
    if args.telemetry is not None:
        # The sweep's machine output as a run manifest: the same dict the
        # tail line prints, schema-tagged so the summarizer and any other
        # manifest consumer can ingest it beside sim manifests.
        from kaboodle_tpu_torch.telemetry.manifest import ManifestWriter

        with ManifestWriter(args.telemetry) as w:
            w.write("run", **{k: v for k, v in line.items() if k != "per_knob"})
            for bucket in line.get("per_knob") or []:
                w.write("sweep_bucket", **bucket)
        print(f"telemetry manifest: {args.telemetry}", file=sys.stderr)
    print(json.dumps(line))
    # A completed measurement is success even when nothing converged (the
    # non-convergent region of a sweep is a designed outcome, not an error).
    return 0


if __name__ == "__main__":
    sys.exit(main())
