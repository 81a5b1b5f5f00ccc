#!/usr/bin/env python3
"""Where the PyTorch port's tick spends its time on the card.

    python3 scripts/torch_tick_profile.py [--out PATH] [--cells NAME,...]

Runs the main-path cells of ``chip_smoke.py`` (its ``boot_case``,
``churn_case``, ``chunked_boot_case``, ``chunked_faulty_case`` and
``fleet_args``, imported from there) -- the N=16,384 lean broadcast boot
(``run_until_converged``), the N=8,192 BASELINE config-3 churn (64 ticks,
``simulate``), both with all three kernel flags on, the blocked tick at
N=65,536: the config-4 boot and the first 3 ticks of config 5 (the Join
avalanche under drop, a drop tick in the partition, the first healed
tick), and the fleet's drop-rate sweep (``fleet/bench.py::sweep``, E = 256
meshes of N = 1,024, ``drop_rate=0:0.3:16``, at most 64 ticks), random
mode -- twice each: once plain for the wall time (ending in
``torch.cuda.synchronize()``), once under ``torch.profiler`` for the device
time by kernel. The dense cells are warmed up by a third run first; the
blocked and fleet cells, tens of seconds each, are not. Prints one JSON line per
cell: wall seconds, device kernel time, the device's busy share (device
time over the unprofiled wall) and the share of the four hand kernels;
``--out`` writes the full report, with the top device kernels by time,
as JSON. Needs a CUDA card; builds the kernels itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HAND_KERNELS = ("fused_fp_kernel", "fused_suspicion_kernel", "fused_oldest_k_kernel")
CELLS = ("boot_n16384_lean", "churn_config3_n8192", "chunked_boot_config4_n65536",
         "chunked_config5_n65536_3ticks", "fleet_sweep_e256_n1024")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_cell(name: str, make, run, warm: bool = True) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run(make())  # warm-up: library loads, cuBLAS handles, allocator
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    state = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    del state
    state = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state)
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    total_us = sum(us for _, us, _ in rows)
    hand_us = sum(us for k, us, _ in rows if any(h in k for h in HAND_KERNELS))
    rows.sort(key=lambda r: -r[1])
    return {
        "cell": name,
        "wall_s": wall,
        "device_kernel_s": total_us / 1e6,
        "device_busy_share": total_us / 1e6 / wall,
        "hand_kernel_s": hand_us / 1e6,
        "hand_kernel_share_of_device": hand_us / total_us if total_us else 0.0,
        "top_kernels": [{"name": k[:120], "device_ms": us / 1e3, "count": c}
                        for k, us, c in rows[:15]],
    }


def _fleet_sweep(args):
    from kaboodle_tpu_torch.fleet.bench import sweep

    return sweep(args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report (JSON) here")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help=f"comma-separated cells to run (default: all of {', '.join(CELLS)})")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tick_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from kaboodle_tpu_torch.ops import _cuda

    _cuda.build()
    card = chip_smoke.card_line()
    cases = {
        "boot_n16384_lean": lambda: chip_smoke.boot_case(),
        "churn_config3_n8192": lambda: chip_smoke.churn_case()[1:],
        "chunked_boot_config4_n65536": lambda: chip_smoke.chunked_boot_case() + (False,),
        "chunked_config5_n65536_3ticks": lambda: chip_smoke.chunked_faulty_case(3)[1:] + (False,),
        "fleet_sweep_e256_n1024": lambda: (
            lambda: chip_smoke.fleet_args("--sweep", chip_smoke.FLEET_SWEEP), _fleet_sweep, False),
    }
    cells = []
    for name in args.cells.split(","):
        cells.append(profile_cell(name, *cases[name]()))
        print(json.dumps({k: v for k, v in cells[-1].items() if k != "top_kernels"}), flush=True)
    out = {"card": card, "torch": torch.__version__, "cells": cells}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
