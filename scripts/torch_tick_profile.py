#!/usr/bin/env python3
"""Where the PyTorch port's tick spends its time on the card.

    python3 scripts/torch_tick_profile.py [--out PATH]

Runs the two main-path cells of ``chip_smoke.py`` (its ``boot_case`` and
``churn_case``, imported from there) -- the N=16,384 lean
broadcast boot (``run_until_converged``) and the N=8,192 BASELINE config-3
churn (64 ticks, ``simulate``), all three kernel flags on, random mode --
twice each: once plain for the wall time (ending in
``torch.cuda.synchronize()``), once under ``torch.profiler`` for the device
time by kernel. Prints one JSON line per cell: wall seconds, device kernel
time, the device's busy share (device time over the unprofiled wall) and
the share of the four hand kernels; ``--out`` writes the full report, with
the top device kernels by time, as JSON. Needs a CUDA card; builds the
kernels itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HAND_KERNELS = ("fused_fp_kernel", "fused_suspicion_kernel", "fused_oldest_k_kernel")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_cell(name: str, make, run) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(make())  # warm-up: library loads, cuBLAS handles, allocator
    torch.cuda.synchronize()
    state = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report (JSON) here")
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
    _, churn_make, churn_run = chip_smoke.churn_case()
    cells = [
        profile_cell("boot_n16384_lean", *chip_smoke.boot_case()),
        profile_cell("churn_config3_n8192", churn_make, churn_run),
    ]
    out = {"card": card, "torch": torch.__version__, "cells": cells}
    for c in cells:
        print(json.dumps({k: v for k, v in c.items() if k != "top_kernels"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
