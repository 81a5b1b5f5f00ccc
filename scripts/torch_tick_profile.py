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
meshes of N = 1,024, ``drop_rate=0:0.3:16``, at most 64 ticks), and the
warp pass of ``BENCH_warp3.json``'s drain (``chip_smoke.warp_drain_case``:
N = 1,024 and its 8,192 ticks, ``simulate_warped`` over 1,024 calm ticks from the entry of the
pass's first leap, a hybrid span, through the dense season after it), and
the sparse bench's first chunk (``simulate_sparse``: 8 ticks from the boot
of N = 2^20 peers, K = 16, ``chip_smoke.sparse_spec``), and config 3's
first 16 churn ticks twice, through the dense tick and through the
row-sharded tick on a one-rank NCCL group (``chip_smoke.py``'s
``sharded`` cell: the collectives the sharded path calls, on one card),
random mode -- twice each: once plain for the wall time (ending in
``torch.cuda.synchronize()``), once under ``torch.profiler`` for the device
time by kernel. The dense cells are warmed up by a third run first; the
blocked and fleet cells, tens of seconds each, are not. Prints one JSON line per
cell: wall seconds, device kernel time, the device's busy share (device
time over the unprofiled wall) and the share of the four hand kernels;
``--out`` writes the full report, with the top device kernels by time,
as JSON. Each cell also lists the port's ``kaboodle:`` profiler ranges
(``telemetry/trace.py``): calls, host time and the device time of the
kernels launched inside them; the warp cell adds the device time per dense
tick and per leap step. Needs a CUDA card; builds the kernels itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HAND_KERNELS = ("fused_fp_kernel", "fused_suspicion_kernel", "fused_oldest_k_kernel")
# Calm ticks of the drain's warp pass in the warp cell's profile.
WARP_WINDOW = 1024
CELLS = ("boot_n16384_lean", "churn_config3_n8192", "chunked_boot_config4_n65536",
         "chunked_config5_n65536_3ticks", "fleet_sweep_e256_n1024", "warp_drain_n1024",
         "sparse_boot_n1048576", "churn16_config3_n8192", "sharded_churn16_config3_n8192")


def _device_us(evt, attrs=("self_device_time_total", "self_cuda_time_total")) -> float:
    for attr in attrs:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _ranges(prof) -> list[dict]:
    """The host-side ``kaboodle:`` ranges: calls, host ms, and the device ms
    of the kernels launched inside them."""
    import torch

    return [{"name": e.key, "count": e.count, "host_ms": e.cpu_time_total / 1e3,
             "device_ms": _device_us(e, ("device_time_total", "cuda_time_total")) / 1e3}
            for e in prof.key_averages()
            if e.key.startswith("kaboodle:") and e.device_type == torch.autograd.DeviceType.CPU]


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
    # Kernels only: a ``kaboodle:`` range also shows on the device timeline
    # (its first to last kernel, idle gaps included), not as a kernel.
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
            and not e.key.startswith("kaboodle:")]
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
        "ranges": _ranges(prof),
    }


def _fleet_sweep(args):
    from kaboodle_tpu_torch.fleet.bench import sweep

    return sweep(args)


def _warp_drain_case(chip_smoke, device="cuda", window: int = WARP_WINDOW):
    """``(make, run, warm, box)`` of a window of the drain's warp pass.

    A profile of the whole calm half (~7 M host events) outgrows the
    profiler's post-processing, so the cell profiles ``window`` calm ticks
    from the entry of the pass's first leap (a hybrid span: its leap, then
    the dense expiry season after it). ``make()`` finds that entry state
    once (the churn half dense, then the warp pass unprofiled)."""
    from kaboodle_tpu_torch.sim import simulate
    from kaboodle_tpu_torch.warp.runner import WarpLedger, simulate_warped

    cfg, st, churn, calm = chip_smoke.warp_drain_case(ticks=8192, device=device)
    box = {}

    def make():
        if "st" not in box:
            entries, ledger = [], WarpLedger()
            simulate_warped(simulate(st, churn, cfg, faulty=True)[0], calm, cfg, faulty=True,
                            ledger=ledger, on_boundary=lambda t, s: entries.append((t, s)))
            t0, box["st"] = entries[0]
            box.update(window_from=t0, first_leap=ledger.spans[0]["engine"], calm_ticks=window,
                       cfg=cfg)
            box["inputs"] = dataclasses.replace(calm, **{
                f.name: getattr(calm, f.name)[t0:t0 + window]
                for f in dataclasses.fields(calm) if getattr(calm, f.name) is not None})
        return box["st"]

    def run(state):
        box["dense_ticks"] = int(simulate_warped(state, box["inputs"], cfg, faulty=True)[1].size)

    return make, run, True, box


def _sparse_case(chip_smoke, ticks: int = 8):
    """``(make, run, warm)`` of the sparse bench's first chunk."""
    from kaboodle_tpu_torch.sparseplane import init_sparse_state, simulate_sparse, sparse_idle_inputs
    from kaboodle_tpu_torch.sparseplane.bench import bench_cfg

    spec, n = chip_smoke.sparse_spec(), chip_smoke.SPARSE_N
    idle = sparse_idle_inputs(n, ticks=ticks)
    return (lambda: init_sparse_state(n, spec, seed=0),
            lambda st: simulate_sparse(st, idle, bench_cfg(), spec), True)


def _churn16(chip_smoke, sharded: bool, ticks: int = 16):
    """``(make, run, warm)`` of config 3's first ``ticks`` churn ticks, all
    kernel flags on: the dense tick, or the row-sharded tick on a one-rank
    NCCL group (made here, or the one the process has)."""
    from kaboodle_tpu_torch.sim.kernel import make_tick_fn

    sc, make, _ = chip_smoke.churn_case()
    cfg = chip_smoke.all_kernels_cfg()
    inputs = sc.build()
    if sharded:
        from kaboodle_tpu_torch.parallel import (
            make_mesh,
            make_sharded_tick,
            shard_inputs,
            shard_state,
        )

        mesh = make_mesh()
        tick = make_sharded_tick(cfg, mesh)
        inputs = shard_inputs(inputs, mesh, stacked=True)
        make_state = lambda: shard_state(make(), mesh)  # noqa: E731
    else:
        tick, make_state = make_tick_fn(cfg, faulty=True), make

    def run(st):
        for t in range(ticks):
            st, _ = tick(st, inputs.at(t))

    return make_state, run, True


def _per_tick(cell: dict, box: dict, steps: int = 256, ticks: int = 64) -> None:
    """Device ms per dense tick and per leap step from the warp cell's
    ranges, and both timed directly from the window's entry state: a
    ``steps``-step hybrid leap against ``ticks`` dense ticks, each run
    ending in ``torch.cuda.synchronize()``."""
    import torch

    from kaboodle_tpu_torch.sim import idle_inputs, make_tick_fn
    from kaboodle_tpu_torch.warp.runner import _get_leap

    st, cfg = box["st"], box["cfg"]
    leap, tick = _get_leap(cfg, steps, hybrid=True), make_tick_fn(cfg)
    idle = idle_inputs(st.n, device=st.device)
    def dense():
        s = st
        for _ in range(ticks):
            s, _ = tick(s, idle)

    walls = {}
    for name, run in (("leap", lambda: leap(st)), ("dense", dense)):
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    cell.update(wall_ms_per_leap_step=1e3 * walls["leap"] / steps,
                wall_ms_per_dense_tick=1e3 * walls["dense"] / ticks)
    dense = sum(r["device_ms"] for r in cell["ranges"] if r["name"] == "kaboodle:dense_span")
    leap = sum(r["device_ms"] for r in cell["ranges"]
               if r["name"].startswith("kaboodle:leap_span:"))
    leaped = box["calm_ticks"] - box["dense_ticks"]
    cell.update(window_ticks=box["calm_ticks"], window_from_calm_tick=box["window_from"],
                first_leap=box["first_leap"], dense_ticks=box["dense_ticks"], leaped_ticks=leaped,
                device_ms_per_dense_tick=dense / max(box["dense_ticks"], 1),
                device_ms_per_leap_step=leap / max(leaped, 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report (JSON) here")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help=f"comma-separated cells to run (default: all of {', '.join(CELLS)})")
    args = ap.parse_args()
    import torch
    import torch.distributed

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
        "warp_drain_n1024": lambda: _warp_drain_case(chip_smoke),
        "sparse_boot_n1048576": lambda: _sparse_case(chip_smoke),
        "churn16_config3_n8192": lambda: _churn16(chip_smoke, sharded=False),
        "sharded_churn16_config3_n8192": lambda: _churn16(chip_smoke, sharded=True),
    }
    cells = []
    for name in args.cells.split(","):
        case = cases[name]()
        cells.append(profile_cell(name, *case[:3]))
        if name == "warp_drain_n1024":
            _per_tick(cells[-1], case[3])
        line = {k: v for k, v in cells[-1].items() if k not in ("top_kernels", "ranges")}
        print(json.dumps(line), flush=True)
    if torch.distributed.is_initialized():  # the sharded cell's one-rank group
        torch.distributed.destroy_process_group()
    out = {"card": card, "torch": torch.__version__, "cells": cells}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
