#!/usr/bin/env python3
"""The spread of the spill-latency arms on the card, measured one after another.

    python3 scripts/spill_latency_spread.py [--reps 4]

The chaos lane's ``spill_latency`` arms (``serve/chaos.py``: a class-32
pool of 4 lanes, chunk 8, no warp; a long horizon runner and 3 kept lanes
whose spill is armed before 40 measured rounds) are built here one arm at
a time and measured one after another, the order reversed every other
repetition (base, sync, async / async, sync, base), as the JAX lane
measures them. Each repetition prints every arm's mean and median round
in ms and its first 12 rounds. Then 10 rounds of a no-spill engine run
under ``torch.profiler``: wall per round, device time per round and
kernel launches, and the top host ops. Shows how far the arm means move
between repetitions against the lane's 10 % bar. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDS = 40


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool

    if not torch.cuda.is_available():
        print("spill_latency_spread: no CUDA device is available", file=sys.stderr)
        return 2
    cfg = SwimConfig(deterministic=True)

    def engine_for(sync):
        engine = ServeEngine([LanePool(32, 4, cfg=cfg, chunk=8, device="cuda")], warp=False,
                             sync_spill=bool(sync))
        engine.warmup()
        return engine

    def measure(sync):
        engine = engine_for(sync)
        engine.submit(ServeRequest(n=32, seed=1, mode="ticks", ticks=8 * (ROUNDS + 8),
                                   scenario="steady"))
        kept = [engine.submit(ServeRequest(n=32, seed=10 + i, mode="ticks", ticks=8,
                                           scenario="steady", keep=True)) for i in range(3)]
        while any(engine.status(r)["state"] != "parked" for r in kept):
            engine.step()
        if sync is not None:
            engine.spill_dir = tempfile.mkdtemp(prefix="kaboodle-spill-spread-")
            engine.spill_after = 0
        lat = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            engine.step()
            lat.append(time.perf_counter() - t0)
        if sync is not None:
            engine.settle_spills()
        engine.close()
        return (float(np.mean(lat) * 1e3), float(np.median(lat) * 1e3),
                [round(x * 1e3, 1) for x in lat[:12]])

    engine_for(None)  # builds the class-32 programs once
    names = {None: "base", True: "sync", False: "async"}
    for rep in range(args.reps):
        order = [None, True, False] if rep % 2 == 0 else [False, True, None]
        res = {names[arm]: measure(arm) for arm in order}
        print(json.dumps({"rep": rep, "order": [names[a] for a in order],
                          **{k: v[:2] for k, v in res.items()}}), flush=True)
        print("  first rounds", {k: v[2] for k, v in res.items()}, flush=True)

    engine = engine_for(None)
    engine.submit(ServeRequest(n=32, seed=1, mode="ticks", ticks=8 * 30, scenario="steady"))
    for _ in range(3):
        engine.step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ms = sum(k.self_device_time_total for k in ka) / 1e3
    launches = sum(k.count for k in ka if k.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({"profile_wall_ms_per_round": wall * 100,
                      "device_ms_per_round": dev_ms / 10, "kernel_launches": launches}))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
