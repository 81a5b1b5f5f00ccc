#!/usr/bin/env python3
"""The row-blocked tick's block size at N = 65,536: wall and peak per size.

    python3 scripts/chunked_block_sweep.py [--blocks 1024,2048,4096]

For each block size, in turns, runs the two blocked cells of
``chip_smoke.py`` at full width with that ``CHUNK_BLOCK``: the BASELINE
config-4 broadcast boot (tick 0 with the closed-form union, then
``converge_loop``) and the first 3 ticks of config 5 (the Join avalanche
under 10 % drop with the full blocked union, a drop tick in the partition,
the first healed tick), random mode, lean state with int16 timers. Prints
one JSON line per run: wall seconds (ending in ``torch.cuda.synchronize()``)
and ``torch.cuda.max_memory_allocated()``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", default="1024,2048,4096")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunked_block_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for block in (int(b) for b in args.blocks.split(",")):
        chip_smoke.CHUNK_BLOCK = block
        boot_make, boot_run = chip_smoke.chunked_boot_case()
        _, faulty_make, faulty_run = chip_smoke.chunked_faulty_case(3)
        for cell, make, run in (("config4_boot", boot_make, boot_run),
                                ("config5_3ticks", faulty_make, faulty_run)):
            chip_smoke.release_device_memory()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run(make())
            torch.cuda.synchronize()
            print(json.dumps({"cell": cell, "n": chip_smoke.CHUNK_N, "block": block,
                              "wall_s": time.perf_counter() - t0,
                              "max_memory_allocated": torch.cuda.max_memory_allocated()}),
                  flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
