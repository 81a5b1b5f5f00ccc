#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` alone, each timed, on the card.

    python3 scripts/smoke_phases.py [PHASE ...]

Builds the hand kernels (``ops/_cuda.py``), then calls each named phase
function of ``chip_smoke.py`` (``oracle_parity``, ``serve_load``,
``fed_serve``, ``serve_chaos_obs``, ``sparse_parity``, ``sparse_boot``,
``cli``, ``shard_serve``, ``costscope`` (which runs ``churn`` first for its wall),
``kernels``, ``stage_cuts`` and ``analysis`` (each runs ``churn`` first for its
state), ``warp_drain``; default: all thirteen) with its defaults. Each phase prints its own JSON line; after it this prints
``PHASE <name> <seconds>``, or the traceback and goes on to the next. Prints the card line first, and exits
non-zero if any phase failed. A quick check of those phases, and a timing
probe of their sizes, without the rest of the smoke. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("oracle_parity", "serve_load", "fed_serve", "serve_chaos_obs", "sparse_parity",
          "sparse_boot", "cli", "shard_serve", "costscope", "kernels", "stage_cuts",
          "analysis", "warp_drain")


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}; choose from {PHASES}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from kaboodle_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device is available", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    print(f"build_s {time.perf_counter() - t0}", flush=True)
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            getattr(chip_smoke, f"phase_{name}")()
        except Exception:  # report the phase and go on to the next one
            traceback.print_exc()
            failed.append(name)
        print(f"PHASE {name} {time.perf_counter() - t0}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
