"""The comparison's control, run at a cell's own size on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds <s>

It puts the reference, computed in the nearest precision below the
configurations' float32 (bfloat16: the uniform draws, the reply
probabilities, the latency EWMA and the float metrics), in the program's
place and runs the cell as ``run.py`` does: set-up, the window, the
float32 reference and the comparison. Each seed prints one JSON line of
the numbers compared; the control has to fail at least one of them on
every seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import spec  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def control_factory(config, traffic, device):
    eng = spec.engine(config["engine"]["tick"])
    return eng.Reference(config, traffic, device, fdt=torch.bfloat16)


def readings(cell, seeds, seconds: float, factory, device) -> list[dict]:
    """One run of ``cell`` per seed with ``factory``'s side under test."""
    out = []
    for seed in seeds:
        result, shown = run_cell(cell, seed, seconds, False, factory, device, time.time())
        out.append({"seed": seed, "correct": result["correct"], "failed": result["failed"],
                    "attempted": result["attempted"],
                    "numbers": {k: v["value"] for k, v in shown.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    for row in readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                        control_factory, "cuda:0"):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
