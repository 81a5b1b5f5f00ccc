#!/usr/bin/env python3
"""The dense boot, churn and warp drain of ``chip_smoke.py``: this tree against another checkout's.

    python3 scripts/dense_ab.py --other DIR

``--other DIR`` is the root of another checkout, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory. Each
side runs in a process of its own, in the order other, this, this,
other, importing ``chip_smoke.py`` from its own root: it
builds its kernels, warms up with one boot, then times the N = 16,384 lean
broadcast boot (``boot_case``), the N = 8,192 BASELINE config-3 churn
(``churn_case``, 64 ticks), each ending in ``torch.cuda.synchronize()``,
with its peak and a SHA-256 digest of the run's final state and metrics
(every leaf's bytes) to show the two trees compute the same bits, and the
facade script at capacity 8,192 (``facade_script``: wall and host event
delivery per tick, and its tick counts, which must agree), and the warp
drain (``warp_drain_case`` at its 8,192 ticks: its churn half dense, then the calm half
through ``simulate_warped``; both walls, the dense tick count and the
final state's digest). Prints
the card line, one JSON line per run, then the summary: each side's walls,
the ratio of this tree's median wall to the other's, and whether every
digest agrees. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import dataclasses, hashlib, json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke
from kaboodle_tpu_torch.ops import _cuda

def digest(*objs):
    h = hashlib.sha256()
    for obj in objs:
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            if x is not None:
                h.update(f.name.encode())
                h.update(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

def timed(run, state):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(state)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

_cuda.build()
make, run = chip_smoke.boot_case()
run(make())  # warm-up
(final, ticks, conv), boot_s, boot_peak = timed(run, make())
boot_digest = digest(final)
del final
sc, cmake, crun = chip_smoke.churn_case()
(cfinal, metrics), churn_s, churn_peak = timed(crun, cmake())
churn_digest = digest(cfinal, metrics)
del cfinal, metrics
facade = chip_smoke.facade_script(8192, 512, 32, "cuda", log_events=False)
from kaboodle_tpu_torch.sim import simulate
from kaboodle_tpu_torch.warp.runner import simulate_warped
cfg, dst, churn_in, calm_in = chip_smoke.warp_drain_case(ticks=8192)
(dst, _), drain_churn_s, _ = timed(lambda s: simulate(s, churn_in, cfg, faulty=True), dst)
(dfinal, dense_ticks, _), drain_warp_s, _ = timed(
    lambda s: simulate_warped(s, calm_in, cfg, faulty=True), dst)
drain_digest = digest(dfinal)
print(json.dumps({"root": root, "boot_wall_s": boot_s, "boot_ticks": ticks,
                  "boot_converged": conv, "boot_peak": boot_peak, "boot_digest": boot_digest,
                  "churn_wall_s": churn_s, "churn_peak": churn_peak,
                  "churn_digest": churn_digest,
                  "facade_ms_per_tick": facade["wall_ms_per_tick"],
                  "facade_deliver_events_ms_per_tick": facade["deliver_events_ms_per_tick"],
                  "facade_ticks": [facade[k] for k in ("ticks", "boot_ticks", "departure_ticks",
                                                       "reconverge_ticks",
                                                       "rename_reconverge_ticks")],
                  "drain_churn_wall_s": drain_churn_s, "drain_warp_wall_s": drain_warp_s,
                  "drain_dense_ticks": int(dense_ticks.size), "drain_digest": drain_digest}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dense_ab: no CUDA device is available", file=sys.stderr)
        return 2
    roots = {"this": str(ROOT), "other": str(Path(args.other).resolve())}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for side in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, "-c", CHILD, roots[side]], capture_output=True,
                             text=True, check=True)
        row = {"side": side, **json.loads(out.stdout.strip().splitlines()[-1])}
        runs.append(row)
        print(json.dumps(row), flush=True)
    summary = {"card": card}
    ratios = {"boot_wall_s": "boot", "churn_wall_s": "churn", "facade_ms_per_tick": "facade",
              "drain_churn_wall_s": "drain_churn", "drain_warp_wall_s": "drain_warp"}
    for key, name in ratios.items():
        walls = {s: [r[key] for r in runs if r["side"] == s] for s in ("this", "other")}
        summary[key] = walls
        summary[name + "_ratio_this_over_other"] = (
            statistics.median(walls["this"]) / statistics.median(walls["other"]))
    summary["bits_equal"] = all(len({str(r[k]) for r in runs}) == 1
                                for k in ("boot_digest", "churn_digest", "facade_ticks",
                                          "drain_digest", "drain_dense_ticks"))
    print(json.dumps(summary), flush=True)
    return 0 if summary["bits_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
