"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: finds the cell in ``BENCHMARK.json``, makes
its inputs from the seed, sets up (the kernels' build or load, the start
mesh, the warm-up), measures the window, then holds what the window
produced to the benchmark's reference (``check.py``) and prints one JSON
line last on standard output. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled stretch of the
window. Each number compared is printed with its limit as the last lines of
standard error and under ``checks``, the line's last key.

Exits non-zero with no result line when there is no card (or fewer than the
cell asks for), when the checkout holds no program, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_WALL_AT_IMPORT = time.time()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Build and kernel caches at fixed paths inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import torch  # noqa: E402

from portbench import check, guard, spec  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench import window  # noqa: E402


def process_start_wall() -> float:
    """The wall-clock time this process started: its age from ``/proc`` (the
    start in clock ticks since boot against the uptime), else import time."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_s = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime_s = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime_s - start_s)
    except (OSError, ValueError, IndexError):
        return _WALL_AT_IMPORT


@dataclasses.dataclass
class WindowContext:
    """What an end-to-end reader is handed."""

    unit: str
    n: int
    units: int
    window_s: float
    unit_ms: list
    peak_bytes: int
    setup_s: float


def read_metrics(entries, read, ctx) -> dict:
    out = {}
    for m in entries:
        v = read(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def port(config: dict, traffic: dict, device):
    """The side under test in the benchmark's runs: the engine's ``Program``."""
    return spec.engine(config["engine"]["tick"]).Program(config, traffic, device)


def run_cell(cell, seed: int, seconds: float, trace: bool, adapter_factory, device,
             started: float) -> tuple[dict, dict]:
    """Set-up, window and check of one cell; returns (result line, checks).

    ``adapter_factory(config, traffic, device)`` builds the side under test:
    the program (``port``), or (for the control and the tests) a stand-in.
    The window, the reference and the comparison are the cell's engine's
    (``portbench/engines/``), or ``window.py``'s and ``check.py``'s."""
    eng = spec.engine(cell.config["engine"]["tick"])
    session_cls = getattr(eng, "Session", window.Session)
    follow, compare = getattr(eng, "follow", check.follow), getattr(eng, "compare", check.compare)
    adapter = adapter_factory(cell.config, cell.traffic, device)
    counter = None
    if trace:
        from portbench import program

        counter = (program.reset_launches, program.launches)
    session = session_cls(cell, seed, adapter, device, trace=trace, counter=counter)
    session.setup()
    setup_s = time.time() - started
    timing = session.window(seconds)
    produced = session.finish()
    tr = trace_mod.read(session.prof) if trace else None
    session.prof = None
    sched = session.sched
    win_ticks = len(produced.tick_pos) - session.window_from[0]
    win_runs = len(produced.runs) - session.window_from[1]
    unit = session.mode
    del adapter, session
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # The reference follows the same mix once the window has closed.
    t_ref = time.time()
    ref = eng.Reference(cell.config, cell.traffic, device)
    followed = follow(ref, produced, cell.traffic, sched, seed)
    numbers, bad = compare(produced, followed)
    correct, shown = check.verdict(numbers, cell.config["limits"])
    del followed, produced
    ms = timing["unit_ms"]
    first = (f" unit_ms first {ms[0]:.3f} rest median {statistics.median(ms[1:]):.3f}"
             f" min {min(ms[1:]):.3f} max {max(ms[1:]):.3f}" if len(ms) > 1 else "")
    print(f"portbench: setup_s {setup_s:.3f} window_s {timing['window_s']:.3f} "
          f"units {timing['units']} reference_s {time.time() - t_ref:.3f}{first}",
          file=sys.stderr)
    in_window = win_runs if unit == "run" else win_ticks
    failed = sum(bad[len(bad) - in_window:]) if in_window else 0

    if trace:
        alive = []
        if sched is not None:
            live = sched.alive_after().sum(axis=1)
            alive = [int(live[i]) for _, i in timing["trace_pos"]]
        ctx = trace_mod.Context(trace=tr, unit=unit, config=cell.config, alive=alive,
                                launches=timing["launches"])
        metrics = read_metrics(cell.per_layer, spec.metric_reader, ctx)
    else:
        wctx = WindowContext(unit=unit, n=cell.config["n"], units=timing["units"],
                             window_s=timing["window_s"], unit_ms=timing["unit_ms"],
                             peak_bytes=timing["peak_bytes"], setup_s=setup_s)
        metrics = read_metrics(cell.end_to_end, spec.end_to_end_reader, wctx)
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": timing["peak_bytes"],
    }
    result = {"correct": bool(correct and failed == 0), "attempted": timing["units"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = shown
    return result, shown


def main(argv=None) -> int:
    started = process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bad_ref = guard.reference_forbidden()
    if bad_ref:
        print(f"the reference imports what it may not: {bad_ref}", file=sys.stderr)
        return 3
    if importlib.util.find_spec("kaboodle_tpu_torch") is None:
        print("the program, kaboodle_tpu_torch, is not in this checkout", file=sys.stderr)
        return 5
    result, shown = run_cell(cell, args.seed, args.seconds, bool(args.trace), port,
                             "cuda:0", started)
    loaded = guard.loaded_forbidden()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    for k, v in shown.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
