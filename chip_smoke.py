#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the hand CUDA kernels of ``kaboodle_tpu_torch/csrc/`` itself and
runs nine phases, each printing one JSON line; any failure raises and the
script exits non-zero without the result line:

1. build    -- nvcc for ``sm_90a``, one process per source, all at once;
               registers and spills of every kernel (``-Xptxas -v``).
2. kernels  -- each kernel against its plain PyTorch version on the card,
               bit-exact, at the path's widths (N = 16,384 and 8,192) and
               others (4,112, 1,000), int16 and int32 timers, k = 1, 5, 9,
               40 and k above the eligible count, negative timers, timers at
               the dtype max, dead rows. Each shape the main path launches a
               kernel at is timed with CUDA events over repeated launches,
               beside its bound and its plain version; K4 also beside
               ``torch.topk`` over a prebuilt key plane (a selection
               yardstick, not the same function).
3. boot     -- fault-free broadcast boot to convergence at N = 16,384, lean
               state, int16 timers, all three kernel flags on, random mode.
4. churn    -- BASELINE config 3: N = 8,192, 64 ticks, 5 %/tick churn over
               ticks 1-32, full state (latency, identity views, int32
               timers), all flags on, random mode.
5. kernels_churn_state -- K4 on the churn run's final state, timer and
               alive planes (realistic timers: few distinct values, long
               runs of ties), bit-exact for k = 1, 5, 9, timed at k = 5.
6. telemetry -- the telemetry build: ``simulate_with_telemetry`` over the
               churn run's inputs (recorder of 32 ticks), its final state and
               per-tick metrics bit-equal to the churn's; then
               ``run_until_converged_telemetry`` at the boot's shape,
               ``(state, ticks, converged)`` equal to the boot's. Counter
               totals, the recorder's last rows, walls and peaks.
7. parity   -- the port on the card (kernels) against the port on the CPU
               (plain versions) at N = 512, 24 churn ticks, deterministic and
               random mode: every integer and bool leaf and metric equal,
               ``latency`` with NaN positions equal and rtol 1e-5; the
               telemetry build's counters and digest plane equal per tick.
8. facade   -- ``SimNetwork(8192)`` with all kernel flags on the card: 512
               instances start and converge, 32 stop and every running
               instance receives their departures, then one of the departed
               instances rejoins under a new identity and the mesh
               re-converges; at each convergence every running instance's
               ``fingerprint()`` equals its row of the kernel fingerprint.
               The same script at capacity 256 gives the same events, tick
               for tick, on the card and on the CPU.
9. checkpoint -- the churn state at tick 32 saved to ``.npz`` in a
               temporary directory of the checkout, loaded onto the card,
               run 32 more ticks: bit-equal to the uninterrupted churn run.

Launch counts are reset just before each main-path run (boot, churn, the
two telemetry runs, the facade at capacity 8,192 and the checkpoint's
resumed ticks) and read just after: each kernel of the path must have
launched. The last lines are the card's name and power limit, the
``{"kernels": [...]}`` summary (per kernel the numbers of the shape it is
launched at most, every timed shape under ``shapes`` and the launches per
run under ``launches_by_run``), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The card's peaks for the bounds. Memory: 3.35 TB/s (H100 SXM data sheet).
# The kernels do 32-bit integer operations: 64 INT32 lanes per SM (Hopper
# whitepaper) x 132 SMs x 1.98 GHz, the boost clock behind the data sheet's
# 67 TFLOP/s float32 rate (128 lanes x 2 FLOPs an FMA at the same clock).
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 64 * 132 * SM_CLOCK_HZ
# 32-bit integer operations a function needs per cell, counted from its
# definition (the per-cell body of the kernel), as (cell of an alive row,
# cell of a dead row). fp_idv: two mix32 (3 xor-shifts + 2 multiplies each,
# 8 ops) + 2 xors to key the hash, the state > 0 test, the masked add and the
# count add = 21. fp_hash: test, masked add, count add = 3. suspicion: count
# (test + add) and has_cand (== KNOWN, j != i, or) = 5 on every cell; an alive
# row adds timer <= thr, == WAITING_FOR_PING, == WAITING_FOR_INDIRECT_PING,
# the argmin compare and the flag or = 10. oldest_k: == KNOWN, j != i,
# timer != max, two ands and the compare against the k-th key = 6 on an alive
# row; a dead row has no eligible cell.
OPS_PER_CELL = {"fused_fp_idv": (21, 21), "fused_fp_hash": (3, 3),
                "fused_suspicion": (10, 5), "fused_oldest_k": (6, 0)}
ROOT = Path(__file__).resolve().parent

KERNEL_META = {
    "fused_fp_idv": ("kaboodle_tpu_torch/csrc/fused_fp.cu", "kaboodle_tpu/ops/fused_fp.py:129"),
    "fused_fp_hash": ("kaboodle_tpu_torch/csrc/fused_fp.cu", "kaboodle_tpu/ops/fused_fp.py:139"),
    "fused_suspicion": ("kaboodle_tpu_torch/csrc/fused_suspicion.cu",
                        "kaboodle_tpu/ops/fused_suspicion.py:119"),
    "fused_oldest_k": ("kaboodle_tpu_torch/csrc/fused_oldest_k.cu",
                       "kaboodle_tpu/ops/fused_oldest_k.py:119"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[dict]:
    """Registers and spills per compiled entry point, from ``-Xptxas -v``."""
    rows, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            rows.append({"fn": fn, "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["fn"] == fn:
            rows[-1]["registers"] = int(m.group(1))
    return rows


# ----------------------------------------------------------------- kernels


def time_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps`` calls.

    The calls are queued behind a sleep kernel that outlasts their launch
    on the host, so a kernel shorter than its wrapper's host time is timed
    on the card, not at the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_call_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * one_call_s, 2.0) * SM_CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(got, want) -> tuple[int, int]:
    """(mismatching elements, max |difference|) over tuples of outputs."""
    import torch

    mism, err = 0, 0
    for g, w in zip(got, want):
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        mism += int((g64 != w64).sum())
        err = max(err, int((g64 - w64).abs().max()) if g64.numel() else 0)
    return mism, err


def kernel_inputs(n: int, timer_dtype, gen):
    import torch

    dev = "cuda"
    state = torch.randint(0, 4, (n, n), generator=gen, device=dev, dtype=torch.int8)
    timer = torch.randint(-12, 40, (n, n), generator=gen, device=dev, dtype=torch.int32)
    tmax = torch.iinfo(timer_dtype).max
    sentinel = torch.rand((n, n), generator=gen, device=dev) < 0.05
    timer = torch.where(sentinel, tmax, timer).to(timer_dtype)  # timers at the dtype max
    alive = torch.rand((n,), generator=gen, device=dev) < 0.8  # dead rows
    idv = torch.randint(-2**31, 2**31 - 1, (n, n), generator=gen, device=dev, dtype=torch.int32)
    return state, timer, alive, idv


def oldest_k_key_plane(state, timer, alive):
    """The int64 (timer, j) keys of K4's eligible cells, INT64_MAX elsewhere:
    the input of the ``torch.topk`` yardstick, built outside its timing."""
    import torch

    from kaboodle_tpu_torch.spec import KNOWN

    n = state.shape[-1]
    col = torch.arange(n, device=state.device)
    T = timer.to(torch.int64)
    elig = (alive[:, None] & (state == KNOWN) & (col[None, :] != col[:, None])
            & (T != torch.iinfo(timer.dtype).max))
    return torch.where(elig, T * 2**32 + col[None, :], torch.iinfo(torch.int64).max)


def measure(name, n, k, state, timer, alive, idv, timed) -> tuple[dict, dict | None]:
    """One kernel case against its plain version; with ``timed`` (the main
    path cell whose shape this is) also its time, its bound and, for K4, the
    ``torch.topk`` yardstick."""
    import torch

    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count, fused_fp_count_plain
    from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k, fused_oldest_k_plain
    from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion, fused_suspicion_plain
    from kaboodle_tpu_torch.ops.hashing import peer_record_hash

    tb = timer.element_size()
    thr = 9
    live = int(alive.sum())
    if name == "fused_fp_idv":
        run = lambda: fused_fp_count(state, idv)  # noqa: E731
        plain = lambda: fused_fp_count_plain(state, idv)  # noqa: E731
        nbytes = n * n * 5 + 8 * n
    elif name == "fused_fp_hash":
        rec = peer_record_hash(torch.arange(n, device="cuda"), idv[0])
        run = lambda: fused_fp_count(state, rec)  # noqa: E731
        plain = lambda: fused_fp_count_plain(state, rec)  # noqa: E731
        nbytes = n * n + 4 * n + 8 * n
    elif name == "fused_suspicion":
        run = lambda: fused_suspicion(state, timer, alive, thr)  # noqa: E731
        plain = lambda: fused_suspicion_plain(state, timer, alive, thr)  # noqa: E731
        # Every output that reads a timer is gated on alive[i]: a dead
        # row needs its state row only.
        nbytes = n * n + live * n * tb + n + 11 * n
    else:
        run = lambda: fused_oldest_k(state, timer, alive, k)  # noqa: E731
        plain = lambda: fused_oldest_k_plain(state, timer, alive, k)  # noqa: E731
        # Dead rows have no eligible cell and are not read.
        nbytes = live * n * (1 + tb) + n + 5 * n * k
    got = run()
    want = plain()
    torch.cuda.synchronize()
    mism, err = max_abs_diff(got, want)
    case = {"kernel": name, "n": n, "timer": str(timer.dtype).replace("torch.", ""), "k": k,
            "mismatches": mism, "max_abs_err": err}
    if mism:
        raise AssertionError(f"{name} disagrees with its plain version: {case}")
    if not timed:
        return case, None
    per_live, per_dead = OPS_PER_CELL[name]
    ops = (live * per_live + (n - live) * per_dead) * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    row = {
        "cell": timed, "shape": case, "rows_alive": live,
        "kernel_ms": time_ms(run, 20),
        "plain_ms": time_ms(plain, 3),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "library_ms": None,
    }
    if name == "fused_oldest_k":
        keys = oldest_k_key_plane(state, timer, alive)
        top = lambda: torch.topk(keys, k, dim=-1, largest=False, sorted=True)  # noqa: E731
        vals, cols = top()
        ok = vals != torch.iinfo(torch.int64).max
        if not (torch.equal(ok, got[1]) and torch.equal(cols[ok].to(torch.int32), got[0][ok])):
            raise AssertionError(f"torch.topk yardstick disagrees with {name}: {case}")
        row["library_ms"] = time_ms(top, 5)
        row["library_call"] = ("torch.topk(keys, k, largest=False, sorted=True): "
                               "selection only, key plane prebuilt")
        del keys, vals, cols
    return case, row


def phase_kernels() -> dict:
    """Every kernel against its plain version; each shape the main path
    launches a kernel at is timed (``cell`` names the run that launches it)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    i16, i32 = torch.int16, torch.int32
    # (kernel, n, timer dtype, k, the main-path cell launching this shape)
    plan = [("fused_fp_idv", n, i32, 0, "churn" if n == 8192 else None)
            for n in (8192, 16384, 1000)]
    plan += [("fused_fp_hash", n, i16, 0, "boot" if n == 16384 else None)
             for n in (16384, 8192, 1000)]
    plan += [("fused_suspicion", n, dt, 0,
              {(16384, i16): "boot", (8192, i32): "churn"}.get((n, dt)))
             for n in (16384, 8192, 4112, 1000) for dt in (i16, i32)]
    plan += [("fused_oldest_k", n, dt, k,
              {(16384, i16, 5): "boot", (8192, i32, 5): "churn"}.get((n, dt, k)))
             for n in (16384, 8192, 1000) for dt in (i16, i32) for k in (1, 5, 9)]
    # k above one 32-wide round; k above the eligible count
    plan += [("fused_oldest_k", 4112, i16, 40, None), ("fused_oldest_k", 1000, i32, 1000, None)]
    cases, rows = [], []
    for name, n, dt, k, timed in plan:
        state, timer, alive, idv = kernel_inputs(n, dt, gen)
        case, row = measure(name, n, k, state, timer, alive, idv, timed)
        cases.append(case)
        if row:
            rows.append({"kernel": name, **row})
        del state, timer, alive, idv
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "tolerance": "bit-exact", "cases": cases, "timed": rows})
    return {"rows": rows, "cases": cases}


def phase_kernels_churn_state(final) -> dict:
    """K4 on the churn run's final planes (few distinct timers, long runs of
    ties), bit-exact for k = 1, 5, 9; timed at k = 5, the churn's k."""
    import torch

    state, timer, alive = final.state, final.timer, final.alive
    n = state.shape[-1]
    cases, rows = [], []
    for k in (1, 5, 9):
        case, row = measure("fused_oldest_k", n, k, state, timer, alive, None,
                            "churn_final_state" if k == 5 else None)
        cases.append({**case, "data": "churn final state"})
        if row:
            rows.append({"kernel": "fused_oldest_k", **row})
    torch.cuda.empty_cache()
    emit({"phase": "kernels_churn_state", "tolerance": "bit-exact", "cases": cases,
          "timed": rows, "distinct_timers": int(torch.unique(timer).numel())})
    return {"rows": rows, "cases": cases}


# ----------------------------------------------------------------- main path


def counts() -> dict:
    from kaboodle_tpu_torch.ops import _cuda

    return dict(_cuda.launches)


# The kernels each main-path run must launch: the boot's lean state hashes
# a precomputed record vector (K2), every full state its identity views (K1).
BOOT_KERNELS = ("fused_fp_hash", "fused_suspicion", "fused_oldest_k")
CHURN_KERNELS = ("fused_fp_idv", "fused_suspicion", "fused_oldest_k")


def require_launches(run: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{run} never launched {k}")


def to_host(obj):
    """A copy of a ``MeshState``/``TickMetrics`` with every tensor on the host,
    so a reference result held for a later comparison takes no device memory
    (and no share of a later run's peak)."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu()
                                       for f in dataclasses.fields(obj)
                                       if getattr(obj, f.name) is not None})


def state_diff(a, b) -> list[str]:
    """The ``MeshState`` fields where ``a`` and ``b`` differ (NaN == NaN)."""
    import torch

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(f.name)
        elif x.dtype != y.dtype or x.shape != y.shape:
            bad.append(f.name)
        elif x.is_floating_point():
            if not (torch.equal(torch.isnan(x), torch.isnan(y))
                    and torch.equal(torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0))):
                bad.append(f.name)
        elif not torch.equal(x, y):
            bad.append(f.name)
    return bad


def metrics_diff(a, b) -> list[str]:
    """The ``TickMetrics`` fields where the stacked metrics differ, bit for bit."""
    import torch

    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def recorder_tail(rec, rows: int = 3) -> list[dict]:
    """The recorder's last rows as JSON-ready dicts."""
    from kaboodle_tpu_torch.telemetry import recorder_rows

    table = recorder_rows(rec)["table"]
    return [{name: table[name][i].item() for name in table.dtype.names}
            for i in range(max(0, len(table) - rows), len(table))]


def all_kernels_cfg():
    """The default configuration with all three kernel flags on."""
    from kaboodle_tpu_torch.config import SwimConfig

    return SwimConfig(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


def boot_case():
    """The boot run as ``(make, run)``: ``make()`` gives a fresh N=16,384 lean
    state with int16 timers, ``run(state)`` boots it to convergence."""
    import torch

    from kaboodle_tpu_torch.sim import init_state, run_until_converged

    cfg = all_kernels_cfg()

    def make():
        return init_state(16384, seed=0, track_latency=False, instant_identity=True,
                          timer_dtype=torch.int16)

    def run(st):
        return run_until_converged(st, cfg, max_ticks=64)

    return make, run


def churn_case():
    """The churn run as ``(scenario, make, run)``: BASELINE config 3, full
    state, faulty ``simulate`` over the scenario's inputs."""
    from kaboodle_tpu_torch.sim import baseline_scenario, init_state, simulate

    cfg = all_kernels_cfg()
    sc = baseline_scenario(3)
    inputs = sc.build()

    def make():
        return init_state(sc.n, seed=0, alive=sc.initial_alive())

    def run(st):
        return simulate(st, inputs, cfg, faulty=True)

    return sc, make, run


def phase_boot() -> dict:
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    make, run = boot_case()
    st = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    final, ticks, conv = run(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    out = {"phase": "boot", "n": 16384, "ticks_run": ticks, "converged": conv,
           "wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(out)
    if not conv:
        raise AssertionError("the N=16,384 broadcast boot did not converge")
    require_launches("boot", launches, BOOT_KERNELS)
    return out, final


def phase_churn() -> dict:
    import numpy as np
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    sc, make, run = churn_case()
    st = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    final, metrics = run(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    T = sc.ticks
    at = {}
    for t in (0, T // 2, T - 1):
        at[str(t)] = {
            "messages_delivered": int(metrics.messages_delivered[t]),
            "converged": bool(metrics.converged[t]),
            "mean_membership": float(metrics.mean_membership[t]),
        }
    out = {"phase": "churn", "n": sc.n, "ticks": T, "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "metrics_at_tick": at, "launches": launches}
    emit(out)
    if not np.array_equal(final.alive.cpu().numpy(), sc.alive_trajectory()[-1]):
        raise AssertionError("final alive mask differs from the scenario's trajectory")
    if not bool(torch.isfinite(metrics.mean_membership).all()):
        raise AssertionError("non-finite mean_membership")
    require_launches("churn", launches, CHURN_KERNELS)
    return out, final, metrics


def phase_parity() -> dict:
    import numpy as np

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim import baseline_scenario, init_state, make_tick_fn
    from kaboodle_tpu_torch.sim.state import metrics_to_numpy, state_to_numpy

    out = {"phase": "parity", "n": 512, "ticks": 24}
    for det in (True, False):
        cfg = SwimConfig(deterministic=det, use_pallas_fp=True, use_pallas_oldest_k=True,
                         use_pallas_suspicion=True)
        sc = baseline_scenario(3, n=512, ticks=24, seed=1)
        tick = make_tick_fn(cfg, faulty=True)
        sides = {}
        for dev in ("cuda", "cpu"):
            sides[dev] = (init_state(512, seed=2, alive=sc.initial_alive(), device=dev),
                          sc.build(dev))
        worst_lat = 0.0
        for t in range(sc.ticks):
            res = {}
            for dev, (st, inp) in sides.items():
                st, m = tick(st, inp.at(t))
                sides[dev] = (st, inp)
                res[dev] = (state_to_numpy(st), metrics_to_numpy(m))
            for part in (0, 1):
                for k, g in res["cuda"][part].items():
                    w = res["cpu"][part][k]
                    if g is None or w is None:
                        if (g is None) != (w is None):
                            raise AssertionError(f"tick {t}: {k} present on one side only")
                        continue
                    if k == "latency":
                        if not np.array_equal(np.isnan(g), np.isnan(w)):
                            raise AssertionError(f"tick {t}: latency NaN positions differ")
                        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"tick {t} latency")
                        fin = ~np.isnan(w)
                        if fin.any():
                            worst_lat = max(worst_lat, float(np.abs(g[fin] - w[fin]).max()))
                    elif not np.array_equal(g, w):
                        raise AssertionError(f"tick {t}: {k} differs between card and CPU")
        out["deterministic" if det else "random"] = {
            "equal_ticks": sc.ticks, "latency_max_abs_diff": worst_lat,
            "final_converged": bool(res["cuda"][1]["converged"]),
            "telemetry": parity_telemetry(cfg, sc),
        }
    emit(out)
    return out


def parity_telemetry(cfg, sc) -> dict:
    """The telemetry build on the card against the CPU: every counter, the
    digest plane, the state and the metrics equal per tick."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.sim import init_state, make_tick_fn
    from kaboodle_tpu_torch.telemetry import FIELDS

    tick = make_tick_fn(cfg, faulty=True, telemetry=True)
    sides = {dev: (init_state(512, seed=2, alive=sc.initial_alive(), device=dev),
                   sc.build(dev)) for dev in ("cuda", "cpu")}
    totals = dict.fromkeys(FIELDS, 0)
    for t in range(sc.ticks):
        res = {}
        for dev, (st, inp) in sides.items():
            st, tel = tick(st, inp.at(t))
            sides[dev] = (st, inp)
            res[dev] = (st, tel)
        (gst, gtel), (wst, wtel) = res["cuda"], res["cpu"]
        for f in FIELDS:
            g, w = getattr(gtel.counters, f).cpu(), getattr(wtel.counters, f)
            if not torch.equal(g, w):
                raise AssertionError(f"telemetry tick {t}: counter {f} differs")
            totals[f] += int(w)
        if not torch.equal(gtel.fp.cpu(), wtel.fp):
            raise AssertionError(f"telemetry tick {t}: fp differs between card and CPU")
        gcpu = dataclasses.replace(gst, **{f.name: getattr(gst, f.name).cpu()
                                           for f in dataclasses.fields(gst)
                                           if getattr(gst, f.name) is not None})
        bad = [f for f in state_diff(gcpu, wst) if f != "latency"]
        if bad:
            raise AssertionError(f"telemetry tick {t}: state {bad} differs between card and CPU")
        if wst.latency is not None:
            np.testing.assert_allclose(gcpu.latency.numpy(), wst.latency.numpy(), rtol=1e-5)
        gm = dataclasses.replace(gtel.metrics, **{f.name: getattr(gtel.metrics, f.name).cpu()
                                                  for f in dataclasses.fields(gtel.metrics)})
        if metrics_diff(gm, wtel.metrics):
            raise AssertionError(f"telemetry tick {t}: metrics differ between card and CPU")
    return {"equal_ticks": sc.ticks, "counter_totals": totals}


def phase_telemetry(churn, churn_final, churn_metrics, boot, boot_final) -> dict:
    """The telemetry build at the churn's and the boot's shapes: the same
    trajectory as the telemetry-off runs (their results held on the host),
    plus counters and a recorder."""
    import torch

    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sim import run_until_converged_telemetry, simulate_with_telemetry
    from kaboodle_tpu_torch.telemetry import (
        FIELDS,
        ProtocolCounters,
        counters_totals,
        recorder_rows,
    )

    cfg = all_kernels_cfg()
    sc, make, _ = churn_case()
    inputs = sc.build()
    st = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    final, metrics, counters, rec = simulate_with_telemetry(st, inputs, cfg, faulty=True,
                                                            recorder_len=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    del st
    churn_out = {
        "n": sc.n, "ticks": sc.ticks, "wall_s": wall, "wall_s_telemetry_off": churn["wall_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_allocated_telemetry_off": churn["max_memory_allocated"],
        "counter_totals": counters_totals(counters), "recorder_rows": len(
            recorder_rows(rec)["table"]), "recorder_last_rows": recorder_tail(rec),
        "launches": launches,
    }
    require_launches("telemetry churn", launches, CHURN_KERNELS)
    bad = state_diff(to_host(final), churn_final) + metrics_diff(to_host(metrics), churn_metrics)
    if bad:
        raise AssertionError(f"telemetry churn differs from the telemetry-off churn in {bad}")
    del final, metrics, rec

    make_boot, run_boot = boot_case()
    # The boot phase was the run's first tick program and paid first-use
    # costs; a second telemetry-off boot gives the warm wall to compare with.
    st = make_boot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_boot(st)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    del st, warm
    st = make_boot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    bfinal, ticks, conv, totals, brec = run_until_converged_telemetry(st, cfg, max_ticks=64,
                                                                      recorder_len=32)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    blaunches = counts()
    del st
    boot_out = {
        "n": bfinal.n, "ticks_run": ticks, "converged": conv, "wall_s": bwall,
        "wall_s_telemetry_off": boot["wall_s"], "wall_s_telemetry_off_warm": warm_wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_allocated_telemetry_off": boot["max_memory_allocated"],
        "counter_totals": counters_totals(ProtocolCounters(
            **{f: getattr(totals, f).reshape(1) for f in FIELDS})),
        "recorder_last_rows": recorder_tail(brec), "launches": blaunches,
    }
    emit({"phase": "telemetry", "churn": churn_out, "boot": boot_out})
    require_launches("telemetry boot", blaunches, BOOT_KERNELS)
    if (ticks, conv) != (boot["ticks_run"], boot["converged"]) or state_diff(to_host(bfinal),
                                                                             boot_final):
        raise AssertionError("telemetry boot differs from the telemetry-off boot")
    return {"churn": churn_out, "boot": boot_out}


# ----------------------------------------------------------------- facade


def facade_script(capacity: int, instances: int, stops: int, device, log_events: bool) -> dict:
    """Drive ``SimNetwork``/``Kaboodle`` through one script of operations.

    ``instances`` start and converge; ``stops`` of them (slots 1..stops)
    stop, and the script ticks until every running instance has received
    all their departures; the mesh re-converges; then slot 1 rejoins under
    a new identity and the mesh re-converges. At each convergence every
    running instance's ``fingerprint()`` must equal its row of the kernel
    fingerprint (K1 over the identity views); the K1 launches of these
    checks are not counted as the run's (``check_launches``). With
    ``log_events`` the events every instance received are kept per tick."""
    import torch

    from kaboodle_tpu_torch import Kaboodle, SimNetwork
    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count

    net = SimNetwork(capacity, cfg=all_kernels_cfg(), seed=11, device=device)
    nodes = [Kaboodle(net, f"peer-{i}") for i in range(instances)]
    queues = [(k.discover_peers(), k.discover_departures(), k.discover_fingerprint_changes())
              for k in nodes]
    departed = [set() for _ in nodes]
    log = []
    ticks = 0
    deliver_s = 0.0
    orig_tick, orig_deliver = net.tick, net._deliver_events

    def deliver():
        # The host's share of a facade tick: the row fetch and the event
        # taps, after the tick's device work has finished.
        nonlocal deliver_s
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_deliver()
        deliver_s += time.perf_counter() - t0

    net._deliver_events = deliver

    def tick(n=1):
        nonlocal ticks
        for _ in range(n):
            m = orig_tick(1)
            ticks += 1
            for i, (disc, dep, fps) in enumerate(queues):
                departed[i].update(dep)
                if log_events:
                    log.append((i, list(disc), list(dep), list(fps)))
                disc.clear()
                dep.clear()
                fps.clear()
        return m

    net.tick = tick

    check_launches = dict.fromkeys(counts(), 0)

    def check_fingerprints(where: str) -> int:
        if net.state.id_view is None:
            raise AssertionError("the facade's state has no identity views")
        before = counts()
        fp, _ = fused_fp_count(net.state.state, net.state.id_view)
        fp = fp.cpu().numpy()
        for k, v in counts().items():
            check_launches[k] += v - before[k]
        bad = [k.self_addr() for k in nodes
               if k.is_running and int(fp[k.self_addr()]) & 0xFFFFFFFF != k.fingerprint()]
        if bad:
            raise AssertionError(f"facade {where}: fingerprint() != kernel row fp at {bad[:8]}")
        return sum(k.is_running for k in nodes)

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in nodes:
        k.start()
    boot_ticks = net.tick_until_converged(max_ticks=64)
    checked = check_fingerprints("boot")
    stopped = list(range(1, 1 + stops))
    for i in stopped:
        nodes[i].stop()
    detect_ticks = 0
    while not all(set(stopped) <= departed[i] for i, k in enumerate(nodes) if k.is_running):
        if detect_ticks >= 400:
            raise AssertionError("departures not delivered within 400 ticks")
        net.tick()
        detect_ticks += 1
    reconverge_ticks = net.tick_until_converged(max_ticks=64)
    checked += check_fingerprints("after departures")
    nodes[1].set_identity(b"renamed")
    nodes[1].start()
    rename_ticks = net.tick_until_converged(max_ticks=400)
    checked += check_fingerprints("after the rename")
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"capacity": capacity, "instances": instances, "stopped": stops,
            "ticks": ticks, "boot_ticks": boot_ticks, "departure_ticks": detect_ticks,
            "reconverge_ticks": reconverge_ticks, "rename_reconverge_ticks": rename_ticks,
            "fingerprints_checked": checked, "wall_s": wall, "wall_ms_per_tick": 1e3 * wall / ticks,
            "deliver_events_ms_per_tick": 1e3 * deliver_s / ticks,
            "check_launches": check_launches, "log": log}


def phase_facade() -> dict:
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    big = facade_script(8192, 512, 32, "cuda", log_events=False)
    launches = {k: v - big["check_launches"][k] for k, v in counts().items()}
    big["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    big["launches"] = launches
    del big["log"]
    require_launches("facade", launches, CHURN_KERNELS)
    small = {dev: facade_script(256, 64, 8, dev, log_events=True) for dev in ("cuda", "cpu")}
    if small["cuda"]["log"] != small["cpu"]["log"]:
        raise AssertionError("the capacity-256 facade script's events differ between card and CPU")
    events = sum(len(d) + len(p) + len(f) for _, d, p, f in small["cpu"]["log"])
    out = {"phase": "facade", "capacity_8192": big,
           "capacity_256": {"ticks": small["cpu"]["ticks"], "events_equal": events,
                            "wall_s_cuda": small["cuda"]["wall_s"],
                            "wall_s_cpu": small["cpu"]["wall_s"]}}
    emit(out)
    return big


# ----------------------------------------------------------------- checkpoint


def phase_checkpoint(churn_final) -> dict:
    """Save the churn state at tick 32, load it onto the card, run the last
    32 ticks: bit-equal to the uninterrupted churn run (``churn_final``,
    held on the host)."""
    import torch

    from kaboodle_tpu_torch import checkpoint
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sim import make_tick_fn

    sc, make, _ = churn_case()
    inputs = sc.build()
    tick = make_tick_fn(all_kernels_cfg(), faulty=True)
    half = sc.ticks // 2
    st = make()
    for t in range(half):
        st, _ = tick(st, inputs.at(t))
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        path = Path(d) / "churn_tick32.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, st)
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        back = checkpoint.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    bad = state_diff(back, st)
    if bad:
        raise AssertionError(f"the loaded checkpoint differs from the saved state in {bad}")
    del st
    _cuda.reset_launches()
    for t in range(half, sc.ticks):
        back, _ = tick(back, inputs.at(t))
    torch.cuda.synchronize()
    launches = counts()
    out = {"phase": "checkpoint", "n": sc.n, "at_tick": half, "archive_bytes": size,
           "save_s": save_s, "load_s": load_s, "launches_resumed": launches}
    emit(out)
    require_launches("checkpoint resume", launches, CHURN_KERNELS)
    bad = state_diff(to_host(back), churn_final)
    if bad:
        raise AssertionError(f"the resumed churn differs from the uninterrupted run in {bad}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "kaboodle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from kaboodle_tpu_torch.ops import _cuda

    card = card_line()
    t0 = time.perf_counter()
    _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {name: ptxas_summary(log) for name, log in _cuda.build_logs.items()}})

    kern = phase_kernels()
    boot, boot_final = phase_boot()
    boot_final = to_host(boot_final)
    churn, final, churn_metrics = phase_churn()
    churn_state = phase_kernels_churn_state(final)
    final, churn_metrics = to_host(final), to_host(churn_metrics)
    tele = phase_telemetry(churn, final, churn_metrics, boot, boot_final)
    del boot_final, churn_metrics
    phase_parity()
    facade = phase_facade()
    ckpt = phase_checkpoint(final)
    del final
    runs = {"boot": boot["launches"], "churn": churn["launches"],
            "telemetry_churn": tele["churn"]["launches"],
            "telemetry_boot": tele["boot"]["launches"], "facade": facade["launches"],
            "checkpoint_resume": ckpt["launches_resumed"]}

    rows = kern["rows"] + churn_state["rows"]
    cases = kern["cases"] + churn_state["cases"]
    summary = []
    for name, (source, replaces) in KERNEL_META.items():
        shapes = []
        for row in (r for r in rows if r["kernel"] == name):
            run = boot if row["cell"] == "boot" else churn
            shapes.append({**{k: v for k, v in row.items() if k != "kernel"},
                           "launches": run["launches"][name]})
        # The headline numbers are those of the shape launched most often.
        top = max(shapes, key=lambda r: r["launches"])
        mine = [c for c in cases if c["kernel"] == name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r[name] for r in runs.values()),
            "launches_boot": boot["launches"][name], "launches_churn": churn["launches"][name],
            "launches_by_run": {run: r[name] for run, r in runs.items()},
            "mismatches": sum(c["mismatches"] for c in mine),
            "max_abs_err": max((c["max_abs_err"] for c in mine), default=0),
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": top["shape"], "cell": top["cell"], "shapes": shapes,
        })
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
