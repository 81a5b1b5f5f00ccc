#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the hand CUDA kernels of ``kaboodle_tpu_torch/csrc/`` itself and
runs thirty-three phases, each printing one JSON line; any failure raises and the
script exits non-zero without the result line:

1. build    -- nvcc for ``sm_90a``, one process per source, all at once;
               registers and spills of every kernel (``-Xptxas -v``).
2. kernels  -- each kernel against its plain PyTorch version on the card,
               bit-exact, at the path's widths (N = 16,384, 8,192 and the
               warp drain's 1,024) and others (4,112, 1,000), int16 and int32 timers, k = 1, 5, 9,
               40 and k above the eligible count, negative timers, timers at
               the dtype max, dead rows. Each shape the main path launches a
               kernel at is timed with CUDA events over repeated launches,
               beside its bound, its plain version and its launch floor (an
               empty kernel at the same grid and block); K4 also beside
               ``torch.topk`` over a prebuilt key plane (a selection
               yardstick, not the same function). The costscope entries'
               shapes (N = 32 ticks, N = 128 ``ops.*``) are timed too.
3. boot     -- fault-free broadcast boot to convergence at N = 16,384, lean
               state, int16 timers, all three kernel flags on, random mode.
4. churn    -- BASELINE config 3: N = 8,192, 64 ticks, 5 %/tick churn over
               ticks 1-32, full state (latency, identity views, int32
               timers), all flags on, random mode.
5. kernels_churn_state -- K4 on the churn run's final state, timer and
               alive planes (realistic timers: few distinct values, long
               runs of ties), bit-exact for k = 1, 5, 9, timed at k = 5.
32. stage_cuts -- (run right after ``kernels_churn_state``) the dense
               tick's stage probe, ``make_tick_fn(cfg, _cut=label)`` for
               each label of ``tick.graph.cut_labels`` (``A``, ``c1``,
               ``c2``, ``c34``, ``G``) and the uncut full program: at N =
               1,024 (full state, all kernel flags, random mode; peer 5 cut
               off by a partition for two ticks, then healed with peer 9
               killed, so suspicion escalates and calls 3-4 deliver) one
               tick on the card and one on the CPU per cut, every leaf
               equal (``latency`` as ``parity`` compares it); then at
               config 3's width, from the churn run's final state under the
               churn schedule's tick-16 inputs, one warm-up and the median
               of 3 ticks per cut by CUDA events: each cut's ms, the
               successive differences (each stage's in-context cost) and
               the K1/K3/K4 launches of one tick under each cut. The ``G``
               cut must launch K1, K3 and K4.
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
10. chunked_parity -- the row-blocked tick against the dense tick (all kernel
               flags) at N = 16,384, lean, int16, deterministic mode: a
               broadcast boot tick (blocked: ``boot_union=True``), then 8
               faulty ticks with kills, a partition window and manual pings;
               state and integer metrics bit-equal per tick, the float
               metrics within a relative 1e-6. Then the blocked tick on the
               card against the CPU at N = 512 under config 5's drop with
               kills and a revive, both modes, plain and telemetry builds:
               every leaf and counter equal (``latency`` rtol 1e-5).
11. chunked_boot -- BASELINE config 4 at full width: N = 65,536, lean, int16,
               random mode, tick 0 through the blocked tick's closed-form
               union, then ``converge_loop``; converged, every sampled row
               knows every peer; the peak right after ``init_state``.
12. chunked_faulty -- BASELINE config 5 at full width, the first ``T5`` of
               its 96 ticks (10 % drop, the partition window, the heal):
               every tick delivers messages, the alive mask is the
               scenario's, every alive peer knows itself, the planes stay
               contiguous. Agreement is not asserted: it cannot hold while
               drop is on.
13. fleet_boot -- the sweep's seeds-only ensemble at BASELINE config 2's mesh:
               E = 256 members of N = 1,024 (268 M cells), broadcast boot,
               fault-free, lean state with int32 timers, random mode, seeds
               0-255, ``run_fleet_until_converged(max_ticks=64)``, then the
               quantiles and the survival curve on the card (``fleet/bench.py
               ::sweep``): wall, ticks run, peak, p50/p90/p99.
14. fleet_sweep -- the documented sweep ``--sweep drop_rate=0:0.3:16`` at E =
               256 (16 members a rate), N = 1,024, faulty, 64 ticks at most:
               the sweep's dict, wall and peak. Members that never converge
               under high drop are a result, not a failure.
15. fleet_parity -- a gate: members 0, 131 and 255 of fleet_boot and one
               member per drop rate of fleet_sweep equal standalone runs of
               the single-mesh tick on the card (same seed, rate and
               ``max_ticks``), state bit for bit and ``conv_tick ==
               ticks_run``; then a small fleet (E = 8, N = 128, 12 ticks,
               random mode, faulty, per-member drop rates and churn
               schedules) equals itself on the CPU, telemetry off and on.

16. warp_window -- the JAX TPU lane's calm-window measurement at full width
               (bench.py ``_bench_warp_drain_window``): N = 16,384, lean,
               int16 timers, all kernel flags on, ``ping_timeout_ticks`` =
               1,024; a mid-drain state (8 victims armed ``WaitingForPing``,
               victim 0 gone from half the rows) that classes ``hybrid``; 256
               dense fault-free ticks, the hybrid leap in one 256 chunk, and
               a span-memo replay, all three final states bit-equal.
17. warp_drain -- ``BENCH_warp3.json``'s end-to-end churn-recovery drain (bench.py
               ``_bench_warp_churn_recovery``) at N = 1,024, cut to 4,096 of
               its 8,192 ticks and its churn half to its last 512 (the
               smoke's budget; 2,560 ticks, the calm half 2,048):
               full state, int32 timers, ``ping_timeout_ticks`` = 682,
               kernel flags on; the churn half dense once, then the calm half
               dense, through ``simulate_warped`` with a ledger, a memo
               banking pass and a memo replay pass (all ``+memo``, no tick or
               leap run), all bit-equal, the warp and replay runs with the
               same dense ticks; then ``warp_mode="distributional"`` held to
               the dense run's alive planes, convergence and 8-tick steady
               message mean.
18. warp_fleet -- ``run_fleet_warped`` over E = 16 members of N = 1,024
               (converged, mid-drain and mid-boot, ``ping_timeout_ticks`` =
               512) for 512 ticks: members 0, 6 and 11 bit-equal to
               standalone ``run_warped`` on the card, the ledger with fleet
               leap rounds; then an E = 8, N = 128 warped fleet on the card
               equal to the same fleet on the CPU.
19. serve    -- ``ServeServer`` in-process on 127.0.0.1 (ephemeral port) over
               ``LanePool(1024, 64)`` and ``LanePool(4096, 8)`` on the card,
               the server's defaults otherwise (deterministic config, not
               faulty, chunk 8, warp and the process span memo on,
               ``max_leap`` 256), journal and spills in a temporary
               directory of the checkout: the warmup timed, then 8
               concurrent ``ServeClient``s submit 104 requests (64 converge
               boots at n = 1,000, 32 steady runs of 256 ticks at 1,024, 4
               boots and 4 steady runs of 128 ticks at 4,096) while a ninth
               connection cancels one request and takes a kept one through
               park, spill, restore and a 16-tick resume. Every request ends
               done or cancelled, ``compiles_steady`` (programs built after
               warmup) is 0, the streamed records equal the manifest's, and 8
               sampled harvests (both classes, both modes) and the resumed
               request equal standalone runs on the card, member leaf by
               leaf with ``conv_tick`` and the fingerprint statistics.
               Warmup, wall, requests/s, client p50/p99, rounds by engine,
               memo hits and bytes, a leap round's wall split into the leap
               program and the memo's host work, peak memory.
20. serve_parity -- ``serve/dryrun.py::parity_script`` (class 64, 8 lanes,
               chunk 4, the kept request's spill round trip included) on the
               card and on the CPU: status rows, records, ``serve_round``
               records and final pools bit-equal.
21. oracle_parity -- the dense tick on the card, all four kernels on, held
               tick by tick to the lockstep oracle (``oracle/lockstep.py``):
               state codes, timers where a state exists, fingerprints of
               alive rows, ``converged``, messages delivered. The N = 256
               broadcast boot (share cap 16, lean state, int16 timers, 4
               ticks), then a random-fault N = 128 run (random flags, full
               state, 32 ticks) whose dense and blocked (block 64) telemetry
               ticks also equal the oracle's counters field by field. K1, K2,
               K3 and K4 must each launch.
22. serve_load -- ``serve/loadgen.py`` in its default mode at class 1,024
               (16 lanes, chunk 8, warp on): the warmup wave, 32 closed-loop
               requests at concurrency 8, 32 open-loop at ``LOAD_RATE``;
               nothing built in the steady phases, the results of 4 sampled
               seeds (every request with that seed) equal to standalone runs.
23. fed_serve -- two ``ServeServer``s (e0: 1,024 x 16 and 4,096 x 4; e1:
               1,024 x 16) on one spill root and one journal root behind a
               ``FedRouter``: fedload's open-loop level of 48 requests (every
               4th of class 4,096, every 8th kept, resumed and cancelled),
               then e1 killed mid-round (fedload's chaos at class 1,024). No
               lost terminal, no request completed twice in a journal, the
               request spilled on e1 adopted by e0 and resumed equal to its
               standalone run, nothing built, sampled results equal to
               standalone runs; then ``fedload --dryrun`` on the card.
24. serve_chaos -- ``serve/chaos.py::run_chaos_dryrun`` on the card (the six
               scenarios at N = 16/32, their own bars).
25. serve_obs -- ``serve/obsdryrun.py::run_obs_dryrun`` on the card
               (traced lifecycle, exporters, obs overhead at most 5 %).
26. sparse_parity -- the blocked-sparse ``[N, K]`` tick on the card against
               the CPU: 48 faulty ticks at N = 4,096, K = 16 (kills, a
               revival, 5 % drop), random and deterministic, int32 and int16
               timers, every plane and metric bit-equal tick by tick; then
               the first 2 ticks at N = 2^20, planes bit-equal and
               ``mean_membership`` to rel 1e-6. Mismatches by field and tick.
27. sparse_boot -- the sparse bench's run at full width (N = 1,048,576,
               K = 16, 3 boot contacts, 3 chunks of 8 ticks): warmup, s/tick
               and ns/peer/tick of the steady chunks, the fill curve, peak
               memory, ``compiles_steady`` 0; a ``save_sparse`` /
               ``load_sparse`` round trip of the mid state resumed bit-equal
               to the unbroken run; the peak of one tick at N = 1,024 and
               8,192; the dryrun's stat leg at n = 24 on the card.
28. cli      -- the port's command line (``python -m kaboodle_tpu_torch``)
               as a user calls it: ``--sim 1024 --ticks 64`` as a
               subprocess with no ``--device`` (so on the card), exit 0 and
               converged, its JSON line equal to the same run in-process on
               the CPU in every key but ``wall_s``; ``--sim-scenario 3 --sim
               1024 --ticks 512 --warp --telemetry`` on the card (the churn's
               recovery takes ~2·N ticks, so the run may end unconverged:
               the exit code must say which) and ``telemetry --check`` on its
               manifest; the sweep ``fleet --ensemble 64 --n 1024 --sweep
               drop_rate=0:0.3:4 --max-ticks 32 --telemetry`` (one ``run``
               and four ``sweep_bucket`` records); the ``phasegraph`` dryrun
               at n = 32 and at n = 1,024 with E = 8, every engine bit-exact
               with the dense tick on the card; beside them, each in a fresh
               process, ``python -m kaboodle_tpu_torch.analysis --ir
               --entries ops.fused_fp`` (the KB405 exercise on the card
               against the committed ``surface.json``, one traced entry) and
               ``--rng --entries ops.crc32`` (the STREAM_* register, one
               traced entry; the whole registry is phase 33's), each exit 0.
               Default ``SwimConfig``: no
               hand kernel runs (the ``use_pallas_*`` flags are off, as in
               the JAX CLI), so the in-process runs count 0 launches.

29. sharded  -- (run right after ``telemetry``) the multi-device layer on
               the card's one rank: a one-rank NCCL group made in-process,
               every collective of the row-sharded tick called on it.
               Config 3's churn for 16 ticks, all kernel flags on, each
               sharded tick bit-equal to the dense tick (K1, K3, K4
               launching on the rank's rows); the N = 16,384 boot through
               ``run_until_converged_sharded``, equal to ``boot`` in ticks
               and state; a ``save_async`` / ``load_orbax`` (DCP) round trip
               of the sharded churn state; ``run_warped(mesh=)`` over 256
               ticks of a converged N = 1,024 mesh, equal to the sharded
               dense run; the sweep with ``--shard ensemble`` (``"sharded":
               true``); the dryrun's ``sharded`` arm. The group is destroyed
               at the end. The ``kernels`` phase also checks K1, K3 and K4
               on ``[N/4, N]`` row slices of an N = 8,192 mesh at row0 =
               N/4, N/2, 3N/4 (bit-exact, timed; cell ``row_slice``).
30. shard_serve -- (run right after ``sharded``) the sharded serve pool
               (``serve/shardpool.py``) on the card's one rank, a one-rank
               NCCL group made in-process: ``ShardedLanePool(1024, 64)`` on
               a 1-D ``ensemble`` mesh and ``ShardedLanePool(4096, 8)`` on a
               1 x 1 ``ensemble x peers`` mesh (the row-sharded tick's
               collectives called on the peer group), each beside a plain
               ``LanePool`` of its class, both behind a ``ServeEngine``
               (warp on, ``max_leap`` 256): 16 + 8 (4 + 2 at 4,096)
               converge boots and steady ticks-mode runs with their leap
               rounds, and a kept request parked, spilled, restored and
               resumed. The request results equal, every lane's member
               bit-equal, nothing built after warmup; warmups, walls and
               peak memory. The group is destroyed at the end.
31. costscope -- (run right after ``cli``) the port's cost observatory
               (``kaboodle_tpu_torch/costscope/``) on the card: every entry
               of the registry (``analysis/ir/registry.py``: the dense,
               fused, lean, random, blocked, sparse and telemetry ticks,
               the recorder, the leaps, the fleet tick, the serve step,
               reseed and leap, the sharded twins and the ``ops.*``
               kernels, N = 16 to 128) run on the card and on the CPU, its
               outputs bit-equal, and every one-device entry's static
               record (flops, bytes accessed, argument, output and peak
               bytes of ``costscope/extract.py``'s dispatch counter) equal
               on both devices; the four sharded entries on a one-rank
               NCCL group made here, against a one-rank gloo job on the
               CPU. K1-K4 must launch. Then ``costscope --icibench`` at
               world 1 over NCCL for N = 2^10 .. 2^16 (its walls; nothing
               crosses a link, so the ring bytes are 0) and ``costscope
               --report`` with the ``churn`` phase's wall as its one
               ``--walls`` line (the ``tick.faulty`` placement).
33. analysis -- (run right after ``costscope``) the traced analysis lanes
               on the card: ``run_scan`` (KB401-KB404 over the dispatch
               trace, ``analysis/ir/``) and ``run_rng_scan`` (KB601-KB605
               over the key provenance recorded at the counter-RNG calls,
               ``analysis/rng/``) over the registry's 31 entries, each
               entry run as it is and with every device gate forced each
               way, the sharded ones on a one-rank NCCL group made here.
               The finding keys and the KB402 counts by site equal the
               committed baselines, the leap report the committed
               ``analysis/rng/leap.json``; K1-K4 must launch. Then one
               dense churn tick at full width (the ``churn`` run's final
               N = 8,192 state through the ``phasegraph.tick.faulty``
               build): its KB401-KB404 keys and its sinks equal the N = 32
               entry's, shapes scaled to N (one sink for the drop draw's
               16 row chunks). Prints the KB402 host syncs per call of
               each tick entry and of the full-width tick.

Launch counts are reset just before each main-path run (boot, churn, the
two telemetry runs, the sharded churn ticks and the sharded boot, the facade at capacity 8,192, the checkpoint's
resumed ticks, the two blocked runs, the two fleet runs, the warp runs,
the two serve runs, the sharded serve runs, the oracle parity, the serve drivers, the two
sparse runs, the in-process command-line runs, the costscope entries' card runs, the
stage cuts' timed ticks and the analysis phase's registry and full-width runs) and read
just after: each kernel of the dense path
must have launched; the blocked tick, the fleet, the leaps, the serve
step and the sparse tick run no kernel (as in the JAX package, whose fleet
refuses the Pallas flags and whose leap and sparse tick have no Pallas
call), so their runs count 0 and none is required of them; every one-mesh
warp run with a dense tick in it must launch the dense path's kernels. The
last lines are the card's name and power limit, the
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


def oldest_k_key_plane(state, timer, alive, row0: int = 0):
    """The int64 (timer, j) keys of K4's eligible cells, INT64_MAX elsewhere:
    the input of the ``torch.topk`` yardstick, built outside its timing
    (``state`` may be rows ``row0 ..`` of a mesh)."""
    import torch

    from kaboodle_tpu_torch.spec import KNOWN

    n = state.shape[-1]
    col = torch.arange(n, device=state.device)
    own = col[row0:row0 + state.shape[0]]
    T = timer.to(torch.int64)
    elig = (alive[:, None] & (state == KNOWN) & (col[None, :] != own[:, None])
            & (T != torch.iinfo(timer.dtype).max))
    return torch.where(elig, T * 2**32 + col[None, :], torch.iinfo(torch.int64).max)


# The mesh whose quarter-row slices the kernels phase checks and times.
ROW_SLICE_N = 8192

# Warps (rows) per block of K4's launch (``kWarps`` in fused_oldest_k.cu,
# which has no launch-shape query).
OLDEST_K_WARPS = 4


def launch_shape(name: str, n: int) -> tuple[int, int]:
    """The grid and block ``name`` is launched with at ``n``: from its
    library's ``kb_launch_shape`` (K1-K3), from ``OLDEST_K_WARPS`` (K4)."""
    import ctypes

    from kaboodle_tpu_torch.ops import _cuda

    if name == "fused_oldest_k":
        return -(-n // OLDEST_K_WARPS), 32 * OLDEST_K_WARPS
    lib = _cuda.library(Path(KERNEL_META[name][0]).stem)
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    lib.kb_launch_shape.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.kb_launch_shape.restype = None
    lib.kb_launch_shape(n, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def launch_floor_ms(name: str, n: int, rows: int | None = None) -> tuple[float, list[int]]:
    """An empty kernel at the grid and block of ``name``'s launch at ``n``
    (over ``rows`` of its rows: the grid is in rows), timed as the kernel is
    (``time_ms``, 20 launches): the device time any launch of that shape
    takes before it does work."""
    import ctypes

    import torch

    from kaboodle_tpu_torch.ops import _cuda

    blocks, threads = launch_shape(name, n)
    if rows is not None:  # every launch shape here has whole blocks of rows
        blocks = -(-blocks * rows // n)
    lib = _cuda.library(Path(KERNEL_META[name][0]).stem)
    lib.kb_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kb_empty_launch.restype = ctypes.c_int
    stream = _cuda.stream_handle(torch.device("cuda"))

    def run():
        _cuda.check(lib, lib.kb_empty_launch(blocks, threads, stream), "kb_empty_launch")

    return time_ms(run, 20), [blocks, threads]


def measure(name, n, k, state, timer, alive, idv, timed, row0: int = 0
            ) -> tuple[dict, dict | None]:
    """One kernel case against its plain version; with ``timed`` (the main
    path cell whose shape this is) also its time, its bound and, for K4, the
    ``torch.topk`` yardstick. The inputs may be ``B`` rows of a mesh of
    ``n`` starting at ``row0`` (a rank's rows); ``idv`` then holds those
    rows' identity views."""
    import torch

    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count, fused_fp_count_plain
    from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k, fused_oldest_k_plain
    from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion, fused_suspicion_plain
    from kaboodle_tpu_torch.ops.hashing import peer_record_hash

    tb = timer.element_size()
    thr = 9
    b = state.shape[0]  # the rows: n for a whole mesh
    live = int(alive.sum())
    if name == "fused_fp_idv":
        run = lambda: fused_fp_count(state, idv)  # noqa: E731
        plain = lambda: fused_fp_count_plain(state, idv)  # noqa: E731
        nbytes = b * n * 5 + 8 * b
    elif name == "fused_fp_hash":
        rec = peer_record_hash(torch.arange(n, device="cuda"), idv[0])
        run = lambda: fused_fp_count(state, rec)  # noqa: E731
        plain = lambda: fused_fp_count_plain(state, rec)  # noqa: E731
        nbytes = b * n + 4 * n + 8 * b
    elif name == "fused_suspicion":
        run = lambda: fused_suspicion(state, timer, alive, thr, row0)  # noqa: E731
        plain = lambda: fused_suspicion_plain(state, timer, alive, thr, row0)  # noqa: E731
        # Every output that reads a timer is gated on alive[i]: a dead
        # row needs its state row only.
        nbytes = b * n + live * n * tb + b + 11 * b
    else:
        run = lambda: fused_oldest_k(state, timer, alive, k, row0)  # noqa: E731
        plain = lambda: fused_oldest_k_plain(state, timer, alive, k, row0)  # noqa: E731
        # Dead rows have no eligible cell and are not read.
        nbytes = live * n * (1 + tb) + b + 5 * b * k
    got = run()
    want = plain()
    torch.cuda.synchronize()
    mism, err = max_abs_diff(got, want)
    case = {"kernel": name, "n": n, "timer": str(timer.dtype).replace("torch.", ""), "k": k,
            "mismatches": mism, "max_abs_err": err}
    if b != n:
        case.update(rows=b, row0=row0)
    if mism:
        raise AssertionError(f"{name} disagrees with its plain version: {case}")
    if not timed:
        return case, None
    per_live, per_dead = OPS_PER_CELL[name]
    ops = (live * per_live + (b - live) * per_dead) * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    floor_ms, grid = launch_floor_ms(name, n, b)
    row = {
        "cell": timed, "shape": case, "rows_alive": live,
        "kernel_ms": time_ms(run, 20),
        "launch_floor_ms": floor_ms, "launch_grid": grid,
        "plain_ms": time_ms(plain, 3),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "library_ms": None,
    }
    if name == "fused_oldest_k":
        keys = oldest_k_key_plane(state, timer, alive, row0)
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
    plan += [("fused_suspicion", 1024, i16, 0, None), ("fused_fp_hash", 1024, i16, 0, None)]
    plan += [("fused_oldest_k", n, dt, k,
              {(16384, i16, 5): "boot", (8192, i32, 5): "churn"}.get((n, dt, k)))
             for n in (16384, 8192, 1000) for dt in (i16, i32) for k in (1, 5, 9)]
    # k above one 32-wide round; k above the eligible count
    plan += [("fused_oldest_k", 4112, i16, 40, None), ("fused_oldest_k", 1000, i32, 1000, None)]
    # The warp drain's dense stretches: N = 1,024, full state, int32 timers.
    plan += [("fused_fp_idv", 1024, i32, 0, "warp_drain"),
             ("fused_suspicion", 1024, i32, 0, "warp_drain")]
    plan += [("fused_oldest_k", 1024, i32, k, "warp_drain" if k == 5 else None) for k in (1, 5, 9)]
    # The costscope entries' shapes: the N = 32 ticks (full state, int32
    # timers; the lean ones hash, int16; deterministic, so K4 at k = 1) and
    # the N = 128 ``ops.*`` entries (int32 timers, K4 at k = 5).
    plan += [("fused_fp_idv", 32, i32, 0, "costscope"), ("fused_fp_hash", 32, i16, 0, "costscope"),
             ("fused_fp_hash", 128, i32, 0, "costscope"),
             ("fused_suspicion", 32, i32, 0, "costscope"),
             ("fused_suspicion", 128, i32, 0, "costscope"),
             ("fused_oldest_k", 32, i32, 1, "costscope"),
             ("fused_oldest_k", 128, i32, 5, "costscope")]
    cases, rows = [], []
    for name, n, dt, k, timed in plan:
        state, timer, alive, idv = kernel_inputs(n, dt, gen)
        case, row = measure(name, n, k, state, timer, alive, idv, timed)
        cases.append(case)
        if row:
            rows.append({"kernel": name, **row})
        del state, timer, alive, idv
    # A rank's rows of the churn's mesh: [N/4, N] at row0 = N/4, N/2, 3N/4
    # (the row offset a sharded tick gives every kernel but rank 0's), each
    # bit-exact and timed as the whole-mesh shapes are. The card runs one
    # rank, so these shapes are on no run of the smoke ("row_slice").
    n = ROW_SLICE_N
    state, timer, alive, idv = kernel_inputs(n, i32, gen)
    for name, k in (("fused_fp_idv", 0), ("fused_suspicion", 0), ("fused_oldest_k", 5)):
        for row0 in (n // 4, n // 2, 3 * n // 4):
            sl = slice(row0, row0 + n // 4)
            case, row = measure(name, n, k, state[sl], timer[sl], alive[sl], idv[sl],
                                "row_slice", row0)
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


# ---------------------------------------------------------------- stage cuts

CUT_PARITY_N = 1024
# The churn schedule's tick whose inputs (5 % kills and revives) drive the
# timed cut ticks from the churn run's final state.
CUT_TICK = 16
CUT_REPS = 3


def cut_parity_case(n: int, device: str):
    """``(state, inputs)`` of the cut parity: a converged mesh of ``n``
    (full state, int32 timers) with peer 5 cut off by a partition for two
    ticks, so pings to it time out; the probed tick's inputs heal the
    partition and kill peer 9, so suspicion escalates and calls 3-4
    deliver. The two lead-in ticks run the card's kernels on the card."""
    import torch

    from kaboodle_tpu_torch.sim import init_state, make_tick_fn
    from kaboodle_tpu_torch.sim.state import idle_inputs

    st = init_state(n, seed=5, ring_contacts=n - 1, announced=True, device=device)
    part = torch.zeros(n, dtype=torch.int32, device=device)
    part[5] = 1
    cut_off = dataclasses.replace(idle_inputs(n, device=device), partition=part)
    tick = make_tick_fn(all_kernels_cfg(), faulty=True)
    for _ in range(2):
        st, _ = tick(st, cut_off)
    kill = torch.zeros(n, dtype=torch.bool, device=device)
    kill[9] = True
    return st, dataclasses.replace(idle_inputs(n, device=device), kill=kill)


def card_cpu_mismatch(card: tuple, cpu: tuple, where: str) -> float:
    """Raise unless ``(state_np, metrics_np)`` of the card equals the CPU's:
    every integer and bool leaf bit for bit, ``latency`` with NaN positions
    equal and rtol 1e-5. Returns the largest finite ``latency`` difference."""
    import numpy as np

    worst_lat = 0.0
    for part in (0, 1):
        for k, g in card[part].items():
            w = cpu[part][k]
            if g is None or w is None:
                if (g is None) != (w is None):
                    raise AssertionError(f"{where}: {k} present on one side only")
                continue
            if k == "latency":
                if not np.array_equal(np.isnan(g), np.isnan(w)):
                    raise AssertionError(f"{where}: latency NaN positions differ")
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{where} latency")
                fin = ~np.isnan(w)
                if fin.any():
                    worst_lat = max(worst_lat, float(np.abs(g[fin] - w[fin]).max()))
            elif not np.array_equal(g, w):
                raise AssertionError(f"{where}: {k} differs between card and CPU")
    return worst_lat


def phase_stage_cuts(final=None, device="cuda") -> dict:
    """The stage probe (phase 32): each cut of the full program on the card
    against the CPU at N = 1,024, then each cut timed in context from the
    churn run's final state (``final``, on the card; the ``churn`` phase is
    run here when it is not given)."""
    import statistics

    import torch

    if final is None:
        final = phase_churn()[1]

    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sim import baseline_scenario, make_tick_fn
    from kaboodle_tpu_torch.sim.state import (
        metrics_to_numpy,
        state_to_numpy,
    )
    from kaboodle_tpu_torch.spec import WAITING_FOR_PING

    t_phase = time.perf_counter()
    cfg = all_kernels_cfg()
    labels = make_tick_fn(cfg, faulty=True).graph.cut_labels
    cuts = (*labels, None)  # None: the uncut full program

    def build(cut):
        return make_tick_fn(cfg, faulty=True, _cut=cut, program=None if cut else "full")

    # -- card against CPU, bit for bit -----------------------------------
    st, inp = cut_parity_case(CUT_PARITY_N, device)
    st_cpu, inp_cpu = to_host(st), to_host(inp)
    timed_out = bool(((st_cpu.state == WAITING_FOR_PING)
                      & (int(st_cpu.tick) - st_cpu.timer.to(torch.int64)
                         >= cfg.ping_timeout_ticks)).any())
    parity, timers = {}, {}
    for cut in cuts:
        tick = build(cut)
        got = tick(st, inp)
        want = tick(st_cpu, inp_cpu)
        name = cut or "full"
        parity[name] = card_cpu_mismatch(
            (state_to_numpy(got[0]), metrics_to_numpy(got[1])),
            (state_to_numpy(want[0]), metrics_to_numpy(want[1])), f"stage_cuts {name}")
        timers[name] = int((want[0].timer != st_cpu.timer).sum())
        del got
    del st, inp
    t_parity = time.perf_counter() - t_phase

    # -- each cut timed in context at config 3's width -------------------
    sc = baseline_scenario(3)
    inputs = sc.build(device).at(CUT_TICK)
    n = final.state.shape[-1]
    card = card_line()
    ms, per_tick = {}, {}
    torch.cuda.synchronize()
    _cuda.reset_launches()
    for cut in cuts:
        tick = build(cut)
        name = cut or "full"
        before = counts()
        tick(final, inputs)  # the warm-up, whose launches are one tick's
        torch.cuda.synchronize()
        after = counts()
        per_tick[name] = {k: after[k] - before[k] for k in after}
        reps = []
        for _ in range(CUT_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tick(final, inputs)
            end.record()
            torch.cuda.synchronize()
            reps.append(start.elapsed_time(end))
        ms[name] = {"median": statistics.median(reps), "reps": reps}
    launches = counts()
    names = [c or "full" for c in cuts]
    stages = {f"{a}->{b}": ms[b]["median"] - ms[a]["median"] for a, b in zip(names, names[1:])}
    stages = {f"start->{names[0]}": ms[names[0]]["median"], **stages}
    k134 = ("fused_fp_idv", "fused_suspicion", "fused_oldest_k")
    line = {"stage_cuts": {"card": card, "n": n, "tick": int(final.tick),
                           "inputs": f"churn schedule tick {CUT_TICK}",
                           "ms": {k: v["median"] for k, v in ms.items()}, "stages_ms": stages,
                           "launches_per_tick": {c: {k: per_tick[c][k] for k in k134}
                                                 for c in names}}}
    out = {"phase": "stage_cuts", "card": card, "labels": list(labels),
           "parity": {"n": CUT_PARITY_N, "equal": names, "timed_out_ping": timed_out,
                      "latency_max_abs_diff": parity, "timers_moved": timers},
           "parity_s": t_parity, "n": n, "cut_ms": ms, "stages_ms": stages,
           "launches_per_tick": per_tick, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    print(json.dumps(line), flush=True)
    if not timed_out:
        raise AssertionError("stage_cuts: the parity state has no timed-out ping to escalate")
    if not timers["c2"] < timers["c34"]:
        raise AssertionError(f"stage_cuts: calls 3-4 moved no timer: {timers}")
    require_launches("stage_cuts G", per_tick["G"], k134)
    return out


# ------------------------------------------------------------------ sharded

SHARDED_CHURN_TICKS = 16
SHARDED_WARP_N = 1024
SHARDED_WARP_TICKS = 256
SHARDED_SWEEP = ("--ensemble", "16", "--n", "1024", "--seeds-only", "--max-ticks", "16")


def phase_sharded(boot, boot_final) -> dict:
    """The multi-device layer (``parallel/``) on the card's one rank: a
    one-rank NCCL group made here, every collective of the row-sharded tick
    called on it, destroyed at the end. Config 3's churn for its first 16
    ticks, all kernel flags on, each tick of the sharded tick held bit-equal
    to the dense tick (launches counted around the sharded ticks only); the
    N = 16,384 boot through ``run_until_converged_sharded``, equal to the
    ``boot`` phase in ticks and state; a ``save_async`` / ``load_orbax``
    round trip of the churn's sharded state; ``run_warped(mesh=)`` over 256
    ticks of a converged N = 1,024 mesh, equal to the sharded dense run;
    the sweep with ``--shard ensemble``; the dryrun's ``sharded`` arm."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from kaboodle_tpu_torch import checkpoint
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet import bench as fleet_bench
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.parallel import (
        gather_state,
        make_mesh,
        make_sharded_tick,
        run_until_converged_sharded,
        shard_inputs,
        shard_state,
    )
    from kaboodle_tpu_torch.phasegraph import dryrun
    from kaboodle_tpu_torch.sim import init_state
    from kaboodle_tpu_torch.sim.kernel import make_tick_fn
    from kaboodle_tpu_torch.sim.state import idle_inputs
    from kaboodle_tpu_torch.warp.runner import WarpLedger, run_warped

    t_phase = time.perf_counter()
    mesh = make_mesh()
    out = {"phase": "sharded", "mesh": str(mesh), "backend": str(dist.get_backend()),
           "world": dist.get_world_size()}

    # Config 3's churn: the sharded tick against the dense tick, tick by tick.
    sc, make, _ = churn_case()
    cfg = all_kernels_cfg()
    inputs = sc.build()
    dense_tick, sh_tick = make_tick_fn(cfg, faulty=True), make_sharded_tick(cfg, mesh)
    a = make()
    b, sin = shard_state(a, mesh), shard_inputs(inputs, mesh, stacked=True)
    launches = {k: 0 for k in _cuda.KERNELS}
    bad, t_dense, t_sharded = [], 0.0, 0.0
    for t in range(SHARDED_CHURN_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, ma = dense_tick(a, inputs.at(t))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _cuda.reset_launches()
        b, mb = sh_tick(b, sin.at(t))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k, v in counts().items():
            launches[k] += v
        t_dense, t_sharded = t_dense + t1 - t0, t_sharded + t2 - t1
        diff = state_diff(a, b) + [f.name for f in dataclasses.fields(ma)
                                   if not torch.equal(getattr(ma, f.name), getattr(mb, f.name))]
        if diff:
            bad.append({"tick": t, "fields": diff})
    out["churn"] = {"n": sc.n, "ticks": SHARDED_CHURN_TICKS, "dense_s": t_dense,
                    "sharded_s": t_sharded, "mismatched_ticks": bad, "launches": launches}
    if bad:
        raise AssertionError(f"sharded churn != dense churn: {bad}")
    require_launches("sharded_churn", launches, CHURN_KERNELS)

    # save_async / load_orbax of the sharded churn state (DCP), in the checkout.
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        handle = checkpoint.save_async(Path(tmp) / "dcp", b, mesh=mesh)
        returned = time.perf_counter() - t0
        handle.wait_until_finished()
        saved = time.perf_counter() - t0
        template = init_state(sc.n, device="meta")
        back = checkpoint.load_orbax(Path(tmp) / "dcp", template, mesh=mesh)
        torch.cuda.synchronize()
        loaded = time.perf_counter() - t0 - saved
    out["checkpoint"] = {"save_returned_s": returned, "save_s": saved, "load_s": loaded,
                         "mismatches": state_diff(b, back)}
    if out["checkpoint"]["mismatches"]:
        raise AssertionError(f"save_async/load_orbax round trip: {out['checkpoint']}")
    del a, b, back, sin, inputs
    torch.cuda.empty_cache()

    # The N = 16,384 boot, sharded: the boot phase's ticks and state.
    make_boot, _ = boot_case()
    st = shard_state(make_boot(), mesh)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    final, ticks, conv = run_until_converged_sharded(st, all_kernels_cfg(), mesh, max_ticks=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    boot_launches = counts()
    diff = state_diff(to_host(gather_state(final, mesh)), boot_final)
    out["boot"] = {"n": 16384, "ticks_run": ticks, "converged": conv, "wall_s": wall,
                   "boot_phase_wall_s": boot["wall_s"], "mismatches": diff,
                   "launches": boot_launches}
    if (ticks, conv) != (boot["ticks_run"], boot["converged"]) or diff:
        raise AssertionError(f"sharded boot != boot: {out['boot']}")
    require_launches("sharded_boot", boot_launches, BOOT_KERNELS)
    del st, final
    torch.cuda.empty_cache()

    # run_warped(mesh=) on a converged mesh against the sharded dense run.
    wcfg = SwimConfig()
    n = SHARDED_WARP_N
    conv_st = shard_state(init_state(n, seed=5, ring_contacts=n - 1, announced=True), mesh)
    led = WarpLedger()
    t0 = time.perf_counter()
    warped, ran, wconv = run_warped(conv_st, wcfg, SHARDED_WARP_TICKS, ledger=led, mesh=mesh)
    torch.cuda.synchronize()
    warp_s = time.perf_counter() - t0
    tick = make_sharded_tick(wcfg, mesh, faulty=False)
    idle = idle_inputs(n)
    ref = conv_st
    t0 = time.perf_counter()
    for _ in range(SHARDED_WARP_TICKS):
        ref = tick(ref, idle)[0]
    torch.cuda.synchronize()
    out["warp"] = {"n": n, "ticks": SHARDED_WARP_TICKS, "warp_s": warp_s,
                   "dense_s": time.perf_counter() - t0, "converged": wconv,
                   "engines": sorted({r["engine"] for r in led.spans}),
                   "mismatches": state_diff(ref, warped)}
    if out["warp"]["mismatches"] or ran != SHARDED_WARP_TICKS or not wconv:
        raise AssertionError(f"run_warped(mesh=) != sharded dense: {out['warp']}")

    # The sweep with --shard ensemble, and the dryrun's sharded arm (both
    # print tables: kept out of the smoke's lines).
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = fleet_bench.run_sweep(fleet_bench.build_parser().parse_args(
            [*SHARDED_SWEEP, "--shard", "ensemble"]))
        rc = dryrun.main(["--n", "32"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["sweep"] = {k: line[k] for k in ("sharded", "ensemble", "n_peers",
                                         "converged_fraction", "quantiles", "wall_s")}
    out["dryrun"] = {"rc": rc, "engines": report["engines"]}
    if not line["sharded"] or rc != 0 or report["engines"].get("sharded") != "ok":
        raise AssertionError(f"sweep or dryrun: {out['sweep']} {out['dryrun']}")
    dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ----------------------------------------------------------------- main path


def counts() -> dict:
    from kaboodle_tpu_torch.ops import _cuda

    return dict(_cuda.launches)


# The main-path runs that launch the kernels at each timed shape (a
# ``cell`` of phase ``kernels``): the N = 16,384 lean int16 state, the
# N = 8,192 full state and the N = 1,024 full state of the warp drain.
SHAPE_RUNS = {
    "boot": ("boot", "telemetry_boot", "warp_window_dense", "sharded_boot"),
    "churn": ("churn", "telemetry_churn", "facade", "checkpoint_resume", "sharded_churn",
              "analysis_full"),
    "row_slice": (),
    "churn_final_state": ("churn", "telemetry_churn", "facade", "checkpoint_resume",
                          "analysis_full"),
    "warp_drain": ("warp_drain_churn", "warp_drain_dense", "warp_drain_warp", "warp_drain_bank",
                   "warp_drain_distributional"),
    "costscope": ("costscope", "analysis"),
}
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
    from kaboodle_tpu_torch.sim import run_until_converged

    cfg = all_kernels_cfg()

    def run(st):
        return run_until_converged(st, cfg, max_ticks=64)

    return lambda: lean_state(16384), run


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
            worst_lat = max(worst_lat, card_cpu_mismatch(res["cuda"], res["cpu"], f"tick {t}"))
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


# ----------------------------------------------------------------- blocked tick

# The row-blocked tick's runs: BASELINE configs 4 and 5 at their full width.
CHUNK_N = 65536
# Chosen with scripts/chunked_block_sweep.py: on an H100 80GB HBM3 at 700 W
# the boot takes the same time at 1,024 to 4,096, and the first 3 config-5
# ticks take 8 % less time than at 2,048 and 22 % less than at 1,024, for
# ~1.6 GB more peak than at 2,048.
CHUNK_BLOCK = 4096
# The blocked tick against the dense one: the boot's width, 8 row blocks.
PARITY_N = 16384
PARITY_BLOCK = 2048
# Config 5's depth cut: the first T5 of its 96 ticks, scaled as the
# scenario scales its thirds (drop over ticks 0-9, the partition over 5-9,
# healed from 10). 16 keeps the smoke inside its 1,000 s budget.
T5 = 16


def lean_state(n: int, device="cuda"):
    """A fresh lean state (no latency, no identity views) with int16 timers."""
    import torch

    from kaboodle_tpu_torch.sim import init_state

    return init_state(n, seed=0, track_latency=False, instant_identity=True,
                      timer_dtype=torch.int16, device=device)


def float_metrics_rel_diff(a, b) -> float:
    """The largest relative difference of the two float metrics."""
    pairs = ((float(getattr(a, f)), float(getattr(b, f)))
             for f in ("agree_fraction", "mean_membership"))
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in pairs)


def phase_chunked_parity() -> dict:
    """The blocked tick against the dense tick on the card at N = 16,384,
    then against itself on the CPU at N = 512."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim import Scenario, idle_inputs, make_chunked_tick_fn, make_tick_fn
    from kaboodle_tpu_torch.spec import WAITING_FOR_INDIRECT_PING

    n = PARITY_N
    cfg = SwimConfig(deterministic=True, use_pallas_fp=True, use_pallas_oldest_k=True,
                     use_pallas_suspicion=True)
    dense_boot, dense = make_tick_fn(cfg, faulty=False), make_tick_fn(cfg)
    blk_boot = make_chunked_tick_fn(cfg, faulty=False, block=PARITY_BLOCK, boot_union=True)
    blk = make_chunked_tick_fn(cfg, block=PARITY_BLOCK, drop=False)
    # After the boot: kills, a two-way partition window and manual pings.
    sc = (Scenario(n, 8).kill_at(0, [3, n // 4, n // 2 + 1, n - 5])
          .partition_at(2, np.arange(n) % 2, until=5).manual_ping_at(1, 0, 77)
          .manual_ping_at(3, 9, n // 4).manual_ping_at(5, 3 * n // 4, 3 * n // 4 + 1))
    inputs = sc.build()
    a, b = lean_state(n), lean_state(n)
    steps = [(dense_boot, blk_boot, idle_inputs(n))] + [(dense, blk, inputs.at(t))
                                                      for t in range(sc.ticks)]
    rel, escalated, t0 = 0.0, 0, time.perf_counter()
    for t, (f_dense, f_blk, inp) in enumerate(steps):
        a, ma = f_dense(a, inp)
        b, mb = f_blk(b, inp)
        bad = state_diff(a, b) + [f for f in ("messages_delivered", "converged", "fingerprint_min",
                                              "fingerprint_max")
                                  if not torch.equal(getattr(ma, f), getattr(mb, f))]
        if bad:
            raise AssertionError(f"blocked != dense at N={n}, tick {t}: {bad}")
        for f in ("state", "timer"):
            if not getattr(b, f).is_contiguous():
                raise AssertionError(f"blocked tick left {f} non-contiguous")
        rel = max(rel, float_metrics_rel_diff(mb, ma))
        escalated += bool((b.state == WAITING_FOR_INDIRECT_PING).any())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rel > 1e-6:
        raise AssertionError(f"blocked float metrics off the dense ones by {rel}")
    if not escalated:
        raise AssertionError("the parity schedule never escalated")
    del a, b
    out = {"phase": "chunked_parity", "n": n, "block": PARITY_BLOCK, "ticks_equal": len(steps),
           "ticks_with_escalations": escalated, "float_metrics_max_rel_diff": rel,
           "float_metrics_tolerance": "rel 1e-6", "wall_s_both_engines": wall,
           "card_vs_cpu": chunked_card_vs_cpu()}
    emit(out)
    return out


def chunked_card_vs_cpu() -> dict:
    """The blocked tick on the card against the CPU at N = 512 (block 128)
    under config 5's drop and partition plus kills and a revive, in both
    modes, plain and telemetry builds: every leaf, metric and counter equal
    per tick, ``latency`` with NaN positions equal and rtol 1e-5."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim import baseline_scenario, init_state, make_chunked_tick_fn
    from kaboodle_tpu_torch.sim.state import metrics_to_numpy, state_to_numpy
    from kaboodle_tpu_torch.telemetry import FIELDS

    out = {"n": 512, "block": 128}
    for det in (True, False):
        for telemetry in (False, True):
            sc = baseline_scenario(5, n=512, ticks=12, seed=4).kill_at(2, [5, 6]).revive_at(9, [5])
            tick = make_chunked_tick_fn(SwimConfig(deterministic=det), block=128,
                                        telemetry=telemetry)
            sides = {d: (init_state(512, seed=1, device=d), sc.build(d)) for d in ("cuda", "cpu")}
            totals = dict.fromkeys(FIELDS, 0)
            for t in range(sc.ticks):
                res = {}
                for d, (st, inp) in sides.items():
                    st, o = tick(st, inp.at(t))
                    sides[d] = (st, inp)
                    m = o.metrics if telemetry else o
                    leaves = {**state_to_numpy(st), **metrics_to_numpy(m)}
                    if telemetry:
                        leaves["fp"] = o.fp.cpu().numpy()
                        leaves.update({f"c_{f}": getattr(o.counters, f).cpu().numpy()
                                       for f in FIELDS})
                    res[d] = leaves
                for k, w in res["cpu"].items():
                    g = res["cuda"][k]
                    if k == "latency":
                        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"tick {t} latency")
                    elif w is not None and not np.array_equal(g, w):
                        raise AssertionError(f"blocked card != CPU, tick {t}: {k}")
                if telemetry:
                    for f in FIELDS:
                        totals[f] += int(res["cpu"][f"c_{f}"])
            key = ("deterministic" if det else "random") + ("_telemetry" if telemetry else "")
            out[key] = {"equal_ticks": sc.ticks,
                        "final_converged": bool(res["cpu"]["converged"])}
            if telemetry:
                out[key]["counter_totals"] = totals
    torch.cuda.synchronize()
    return out


def release_device_memory() -> None:
    """Free what earlier phases left: objects in reference cycles (a facade
    and its event closures) wait for the collector, and the allocator's
    cache for ``empty_cache``."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def chunked_boot_case():
    """The config-4 run as ``(make, run)``: ``make()`` gives a fresh
    N = 65,536 lean state, ``run(state)`` boots it through the blocked tick
    (tick 0 with the closed-form union, then ``converge_loop``) and returns
    ``(final, tick0_metrics, ticks_after_tick0, converged)``."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim import idle_inputs, make_chunked_tick_fn
    from kaboodle_tpu_torch.sim.runner import converge_loop

    cfg = SwimConfig()
    boot = make_chunked_tick_fn(cfg, faulty=False, block=CHUNK_BLOCK, boot_union=True)
    tick = make_chunked_tick_fn(cfg, faulty=False, block=CHUNK_BLOCK)

    def run(st):
        st, m0 = boot(st, idle_inputs(CHUNK_N))
        final, ticks, conv = converge_loop(st, tick, max_ticks=16)
        return final, m0, ticks, conv

    return lambda: lean_state(CHUNK_N), run


def chunked_faulty_case(ticks: int = T5):
    """The config-5 run as ``(scenario, make, run)``: ``run(state, each)``
    ticks the faulty blocked build (random drop on) over the scenario's
    inputs, calling ``each(t, metrics)`` after every tick, and returns the
    final state and the last tick's metrics."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim import baseline_scenario, make_chunked_tick_fn

    sc = baseline_scenario(5, n=CHUNK_N, ticks=ticks)
    inputs = sc.build()
    tick = make_chunked_tick_fn(SwimConfig(), faulty=True, block=CHUNK_BLOCK, drop=True)

    def run(st, each=None):
        for t in range(sc.ticks):
            st, m = tick(st, inputs.at(t))
            if each is not None:
                each(t, m)
        return st, m

    return sc, lambda: lean_state(CHUNK_N), run


def phase_chunked_boot() -> dict:
    """BASELINE config 4 at full width: a broadcast boot of N = 65,536 through
    the blocked tick (the closed-form union on tick 0), then ``converge_loop``."""
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    make, run = chunked_boot_case()
    release_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    box = [make()]
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    # Handed over, not kept here: the run is then free to drop it.
    final, m0, ticks, conv = run(box.pop())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    known = final.state[:: CHUNK_N // 64].gt(0).sum(dim=-1)
    out = {"phase": "chunked_boot", "n": CHUNK_N, "block": CHUNK_BLOCK, "config": 4,
           "allocated_before": before, "peak_after_init_state": init_peak,
           "tick0_messages_delivered": int(m0.messages_delivered),
           "ticks_after_tick0": ticks, "converged": conv, "wall_s": wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "sampled_rows_known_min": int(known.min()), "launches": launches}
    emit(out)
    if not conv:
        raise AssertionError(f"the N={CHUNK_N} blocked boot did not converge")
    if int(known.min()) != CHUNK_N:
        raise AssertionError("a converged row does not know every peer")
    del final
    return out


def phase_chunked_faulty() -> dict:
    """BASELINE config 5 at full width, depth cut to T5 ticks: 10 % drop over
    the first two thirds, a two-way partition over the middle third."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.spec import KNOWN

    sc, make, run = chunked_faulty_case()
    release_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    walls, msgs = [], []
    t0 = time.perf_counter()
    last = [t0]

    def each(t, m):
        msgs.append(int(m.messages_delivered))  # a device fetch: the tick has finished
        now = time.perf_counter()
        walls.append(now - last[0])
        last[0] = now

    st, m = run(make(), each)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    alive_want = sc.alive_trajectory()[-1]
    self_known = bool((st.state.diagonal()[st.alive] == KNOWN).all())
    out = {"phase": "chunked_faulty", "n": CHUNK_N, "block": CHUNK_BLOCK, "config": 5,
           "ticks": sc.ticks, "ticks_full_config": 96, "wall_s": wall, "wall_s_per_tick": walls,
           "messages_delivered": msgs, "agree_fraction": float(m.agree_fraction),
           "mean_membership": float(m.mean_membership),
           "alive": int(st.alive.sum()), "alive_expected": int(alive_want.sum()),
           "self_known": self_known, "allocated_before": before,
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches}
    emit(out)
    if not all(x > 0 for x in msgs):
        raise AssertionError("a config-5 tick delivered no message")
    if not np.array_equal(st.alive.cpu().numpy(), alive_want):
        raise AssertionError("the alive mask differs from the scenario's")
    if not self_known:
        raise AssertionError("an alive peer does not know itself")
    if not (st.state.is_contiguous() and st.timer.is_contiguous()):
        raise AssertionError("a state plane is not contiguous")
    del st
    return out


# ----------------------------------------------------------------- fleet

# BASELINE config 2's mesh, E members: the sweep's defaults (``--ensemble``).
FLEET_N = 1024
FLEET_E = 256
FLEET_MAX_TICKS = 64
FLEET_BOOT_MEMBERS = (0, 131, 255)
FLEET_SWEEP = "drop_rate=0:0.3:16"


def fleet_args(*argv):
    """The sweep's arguments (``fleet/bench.py::build_parser``) at the fleet
    runs' shape, on the card."""
    from kaboodle_tpu_torch.fleet.bench import build_parser

    return build_parser().parse_args(
        ["--ensemble", str(FLEET_E), "--n", str(FLEET_N), "--max-ticks", str(FLEET_MAX_TICKS),
         "--device", "cuda", *argv])


def run_fleet_phase(name: str, args) -> tuple[dict, object]:
    """One sweep through ``fleet/bench.py::sweep`` with the launch counts at 0
    before it: its line, wall, ticks run and peak, and the fleet run's
    ``(fleet, conv_tick, done)`` for the parity phase."""
    import torch

    from kaboodle_tpu_torch.fleet.bench import sweep
    from kaboodle_tpu_torch.ops import _cuda

    release_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    line, fleet, conv_tick, done = sweep(args)
    torch.cuda.synchronize()
    phase_wall = time.perf_counter() - t0
    launches = counts()
    ticks_run = FLEET_MAX_TICKS if not bool(done.all()) else int(conv_tick.max())
    out = {"phase": name, "e": FLEET_E, "n": FLEET_N, "cells": FLEET_E * FLEET_N * FLEET_N,
           "wall_s": line["wall_s"], "wall_s_with_init": phase_wall, "ticks_run": ticks_run,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "conv_tick_histogram": torch.bincount(conv_tick[done].long()).tolist(),
           "sweep_line": line, "launches": launches}
    emit(out)
    if line["backend"] != "cuda" or fleet.mesh.state.device.type != "cuda":
        raise AssertionError(f"{name} did not run on the card")
    if not bool(torch.isfinite(torch.tensor(list(line["quantiles"].values()))).any()):
        raise AssertionError(f"{name}: no member converged")
    return out, (fleet, conv_tick, done)


def phase_fleet_boot():
    """The seeds-only ensemble: E = 256 broadcast boots of N = 1,024."""
    out, res = run_fleet_phase("fleet_boot", fleet_args("--seeds-only"))
    if out["sweep_line"]["converged_fraction"] != 1.0:
        raise AssertionError("a fleet_boot member did not converge in 64 ticks")
    return out, res


def phase_fleet_sweep():
    """The documented drop-rate sweep: 16 rates over E = 256 members."""
    out, res = run_fleet_phase("fleet_sweep", fleet_args("--sweep", FLEET_SWEEP))
    if len(out["sweep_line"]["per_knob"]) != 16:
        raise AssertionError("fleet_sweep did not report 16 drop rates")
    return out, res


def fleet_member_vs_standalone(res, members, rates=None) -> list[dict]:
    """Members of a fleet run against standalone single-mesh runs on the card
    from the same seed (and drop rate, in the faulty build): the frozen
    state bit-equal and ``conv_tick == ticks_run``, ``done == converged``.
    Each standalone run's wall (ending in ``torch.cuda.synchronize()``) is
    the one-mesh yardstick for the fleet's time per member-tick."""
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet import member_state
    from kaboodle_tpu_torch.sim import init_state, make_tick_fn
    from kaboodle_tpu_torch.sim.runner import converge_loop

    fleet, conv_tick, done = res
    cfg = SwimConfig()  # the sweep's broadcast boot, random mode
    tick = make_tick_fn(cfg, faulty=rates is not None)
    rows = []
    for e in members:
        st = init_state(FLEET_N, seed=e, track_latency=False, instant_identity=True)
        rate = None if rates is None else float(rates[e])
        if rate is None:
            step = tick
        else:
            r = torch.tensor(rate, dtype=torch.float32, device=st.device)

            def step(s, inp, r=r):
                return tick(s, dataclasses.replace(inp, drop_rate=r))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ticks_run, conv = converge_loop(st, step, FLEET_MAX_TICKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = state_diff(member_state(fleet, e), st)
        row = {"member": e, "drop_rate": rate, "ticks_run": ticks_run, "converged": conv,
               "conv_tick": int(conv_tick[e]), "done": bool(done[e]), "state_diff": bad,
               "standalone_wall_s": wall}
        rows.append(row)
        if bad or (ticks_run, conv) != (row["conv_tick"], row["done"]):
            raise AssertionError(f"fleet member != standalone run: {row}")
    return rows


def fleet_card_vs_cpu() -> dict:
    """A small fleet on the card against the CPU: E = 8, N = 128, 12 ticks,
    random mode, faulty, per-member drop rates and churn schedules stacked
    by ``stack_member_inputs``; telemetry off and on. Every leaf, metric,
    counter and digest equal per run (``latency``: NaN positions equal,
    rtol 1e-5, as in phase ``parity``)."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet import (
        init_fleet,
        scan_axis_first,
        simulate_fleet,
        stack_member_inputs,
    )
    from kaboodle_tpu_torch.sim import Scenario
    from kaboodle_tpu_torch.sim.state import fleet_to_numpy, metrics_to_numpy
    from kaboodle_tpu_torch.telemetry import FIELDS

    n, e, ticks = 128, 8, 12
    rates = [0.02 * m for m in range(e)]
    scenarios = [Scenario(n, ticks).kill_at(2, [m + 1, m + 40, m + 90]).revive_at(7, [m + 1])
                 .partition_at(4, (np.arange(n) + m) % 2, until=6).manual_ping_at(3, m, 100 - m)
                 for m in range(e)]
    out = {"e": e, "n": n, "ticks": ticks}
    for telemetry in (False, True):
        res = {}
        for dev in ("cuda", "cpu"):
            inputs = scan_axis_first(stack_member_inputs([sc.build(dev) for sc in scenarios]))
            inputs.drop_rate = torch.tensor(rates, device=dev).expand(ticks, e)
            fleet = init_fleet(n, e, drop_rates=rates, device=dev)
            fleet, m = simulate_fleet(fleet, inputs, SwimConfig(), faulty=True,
                                      telemetry=telemetry)
            leaves = {f"state.{k}": v for k, v in fleet_to_numpy(fleet)["mesh"].items()}
            metrics = m.metrics if telemetry else m
            leaves.update({f"metrics.{k}": v for k, v in metrics_to_numpy(metrics).items()})
            if telemetry:
                leaves["fp"] = m.fp.cpu().numpy()
                leaves.update({f"counter.{f}": getattr(m.counters, f).cpu().numpy()
                               for f in FIELDS})
            res[dev] = leaves
        bad = []
        for k, w in res["cpu"].items():
            g = res["cuda"][k]
            if w is None or g is None:
                if (w is None) != (g is None):
                    bad.append(k)
            elif k == "state.latency":  # NaN positions equal, rtol 1e-5 (as phase parity)
                if not (np.array_equal(np.isnan(g), np.isnan(w))
                        and np.allclose(g, w, rtol=1e-5, atol=0.0, equal_nan=True)):
                    bad.append(k)
            elif not np.array_equal(g, w):
                bad.append(k)
        key = "telemetry" if telemetry else "plain"
        out[key] = {"leaves_equal": len(res["cpu"]) - len(bad), "differ": bad,
                    "deaths_declared": int(res["cpu"]["counter.deaths_declared"].sum())
                    if telemetry else None}
        if bad:
            raise AssertionError(f"fleet card != CPU ({key}): {bad}")
    return out


def phase_fleet_parity(boot_res, sweep_res, sweep_line) -> dict:
    import numpy as np

    t0 = time.perf_counter()
    boot_rows = fleet_member_vs_standalone(boot_res, FLEET_BOOT_MEMBERS)
    steps = len(sweep_line["per_knob"])
    per = FLEET_E // steps
    rates = np.repeat(np.linspace(0.0, 0.3, steps, dtype=np.float32), per)
    sweep_rows = fleet_member_vs_standalone(sweep_res, [b * per + b % per for b in range(steps)],
                                            rates)
    card_cpu = fleet_card_vs_cpu()
    standalone_ticks = sum(r["ticks_run"] for r in sweep_rows)
    out = {"phase": "fleet_parity", "boot_members": boot_rows, "sweep_members": sweep_rows,
           "sweep_standalone_s_per_tick": sum(r["standalone_wall_s"] for r in sweep_rows)
           / max(standalone_ticks, 1),
           "card_vs_cpu": card_cpu, "wall_s": time.perf_counter() - t0}
    emit(out)
    return out


# ----------------------------------------------------------------- warp

# The calm window of the JAX TPU lane (bench.py ``--warp``, ``wn2``): one
# 256-tick hybrid span at N = 16,384.
WINDOW_N = 16384
WINDOW_K = 256
# BENCH_warp3.json's drain: N = 1,024 (churn half, calm half), cut from its
# 8,192 ticks to 4,096 when the sharded phase took the smoke past its budget;
# then its churn half (quiet but for the kills at its two ends) to its last
# 512 ticks, when the analysis phase did: 2,560 ticks, the calm half's 2,048
# and its 682-tick ping timeout as before. A shorter calm half does not
# drain: at 1,024 calm ticks the victims are not all removed, and no tick
# leaps.
DRAIN_N = 1024
DRAIN_TICKS = 2560
DRAIN_CHURN = 512
WARP_FLEET_N = 1024
WARP_FLEET_TICKS = 512
# Members of the warped fleet: converged, mid-drain, mid-boot.
WARP_FLEET_KINDS = ("converged",) * 6 + ("drain",) * 5 + ("boot",) * 5
WARP_FLEET_CHECK = (0, 6, 11)
# The kernels a dense stretch of each one-mesh warp run launches: the
# window's lean state hashes a record vector (K2) in its anti-entropy
# recounts, the drain's full state its identity views (K1), and its
# escalation ticks take the full program (K4).
WINDOW_KERNELS = ("fused_fp_hash", "fused_suspicion")
DRAIN_KERNELS = CHURN_KERNELS


def drain_victims(n: int) -> list[int]:
    """bench.py's eight victims, spread over the index range."""
    return [(i * n) // 9 + 1 for i in range(8)]


def window_state(cfg, n: int = WINDOW_N, device="cuda"):
    """bench.py's mid-drain window state: a converged lean int16 mesh, 8
    victims killed, every survivor's cell for them armed ``WaitingForPing``
    now, and victim 0 already gone from half the rows (fingerprints
    disagree, so anti-entropy fires every tick)."""
    import torch

    from kaboodle_tpu_torch.sim import Scenario, init_state, make_tick_fn
    from kaboodle_tpu_torch.spec import WAITING_FOR_PING

    st = init_state(n, seed=1, ring_contacts=n - 1, announced=True, track_latency=False,
                    instant_identity=True, timer_dtype=torch.int16, device=device)
    victims = drain_victims(n)
    kill = Scenario(n, 1).kill_at(0, victims).build(device).at(0)
    st, _ = make_tick_fn(cfg, faulty=True)(st, kill)
    S, T, alive = st.state.clone(), st.timer.clone(), st.alive
    for v in victims:  # dead rows stay as they are
        S[alive, v] = WAITING_FOR_PING
        T[alive, v] = int(st.tick)
    S[alive & (torch.arange(n, device=device) >= n // 2), victims[0]] = 0
    return dataclasses.replace(st, state=S, timer=T)


def phase_warp_window() -> dict:
    """256 dense ticks, the 256-tick hybrid leap and a memo replay from one
    mid-drain state at N = 16,384: all three bit-equal."""
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sim import idle_inputs, make_tick_fn
    from kaboodle_tpu_torch.warp.horizon import decode_signature, make_signature_fn
    from kaboodle_tpu_torch.warp.runner import (
        SpanMemo,
        _digest_leaves,
        _get_leap,
        _host_leaves,
        _memo_replay,
        _memo_store,
    )

    n, k = WINDOW_N, WINDOW_K
    cfg = dataclasses.replace(all_kernels_cfg(), ping_timeout_ticks=4 * k)
    release_device_memory()
    st = window_state(cfg, n)
    cls = decode_signature(make_signature_fn(cfg)(st))
    if cls.mode != "hybrid":
        raise AssertionError(f"the window state classes {cls.describe()}, not hybrid")
    tick, idle = make_tick_fn(cfg, faulty=False), idle_inputs(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    dense = st
    for _ in range(k):
        dense, _ = tick(dense, idle)
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    dense_launches = counts()
    dense_peak = torch.cuda.max_memory_allocated()
    require_launches("warp_window dense arm", dense_launches, WINDOW_KERNELS)

    leap = _get_leap(cfg, k, hybrid=True)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    walls = []
    for _ in range(2):  # the first call pays the allocator's growth
        t0 = time.perf_counter()
        out_w = leap(st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    leap_launches = counts()
    leap_peak = torch.cuda.max_memory_allocated()

    memo = SpanMemo(max_bytes=8 << 30)
    entry = _host_leaves(st)
    _memo_store(memo, ("window", cls.key, k, _digest_leaves(entry)), entry, out_w)
    t0 = time.perf_counter()
    entry2 = _host_leaves(st)  # a replay's whole cost: fetch, digest, lookup, XOR, copy back
    hit = memo.get(("window", cls.key, k, _digest_leaves(entry2)), kind="window")
    out_m = _memo_replay(st, entry2, hit[0])
    torch.cuda.synchronize()
    memo_wall = time.perf_counter() - t0
    bad = {"leap": state_diff(dense, out_w), "memo": state_diff(dense, out_m)}
    out = {"phase": "warp_window", "n": n, "ticks": k, "class": cls.describe(),
           "dense_wall_s": dense_wall, "dense_ms_per_tick": 1e3 * dense_wall / k,
           "leap_wall_s": walls[1], "leap_wall_s_first": walls[0],
           "leap_ms_per_step": 1e3 * walls[1] / k, "memo_wall_s": memo_wall,
           "dense_over_leap": dense_wall / walls[1], "dense_over_memo": dense_wall / memo_wall,
           "max_memory_allocated_dense": dense_peak, "max_memory_allocated_leap": leap_peak,
           "memo_bytes": memo.stats()["bytes"], "state_diff": bad,
           "launches_dense": dense_launches, "launches_leap": leap_launches}
    emit(out)
    if bad["leap"] or bad["memo"]:
        raise AssertionError(f"warp_window: leap or memo != dense: {bad}")
    if any(leap_launches.values()):
        raise AssertionError("the leap launched a hand kernel")
    del st, dense, out_w, out_m
    return out


def warp_drain_case(n: int = DRAIN_N, ticks: int = DRAIN_TICKS, device="cuda",
                    churn_ticks: int | None = None):
    """BENCH_warp3.json's churn-recovery drain (bench.py
    ``_bench_warp_churn_recovery``) as ``(cfg, state, churn_inputs,
    calm_inputs)``: a converged full-state mesh, 8 staggered kills at the
    tail of the churn half plus one early kill and revive, and a suspicion
    timeout of a third of the calm half; all kernel flags on. The churn
    half is the first ``churn_ticks`` (default: half the ticks)."""
    from kaboodle_tpu_torch.sim import Scenario, init_state

    churn_end = ticks // 2 if churn_ticks is None else churn_ticks
    cfg = dataclasses.replace(all_kernels_cfg(),
                              ping_timeout_ticks=max(8, (ticks - churn_end) // 3))
    st = init_state(n, seed=0, ring_contacts=n - 1, announced=True, device=device)
    sc = Scenario(n, ticks)
    victims = drain_victims(n)
    for i, p in enumerate(victims):
        sc.kill_at(max(1, churn_end - 16 + 2 * i), [p])
    extra = victims[0] + 1 if victims[0] + 1 not in victims else victims[0] + 2
    sc.kill_at(1, [extra]).revive_at(min(6, churn_end - 1), [extra])
    inputs = sc.build(device)
    churn = dataclasses.replace(inputs, **{f.name: getattr(inputs, f.name)[:churn_end]
                                           for f in dataclasses.fields(inputs)
                                           if getattr(inputs, f.name) is not None})
    calm = dataclasses.replace(inputs, **{f.name: getattr(inputs, f.name)[churn_end:]
                                          for f in dataclasses.fields(inputs)
                                          if getattr(inputs, f.name) is not None})
    return cfg, st, churn, calm


def timed(run):
    """``(result, wall seconds, launches)`` of ``run()``, counts reset before."""
    import torch

    from kaboodle_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, counts()


def steady_mean(state, cfg, ticks: int = 8) -> float:
    """Mean messages delivered a tick over ``ticks`` idle faulty ticks."""
    from kaboodle_tpu_torch.sim import idle_inputs, make_tick_fn

    tick, idle = make_tick_fn(cfg, faulty=True), idle_inputs(state.n)
    msgs = []
    for _ in range(ticks):
        state, m = tick(state, idle)
        msgs.append(int(m.messages_delivered))
    return sum(msgs) / len(msgs)


def phase_warp_drain() -> dict:
    """The drain's calm half four ways (dense, warped, memo banking, memo
    replay), all bit-equal, then the distributional tier."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.sim import simulate
    from kaboodle_tpu_torch.sim.runner import state_converged
    from kaboodle_tpu_torch.warp.runner import SpanMemo, WarpLedger, leap_cache, simulate_warped

    release_device_memory()
    cfg, st, churn_in, calm_in = warp_drain_case(DRAIN_N, DRAIN_TICKS, churn_ticks=DRAIN_CHURN)
    calm_ticks = int(calm_in.kill.shape[0])
    torch.cuda.reset_peak_memory_stats()
    (st_c, _), churn_wall, l_churn = timed(lambda: simulate(st, churn_in, cfg, faulty=True))
    (out_d, _), dense_wall, l_dense = timed(lambda: simulate(st_c, calm_in, cfg, faulty=True))
    ledger = WarpLedger()
    cache_before = leap_cache.stats()
    (out_w, dt_w, _), warp_wall, l_warp = timed(
        lambda: simulate_warped(st_c, calm_in, cfg, faulty=True, ledger=ledger))
    memo = SpanMemo(max_bytes=16 << 30, max_entries=65536)
    (out_b, dt_b, _), bank_wall, l_bank = timed(
        lambda: simulate_warped(st_c, calm_in, cfg, faulty=True, memo=memo))
    mled = WarpLedger()
    (out_m, dt_m, _), replay_wall, l_replay = timed(
        lambda: simulate_warped(st_c, calm_in, cfg, faulty=True, memo=memo, ledger=mled))
    peak = torch.cuda.max_memory_allocated()
    dled = WarpLedger()
    (out_x, dt_x, _), dist_wall, l_dist = timed(
        lambda: simulate_warped(st_c, calm_in, cfg, faulty=True, ledger=dled,
                                warp_mode="distributional"))
    why_dense = ledger.blocked_histogram()
    bad = {name: state_diff(out_d, o) for name, o in
           (("warp", out_w), ("bank", out_b), ("replay", out_m))}
    steady = {"dense": steady_mean(out_d, cfg), "distributional": steady_mean(out_x, cfg)}
    out = {"phase": "warp_drain", "n": DRAIN_N, "ticks": DRAIN_TICKS, "churn_ticks": DRAIN_CHURN,
           "calm_ticks": calm_ticks,
           "ping_timeout_ticks": cfg.ping_timeout_ticks,
           "churn_wall_s": churn_wall, "dense_wall_s": dense_wall,
           "dense_ms_per_tick": 1e3 * dense_wall / calm_ticks, "warp_wall_s": warp_wall,
           "bank_wall_s": bank_wall, "replay_wall_s": replay_wall,
           "distributional_wall_s": dist_wall,
           "dense_over_warp": dense_wall / warp_wall, "dense_over_replay": dense_wall / replay_wall,
           "dense_ticks": int(dt_w.size), "leaped_ticks": calm_ticks - int(dt_w.size),
           "dense_ticks_distributional": int(dt_x.size), "why_dense": why_dense,
           "per_class": {str(k): v for k, v in ledger.per_class().items()},
           "program_cache": leap_cache.stats(), "program_cache_before": cache_before,
           "memo": memo.stats(), "max_memory_allocated": peak, "state_diff": bad,
           "steady_msgs_mean": steady,
           "launches": {"churn": l_churn, "dense": l_dense, "warp": l_warp, "bank": l_bank,
                        "replay": l_replay, "distributional": l_dist}}
    emit(out)
    if any(bad.values()):
        raise AssertionError(f"warp_drain: a warped calm half != the dense one: {bad}")
    if not (np.array_equal(dt_w, dt_m) and np.array_equal(dt_w, dt_b)):
        raise AssertionError("warp_drain: the memo runs' dense ticks differ from the warp run's")
    if sum(v["ticks"] for v in why_dense.values()) != dt_w.size:
        raise AssertionError("warp_drain: the why-dense histogram does not sum to the dense ticks")
    if not (all(r["engine"].endswith("+memo") and r["dispatches"] == 0 for r in mled.spans)
            and mled.spans and not mled.blocked):
        raise AssertionError("warp_drain: the replay pass ran a tick or a leap")
    if any(l_replay.values()):
        raise AssertionError("warp_drain: the replay pass launched a kernel")
    if memo.stats()["evictions"] or not memo.stats()["hits"]:
        raise AssertionError(f"warp_drain: memo {memo.stats()}")
    for run, launches in (("dense", l_dense), ("warp", l_warp), ("bank", l_bank)):
        require_launches(f"warp_drain {run}", launches, DRAIN_KERNELS)
    if not (torch.equal(out_x.alive, out_d.alive) and state_converged(out_x)
            and steady["dense"] == steady["distributional"]):
        raise AssertionError(f"warp_drain: the distributional run is off the dense one: {steady}")
    return out


def stack_members(states):
    """``[E, ...]`` leaves from standalone states."""
    import torch

    return dataclasses.replace(states[0], **{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0]) if getattr(states[0], f.name) is not None})


def warp_fleet_members(cfg, n: int, kinds, device="cuda") -> list:
    """Standalone members: converged (``ring_contacts=n-1``, announced),
    mid-drain (two low-index victims killed, found within ~40 ticks; dense
    ticks until the signature classes it ``hybrid``) and mid-boot
    (``ring_contacts=2``), seed = index."""
    from kaboodle_tpu_torch.sim import Scenario, idle_inputs, init_state, make_tick_fn
    from kaboodle_tpu_torch.warp.horizon import decode_signature, make_signature_fn

    tick, faulty = make_tick_fn(cfg, faulty=False), make_tick_fn(cfg, faulty=True)
    sig, idle = make_signature_fn(cfg), idle_inputs(n, device=device)
    members = []
    for e, kind in enumerate(kinds):
        if kind == "boot":
            members.append(init_state(n, seed=e, ring_contacts=2, device=device))
            continue
        st = init_state(n, seed=e, ring_contacts=n - 1, announced=True, device=device)
        if kind == "drain":
            st, _ = faulty(st, Scenario(n, 1).kill_at(0, [2 + e, 30 + e]).build(device).at(0))
            for _ in range(4 * n):
                if decode_signature(sig(st)).mode == "hybrid":
                    break
                st, _ = tick(st, idle)
            else:
                raise AssertionError(f"drain member {e} never reached the hybrid class")
        members.append(st)
    return members


def phase_warp_fleet() -> dict:
    """``run_fleet_warped`` over a mixed E = 16 fleet of N = 1,024; members
    against standalone ``run_warped`` on the card; a small warped fleet on
    the card against the CPU."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet import FleetState, member_state
    from kaboodle_tpu_torch.sim.state import fleet_to_numpy
    from kaboodle_tpu_torch.warp.runner import WarpLedger, run_fleet_warped, run_warped

    release_device_memory()
    cfg = SwimConfig(ping_timeout_ticks=WARP_FLEET_TICKS)
    n, ticks = WARP_FLEET_N, WARP_FLEET_TICKS
    members = warp_fleet_members(cfg, n, WARP_FLEET_KINDS)
    fleet = FleetState(mesh=stack_members(members), drop_rate=torch.zeros(len(members),
                                                                           device="cuda"))
    ledger = WarpLedger()
    torch.cuda.reset_peak_memory_stats()
    (out, ran, conv), wall, launches = timed(
        lambda: run_fleet_warped(fleet, cfg, ticks, ledger=ledger))
    peak = torch.cuda.max_memory_allocated()
    rows = []
    for e in WARP_FLEET_CHECK:
        (ref, _, _), swall, _ = timed(lambda e=e: run_warped(members[e], cfg, ticks))
        rows.append({"member": e, "kind": WARP_FLEET_KINDS[e], "standalone_wall_s": swall,
                     "state_diff": state_diff(member_state(out, e), ref)})
    engines = {}
    for r in ledger.spans:
        engines[r["engine"]] = engines.get(r["engine"], 0) + r["ticks"]

    small_kinds = ("converged",) * 3 + ("drain",) * 3 + ("boot",) * 2
    small_cfg = SwimConfig(ping_timeout_ticks=64)
    res = {}
    for dev in ("cuda", "cpu"):
        mem = warp_fleet_members(small_cfg, 128, small_kinds, device=dev)
        f = FleetState(mesh=stack_members(mem), drop_rate=torch.zeros(len(mem), device=dev))
        res[dev] = fleet_to_numpy(run_fleet_warped(f, small_cfg, 128)[0])["mesh"]
    small_bad = []
    for k, w in res["cpu"].items():
        g = res["cuda"][k]
        if w is None or g is None:
            if (w is None) != (g is None):
                small_bad.append(k)
        elif k == "latency":  # NaN positions equal, rtol 1e-5 (as phase parity)
            if not (np.array_equal(np.isnan(g), np.isnan(w))
                    and np.allclose(g, w, rtol=1e-5, atol=0.0, equal_nan=True)):
                small_bad.append(k)
        elif not np.array_equal(g, w):
            small_bad.append(k)
    out_line = {"phase": "warp_fleet", "e": len(members), "n": n, "ticks": ran,
                "kinds": {k: WARP_FLEET_KINDS.count(k) for k in set(WARP_FLEET_KINDS)},
                "wall_s": wall, "converged": int(conv.sum()), "engine_ticks": engines,
                "why_dense": ledger.blocked_histogram(), "max_memory_allocated": peak,
                "members_vs_standalone": rows, "launches": launches,
                "card_vs_cpu": {"e": len(small_kinds), "n": 128, "ticks": 128,
                                "leaves_equal": len(res["cpu"]) - len(small_bad),
                                "differ": small_bad}}
    emit(out_line)
    if any(r["state_diff"] for r in rows):
        raise AssertionError(f"warp_fleet: a member != its standalone run_warped: {rows}")
    if not set(engines) & {"fleet-leap", "fleet-hybrid"}:
        raise AssertionError(f"warp_fleet: no fleet leap round ran: {engines}")
    if small_bad:
        raise AssertionError(f"warp_fleet: the card's warped fleet != the CPU's in {small_bad}")
    return out_line


# The serving slice: the server's defaults at two classes on the card.
SERVE_SMALL, SERVE_LARGE = 1024, 4096  # the two N-classes
SERVE_LANES = (64, 8)  # lanes of each
SERVE_CHUNK = 8
SERVE_MAX_LEAP = 256
SERVE_CLIENTS = 8
SERVE_RESUME_TICKS = 16


def serve_ticks(n: int) -> int:
    """A ticks-mode request's budget in class ``n``."""
    return 256 if n == SERVE_SMALL else 128


def serve_keep() -> tuple:
    """The kept request (class, seed): parked, spilled, restored, resumed."""
    return SERVE_SMALL, 500


def serve_samples() -> tuple:
    """Sampled harvests (class, seed): converge boots and ticks-mode runs of
    both classes, held against standalone runs on the card."""
    small, large = SERVE_SMALL, SERVE_LARGE
    return ((small, 0), (small, 63), (large, 300), (large, 303),
            (small, 100), (small, 131), (large, 400), (large, 403))


def mode_of(seed: int) -> str:
    """The mode of the mix's request with this seed (the kept one: converge)."""
    return "ticks" if 100 <= seed < 300 or 400 <= seed < 500 else "converge"


def serve_requests() -> list:
    """The phase's mix, ``(n, fields)`` in submission order: 64 converge
    boots at n = 1,000 (class 1,024), 32 ticks-mode steady runs of 256
    ticks at 1,024, 4 converge boots and 4 steady runs of 128 ticks at
    4,096."""
    small, large = SERVE_SMALL, SERVE_LARGE
    steady = dict(mode="ticks", scenario="steady")
    return ([(small - small // 41, dict(seed=s)) for s in range(64)]
            + [(small, dict(seed=100 + s, ticks=serve_ticks(small), **steady))
               for s in range(32)]
            + [(large, dict(seed=300 + s)) for s in range(4)]
            + [(large, dict(seed=400 + s, ticks=serve_ticks(large), **steady))
               for s in range(4)])


def serve_reference(cfg, n: int, seed: int, mode: str, ticks: int, extra: int = 0,
                    device="cuda"):
    """The standalone run a harvest must equal: ``run_until_converged``
    (converge mode, then ``extra`` dense ticks) or ``ticks`` dense ticks
    from the steady init (ticks mode). Returns ``(state, conv_tick)``."""
    from kaboodle_tpu_torch.sim import idle_inputs, init_state, make_tick_fn, run_until_converged
    from kaboodle_tpu_torch.sim.runner import state_converged

    tick, idle = make_tick_fn(cfg, faulty=False), idle_inputs(n, device=device)
    if mode == "converge":
        st, ran, _ = run_until_converged(init_state(n, seed=seed, device=device), cfg,
                                         max_ticks=ticks)
        conv = ran
        steps = extra
    else:
        st = init_state(n, seed=seed, ring_contacts=n - 1, announced=True, device=device)
        conv = 0 if state_converged(st) else -1
        steps = ticks
    for t in range(steps):
        st, m = tick(st, idle)
        if conv < 0 and bool(m.converged):
            conv = t + 1
    return st, conv


def leap_round_timer():
    """Wrap ``warp.runner.memo_fleet_leap`` (the serve pool's memo-on leap
    round) to split each round's wall into the leap program's device time
    and the memo's host work (fetch, digest, replay, upload), each ended by
    a ``synchronize``. Returns the totals dict and an undo."""
    import torch

    from kaboodle_tpu_torch.warp import runner

    real = runner.memo_fleet_leap
    tot = {"rounds": 0, "dispatched": 0, "round_s": 0.0, "leap_program_s": 0.0}

    def timed_round(family, mesh_state, k_m, memo, dispatch):
        def timed_dispatch(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = dispatch(*a)
            torch.cuda.synchronize()
            tot["leap_program_s"] += time.perf_counter() - t
            return out

        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(family, mesh_state, k_m, memo, timed_dispatch)
        torch.cuda.synchronize()
        tot["round_s"] += time.perf_counter() - t
        tot["rounds"] += 1
        tot["dispatched"] += int(res[2])
        return res

    runner.memo_fleet_leap = timed_round
    return tot, lambda: setattr(runner, "memo_fleet_leap", real)


async def serve_exercise(tmp: Path) -> dict:
    """The in-process server on the card, 8 clients, the request mix, the
    kept request's lifecycle and a cancel; everything the phase checks."""
    import asyncio

    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.obsplane import ObsPlane
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.telemetry.manifest import read_manifest

    cfg = SwimConfig(deterministic=True)
    torch.cuda.reset_peak_memory_stats()
    pools = [LanePool(n, lanes, cfg=cfg, chunk=SERVE_CHUNK)
             for n, lanes in zip((SERVE_SMALL, SERVE_LARGE), SERVE_LANES)]
    (tmp / "spill").mkdir()
    engine = ServeEngine(pools, warp=True, max_leap=SERVE_MAX_LEAP, warp_memo=True,
                         spill_after=2, spill_dir=str(tmp / "spill"),
                         journal_dir=str(tmp / "wal"), obs=ObsPlane(trace=False))
    manifest = tmp / "manifest.jsonl"
    server = ServeServer(engine, host="127.0.0.1", port=0, manifest_path=str(manifest))
    harvests: dict = {}  # (class, seed) -> [(result fields, member on the card)]
    fanout = engine.on_event

    def tap(rec):  # a harvest event is emitted before its lane is released
        fanout(rec)
        if rec.get("kind") == "serve_event" and rec.get("event") in (
                "converged", "completed", "exhausted"):
            req = engine._requests[rec["request_id"]]["req"]
            key = (req.n_class, req.seed)
            if key in serve_samples() or key == serve_keep():
                member = engine.pools[rec["pool_n"]].member(rec["lane"])
                harvests.setdefault(key, []).append((dict(rec), member))

    engine.on_event = tap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    await server.start()
    ctl = await ServeClient.connect(port=server.port)
    stream = await ctl.open_stream()
    streamed: list = []

    async def pump():
        async for rec in stream:
            streamed.append(rec)

    pump_task = asyncio.create_task(pump())
    leap_split, undo = leap_round_timer()
    _cuda.reset_launches()
    reqs = serve_requests()
    lat: list = []

    async def client_run(k: int):
        c = await ServeClient.connect(port=server.port)
        mine = []
        for n, fields in reqs[k::SERVE_CLIENTS]:
            mine.append((time.perf_counter(), await c.submit(n, **fields)))
        for ts, rid in mine:
            await c.wait(rid, timeout=900)
            lat.append(time.perf_counter() - ts)
        await c.close()

    async def keep_and_cancel():
        n, seed = serve_keep()
        c = await ServeClient.connect(port=server.port)
        gone = await c.submit(n, seed=600, mode="ticks", ticks=4096)
        cancelled = await c.cancel(gone)
        rid = await c.submit(n, seed=seed, keep=True)
        first = await c.wait(rid, timeout=900)
        for _ in range(60_000):
            row = await c.status(rid)
            if row["state"] == "spilled":
                break
            await asyncio.sleep(0.01)
        else:
            raise AssertionError(f"serve: the kept request never spilled: {row}")
        assert await c.restore(rid)
        await c.resume(rid, mode="ticks", ticks=SERVE_RESUME_TICKS)
        resumed = await c.wait(rid, timeout=900)
        assert await c.cancel(rid)
        await c.close()
        return {"rid": rid, "first": first, "spilled": row, "resumed": resumed,
                "cancel_rid": gone, "cancelled": cancelled}

    t1 = time.perf_counter()
    kept, *_ = await asyncio.gather(keep_and_cancel(),
                                    *(client_run(k) for k in range(SERVE_CLIENTS)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    undo()
    launches = counts()
    status = await ctl.status()
    gauges = engine.obs.metrics.collect()["gauges"]
    hist = engine.obs.profiler.totals_us()
    memo = engine.warp_memo.stats()
    peak = torch.cuda.max_memory_allocated()
    await ctl.shutdown()
    await server.close()
    await asyncio.wait_for(pump_task, 60)
    written = list(read_manifest(str(manifest), validate=True))
    return {"warm_s": warm_s, "wall": wall, "lat": lat, "kept": kept,
            "status": status, "gauges": gauges, "segments_us": hist, "memo": memo,
            "peak": peak, "launches": launches, "streamed": streamed, "written": written,
            "harvests": harvests, "leap_split": leap_split, "cfg": cfg}


def phase_serve() -> dict:
    """``ServeServer`` on the card with the server's defaults at classes
    1,024 x 64 lanes and 4,096 x 8: warmup, 8 concurrent clients and the
    106-request mix, the kept request's spill round trip, a cancel; every
    request done or cancelled, nothing built after warmup, streamed ==
    written, sampled harvests and the resumed request equal to standalone
    runs on the card."""
    import asyncio

    import numpy as np

    release_device_memory()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        res = asyncio.run(serve_exercise(Path(d)))
    bad = [r for r in res["status"] if r["state"] not in ("done", "cancelled")]
    if bad:
        raise AssertionError(f"serve: requests not done or cancelled: {bad[:4]}")
    steady = res["gauges"]["compiles_steady"][""]
    if steady != 0:
        raise AssertionError(f"serve: {steady} programs built after warmup")
    if res["written"][0].get("event") != "warm" or res["written"][1:] != res["streamed"]:
        raise AssertionError(f"serve: streamed records ({len(res['streamed'])}) != the "
                             f"manifest's ({len(res['written'])})")
    cfg = res["cfg"]
    checks = []
    for key in serve_samples() + (serve_keep(),):
        n, seed = key
        got = res["harvests"].get(key)
        if not got:
            raise AssertionError(f"serve: no harvest captured for {key}")
        rec, member = got[-1]
        mode = mode_of(seed)
        if key == serve_keep():
            want, ref = standalone_want(cfg, n, seed, mode, 64, extra=SERVE_RESUME_TICKS)
        else:
            want, ref = standalone_want(cfg, n, seed, mode,
                                        64 if mode == "converge" else serve_ticks(n))
        diff = state_diff(member, ref)
        checks.append({"class": n, "seed": seed, "event": rec["event"],
                       "ticks_run": rec["ticks_run"], "conv_tick": rec["conv_tick"],
                       "stats_equal": result_matches(rec, want, mode), "state_diff": diff})
        del ref, member
    lat = np.sort(np.asarray(res["lat"]))
    rounds: dict = {}
    for r in res["written"]:
        if r["kind"] == "serve_round":
            rounds[r["engine"]] = rounds.get(r["engine"], 0) + 1
    split = res["leap_split"]
    out = {"phase": "serve", "classes": [[SERVE_SMALL, SERVE_LANES[0]],
                                         [SERVE_LARGE, SERVE_LANES[1]]],
           "chunk": SERVE_CHUNK, "max_leap": SERVE_MAX_LEAP, "clients": SERVE_CLIENTS,
           "requests": len(res["status"]), "warmup_s": res["warm_s"], "wall_s": res["wall"],
           "requests_per_s": len(res["lat"]) / res["wall"],
           "latency_p50_s": float(np.percentile(lat, 50)),
           "latency_p99_s": float(np.percentile(lat, 99)),
           "rounds": rounds, "memo_hits": res["memo"]["hits"],
           "memo_misses": res["memo"]["misses"], "memo_bytes": res["memo"]["bytes"],
           "memo_evictions": res["memo"]["evictions"],
           "leap_rounds_memo_on": split["rounds"], "leap_rounds_dispatched": split["dispatched"],
           "leap_round_wall_s": split["round_s"], "leap_program_s": split["leap_program_s"],
           "round_segments_us": res["segments_us"], "compiles_steady": steady,
           "max_memory_allocated": res["peak"], "launches": res["launches"],
           "records": len(res["written"]), "harvests_vs_standalone": checks,
           "kept": {"first_ticks": res["kept"]["first"]["result"]["ticks_run"],
                    "resumed_ticks": res["kept"]["resumed"]["result"]["ticks_run"],
                    "spill_path_seen": bool(res["kept"]["spilled"].get("spill_path"))},
           "cancel": res["kept"]["cancelled"]}
    emit(out)
    wrong = [c for c in checks if not c["stats_equal"] or c["state_diff"]]
    if wrong:
        raise AssertionError(f"serve: harvests != standalone runs: {wrong}")
    if not res["kept"]["cancelled"]:
        raise AssertionError("serve: the cancel found its request already finished")
    return out


def shard_serve_requests(n: int) -> tuple:
    """One class's mix for ``shard_serve``: converge boots, steady ticks-mode
    runs of ``serve_ticks(n)`` (each a leap round's worth at ``max_leap``
    256) and the kept request (a converge boot, parked, spilled, restored,
    resumed)."""
    small = n == SERVE_SMALL
    base = 0 if small else 300
    reqs = [dict(seed=base + s) for s in range(16 if small else 4)]
    reqs += [dict(seed=base + 100 + s, mode="ticks", ticks=serve_ticks(n), scenario="steady")
             for s in range(8 if small else 2)]
    return reqs, dict(seed=base + 200, keep=True)


def shard_serve_run(pool, n: int, tmp: Path) -> dict:
    """``pool`` behind a ``ServeEngine`` (warp on, ``max_leap`` 256, spill
    after one idle round): warmup, then under the build counter the class's
    mix drained, the kept request spilled, restored, resumed for
    ``SERVE_RESUME_TICKS`` and drained again. Returns the request rows, the
    rounds by engine, walls, builds and launches."""
    import torch

    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest

    (tmp / "spill").mkdir()
    engine = ServeEngine([pool], warp=True, max_leap=SERVE_MAX_LEAP, spill_after=1,
                         spill_dir=str(tmp / "spill"), journal_dir=str(tmp / "wal"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    reqs, kept = shard_serve_requests(n)
    events = []
    _cuda.reset_launches()
    with compile_counter() as box:
        t0 = time.perf_counter()
        rids = [engine.submit(ServeRequest(n=n, **f)) for f in reqs]
        krid = engine.submit(ServeRequest(n=n, **kept))
        events += engine.drain()
        for _ in range(64):
            if engine.status(krid)["state"] == "spilled":
                break
            events += engine.step()
        engine.settle_spills()
        spilled = engine.status(krid)["state"]
        restored = engine.restore(krid)
        engine.resume(krid, mode="ticks", ticks=SERVE_RESUME_TICKS)
        events += engine.drain()
        engine.settle_spills()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    rows = []
    for rid in rids + [krid]:
        row = engine.status(rid)
        result = {k: v for k, v in (row.get("result") or {}).items() if k != "generation"}
        rows.append({"state": row["state"], "result": result})
    rounds: dict = {}
    for r in events:
        if r["kind"] == "serve_round":
            rounds[r["engine"]] = rounds.get(r["engine"], 0) + 1
    return {"engine": engine, "rows": rows, "rounds": rounds, "warmup_s": warm, "wall_s": wall,
            "builds": box.count, "launches": launches, "kept_spilled": spilled,
            "kept_restored": restored}


def phase_shard_serve() -> dict:
    """The sharded serve pool (``serve/shardpool.py``) on the card's one
    rank: a one-rank NCCL group made here, a 1-D ``ensemble`` mesh for the
    1,024 x 64 class and a 1 x 1 ``ensemble x peers`` mesh for the 4,096 x
    8 class (so the row-sharded tick's collectives run on the peer group).
    Each class's ``ShardedLanePool`` and a plain ``LanePool`` take the same
    mix through a ``ServeEngine`` (``shard_serve_run``): the request rows
    equal, every lane's member bit-equal, nothing built after warmup, leap
    rounds run. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet.sharding import ENSEMBLE_AXIS, make_fleet_mesh
    from kaboodle_tpu_torch.parallel.mesh import PEER_AXIS
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.shardpool import ShardedLanePool

    release_device_memory()
    t_phase = time.perf_counter()
    cfg = SwimConfig(deterministic=True)
    meshes = {SERVE_SMALL: make_fleet_mesh(),
              SERVE_LARGE: init_device_mesh("cuda", (1, 1),
                                            mesh_dim_names=(ENSEMBLE_AXIS, PEER_AXIS))}
    out = {"phase": "shard_serve", "backend": str(dist.get_backend()),
           "world": dist.get_world_size(), "classes": {}}
    launches = {k: 0 for k in counts()}
    bad = []
    for n, lanes in zip((SERVE_SMALL, SERVE_LARGE), SERVE_LANES):
        torch.cuda.reset_peak_memory_stats()
        res = {}
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            for kind in ("plain", "sharded"):
                (Path(d) / kind).mkdir()
                pool = (LanePool(n, lanes, cfg=cfg, chunk=SERVE_CHUNK) if kind == "plain" else
                        ShardedLanePool(n, lanes, cfg=cfg, chunk=SERVE_CHUNK,
                                        device_mesh=meshes[n]))
                res[kind] = shard_serve_run(pool, n, Path(d) / kind)
                res[kind]["pool"] = pool
                for k, v in res[kind]["launches"].items():
                    launches[k] += v
        plain, sharded = res["plain"]["pool"], res["sharded"]["pool"]
        diff = {}
        for lane in range(lanes):
            d = state_diff(plain.member(lane), sharded.member(lane))
            if d:
                diff[lane] = d
        c = {"lanes": lanes, "mesh": sharded.stats()["device_mesh"],
             "requests": len(res["plain"]["rows"]),
             "results_equal": ([r["result"] for r in res["plain"]["rows"]]
                               == [r["result"] for r in res["sharded"]["rows"]]),
             "member_mismatches": diff,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
        for kind in ("plain", "sharded"):
            r = res[kind]
            c[kind] = {k: r[k] for k in ("warmup_s", "wall_s", "builds", "rounds",
                                         "kept_spilled", "kept_restored")}
            c[kind]["states"] = [row["state"] for row in r["rows"]]
            r["engine"].close()
        out["classes"][str(n)] = c
        # Every request done but the kept one, parked after its resumed run
        # (or spilled again, if the engine idled long enough).
        ok = (c["results_equal"] and not diff and all(
            c[k]["builds"] == 0 and c[k]["kept_spilled"] == "spilled" and c[k]["kept_restored"]
            and c[k]["states"][:-1] == ["done"] * (c["requests"] - 1)
            and c[k]["states"][-1] in ("parked", "spilled")
            and c[k]["rounds"].get("leap", 0) >= 1 for k in ("plain", "sharded")))
        if not ok:
            bad.append(n)
        del res, plain, sharded
        release_device_memory()
    dist.destroy_process_group()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError(f"shard_serve: the sharded pool != the plain pool in {bad}: {out}")
    return out


def phase_serve_parity() -> dict:
    """``serve/dryrun.py::parity_script`` (class 64, 8 lanes, chunk 4, the
    kept request's spill round trip) on the card and on the CPU: status
    rows, records, ``serve_round`` records and final pools bit-equal."""
    import numpy as np

    from kaboodle_tpu_torch.serve.dryrun import parity_script

    res, launches = {}, None
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        for dev in ("cuda", "cpu"):
            (Path(d) / dev).mkdir()
            if dev == "cuda":
                res[dev], wall, launches = timed(lambda: parity_script("cuda", str(Path(d) / dev)))
            else:
                res[dev] = parity_script("cpu", str(Path(d) / dev))
    got, want = res["cuda"], res["cpu"]
    differ = [k for k in ("status", "records", "rounds") if got[k] != want[k]]
    if not np.array_equal(got["generation"], want["generation"]):
        differ.append("generation")
    for part in ("pool", "kept_member"):
        for k, w in want[part].items():
            g = got[part][k]
            if (w is None) != (g is None):
                differ.append(f"{part}.{k}")
            elif w is not None and not (g.dtype == w.dtype and np.array_equal(
                    g, w, equal_nan=bool(np.issubdtype(w.dtype, np.floating)))):
                differ.append(f"{part}.{k}")
    out = {"phase": "serve_parity", "n": 64, "lanes": 8, "chunk": 4, "card_wall_s": wall,
           "rounds": [[r["engine"], r["lanes"], r["ticks"]] for r in want["rounds"]],
           "records": len(want["records"]), "launches": launches, "differ": differ}
    emit(out)
    if differ:
        raise AssertionError(f"serve_parity: the card's serve script != the CPU's in {differ}")
    return out


# ------------------------------------------------------------- oracle parity

# The dense tick on the card held to the lockstep oracle (oracle/lockstep.py),
# tick by tick, all kernels on: (a) the N = 256 broadcast boot with an
# active share cap, lean state and int16 timers (K2, K3, K4); (b) a
# random-fault run at N = 128, full state (K1, K3, K4), telemetry build,
# the counters of the dense and the blocked tick against the oracle's.
ORACLE_BOOT_N, ORACLE_BOOT_TICKS, ORACLE_SHARE_CAP = 256, 4, 16
ORACLE_FAULT_N, ORACLE_FAULT_TICKS, ORACLE_BLOCK = 128, 32, 64
ORACLE_SEED = 1010
ORACLE_KERNELS = ("fused_fp_idv", "fused_fp_hash", "fused_suspicion", "fused_oldest_k")


def oracle_fault_plan(rng, n: int, ticks: int) -> list[dict]:
    """Random per-tick faults, drawn as ``tests/test_fuzz_parity.py::
    _random_inputs`` draws them: kills, revives, a two-group partition now
    and then, a fixed drop mask (exact, unlike a rate), manual pings."""
    import numpy as np

    plan = []
    for _ in range(ticks):
        kill = rng.random(n) < 0.06
        revive = (rng.random(n) < 0.06) & ~kill
        part = ((np.arange(n) % 2).astype(np.int32) if rng.random() < 0.2
                else np.zeros(n, np.int32))
        drop_ok = rng.random((n, n)) >= rng.choice([0.0, 0.0, 0.15])
        manual = np.where(rng.random(n) < 0.08, rng.integers(0, n, n), -1).astype(np.int32)
        plan.append({"kill": kill, "revive": revive, "partition": part,
                     "drop_ok": drop_ok, "manual_target": manual})
    return plan


def oracle_inputs(n: int, faults: dict | None, device):
    """One tick's ``TickInputs`` from a plan entry (``None``: no fault)."""
    import numpy as np

    from kaboodle_tpu_torch.sim.state import idle_inputs, inputs_from_numpy

    if faults is None:
        return idle_inputs(n, device=device)
    return inputs_from_numpy({**faults, "drop_rate": np.float32(0.0)}, device=device)


def oracle_tick(mesh, faults: dict | None) -> None:
    """Apply a plan entry to the oracle mesh and run its tick."""
    import numpy as np

    if faults is not None:
        for p in np.nonzero(faults["kill"])[0]:
            mesh.kill(int(p))
        for p in np.nonzero(faults["revive"])[0]:
            mesh.revive(int(p))
        for p in np.nonzero(faults["manual_target"] >= 0)[0]:
            mesh.engines[p].pending_manual_pings.append(int(faults["manual_target"][p]))
        dok, part = faults["drop_ok"], faults["partition"]
        mesh.delivery_ok = lambda s, r, t: bool(dok[s, r] and part[s] == part[r])
    mesh.tick()


def oracle_diff(mesh, st, metrics) -> list[str]:
    """Where the tick's state and metrics differ from the oracle's, as
    ``tests/test_kernel_parity.py::_assert_tick_equal`` compares them: the
    state codes, the timers where a state exists, the fingerprints of alive
    rows, ``converged`` and ``messages_delivered``."""
    import numpy as np

    from kaboodle_tpu_torch.ops.hashing import membership_fingerprint

    bad = []
    S = st.state.cpu().numpy()
    want_s = mesh.state_matrix()
    if not np.array_equal(S, want_s):
        bad.append("state")
    if not np.array_equal(st.timer.cpu().numpy() * (S > 0),
                          mesh.timer_matrix() * (want_s > 0)):
        bad.append("timer")
    alive = st.alive.cpu().numpy()
    fp = membership_fingerprint(st.state > 0, st.identity).cpu().numpy().view(np.uint32)
    want_fp = (np.array(mesh.fingerprints(), dtype=np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    if not np.array_equal(fp[alive], want_fp[alive]):
        bad.append("fingerprint")
    if bool(metrics.converged) != mesh.converged():
        bad.append("converged")
    if int(metrics.messages_delivered) != mesh.last_tick_messages:
        bad.append("messages_delivered")
    return bad


def oracle_counter_diff(mesh, counters) -> list[str]:
    """The ``ProtocolCounters`` fields that differ from the oracle's tallies."""
    return [k for k, want in mesh.last_tick_counters.items()
            if int(getattr(counters, k)) != want]


def oracle_fault_cfg(rng):
    """Random protocol flags (``tests/test_fuzz_parity.py::_random_cfg``),
    deterministic mode, every kernel flag on."""
    from kaboodle_tpu_torch.config import SwimConfig

    return SwimConfig(
        deterministic=True,
        join_broadcast_enabled=bool(rng.integers(2)),
        backdate_gossip_inserts=bool(rng.integers(2)),
        faithful_failed_broadcast=bool(rng.integers(2)),
        faithful_indirect_ack=bool(rng.integers(2)),
        max_share_peers=int(rng.choice([0, 6, 300])),
        use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True,
    )


def phase_oracle_parity(device="cuda") -> dict:
    """The card's dense tick with all four kernels against the lockstep
    oracle, tick by tick: the N = 256 broadcast boot (lean, int16) and a
    random-fault N = 128 run whose dense and blocked telemetry ticks also
    match the oracle's counters field by field."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.oracle import LockstepMesh
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sim import init_state, make_chunked_tick_fn, make_tick_fn

    t_start = time.perf_counter()
    _cuda.reset_launches()
    tick_s = 0.0

    # (a) the broadcast boot with the share cap below N (D5 at scale).
    n = ORACLE_BOOT_N
    cfg = SwimConfig(deterministic=True, max_share_peers=ORACLE_SHARE_CAP, use_pallas_fp=True,
                     use_pallas_oldest_k=True, use_pallas_suspicion=True)
    mesh = LockstepMesh(n, cfg)
    st = init_state(n, instant_identity=True, timer_dtype=torch.int16, device=device)
    tick = make_tick_fn(cfg, faulty=False)
    idle = oracle_inputs(n, None, device)
    for t in range(ORACLE_BOOT_TICKS):
        oracle_tick(mesh, None)
        t0 = time.perf_counter()
        st, m = tick(st, idle)
        tick_s += time.perf_counter() - t0
        bad = oracle_diff(mesh, st, m)
        if bad:
            raise AssertionError(f"oracle_parity boot: tick {t} differs in {bad}")
    boot_launches = counts()
    boot = {"n": n, "ticks": ORACLE_BOOT_TICKS, "share_cap": ORACLE_SHARE_CAP,
            "converged": mesh.converged(), "launches": boot_launches}

    # (b) random faults, full state, dense and blocked telemetry ticks.
    rng = np.random.default_rng(ORACLE_SEED)
    n = ORACLE_FAULT_N
    cfg = oracle_fault_cfg(rng)
    ring = 0 if cfg.join_broadcast_enabled else 2
    mesh = LockstepMesh(n, cfg, seed=ORACLE_SEED, ring_contacts=ring)
    sd = sc = init_state(n, seed=ORACLE_SEED, ring_contacts=ring, device=device)
    dense = make_tick_fn(cfg, faulty=True, telemetry=True)
    blocked = make_chunked_tick_fn(cfg, faulty=True, block=ORACLE_BLOCK, telemetry=True)
    events = {k: 0 for k in ("kills", "revives", "partitioned_ticks", "manual_pings")}
    for t, faults in enumerate(oracle_fault_plan(rng, n, ORACLE_FAULT_TICKS)):
        events["kills"] += int(faults["kill"].sum())
        events["revives"] += int(faults["revive"].sum())
        events["partitioned_ticks"] += int(faults["partition"].any())
        events["manual_pings"] += int((faults["manual_target"] >= 0).sum())
        oracle_tick(mesh, faults)
        inp = oracle_inputs(n, faults, device)
        t0 = time.perf_counter()
        sd, out_d = dense(sd, inp)
        tick_s += time.perf_counter() - t0
        sc, out_c = blocked(sc, inp)
        for side, s, out in (("dense", sd, out_d), ("blocked", sc, out_c)):
            bad = oracle_diff(mesh, s, out.metrics) + [
                f"counters.{k}" for k in oracle_counter_diff(mesh, out.counters)]
            if bad:
                raise AssertionError(f"oracle_parity faults: {side} tick {t} differs in {bad}")
    launches = counts()
    fault = {"n": n, "ticks": ORACLE_FAULT_TICKS, "block": ORACLE_BLOCK,
             "cfg": {k: getattr(cfg, k) for k in (
                 "join_broadcast_enabled", "backdate_gossip_inserts",
                 "faithful_failed_broadcast", "faithful_indirect_ack", "max_share_peers")},
             "ring_contacts": ring, "events": events,
             "launches": {k: launches[k] - boot_launches[k] for k in launches}}
    out = {"phase": "oracle_parity", "boot": boot, "faults": fault,
           "card_tick_s": tick_s, "wall_s": time.perf_counter() - t_start,
           "launches": launches}
    emit(out)
    require_launches("oracle_parity", launches, ORACLE_KERNELS)
    return out


# ----------------------------------------------------------- serve drivers

# ``serve/loadgen.py`` in its default mode on the card at config 2's class.
LOAD_LANES, LOAD_CHUNK, LOAD_REQUESTS, LOAD_CONCURRENCY = 16, 8, 32, 8
# The open-loop rate: half the closed-loop throughput measured at these
# sizes on an NVIDIA H100 80GB HBM3 at 700 W (29.97 requests/s).
LOAD_RATE = 15.0
LOAD_SAMPLES = (0, 1, 6, 7)  # mix indices = seeds: two boots, two steady runs
# The federation: e0 serves both classes, e1 only the small one.
FED_CLASSES = (SERVE_SMALL, SERVE_LARGE)
FED_LANES = ((16, 4), (16,))
# The level's open-loop rate: the single-engine rate above, so two engines
# take it with room to spare.
FED_REQUESTS, FED_RATE = 48, LOAD_RATE
FED_SAMPLES = (0, 1, 2, 3)  # mix indices: both classes, both modes


def standalone_want(cfg, n: int, seed: int, mode: str, ticks: int, extra: int = 0,
                    device="cuda"):
    """The harvest fields a served request must carry, from its standalone
    run (``serve_reference``), and that run's final state."""
    from kaboodle_tpu_torch.sim.runner import state_agreement

    ref, conv = serve_reference(cfg, n, seed, mode, ticks, extra=extra, device=device)
    conv_ok, fp_min, fp_max, n_alive = state_agreement(ref)
    want = {"conv_tick": conv, "converged": bool(conv_ok),
            "fp_min": int(fp_min) & 0xFFFFFFFF, "fp_max": int(fp_max) & 0xFFFFFFFF,
            "n_alive": int(n_alive), "ticks_run": int(ref.tick)}
    return want, ref


def result_matches(result: dict, want: dict, mode: str) -> bool:
    """``result`` carries ``want``'s fields. A ticks-mode lane that only
    ever leaped never had its entry agreement observed (the leap round does
    not test it, in the JAX engine too): its ``conv_tick`` is -1 then."""
    if mode == "ticks" and result["conv_tick"] == -1:
        want = {**want, "conv_tick": -1}
    return {k: result[k] for k in want} == want


def phase_serve_load(device="cuda", n=SERVE_SMALL) -> dict:
    """``serve/loadgen.py`` default mode (warmup wave, closed loop, open
    loop) through the TCP server on the card: nothing built in the steady
    phases, every sampled request's result equal to its standalone run."""
    import asyncio

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve import loadgen

    release_device_memory()
    args = loadgen.parse_args(["--n", str(n), "--lanes", str(LOAD_LANES),
                               "--chunk", str(LOAD_CHUNK), "--requests", str(LOAD_REQUESTS),
                               "--concurrency", str(LOAD_CONCURRENCY),
                               "--rate", str(LOAD_RATE), "--device", str(device)])
    rows: list = []
    report, wall, launches = timed(lambda: asyncio.run(loadgen._run(args, rows=rows)))
    cfg = SwimConfig(deterministic=True)
    checks = []
    for i in LOAD_SAMPLES:
        fields = loadgen._mix_fields(i)
        want, _ = standalone_want(cfg, n, fields["seed"], fields["mode"], fields["ticks"],
                                  device=device)
        mine = [r for r in rows if r["seed"] == fields["seed"]]
        checks.append({"seed": fields["seed"], "mode": fields["mode"], "served": len(mine),
                       "equal": bool(mine) and all(
                           result_matches(r["result"], want, fields["mode"]) for r in mine)})
    out = {"phase": "serve_load", "n": n, "lanes": LOAD_LANES, "chunk": LOAD_CHUNK,
           "requests_per_phase": LOAD_REQUESTS, "concurrency": LOAD_CONCURRENCY,
           "rate": LOAD_RATE, "wall_s": wall, "report": report, "samples": checks,
           "launches": launches}
    emit(out)
    if report["compiles_steady"] != 0:
        raise AssertionError(f"serve_load: {report['compiles_steady']} programs built "
                             "in the steady phases")
    bad = [c for c in checks if not c["equal"]]
    if bad:
        raise AssertionError(f"serve_load: results != standalone runs: {bad}")
    return out


async def fed_exercise(tmp: Path, device, classes, lanes) -> dict:
    """Two servers and the router on loopback: the open-loop level with its
    churn, then e1 killed mid-round; everything the phase checks."""
    from kaboodle_tpu_torch.analysis.ir.surface import assert_counter_live, compile_counter
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.federation import fedload
    from kaboodle_tpu_torch.serve.federation.router import EngineMember, FedRouter
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer

    assert_counter_live()
    spill_root, journal_root = str(tmp / "spill"), str(tmp / "journal")
    engines, terminals = [], {}
    for eid, pool_lanes in zip(("e0", "e1"), lanes):
        engine = ServeEngine(
            [LanePool(n, k, chunk=8, device=device) for n, k in zip(classes, pool_lanes)],
            warp=True, max_leap=64, spill_after=2, spill_dir=spill_root,
            journal_dir=journal_root, engine_id=eid)
        # Keep every record in the WAL: the phase counts completions there.
        engine.journal.compact_every = 1 << 30
        engines.append(engine)
    t0 = time.perf_counter()
    for engine in engines:
        engine.warmup()
    warm_s = time.perf_counter() - t0
    servers = [ServeServer(e, port=0) for e in engines]
    for srv in servers:
        await srv.start()
    router = FedRouter([EngineMember(e.engine_id, "127.0.0.1", s.port)
                        for e, s in zip(engines, servers)],
                       journal_root=journal_root, spill_root=spill_root, port=0)
    await router.start()

    async def client_factory():
        return await ServeClient.connect(port=router.port)

    # Warm wave (uncounted): both classes and modes through the router.
    warm = await client_factory()
    for i in range(4):
        await warm.wait(await warm.submit(fedload._class_of(i, classes),
                                          **fedload._mix_fields(i)))
    await warm.close()
    rows, adopted = {}, {}
    t1 = time.perf_counter()
    with compile_counter() as box:
        submit_client = await client_factory()
        lat, level_s = await fedload._open_level(client_factory, submit_client, FED_REQUESTS,
                                                 FED_RATE, classes=classes, rows=rows)
        await submit_client.close()
        chaos = await fedload._chaos(client_factory, servers[1].kill, "e1", n=classes[0],
                                     adopted=adopted)
    wall = time.perf_counter() - t1
    probe = await client_factory()
    stats = await probe.stats()
    await probe.close()
    await router.close()
    await servers[0].close()
    engines[1].close()  # e1's server was killed, not closed
    from kaboodle_tpu_torch.serve.journal import read_journal_records

    for eid in ("e0", "e1"):
        terminals[eid] = read_journal_records(str(Path(journal_root) / eid))
    return {"warm_s": warm_s, "wall": wall, "level_s": level_s, "lat": lat, "rows": rows,
            "adopted": adopted, "chaos": chaos, "compiles": box.count, "journals": terminals,
            "routes": stats["routes"], "alive": stats["alive"]}


def journal_completions(records: list) -> dict:
    """Per rid of one journal: ``(harvests, resumes)``."""
    per: dict = {}
    for rec in records:
        h, r = per.get(rec["rid"], (0, 0))
        per[rec["rid"]] = (h + (rec["op"] == "harvested"), r + (rec["op"] == "resumed"))
    return per


def phase_fed_serve(device="cuda", classes=FED_CLASSES, lanes=FED_LANES) -> dict:
    """Two port ``ServeServer``s behind a ``FedRouter`` on the card: the
    open-loop level (every 4th request of the class only e0 serves, every
    8th kept and taken through park, resume and cancel), then e1 killed
    mid-round. No lost terminal, one completion per request in each
    journal, the request spilled on e1 adopted by e0 and resumed equal to
    its standalone run, nothing built, sampled results equal to standalone
    runs; then ``fedload --dryrun`` on the card."""
    import asyncio
    import contextlib
    import io

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.serve.federation import fedload

    release_device_memory()
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        res, _, launches = timed(lambda: asyncio.run(fed_exercise(Path(d), device, classes, lanes)))
    cfg = SwimConfig(deterministic=True)
    checks = []
    for i in FED_SAMPLES:
        fields = fedload._mix_fields(i)
        n = fedload._class_of(i, classes)
        want, _ = standalone_want(cfg, n, fields["seed"], fields["mode"], fields["ticks"],
                                  device=device)
        row = res["rows"].get(i)
        checks.append({"class": n, "seed": fields["seed"], "mode": fields["mode"],
                       "engine": row and row.get("engine"),
                       "equal": bool(row) and result_matches(row["result"], want,
                                                             fields["mode"])})
    kept = res["adopted"]
    # fedload's chaos runs the kept request 6 ticks, then resumes it for 4.
    want_adopted, _ = standalone_want(cfg, classes[0], kept["seed"], "ticks", 10,
                                      device=device)
    dup = {}
    for eid, recs in res["journals"].items():
        for rid, (h, r) in journal_completions(recs).items():
            if h > 1 + r:
                dup[f"{eid}:{rid}"] = (h, r)
    t0 = time.perf_counter()
    _cuda.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fedload.main(["--dryrun", "--device", str(device)])
    dry = json.loads(buf.getvalue().strip().splitlines()[-1])
    dry_s, dry_launches = time.perf_counter() - t0, counts()
    out = {"phase": "fed_serve", "classes": list(classes), "lanes": [list(x) for x in lanes],
           "requests": FED_REQUESTS, "rate": FED_RATE, "warmup_s": res["warm_s"],
           "wall_s": res["wall"], "level_s": res["level_s"],
           "latency_by_class": {str(k): fedload._latency_stats(v)
                                for k, v in res["lat"].items() if v},
           "chaos": res["chaos"], "routes": res["routes"], "alive": res["alive"],
           "compiles_steady": res["compiles"], "samples": checks,
           "adopted": {"seed": kept["seed"], "engine": kept.get("engine"),
                       "ticks_run": kept["result"]["ticks_run"],
                       "equal": result_matches(kept["result"], want_adopted, "ticks")},
           "journal_records": {k: len(v) for k, v in res["journals"].items()},
           "journal_duplicates": dup, "launches": launches,
           "dryrun": {"rc": rc, "wall_s": dry_s, "report": dry, "launches": dry_launches}}
    emit(out)
    if res["compiles"] != 0:
        raise AssertionError(f"fed_serve: {res['compiles']} programs built in the steady phase")
    if res["chaos"]["lost_terminals"] or res["chaos"]["failovers"] != 1:
        raise AssertionError(f"fed_serve: chaos accounting {res['chaos']}")
    if dup:
        raise AssertionError(f"fed_serve: requests completed twice in a journal: {dup}")
    if not all(c["equal"] for c in checks) or not out["adopted"]["equal"]:
        raise AssertionError(f"fed_serve: results != standalone runs: {checks}, "
                             f"adopted {out['adopted']}")
    if kept.get("engine") != "e0":
        raise AssertionError(f"fed_serve: the spilled request resumed on {kept.get('engine')}")
    if rc != 0 or dry.get("fedserve_dryrun") != "ok" or dry["compiles_steady"] != 0:
        raise AssertionError(f"fed_serve: fedload --dryrun failed: {dry}")
    return out


def last_json_line(fn, *args, **kw) -> tuple[int, dict, float, dict]:
    """Run a lane that prints its JSON report last: ``(rc, report, wall,
    launches)``, its other output dropped."""
    import contextlib
    import io

    from kaboodle_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    wall = time.perf_counter() - t0
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), wall, counts()


def phase_serve_chaos_obs(device="cuda") -> tuple[dict, dict]:
    """``run_chaos_dryrun`` and ``run_obs_dryrun`` on the card at the JAX
    sizes (N = 16/32): each asserts its own bars (spill round latency
    within 10 % of no-spill plus the floor, obs overhead at most 5 %,
    nothing built)."""
    from kaboodle_tpu_torch.serve.chaos import run_chaos_dryrun
    from kaboodle_tpu_torch.serve.obsdryrun import run_obs_dryrun

    release_device_memory()
    outs = []
    for name, fn in (("serve_chaos", run_chaos_dryrun), ("serve_obs", run_obs_dryrun)):
        rc, report, wall, launches = last_json_line(fn, device=device)
        out = {"phase": name, "rc": rc, "wall_s": wall, "report": report,
               "launches": launches}
        emit(out)
        if rc != 0 or not report.get("ok"):
            raise AssertionError(f"{name}: the lane failed: {report}")
        outs.append(out)
    return tuple(outs)


# ----------------------------------------------------------------- sparse plane

# The sparse plane's runs: the JAX bench's shape (N = 2^20, K = 16, 3 boot
# contacts, chunks of 8 ticks) and a faulty parity schedule at N = 4,096.
SPARSE_N = 1 << 20
SPARSE_K = 16
SPARSE_CHUNK = 8
SPARSE_CHUNKS = 3
SPARSE_PARITY_N = 4096
SPARSE_PARITY_TICKS = 48
SPARSE_FULL_TICKS = 2


def sparse_spec(timer_dtype: str = "int32"):
    from kaboodle_tpu_torch.sparseplane import SparseSpec

    return SparseSpec(k=SPARSE_K, gossip_fanout=4, boot_contacts=3, timer_dtype=timer_dtype)


def sparse_fault_inputs(n: int, ticks: int):
    """The parity schedule, on the CPU: 1 % of the peers killed at tick 8 and
    revived at tick 24, 3 % more killed at tick 16, 5 % drop throughout."""
    import numpy as np
    import torch

    from kaboodle_tpu_torch.sparseplane import SparseTickInputs

    rng = np.random.default_rng(11)
    first, second = rng.permutation(n)[: n // 100], rng.permutation(n)[: 3 * n // 100]
    kill = np.zeros((ticks, n), bool)
    revive = np.zeros((ticks, n), bool)
    kill[8, first] = True
    kill[16, second] = True
    revive[24, first] = True
    return SparseTickInputs(kill=torch.as_tensor(kill), revive=torch.as_tensor(revive),
                            drop_rate=torch.full((ticks,), 0.05))


def sparse_mismatches(tick, st, inputs, ticks: int, device, mean_rel: float | None = None):
    """Tick ``st`` on the card and on the CPU side by side; returns the
    ``(field, tick)`` pairs that differ (every state plane and metric bit
    for bit, or ``mean_membership`` to ``mean_rel`` when given), the
    largest relative ``mean_membership`` difference, and the last state."""
    import torch

    sides = {"card": st.to(device), "cpu": st.to("cpu")}
    bad, rel = [], 0.0
    for t in range(ticks):
        out = {}
        for side, s in sides.items():
            sides[side], m = tick(s, inputs.at(t).to(s.device))
            out[side] = to_host(sides[side]), to_host(m)
        (a, ma), (b, mb) = out["card"], out["cpu"]
        bad += [(f, t) for f in state_diff(a, b)]
        rel = max(rel, abs(float(ma.mean_membership) - float(mb.mean_membership))
                  / max(abs(float(mb.mean_membership)), 1e-30))
        exact = [f.name for f in dataclasses.fields(ma)
                 if mean_rel is None or f.name != "mean_membership"]
        bad += [(f, t) for f in exact if not torch.equal(getattr(ma, f), getattr(mb, f))]
        if mean_rel is not None and rel > mean_rel:
            bad.append(("mean_membership", t))
    return bad, rel, sides["card"]


def phase_sparse_parity(device="cuda") -> dict:
    """The sparse tick on the card against the CPU: 48 faulty ticks at
    N = 4,096 (kills, a revival, 5 % drop) in random and deterministic mode,
    int32 and int16 timers, every plane and metric bit-equal tick by tick;
    then the first ticks of the bench's N = 2^20 boot, planes bit-equal and
    ``mean_membership`` to rel 1e-6."""
    import torch

    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sparseplane import init_sparse_state, sparse_idle_inputs
    from kaboodle_tpu_torch.sparseplane.bench import bench_cfg
    from kaboodle_tpu_torch.sparseplane.runner import sparse_tick_program

    release_device_memory()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    n, ticks = SPARSE_PARITY_N, SPARSE_PARITY_TICKS
    inputs = sparse_fault_inputs(n, ticks)
    runs, mismatches = {}, {}
    for det in (False, True):
        for timer in ("int32", "int16"):
            cfg = dataclasses.replace(bench_cfg(), deterministic=det)
            tick = sparse_tick_program(cfg, sparse_spec(timer), True)
            st = init_sparse_state(n, sparse_spec(timer), seed=5, device="cpu")
            bad, _, last = sparse_mismatches(tick, st, inputs, ticks, device)
            key = ("deterministic" if det else "random") + "_" + timer
            runs[key] = {"ticks": ticks, "alive": int(last.alive.sum()),
                         "wfip_slots": int((last.nbr_state == 3).sum()),
                         "block_fill_end": float(to_host(last).nbr_state.gt(0).float().mean())}
            mismatches[key] = [f"{f}@{t}" for f, t in bad]
    tick = sparse_tick_program(bench_cfg(), sparse_spec(), False)
    idle = sparse_idle_inputs(SPARSE_N, ticks=SPARSE_FULL_TICKS, device="cpu")
    st = init_sparse_state(SPARSE_N, sparse_spec(), seed=0, device="cpu")
    bad, rel, _ = sparse_mismatches(tick, st, idle, SPARSE_FULL_TICKS, device, mean_rel=1e-6)
    mismatches[f"boot_n{SPARSE_N}"] = [f"{f}@{t}" for f, t in bad]
    torch.cuda.synchronize()
    out = {"phase": "sparse_parity", "n": n, "k": SPARSE_K, "faulty_ticks": ticks,
           "runs": runs, "full_width": {"n": SPARSE_N, "ticks": SPARSE_FULL_TICKS,
                                        "mean_membership_max_rel_diff": rel,
                                        "tolerance": "planes and integer metrics bit-equal, "
                                                     "mean_membership rel 1e-6"},
           "mismatches": mismatches, "wall_s": time.perf_counter() - t0, "launches": counts()}
    emit(out)
    wrong = {k: v for k, v in mismatches.items() if v}
    if wrong:
        raise AssertionError(f"sparse_parity: card != CPU: {wrong}")
    return out


def phase_sparse_boot(device="cuda") -> dict:
    """The bench's run at full width (N = 2^20, K = 16, 3 boot contacts, 3
    chunks of 8 ticks) on the card; a ``save_sparse``/``load_sparse`` round
    trip of the state after chunk 1, resumed for chunk 2 and held bit-equal
    to the unbroken run; the per-tick peak at N = 1,024 and 8,192; then the
    dryrun's stat leg at n = 24."""
    import torch

    from kaboodle_tpu_torch import checkpoint
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.sparseplane import simulate_sparse, sparse_idle_inputs
    from kaboodle_tpu_torch.sparseplane import bench as sparse_bench
    from kaboodle_tpu_torch.sparseplane import dryrun as sparse_dryrun

    release_device_memory()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    spec, dev = sparse_spec(), torch.device(device)
    states = {}
    run = sparse_bench.run_boot(SPARSE_N, spec, SPARSE_CHUNK, SPARSE_CHUNKS, 0, dev,
                                on_chunk=states.__setitem__)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    steady = run["steady_chunk_s"]
    s_per_tick = sum(steady) / (len(steady) * SPARSE_CHUNK)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sparse_mid.npz"
        t0 = time.perf_counter()
        checkpoint.save_sparse(path, states[1], atomic=True)
        mid = checkpoint.load_sparse(path, device=dev)
        ckpt_s = time.perf_counter() - t0
        archive_bytes = path.stat().st_size
    loaded_bad = state_diff(mid, states[1])
    resumed, _ = simulate_sparse(mid, sparse_idle_inputs(SPARSE_N, ticks=SPARSE_CHUNK, device=dev),
                                 sparse_bench.bench_cfg(), spec, device=dev)
    resumed_bad = state_diff(resumed, states[SPARSE_CHUNKS - 1])
    del states, mid, resumed
    release_device_memory()
    sub = sparse_bench.sub_quadratic(spec, dev)
    stat = sparse_dryrun._stat_check(0, dev)
    out = {"phase": "sparse_boot", "n": SPARSE_N, "k": SPARSE_K, "boot_contacts": 3,
           "chunk": SPARSE_CHUNK, "chunks": SPARSE_CHUNKS, "warmup_s": run["warmup_s"],
           "steady_chunk_s": steady, "s_per_tick": s_per_tick,
           "ns_per_peer_tick": 1e9 * s_per_tick / SPARSE_N, "curve": run["curve"],
           "compiles_steady": run["compiles_steady"], "allocated_before": before,
           "max_memory_allocated": peak, "launches": launches,
           "checkpoint": {"save_load_s": ckpt_s, "archive_bytes": archive_bytes,
                          "loaded_diff": loaded_bad, "resumed_diff": resumed_bad},
           "sub_quadratic": sub, "stat_check": stat}
    emit(out)
    if run["compiles_steady"] != 0:
        raise AssertionError(f"sparse_boot: {run['compiles_steady']} programs built while steady")
    if loaded_bad or resumed_bad:
        raise AssertionError(f"sparse_boot: checkpoint resume differs: {loaded_bad} {resumed_bad}")
    if not all(stat["checks"].values()):
        raise AssertionError(f"sparse_boot: dryrun stat checks failed: {stat['checks']}")
    return out


# ----------------------------------------------------------------- command line

CLI_N = 1024
CLI_TICKS = 64
CLI_WARP_TICKS = 512
CLI_SWEEP_E = 64
CLI_SWEEP = ("fleet", "--ensemble", str(CLI_SWEEP_E), "--n", "1024", "--sweep",
             "drop_rate=0:0.3:4", "--max-ticks", "32")
CLI_DRYRUNS = (("phasegraph_n32", ("--n", "32")),
               ("phasegraph_n1024", ("--n", "1024", "--ensemble", "8")))
CLI_ENGINES = {"chunked", "sharded", "fleet", "fused", "warp", "hybrid", "hybrid_masked"}


def phase_cli(device="cuda") -> dict:
    """The port's command line as a user calls it (phase 28): a ``--sim``
    subprocess on the default device against the same run on the CPU, a
    warped churn with its telemetry manifest checked by the summarizer, a
    small sweep with its manifest, and the phasegraph dryrun at two sizes,
    each engine bit-exact with the dense tick on ``device``; beside them the
    analysis lanes ``--ir`` (on ``device``) and ``--rng``, each exit 0."""
    from kaboodle_tpu_torch import cli
    from kaboodle_tpu_torch.telemetry.manifest import read_manifest

    release_device_memory()
    sim = ["--sim", str(CLI_N), "--ticks", str(CLI_TICKS)]
    dev_args = [] if device == "cuda" else ["--device", device]
    # The analysis lanes, each a fresh process (the committed surface counts
    # are a fresh process's), run beside the rest of the phase: KB405 on
    # ``device`` against the committed budget, and the STREAM_* register,
    # each with one traced entry (the whole registry is phase 33's).
    lanes = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "kaboodle_tpu_torch.analysis", *argv], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for name, argv in (("analysis_ir", ["--ir", "--entries", "ops.fused_fp", *dev_args]),
                           ("analysis_rng", ["--rng", "--entries", "ops.crc32", *dev_args]))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kaboodle_tpu_torch", *sim, *dev_args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    sub_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli: the --sim subprocess exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    sub_line = json.loads(proc.stdout.strip().splitlines()[-1])
    rc_cpu, cpu_line, cpu_wall, cpu_launches = last_json_line(
        cli.main, [*sim, "--device", "cpu"])
    same = ({k: v for k, v in sub_line.items() if k != "wall_s"}
            == {k: v for k, v in cpu_line.items() if k != "wall_s"})

    runs, walls = {"cli_sim_cpu": cpu_launches}, {"sim_subprocess": sub_wall,
                                                   "sim_cpu": cpu_wall}
    with tempfile.TemporaryDirectory() as tmp:
        warp_path, sweep_path = str(Path(tmp) / "warp.jsonl"), str(Path(tmp) / "sweep.jsonl")
        rc_warp, warp_line, walls["warp"], runs["cli_warp"] = last_json_line(
            cli.main, ["--sim-scenario", "3", "--sim", str(CLI_N), "--ticks",
                       str(CLI_WARP_TICKS), "--warp", "--telemetry", warp_path, *dev_args])
        rc_check, _, walls["telemetry_check"], _ = last_json_line(
            cli.main, ["telemetry", warp_path, "--check"])
        warp_kinds = [r["kind"] for r in read_manifest(warp_path)]
        rc_sweep, sweep_line, walls["sweep"], runs["cli_sweep"] = last_json_line(
            cli.main, [*CLI_SWEEP, "--telemetry", sweep_path, *dev_args])
        sweep_kinds = [r["kind"] for r in read_manifest(sweep_path)]
    dryruns = {}
    for name, argv in CLI_DRYRUNS:
        rc, report, walls[name], runs[f"cli_{name}"] = last_json_line(
            cli.main, ["phasegraph", *argv, *dev_args])
        dryruns[name] = {"rc": rc, "engines": report["engines"], "ok": report["ok"]}
    analysis = {}
    for name, (t_start, p) in lanes.items():
        found, err = p.communicate(timeout=600)
        analysis[name] = {"rc": p.returncode, "wall_s": time.perf_counter() - t_start,
                          "summary": err.strip().splitlines()[-1:],
                          "findings": found.strip().splitlines()}

    out = {"phase": "cli", "walls": walls, "wall_s": sum(walls.values()),
           "sim": {"subprocess": sub_line, "cpu": cpu_line, "equal_but_wall": same,
                   "rc_cpu": rc_cpu},
           "warp": {"rc": rc_warp, "final_converged": warp_line["final_converged"],
                    "dense_ticks": warp_line["dense_ticks_executed"],
                    "leaped_ticks": warp_line["leaped_ticks"],
                    "leap_classes": warp_line["leap_classes"],
                    "memo": warp_line.get("warp_memo_stats"),
                    "counter_totals": warp_line.get("counter_totals"),
                    "manifest_kinds": {k: warp_kinds.count(k) for k in sorted(set(warp_kinds))},
                    "telemetry_check_rc": rc_check},
           "sweep": {"rc": rc_sweep, "line": sweep_line,
                     "manifest_kinds": sweep_kinds},
           "phasegraph": dryruns, "analysis": analysis, "launches": runs}
    emit(out)
    if not (sub_line["final_converged"] and sub_line["n_peers"] == CLI_N and same and rc_cpu == 0):
        raise AssertionError(f"cli: --sim on the card != on the CPU: {sub_line} {cpu_line}")
    if rc_warp != (0 if warp_line["final_converged"] else 2) or rc_check != 0:
        raise AssertionError(f"cli: --warp exited {rc_warp} for {warp_line}, "
                             f"telemetry --check {rc_check}")
    if warp_line["dense_ticks_executed"] + warp_line["leaped_ticks"] != CLI_WARP_TICKS:
        raise AssertionError(f"cli: --warp ticks do not add up: {warp_line}")
    if (rc_sweep != 0 or sweep_kinds != ["run"] + ["sweep_bucket"] * 4
            or sum(b["members"] for b in sweep_line["per_knob"]) != CLI_SWEEP_E):
        raise AssertionError(f"cli: the sweep failed: rc {rc_sweep}, {sweep_kinds}")
    for name, d in dryruns.items():
        if d["rc"] != 0 or not d["ok"] or set(d["engines"]) != CLI_ENGINES:
            raise AssertionError(f"cli: {name} failed: {d}")
    if any(d["rc"] != 0 for d in analysis.values()):
        raise AssertionError(f"cli: an analysis lane failed: {analysis}")
    return out


# The record fields the card must give exactly as the CPU does.
COSTSCOPE_FIELDS = ("bytes_accessed", "argument_bytes", "output_bytes", "peak_bytes", "flops")


def arrays_diff(got: dict, want: dict) -> list[str]:
    """The leaves of two ``registry.output_arrays`` dicts that differ (dtype,
    shape or any byte)."""
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        g, w = got[k], want[k]
        if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
            bad.append(k)
    return bad


def phase_costscope(churn=None, device="cuda") -> dict:
    """costscope on the card (phase 31): every entry of the registry
    (``analysis/ir/registry.py``) run on the card, its outputs bit-equal to
    the same entry on the CPU, and every one-device entry's static record
    (``costscope/extract.py``'s counter) equal in the card and CPU runs; the
    four sharded entries on a one-rank NCCL group made here, against a
    one-rank gloo job on the CPU started beside the card work; K1-K4 must
    launch. Then ``costscope --icibench`` at world 1 over NCCL (its walls;
    at one rank nothing crosses a link), and ``costscope --report`` with
    the ``churn`` phase's wall as its one ``--walls`` line (``churn``: that
    phase's result; run here when not given)."""
    import concurrent.futures
    import contextlib
    import io

    import numpy as np
    import torch.distributed as dist

    from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS, output_arrays
    from kaboodle_tpu_torch.costscope import cli as cs_cli
    from kaboodle_tpu_torch.costscope.extract import measure, run_sharded
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.parallel import make_mesh

    if churn is None:
        churn = phase_churn()[0]
    release_device_memory()
    t_phase = time.perf_counter()
    card = card_line()
    sharded = [e.name for e in ENTRY_POINTS if e.sharded]
    entries, bad = {}, []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ref_path = str(Path(tmp) / "sharded_cpu.npz")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref_job = pool.submit(run_sharded, sharded, 1, ref_path)
            _cuda.reset_launches()
            for e in (e for e in ENTRY_POINTS if not e.sharded):
                rec, (_, out), ops = measure(e, device)
                ref, (_, ref_out), ref_ops = measure(e, "cpu")
                diff = arrays_diff(output_arrays(out), output_arrays(ref_out))
                fields = {f: [rec[f], ref[f]] for f in COSTSCOPE_FIELDS if rec[f] != ref[f]}
                row = {"flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
                       "peak_bytes": rec["peak_bytes"], "outputs_equal": not diff,
                       "record_equal": not fields}
                if diff or fields:
                    row.update(outputs_differ=diff, fields_differ=fields, ops_differ={
                        op: [ops.get(op), ref_ops.get(op)] for op in sorted(set(ops) | set(ref_ops))
                        if ops.get(op) != ref_ops.get(op)})
                    bad.append(e.name)
                entries[e.name] = row
            mesh = make_mesh(device=device)
            card_sharded = {}
            for name in sharded:
                (e,) = [x for x in ENTRY_POINTS if x.name == name]
                rec, (_, out), _ = measure(e, device)
                card_sharded[name] = (rec, output_arrays(out))
            launches = counts()
            ref_records = ref_job.result()
        with np.load(ref_path) as z:
            for name, (rec, arrays) in card_sharded.items():
                ref = {k.split("|", 1)[1]: z[k] for k in z.files if k.startswith(name + "|")}
                diff = arrays_diff(arrays, ref)
                entries[name] = {"flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
                                 "peak_bytes": rec["peak_bytes"], "ici_bytes": rec["ici_bytes"],
                                 "collectives": rec["collectives"], "outputs_equal": not diff,
                                 "cpu_gloo_ici_bytes": ref_records[name]["ici_bytes"]}
                if diff:
                    entries[name]["outputs_differ"] = diff
                    bad.append(name)
        t_entries = time.perf_counter() - t_phase

        buf = io.StringIO()
        ici_path = str(Path(tmp) / "ici.json")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_ici = cs_cli.main(["--icibench", "--json", ici_path,
                                  *([] if device == "cuda" else ["--device", device])])
        t_ici = time.perf_counter() - t0
        ici = json.loads(Path(ici_path).read_text())
        ici_text = buf.getvalue().strip().splitlines()
        dist.destroy_process_group()
        del mesh

        walls_path, rep_path = str(Path(tmp) / "walls.jsonl"), str(Path(tmp) / "report.json")
        Path(walls_path).write_text(json.dumps({
            "n_peers": churn["n"], "ticks": churn["ticks"], "wall_s": churn["wall_s"],
            "backend": card, "source": "chip_smoke.py churn"}) + "\n")
        with contextlib.redirect_stdout(io.StringIO()):
            rc_report = cs_cli.main(["--report", "--walls", walls_path, "--json", rep_path])
        placements = json.loads(Path(rep_path).read_text())["placements"]

    out = {"phase": "costscope", "card": card, "entries": entries, "launches": launches,
           "entries_s": t_entries, "icibench_s": t_ici, "icibench": {
               "rc": rc_ici, "backend": ici["backend"], "ranks": ici["n_devices"],
               "walls_s": {f"{r['collective']}@{r['n']}": r["wall_s_best"]
                           for r in ici["results"]},
               "ici_bytes_ring": sum(r["ici_bytes_ring"] for r in ici["results"]),
               "text": ici_text},
           "report": {"rc": rc_report, "placements": placements},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bad:
        raise AssertionError(f"costscope: entries differ between the card and the CPU: {bad}")
    require_launches("costscope", launches, _cuda.KERNELS)
    if rc_ici != 0 or ici["n_devices"] != 1 or out["icibench"]["ici_bytes_ring"] != 0:
        raise AssertionError(f"costscope: --icibench at world 1 failed: {out['icibench']}")
    if rc_report != 0 or [p["entry"] for p in placements] != ["phasegraph.tick.faulty"]:
        raise AssertionError(f"costscope: --report failed: {out['report']}")
    return out


# The full-width tick of the analysis phase: the registry's dense faulty
# tick (``phasegraph.tick.faulty``, kernel flags on) on the churn's state.
ANALYSIS_FULL_ENTRY = "phasegraph.tick.faulty"


def analysis_lanes(device) -> dict:
    """The traced lanes over the whole registry on ``device`` (one trace read
    by both; the sharded entries on the process's group): ``{"ir": finding
    keys, "rng": finding keys, "counts": KB402 syncs per run by key,
    "leap": report, "results": trace_registry's dict, "ir_findings",
    "rng_findings", "graphs"}``."""
    from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS
    from kaboodle_tpu_torch.analysis.ir.scan import run_scan, trace_registry
    from kaboodle_tpu_torch.analysis.rng import scan as rng_scan
    from kaboodle_tpu_torch.costscope.baseline import DEFAULT_BASELINE as COSTSCOPE

    results = trace_registry(ENTRY_POINTS, device, rng=True)
    ir = run_scan(entries=ENTRY_POINTS, device=device, with_surface=False, results=results)
    rng = rng_scan.run_rng_scan(entries=ENTRY_POINTS, results=results)
    return {"ir": sorted({f.key for f in ir.findings}),
            "rng": sorted({f.key for f in rng.findings}),
            "counts": {k: list(v) for k, v in sorted(ir.counts.items())},
            "leap": rng_scan.build_leap_report(rng.graphs, costscope_path=COSTSCOPE),
            "results": results, "ir_findings": ir.findings, "rng_findings": rng.findings,
            "graphs": rng.graphs}


def phase_analysis(churn_final=None, device="cuda") -> dict:
    """The traced analysis lanes on the card (phase 33): ``run_scan``
    (KB401-KB404) and ``run_rng_scan`` (KB601-KB605) over all 31 registry
    entries on the card, the sharded ones on a one-rank NCCL group made
    here. The finding keys and the KB402 counts by site must equal the
    committed baselines (``kaboodle_tpu_torch/analysis/{ir,rng}/
    baseline.json``), the leap report the committed
    ``analysis/rng/leap.json``: the records that the CPU tests hold equal
    to the CPU's trace (``tests/test_torch_graftscan.py``,
    ``test_torch_keyscope.py``), so the card gives the CPU's findings
    without a second trace here. K1-K4 must launch. Then one dense churn tick at full width (``churn_final``,
    config 3's N = 8,192 state; run here when not given) through the
    ``phasegraph.tick.faulty`` build: its KB401-KB404 keys and its sink
    list must be the N = 32 entry's, shapes scaled to N (one sink per draw
    however many row chunks the draw takes)."""
    import torch
    import torch.distributed as dist

    from kaboodle_tpu_torch.analysis.core import load_baseline, load_counts
    from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS
    from kaboodle_tpu_torch.analysis.ir.scan import read_entry
    from kaboodle_tpu_torch.analysis.rng import scan as rng_scan
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.parallel import make_mesh
    from kaboodle_tpu_torch.sim.state import idle_inputs

    if churn_final is None:
        churn_final = to_host(phase_churn()[1])
    release_device_memory()
    t_phase = time.perf_counter()
    card = card_line()
    committed = {lane: sorted(load_baseline(
        ROOT / f"kaboodle_tpu_torch/analysis/{lane}/baseline.json")) for lane in ("ir", "rng")}
    committed_leap = rng_scan.load_leap_report(ROOT / rng_scan.DEFAULT_LEAP_REPORT)
    committed_counts = {k: list(v) for k, v in sorted(load_counts(
        ROOT / "kaboodle_tpu_torch/analysis/ir/baseline.json").items())}
    mesh = make_mesh(device=device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    lanes = analysis_lanes(device)
    torch.cuda.synchronize()
    t_registry = time.perf_counter() - t0
    launches = counts()
    dist.destroy_process_group()
    del mesh

    # One dense churn tick at full width, the N = 32 entry's build.
    (entry,) = [e for e in ENTRY_POINTS if e.name == ANALYSIS_FULL_ENTRY]
    st = dataclasses.replace(churn_final, **{
        f.name: getattr(churn_final, f.name).to(device)
        for f in dataclasses.fields(churn_final) if getattr(churn_final, f.name) is not None})
    n = st.n
    full_entry = dataclasses.replace(
        entry, build=lambda dev=None: (entry.build(dev)[0], (st, idle_inputs(n, device=dev))))
    _cuda.reset_launches()
    t0 = time.perf_counter()
    full = read_entry(full_entry, device, rng=True)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    full_launches = counts()
    del st, full_entry

    small = lanes["results"][ANALYSIS_FULL_ENTRY]
    strip = lambda fs: sorted({f.key.split("::", 1)[1] for f in fs})  # noqa: E731
    scale = n // 32
    want_sinks = sorted((s.descr(), tuple(d * scale if d == 32 else d for d in s.shape))
                        for s in small.graph.sinks)
    got_sinks = sorted((s.descr(), tuple(s.shape)) for s in full.graph.sinks)
    by_rule: dict[str, int] = {}
    for f in (*lanes["ir_findings"], *lanes["rng_findings"]):
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    equal = {"keys_vs_committed": [lanes["ir"], lanes["rng"]] == [committed["ir"],
                                                                  committed["rng"]],
             "counts_vs_committed": lanes["counts"] == committed_counts,
             "leap_vs_committed": lanes["leap"] == committed_leap}
    full_out = {"entry": ANALYSIS_FULL_ENTRY, "n": n, "kb402_syncs_per_call": full.syncs,
                "keys_equal_n32": strip(full.findings) == strip(small.findings),
                "sinks": [f"{d} {list(s)}" for d, s in got_sinks],
                "sinks_equal_n32_scaled": got_sinks == want_sinks, "launches": full_launches}
    out = {"analysis": {
        "phase": "analysis", "card": card, "seconds": time.perf_counter() - t_phase,
        "registry_s": t_registry, "full_width_s": t_full,
        "findings_by_rule": by_rule, "equal": equal,
        "kb402_syncs_per_call": {name: r.syncs for name, r in lanes["results"].items()
                                 if name.startswith(("phasegraph.tick", "phasegraph.serve",
                                                     "sim."))},
        "sinks": {name: sorted(f"{s.descr()} {list(s.shape)}" for s in g.sinks)
                  for name, g in lanes["graphs"].items() if g.sinks},
        "full_width": full_out, "launches": launches}}
    emit(out)
    if not all(equal.values()):
        raise AssertionError(
            f"analysis: the card's lanes differ from the committed records: {equal}; ir "
            f"{sorted(set(lanes['ir']) ^ set(committed['ir']))} rng "
            f"{sorted(set(lanes['rng']) ^ set(committed['rng']))} counts "
            f"{[k for k in committed_counts if lanes['counts'].get(k) != committed_counts[k]]}")
    if not (full_out["keys_equal_n32"] and full_out["sinks_equal_n32_scaled"]):
        raise AssertionError(f"analysis: the N = {n} tick differs from the N = 32 entry: "
                             f"{strip(full.findings)} vs {strip(small.findings)}; "
                             f"{got_sinks} vs {want_sinks}")
    require_launches("analysis", launches, _cuda.KERNELS)
    require_launches("analysis full width", full_launches, CHURN_KERNELS)
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
    start = t0 = time.perf_counter()
    _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {name: ptxas_summary(log) for name, log in _cuda.build_logs.items()}})

    kern = phase_kernels()
    boot, boot_final = phase_boot()
    boot_final = to_host(boot_final)
    churn, final, churn_metrics = phase_churn()
    churn_state = phase_kernels_churn_state(final)
    cuts = phase_stage_cuts(final)
    final, churn_metrics = to_host(final), to_host(churn_metrics)
    tele = phase_telemetry(churn, final, churn_metrics, boot, boot_final)
    shard = phase_sharded(boot, boot_final)
    shard_serve = phase_shard_serve()
    del boot_final, churn_metrics
    phase_parity()
    facade = phase_facade()
    ckpt = phase_checkpoint(final)
    churn_final = final  # on the host: the analysis phase's full-width tick
    del final
    phase_chunked_parity()
    cboot = phase_chunked_boot()
    cfaulty = phase_chunked_faulty()
    fboot, boot_res = phase_fleet_boot()
    fsweep, sweep_res = phase_fleet_sweep()
    phase_fleet_parity(boot_res, sweep_res, fsweep["sweep_line"])
    del boot_res, sweep_res
    window = phase_warp_window()
    drain = phase_warp_drain()
    wfleet = phase_warp_fleet()
    serve = phase_serve()
    sparity = phase_serve_parity()
    oracle = phase_oracle_parity()
    sload = phase_serve_load()
    fed = phase_fed_serve()
    schaos, sobs = phase_serve_chaos_obs()
    sparse_par = phase_sparse_parity()
    sparse_boot = phase_sparse_boot()
    cli_out = phase_cli()
    cs = phase_costscope(churn)
    an = phase_analysis(churn_final)["analysis"]
    del churn_final
    # The blocked tick, the fleet, the leaps, the serve step and the sparse
    # tick run no kernel (as in the JAX package), nor does the command line
    # at its default config (no kernel flag, as in the JAX CLI): their runs
    # (the serve drivers' too) are counted, and launch 0, but no launch is
    # required of them.
    runs = {"boot": boot["launches"], "churn": churn["launches"],
            "telemetry_churn": tele["churn"]["launches"],
            "telemetry_boot": tele["boot"]["launches"],
            "sharded_churn": shard["churn"]["launches"], "sharded_boot": shard["boot"]["launches"],
            "facade": facade["launches"],
            "checkpoint_resume": ckpt["launches_resumed"],
            "chunked_boot": cboot["launches"], "chunked_faulty": cfaulty["launches"],
            "fleet_boot": fboot["launches"], "fleet_sweep": fsweep["launches"],
            "warp_window_dense": window["launches_dense"],
            "warp_window_leap": window["launches_leap"],
            **{f"warp_drain_{k}": v for k, v in drain["launches"].items()},
            "warp_fleet": wfleet["launches"], "serve": serve["launches"],
            "shard_serve": shard_serve["launches"],
            "serve_parity": sparity["launches"], "oracle_parity": oracle["launches"],
            "serve_load": sload["launches"], "fed_serve": fed["launches"],
            "fed_serve_dryrun": fed["dryrun"]["launches"],
            "serve_chaos": schaos["launches"], "serve_obs": sobs["launches"],
            "sparse_parity": sparse_par["launches"], "sparse_boot": sparse_boot["launches"],
            **cli_out["launches"], "costscope": cs["launches"],
            "stage_cuts": cuts["launches"], "analysis": an["launches"],
            "analysis_full": an["full_width"]["launches"]}

    rows = kern["rows"] + churn_state["rows"]
    cases = kern["cases"] + churn_state["cases"]
    summary = []
    for name, (source, replaces) in KERNEL_META.items():
        shapes = []
        for row in (r for r in rows if r["kernel"] == name):
            shapes.append({**{k: v for k, v in row.items() if k != "kernel"},
                           "launches": sum(runs[r][name] for r in SHAPE_RUNS[row["cell"]])})
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
            "ms": top["kernel_ms"], "launch_floor_ms": top["launch_floor_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": top["shape"], "cell": top["cell"], "shapes": shapes,
        })
    emit({"phase": "total", "seconds": time.perf_counter() - start})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
