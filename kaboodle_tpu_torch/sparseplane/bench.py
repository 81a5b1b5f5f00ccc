"""``python -m kaboodle_tpu_torch.sparseplane.bench`` -- the million-peer bench.

The port of ``kaboodle_tpu/sparseplane/bench.py``, on the card unless
``--device`` names another. It writes ``torch_sparse.json`` (``--out``),
never the JAX package's ``BENCH_sparse.json``. From a cold boot of N peers
(default 2^20, K = 16, 3 ring contacts) it runs ``--ticks`` in chunks of
``--chunk`` and records:

- **per-peer cost** -- seconds/tick and ns/peer/tick over the steady chunks
  (every chunk after the first), with ``compiles_steady``: the programs
  built in that window (``analysis/ir/surface.py::compile_counter``);
- **convergence curves** -- ``block_fill`` and ``mean_membership`` at each
  chunk boundary;
- **sub-quadratic evidence** -- the JAX bench reads XLA's bytes-accessed
  estimate, which has no torch counterpart. In its place: the peak device
  memory of one steady tick at N = 1,024 and at N = 8,192 (an 8x N step),
  over what was allocated before its state was made, and their ratio. The
  dense layout would make that ratio about 64. On the CPU this leg is
  null, with the reason.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kaboodle_tpu_torch.sparseplane.dryrun import sync

PEAK_NS = (1024, 8192)


def bench_cfg():
    from kaboodle_tpu_torch.config import SwimConfig

    return SwimConfig(join_broadcast_enabled=False)


def run_boot(n: int, spec, chunk: int, chunks: int, seed: int, device, on_chunk=None) -> dict:
    """Boot ``n`` peers and run ``chunks`` chunks of ``chunk`` idle ticks.

    Chunk 0 is the warmup (it builds the tick program); every later chunk
    is timed on the host clock up to a device sync, inside a
    ``compile_counter``. ``on_chunk(c, state)`` sees the state after each
    chunk. Returns the warmup seconds, the steady chunks' seconds,
    ``compiles_steady`` and the curve."""
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.sparseplane import (
        init_sparse_state,
        simulate_sparse,
        sparse_idle_inputs,
    )

    cfg = bench_cfg()
    st = init_sparse_state(n, spec, seed=seed, device=device)
    inp = sparse_idle_inputs(n, ticks=chunk, device=device)
    curve, times, warmup_s, compiles_steady = [], [], None, 0
    for c in range(chunks):
        t0 = time.perf_counter()
        with compile_counter() as box:
            st, m = simulate_sparse(st, inp, cfg, spec, device=device)
            sync(st.device)
        dt = time.perf_counter() - t0
        if c == 0:
            warmup_s = dt
        else:
            compiles_steady += box.count
            times.append(dt)
        curve.append({
            "tick": int(st.tick),
            "block_fill": float(m.block_fill[-1]),
            "mean_membership": float(m.mean_membership[-1]),
        })
        if on_chunk is not None:
            on_chunk(c, st)
        print(f"sparse-bench: tick {curve[-1]['tick']:4d} "
              f"fill={curve[-1]['block_fill']:.3f} ({dt:.3f}s)", flush=True)
    return {"warmup_s": warmup_s, "steady_chunk_s": times,
            "compiles_steady": compiles_steady, "curve": curve}


def tick_peak_bytes(spec, n: int, device) -> int:
    """Peak device bytes of one steady tick at ``n`` (its state included),
    over what was allocated before the state was made."""
    from kaboodle_tpu_torch.sparseplane import (
        init_sparse_state,
        simulate_sparse,
        sparse_idle_inputs,
    )

    cfg = bench_cfg()
    sync(device)
    base = torch.cuda.memory_allocated(device)
    st = init_sparse_state(n, spec, seed=0, device=device)
    idle = sparse_idle_inputs(n, ticks=1, device=device)
    st, _ = simulate_sparse(st, idle, cfg, spec, device=device)  # past the boot tick
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    st, _ = simulate_sparse(st, idle, cfg, spec, device=device)
    sync(device)
    return torch.cuda.max_memory_allocated(device) - base


def sub_quadratic(spec, device) -> dict:
    if device.type != "cuda":
        return {"peak_bytes_n1024": None, "peak_bytes_n8192": None, "ratio_8x_n": None,
                "dense_ratio_would_be": 64.0,
                "reason": "peak device memory is read from the CUDA allocator; "
                          "this run is on the CPU"}
    small, big = (tick_peak_bytes(spec, n, device) for n in PEAK_NS)
    return {"peak_bytes_n1024": small, "peak_bytes_n8192": big,
            "ratio_8x_n": big / max(small, 1), "dense_ratio_would_be": 64.0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kaboodle_tpu_torch.sparseplane.bench",
        description="million-peer blocked_topk bench; writes torch_sparse.json",
    )
    p.add_argument("--n", type=int, default=1 << 20,
                   help="mesh size (default: 2^20 = 1,048,576 peers)")
    p.add_argument("--k", type=int, default=16, help="block width K")
    p.add_argument("--boot", type=int, default=3, help="boot ring contacts")
    p.add_argument("--ticks", type=int, default=24,
                   help="total ticks from boot (run in chunks)")
    p.add_argument("--chunk", type=int, default=8, help="ticks a chunk")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="torch_sparse.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p


def main(argv=None) -> int:
    from kaboodle_tpu_torch.analysis.ir.surface import assert_counter_live
    from kaboodle_tpu_torch.sim.state import resolve_device
    from kaboodle_tpu_torch.sparseplane import SparseSpec

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    assert_counter_live()
    spec = SparseSpec(k=args.k, gossip_fanout=4, boot_contacts=args.boot)
    n, chunk = args.n, args.chunk
    chunks = max(args.ticks // chunk, 2)

    print(f"sparse-bench: boot n={n} k={spec.k} ({chunks}x{chunk} ticks) on {dev}")
    run = run_boot(n, spec, chunk, chunks, args.seed, dev)
    s_per_tick = sum(run["steady_chunk_s"]) / (len(run["steady_chunk_s"]) * chunk)
    record = {
        "metric": "sparse_bench",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n": n, "k": spec.k, "boot_contacts": args.boot,
        "ticks": chunks * chunk, "chunk": chunk, "seed": args.seed,
        "warmup_s": run["warmup_s"],
        "s_per_tick": s_per_tick,
        "ns_per_peer_tick": 1e9 * s_per_tick / n,
        "compiles_steady": run["compiles_steady"],
        "curve": run["curve"],
        "sub_quadratic": sub_quadratic(spec, dev),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    ratio = record["sub_quadratic"]["ratio_8x_n"]
    print(f"sparse-bench: {s_per_tick * 1e3:.3f} ms/tick "
          f"({record['ns_per_peer_tick']:.3f} ns/peer), "
          f"compiles_steady={run['compiles_steady']}, "
          f"peak ratio {ratio if ratio is None else f'{ratio:.2f}x'} -> {args.out}")
    return 0 if run["compiles_steady"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
