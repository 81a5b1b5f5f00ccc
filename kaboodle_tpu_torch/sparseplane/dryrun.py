"""``python -m kaboodle_tpu_torch.sparseplane.dryrun`` -- the sparseplane CI lane.

The port of ``kaboodle_tpu/sparseplane/dryrun.py``, on the card unless
``--device`` names another. Two legs:

1. **Toy-N stat check** -- the blocked_topk engine against the port's dense
   runner on a matched-seed boot at n = 24 (k = 32 >= n - 1, so
   "converged" is the fingerprint-agreement predicate the dense runner
   tests): both arms must converge, the sparse convergence tick must sit
   in the calibrated band around the dense one, the converged steady tick
   must emit exactly the dense steady counter means (n pings, 2n
   delivered, agreement 1.0), and a warmed steady window must build no
   program (``compiles_steady`` 0).
2. **Capped million-peer smoke** -- boot N = 2^20 peers (or
   ``--smoke-n``), run a few real ticks, and report per-peer per-tick
   cost. ``--skip-smoke`` drops this leg.

Prints the JAX dryrun's lines and its JSON keys (plus ``device``); exits
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stat_check(seed: int, device=None) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import assert_counter_live, compile_counter
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim.runner import run_until_converged
    from kaboodle_tpu_torch.sim.state import init_state, resolve_device
    from kaboodle_tpu_torch.sparseplane import (
        SparseSpec,
        init_sparse_state,
        run_sparse_until_converged,
        simulate_sparse,
        sparse_idle_inputs,
    )

    dev = resolve_device(device)
    assert_counter_live()
    n, boot = 24, 2
    cfg = SwimConfig(join_broadcast_enabled=False)
    spec = SparseSpec(k=32, gossip_fanout=4, boot_contacts=boot)

    _, d, dconv = run_until_converged(
        init_state(n, seed=seed, ring_contacts=boot, device=dev), cfg, max_ticks=96)
    sst = init_sparse_state(n, spec, seed=seed, device=dev)
    fin, s, sconv = run_sparse_until_converged(sst, cfg, spec, max_ticks=96, device=dev)
    checks = {
        "dense_converged": dconv,
        "sparse_converged": sconv,
        # the calibrated band: empirically ~2.1x at gossip_fanout=4
        "band": dconv and sconv and d // 2 <= s <= 4 * d + 10,
    }

    # steady counter means from the converged mesh, zero drops
    idle = sparse_idle_inputs(n, ticks=8, device=dev)
    _, m = simulate_sparse(fin, idle, cfg, spec, device=dev)
    checks["steady_pings"] = bool((m.pings_sent == n).all())
    checks["steady_delivered"] = bool((m.messages_delivered == 2 * n).all())
    checks["steady_agreement"] = bool((m.agree_fraction == 1.0).all())

    # no program built re-running the warmed steady window
    with compile_counter() as box:
        simulate_sparse(fin, idle, cfg, spec, device=dev)
        sync(dev)
    checks["compiles_steady_zero"] = box.count == 0

    return {
        "n": n, "k": spec.k, "dense_ticks": d, "sparse_ticks": s,
        "compiles_steady": box.count, "checks": checks,
    }


def _smoke(n: int, ticks: int, seed: int, device=None) -> dict:
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sim.state import resolve_device
    from kaboodle_tpu_torch.sparseplane import (
        SparseSpec,
        init_sparse_state,
        simulate_sparse,
        sparse_idle_inputs,
    )

    dev = resolve_device(device)
    cfg = SwimConfig(join_broadcast_enabled=False)
    spec = SparseSpec(k=16, gossip_fanout=4, boot_contacts=3)
    st = init_sparse_state(n, spec, seed=seed, device=dev)
    inp = sparse_idle_inputs(n, ticks=ticks, device=dev)
    # one warm pass, then the timed pass
    st2, _ = simulate_sparse(st, inp, cfg, spec, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    st3, m = simulate_sparse(st2, inp, cfg, spec, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    return {
        "n": n, "k": spec.k, "ticks": ticks,
        "s_per_tick": dt / ticks,
        "ns_per_peer_tick": 1e9 * dt / ticks / n,
        "block_fill": float(m.block_fill[-1]),
        "advanced": int(st3.tick) == 2 * ticks,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kaboodle_tpu_torch.sparseplane.dryrun",
        description="sparseplane dryrun: toy-N stat check vs the dense "
                    "runner + capped million-peer smoke",
    )
    p.add_argument("--dryrun", action="store_true",
                   help="accepted for symmetry with the other CI lanes "
                        "(this tool IS the dryrun)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke-n", type=int, default=1 << 20,
                   help="smoke mesh size (default: 2^20 peers)")
    p.add_argument("--smoke-ticks", type=int, default=4,
                   help="timed smoke ticks after one warm pass")
    p.add_argument("--skip-smoke", action="store_true",
                   help="stat check only (fast local iteration)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p


def main(argv=None) -> int:
    from kaboodle_tpu_torch.sim.state import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    stat = _stat_check(args.seed, dev)
    ok = all(stat["checks"].values())
    for name, good in stat["checks"].items():
        print(f"sparse: {name:22s} {'ok' if good else 'FAIL'}")
    print(f"sparse: convergence dense={stat['dense_ticks']} "
          f"sparse={stat['sparse_ticks']} ticks")

    out = {"metric": "sparse_dryrun", "device": str(dev), "stat": stat}
    if not args.skip_smoke:
        smoke = _smoke(args.smoke_n, args.smoke_ticks, args.seed, dev)
        ok = ok and smoke["advanced"]
        out["smoke"] = smoke
        print(f"sparse: smoke n={smoke['n']} "
              f"{smoke['s_per_tick'] * 1e3:.0f} ms/tick "
              f"({smoke['ns_per_peer_tick']:.0f} ns/peer), "
              f"fill {smoke['block_fill']:.3f}")
    out["ok"] = ok
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
