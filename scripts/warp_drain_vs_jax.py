#!/usr/bin/env python3
"""The port's warp against the JAX warp at BENCH_warp3.json's drain shape, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/warp_drain_vs_jax.py [--n 1024] [--ticks 8192]

The churn-recovery drain of ``chip_smoke.warp_drain_case`` (bench.py
``_bench_warp_churn_recovery``: 8 staggered kills at the tail of the churn
half, one early kill and revive, a suspicion timeout of a third of the
calm half), with the kernel flags off, through both packages on the CPU:
the churn half dense (JAX ``simulate`` under ``jit``, the port's
``simulate``), then the calm half through each package's
``simulate_warped`` with a ledger. Checks that the post-churn states, the
warped final states (every leaf bit for bit, ``latency`` NaN positions
included), the dense-tick indices and the per-class ledgers are equal, and
prints the walls, the dense-tick count and the why-dense histogram. The
port part takes ~8 min at the default shape. Needs both packages (the
repo's test environment).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=8192)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
    from kaboodle_tpu.sim import state as jstate
    from kaboodle_tpu.sim.runner import simulate as jax_simulate
    from kaboodle_tpu.warp import runner as jrunner
    from kaboodle_tpu_torch.sim import simulate
    from kaboodle_tpu_torch.sim.state import state_to_numpy
    from kaboodle_tpu_torch.warp import runner

    cfg, st, churn, calm = chip_smoke.warp_drain_case(args.n, args.ticks, device="cpu")
    cfg = dataclasses.replace(cfg, use_pallas_fp=False, use_pallas_oldest_k=False,
                              use_pallas_suspicion=False)
    jcfg = JaxSwimConfig(ping_timeout_ticks=cfg.ping_timeout_ticks)

    def to_jax(obj, cls):
        leaves = state_to_numpy(obj) if cls is jstate.MeshState else {
            f.name: None if getattr(obj, f.name) is None else getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}
        return cls(**{k: None if v is None else jnp.asarray(v) for k, v in leaves.items()})

    def same(want, got) -> list[str]:
        """The fields where the JAX state ``want`` and the port's ``got``
        differ, bit for bit (NaN == NaN in float leaves)."""
        bad = []
        for name, g in state_to_numpy(got).items():
            w = getattr(want, name)
            if (w is None) != (g is None):
                bad.append(name)
            elif w is not None and not np.array_equal(
                    np.asarray(w), g, equal_nan=np.issubdtype(g.dtype, np.floating)):
                bad.append(name)
        return bad

    out = {"n": args.n, "ticks": args.ticks, "ping_timeout_ticks": cfg.ping_timeout_ticks}
    t0 = time.perf_counter()
    jst_c = jax.jit(lambda s, i: jax_simulate(s, i, jcfg, faulty=True)[0])(
        to_jax(st, jstate.MeshState), to_jax(churn, jstate.TickInputs))
    jax.block_until_ready(jst_c)
    out["jax_churn_s"] = time.perf_counter() - t0
    jled = jrunner.WarpLedger()
    t0 = time.perf_counter()
    jw, jdt, _ = jrunner.simulate_warped(jst_c, to_jax(calm, jstate.TickInputs), jcfg,
                                         faulty=True, ledger=jled)
    jax.block_until_ready(jw)
    out["jax_warp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_c = simulate(st, churn, cfg, faulty=True)[0]
    out["port_churn_s"] = time.perf_counter() - t0
    led = runner.WarpLedger()
    t0 = time.perf_counter()
    w, dt, _ = runner.simulate_warped(st_c, calm, cfg, faulty=True, ledger=led)
    out["port_warp_s"] = time.perf_counter() - t0
    out.update(
        post_churn_differ=same(jst_c, st_c), warped_differ=same(jw, w),
        dense_ticks=int(dt.size), jax_dense_ticks=int(jdt.size),
        dense_ticks_equal=bool(np.array_equal(dt, jdt)),
        per_class_equal=led.per_class() == jled.per_class(),
        why_dense=led.blocked_histogram(),
    )
    print(json.dumps(out), flush=True)
    ok = (not out["post_churn_differ"] and not out["warped_differ"]
          and out["dense_ticks_equal"] and out["per_class_equal"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
