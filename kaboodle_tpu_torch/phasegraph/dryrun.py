"""``python -m kaboodle_tpu_torch phasegraph`` -- every derived engine vs dense.

The port of ``kaboodle_tpu/phasegraph/dryrun.py``: each engine that
``phasegraph/derive.py`` builds from the one tick -- dense (full + fused
dispatch), standalone fused, chunked (row-blocked), sharded (each rank its
rows, over the job's ranks), fleet (the tick over
``[E, ...]`` leaves), warp leap, hybrid leap and the masked hybrid leap --
is built at toy N, runs real ticks, and its outputs are diffed bit for bit
(``profiling.state_equal``) against the dense tick:

- chunked: one faulty tick from the same state and inputs;
- sharded: the same faulty tick over ``parallel.make_mesh``'s ranks (a
  one-rank group in a plain process, R ranks under ``torchrun``), the
  ranks' rows gathered;
- fleet: member 0 of a fleet tick vs a standalone dense tick of the same
  member state (the full-program-only build vs the dispatched one);
- fused: one steady tick on a converged mesh vs the dispatched build (the
  dispatch predicate must route that tick to the same values);
- warp / hybrid: a k-tick leap vs k dense fault-free ticks on a quiescent
  mesh; hybrid_masked at ``k_m = k`` the same, and at ``k_m = 0`` the
  identity.

Any mismatch exits 1. It runs on the card unless ``--device`` names
another. A process group the dryrun made for its sharded arm is destroyed
before it returns. The ``plan full`` / ``plan fused`` lines come straight
from the planner, over the graph of the dryrun's faulty build.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

def plan_lines() -> list[str]:
    """The ``plan full`` / ``plan fused`` lines (the op/pass summary CI logs)
    for ``build_graph(SwimConfig(deterministic=True), faulty=True)``."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.phasegraph import build_graph, plan

    graph = build_graph(SwimConfig(deterministic=True), faulty=True)
    lines = []
    for mode in ("full", "fused"):
        prog = plan(graph, mode)
        lines.append(f"phasegraph: plan {mode}: {len(prog.passes)} passes, "
                     f"{len(prog.pruned)} pruned, ops={','.join(prog.op_names())}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kaboodle_tpu_torch phasegraph",
        description="build every derived engine at toy N, run one tick each, "
                    "diff against the dense tick",
    )
    p.add_argument("--n", type=int, default=32, help="toy mesh size")
    p.add_argument("--ensemble", type=int, default=4, help="fleet width E")
    p.add_argument("--leap", type=int, default=4, help="warp span length k")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run there)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet, member_state
    from kaboodle_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_inputs, shard_state
    from kaboodle_tpu_torch.phasegraph.derive import (
        make_chunked_tick,
        make_dense_tick,
        make_fleet_tick,
        make_fused_tick,
        make_sharded_tick,
        make_warp_leap,
    )
    from kaboodle_tpu_torch.profiling import state_equal
    from kaboodle_tpu_torch.sim.state import idle_inputs, init_state, resolve_device

    dev = resolve_device(args.device)
    n, e, k = args.n, args.ensemble, args.leap
    cfg = SwimConfig(deterministic=True)
    results: dict[str, bool] = {}

    for line in plan_lines():
        print(line)

    # dense (the reference arm) -- one faulty tick from a cold boot state.
    st = init_state(n, seed=0, device=dev)
    idle = idle_inputs(n, device=dev)
    dense = make_dense_tick(cfg, faulty=True)
    st_d, m_d = dense(st, idle)

    # chunked: same tick, row-blocked layout.
    st_c, m_c = make_chunked_tick(cfg, faulty=True, block=n // 2)(st, idle)
    results["chunked"] = state_equal(st_d, st_c) and state_equal(m_d, m_c)

    # sharded: same tick, each rank its rows, the cross-row reads collectives.
    own_group = not dist.is_initialized()
    mesh = make_mesh(device=args.device)
    st_s, m_s = make_sharded_tick(cfg, mesh, faulty=True)(shard_state(st, mesh),
                                                          shard_inputs(idle, mesh))
    results["sharded"] = state_equal(st_d, gather_state(st_s, mesh)) and state_equal(m_d, m_s)
    if own_group:
        dist.destroy_process_group()

    # fleet: member 0 of the fleet tick vs a standalone dense tick of the
    # same member state (the full-only build vs the dispatched one).
    fleet = init_fleet(n, e, device=dev)
    fm, _ = make_fleet_tick(cfg, faulty=True)(fleet.mesh, fleet_idle_inputs(n, e, device=dev))
    st_m0, _ = dense(member_state(fleet, 0), idle)
    results["fleet"] = state_equal(member_state(dataclasses.replace(fleet, mesh=fm), 0), st_m0)

    # fused: one steady tick on a converged mesh -- the standalone 2-pass
    # program must equal the dispatched build routing the same tick.
    conv = init_state(n, seed=1, ring_contacts=n - 1, announced=True, device=dev)
    st_f, m_f = make_fused_tick(cfg, faulty=True)(conv, idle)
    st_dd, m_dd = dense(conv, idle)
    results["fused"] = state_equal(st_dd, st_f) and state_equal(m_dd, m_f)

    # warp: a k-tick leap vs k dense fault-free ticks on the quiescent mesh.
    st_w = make_warp_leap(cfg, k)(conv)
    st_k = conv
    step = make_dense_tick(cfg, faulty=False)
    for _ in range(k):
        st_k, _ = step(st_k, idle)
    results["warp"] = state_equal(st_w, st_k)

    # hybrid: the near-quiescent span program. On a strictly quiescent
    # mesh it must degenerate bit-exactly to the same k dense ticks; the
    # masked build at k_m == k must agree too, and k_m == 0 is the identity.
    results["hybrid"] = state_equal(make_warp_leap(cfg, k, hybrid=True)(conv), st_k)
    masked = make_warp_leap(cfg, k, hybrid=True, masked=True)
    results["hybrid_masked"] = state_equal(
        masked(conv, torch.tensor(k, dtype=torch.int32, device=dev)), st_k
    ) and state_equal(masked(conv, torch.tensor(0, dtype=torch.int32, device=dev)), conv)

    ok = all(results.values())
    for name, good in results.items():
        print(f"phasegraph: {name:8s} vs dense: {'bit-exact' if good else 'MISMATCH'}")
    print(json.dumps({
        "metric": "phasegraph_dryrun",
        "n": n, "ensemble": e, "leap": k,
        "engines": {name: ("ok" if good else "mismatch")
                    for name, good in results.items()},
        "ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
