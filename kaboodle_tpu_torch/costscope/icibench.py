"""Collective microbench: the two collectives the row-sharded tick pays.

The port of ``kaboodle_tpu/costscope/icibench.py``. It times, standalone,
the port's own code for the two protocol collectives
(``parallel/collectives.py``):

1. ``agreement_all_reduce`` -- ``fingerprint_agreement``: each rank's
   min/max of its rows' fingerprints, all-reduced (with the alive count)
   into the global pair every tick checks. Checked as in JAX: on
   ``arange(n) + 7`` the pair is ``(7, n + 6)``.
2. ``union_ring`` -- ``ring_or_matmul``: the gossip union ``(A @ M) > 0``
   with ``M`` row-sharded, computed over a ring of ``M``'s row blocks
   (each step sends the whole block to the next rank). The JAX package's
   partitioner reduce-scatters partial unions instead; the port's is a
   ring, and the name says so. Checked against the dense ``(A @ M) > 0``.

``payload_bytes`` and ``ici_bytes_ring`` of the agreement are JAX's
attribution (the ``[N]`` uint32 min+max all-reduce pair over a ring), so
the two packages' sweeps read alike; ``wire_ici_bytes`` is what the port's
call sent to other ranks (``record_collectives``). For the union ring both
are the ring's exact sends, ``(D - 1)`` steps of a rank's ``[N/D, 64]``
bool block. Walls are whole-call walls (best of ``repeats``, the card
synchronised around each), so small sizes are dispatch-bound.

``--dryrun`` is the CPU sweep on a gloo group of 8 ranks with the checks
asserted; without it the sweep runs on the card over NCCL and banks
``MULTICHIP_nccl.json`` only at a world above one (one rank sends nothing
over a link: its walls are NCCL's dispatch walls).
"""

from __future__ import annotations

import json
import time
from typing import Any

import torch

from kaboodle_tpu_torch.costscope.collectives import _ici_bytes

DRYRUN_SIZES = (256, 1024)
HW_SIZES = (1 << 10, 1 << 12, 1 << 14, 1 << 16)
UNION_COLS = 64
UNION_DENSITY = 0.01
BANK_PATH = "MULTICHIP_nccl.json"
SCHEMA = "kaboodle-costscope-ici/1"


def _device(group) -> torch.device:
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _time_best(fn, repeats: int, dev: torch.device) -> float:
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _wire_bytes(fn) -> int:
    from kaboodle_tpu_torch.costscope.collectives import collective_audit
    from kaboodle_tpu_torch.parallel.collectives import record_collectives

    with record_collectives() as log:
        fn()
    return collective_audit(log)["ici_bytes"]


def run_sweep(
    sizes: tuple[int, ...],
    group,
    repeats: int = 3,
    check: bool = True,
) -> dict[str, Any]:
    """Time both collectives across ``sizes`` on ``group`` (every rank
    calls it with the same arguments); optionally assert correctness."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.ops import hashing
    from kaboodle_tpu_torch.parallel import collectives as C
    from kaboodle_tpu_torch.phasegraph.exec import _bool_matmul

    d, me = C.size(group), C.rank(group)
    dev = _device(group)
    results: list[dict[str, Any]] = []
    for n in sizes:
        n = max(n, d)
        n -= n % d  # shard-divisible
        row0, b = C.row_range(n, group)
        fp = (torch.arange(n, dtype=torch.int32, device=dev) + 7)[row0:row0 + b]
        alive = torch.ones((b,), dtype=torch.bool, device=dev)

        def agree():
            return C.fingerprint_agreement(alive, fp, group)

        _, lo, hi, _ = agree()
        if check:
            lo, hi = int(hashing.as_u32(lo)), int(hashing.as_u32(hi))
            assert lo == 7 and hi == n + 6, (lo, hi)
        fp_bytes = n * 4
        results.append(
            {
                "collective": "agreement_all_reduce",
                "n": int(n),
                "payload_bytes": fp_bytes,
                "ici_bytes_ring": 2 * _ici_bytes("all-reduce", fp_bytes, d),
                "wire_ici_bytes": _wire_bytes(agree),
                "wall_s_best": _time_best(agree, repeats, dev),
            }
        )

        rows = max(d, n // UNION_COLS)
        rows -= rows % d
        gen = torch.Generator().manual_seed(0)
        a_all = torch.rand((rows, rows), generator=gen) < UNION_DENSITY
        m_all = torch.rand((rows, UNION_COLS), generator=gen) < UNION_DENSITY
        r0, rb = C.row_range(rows, group)
        a = a_all[r0:r0 + rb].to(dev)
        m = m_all[r0:r0 + rb].contiguous().to(dev)

        def union():
            return C.ring_or_matmul(a, m, group, _bool_matmul)

        out = union()
        if check:
            want = (a_all[r0:r0 + rb].to(torch.int32) @ m_all.to(torch.int32)) > 0
            assert out.shape == (rb, UNION_COLS), out.shape
            assert torch.equal(out.cpu(), want), "union ring != dense (A @ M) > 0"
        block = rb * UNION_COLS  # bool bytes of one rank's block of M
        results.append(
            {
                "collective": "union_ring",
                "n": int(rows),
                "payload_bytes": rows * UNION_COLS,
                "ici_bytes_ring": (d - 1) * block,
                "wire_ici_bytes": _wire_bytes(union),
                "wall_s_best": _time_best(union, repeats, dev),
            }
        )
    for r in results:
        wall = r["wall_s_best"]
        r["gbps_ring"] = r["ici_bytes_ring"] / wall / 1e9 if wall and r["ici_bytes_ring"] else None
    return {
        "schema": SCHEMA,
        "backend": dist.get_backend(group),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": int(d),
        "rank": int(me),
        "repeats": int(repeats),
        "results": results,
    }


def bank(report: dict[str, Any], path: str = BANK_PATH) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")


def render(report: dict[str, Any]) -> str:
    lines = [
        f"icibench -- backend={report['backend']} device={report['device']} "
        f"ranks={report['n_devices']} (best of {report['repeats']})",
        f"{'collective':<22} {'n':>9} {'payload':>10} {'ring bytes':>11} {'wire bytes':>11} "
        f"{'wall':>12} {'ring GB/s':>10}",
    ]
    for r in report["results"]:
        gbps = r["gbps_ring"]
        lines.append(
            f"{r['collective']:<22} {r['n']:>9} {r['payload_bytes']:>10} "
            f"{r['ici_bytes_ring']:>11} {r['wire_ici_bytes']:>11} "
            f"{r['wall_s_best'] * 1e3:>10.6f}ms "
            f"{'n/a' if gbps is None else f'{gbps:.3f}':>10}"
        )
    if report["n_devices"] == 1:
        lines.append("one rank: nothing crosses a link (ring bytes 0); the walls are "
                     "the collectives' dispatch walls")
    return "\n".join(lines)
