"""Roofline report: static bytes against the card's floors, no card needed.

The port of ``kaboodle_tpu/costscope/roofline.py``. It places each entry
of the committed baseline (trace-scale static bytes / flops / bytes to
other ranks, ``costscope/baseline.json``) against the floors of the card
the port runs on, an NVIDIA H100 80GB HBM3 at 700.00 W:

- HBM floor: the data sheet's 3.35 TB/s (the rate PERF.md's kernel table
  divides by): static bytes / rate is the time a dispatch cannot beat;
- link floors: the topology of a multi-card machine is unknown, so the
  report quotes each sharded entry's floor at two bookends, NVLink 4 at
  450 GB/s a direction and PCIe Gen 5 x16 at 64 GB/s a direction (data
  sheet figures, until a world > 1 ``--icibench`` run measures one).

It reads no ``BENCH_*.json`` (those hold the JAX package's TPU and CPU
numbers). Walls come only from ``--walls PATH``: a JSON-lines file, one
line per measured run with the port's ``--sim`` keys ``n_peers``,
``ticks`` and ``wall_s`` and a ``backend`` naming the card (its name and
power limit); a line without ``backend`` is refused. Each wall is placed
against the ``tick.faulty`` entries' HBM floor with the static bytes
scaled by ``(n_peers / TRACE_N)^2`` (the dominant traffic is the
``[N, N]`` state sweeps), as in the JAX report.
"""

from __future__ import annotations

import json
from typing import Any

# NVIDIA H100 80GB HBM3 (SXM, 700 W): HBM3 at 3.35 TB/s (data sheet).
H100_HBM_GBPS = 3350.0
# Link bookends for the H100, a direction: NVLink 4 (450 GB/s) and PCIe
# Gen 5 x16 (64 GB/s); unmeasured on the port until a world > 1 icibench.
H100_LINK_GBPS_BOOKENDS = {"nvlink4": 450.0, "pcie5x16": 64.0}
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

WALL_KEYS = ("n_peers", "ticks", "wall_s", "backend")


def load_walls(path: str) -> list[dict[str, Any]]:
    """Per-tick walls from a ``--walls`` JSON-lines file (module
    docstring). Raises ``ValueError`` on a line that lacks a key, a
    ``backend`` above all, or whose numbers are not positive."""
    walls: list[dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            rec = json.loads(line)
            missing = [k for k in WALL_KEYS if k not in rec]
            if missing:
                raise ValueError(f"{path}:{i}: wall line lacks {missing}")
            if not isinstance(rec["backend"], str) or not rec["backend"]:
                raise ValueError(f"{path}:{i}: 'backend' must name the card")
            n, ticks, wall = int(rec["n_peers"]), int(rec["ticks"]), float(rec["wall_s"])
            if n <= 0 or ticks <= 0 or wall <= 0:
                raise ValueError(f"{path}:{i}: n_peers, ticks and wall_s must be > 0")
            walls.append({"source": rec.get("source", path), "backend": rec["backend"],
                          "n_peers": n, "ticks": ticks, "s_per_tick": wall / ticks})
    return walls


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"


def build_report(
    entries: dict[str, dict[str, Any]],
    walls: list[dict[str, Any]],
    trace_n: int,
) -> dict[str, Any]:
    """Assemble the roofline structure from static records + given walls."""
    rows = []
    for name in sorted(entries):
        rec = entries[name]
        bytes_accessed = int(rec.get("bytes_accessed", 0))
        flops = int(rec.get("flops", 0))
        ici = int(rec.get("ici_bytes", 0))
        row: dict[str, Any] = {
            "entry": name,
            "flops": flops,
            "bytes_accessed": bytes_accessed,
            "peak_bytes": int(rec.get("peak_bytes", 0)),
            "ici_bytes": ici,
            "sharded": bool(rec.get("sharded", False)),
            "intensity_flops_per_byte": (
                round(flops / bytes_accessed, 4) if bytes_accessed else 0.0
            ),
            "hbm_floor_us": round(bytes_accessed / H100_HBM_GBPS / 1e3, 6),
        }
        if ici:
            row["link_floor_us"] = {
                k: round(ici / b / 1e3, 6) for k, b in H100_LINK_GBPS_BOOKENDS.items()
            }
        rows.append(row)

    placements = []
    tick_entries = [r for r in rows if r["entry"].endswith("tick.faulty")]
    for wall in walls:
        for r in tick_entries:
            scale = (wall["n_peers"] / trace_n) ** 2
            floor_s = r["bytes_accessed"] * scale / (H100_HBM_GBPS * 1e9)
            placements.append(
                {
                    "entry": r["entry"],
                    "source": wall["source"],
                    "backend": wall["backend"],
                    "n_peers": wall["n_peers"],
                    "wall_s_per_tick": wall["s_per_tick"],
                    "hbm_floor_s_per_tick": floor_s,
                    "wall_over_floor": (
                        round(wall["s_per_tick"] / floor_s, 2) if floor_s > 0 else None
                    ),
                }
            )
    return {
        "schema": "kaboodle-costscope-roofline/1",
        "trace_n": trace_n,
        "card": CARD,
        "hbm_gbps": H100_HBM_GBPS,
        "link_gbps_bookends": dict(H100_LINK_GBPS_BOOKENDS),
        "entries": rows,
        "walls": walls,
        "placements": placements,
    }


def render_report(report: dict[str, Any]) -> str:
    """Human table: the per-entry static plane, then the placements."""
    links = ", ".join(f"{k} {v:.0f}" for k, v in report["link_gbps_bookends"].items())
    lines = [
        f"costscope roofline -- trace N={report['trace_n']}, {report['card']}: "
        f"HBM {report['hbm_gbps']:.0f} GB/s, link bookends {links} GB/s",
        "",
        f"{'entry':<34} {'flops':>12} {'bytes':>12} {'peak':>12} "
        f"{'ICI':>10} {'fl/B':>7} {'HBMfloor':>10}",
    ]
    for r in report["entries"]:
        lines.append(
            f"{r['entry']:<34} {r['flops']:>12} "
            f"{_fmt_bytes(r['bytes_accessed']):>12} "
            f"{_fmt_bytes(r['peak_bytes']):>12} "
            f"{_fmt_bytes(r['ici_bytes']):>10} "
            f"{r['intensity_flops_per_byte']:>7.3f} "
            f"{r['hbm_floor_us']:>8.3f}us"
        )
    if report["placements"]:
        lines += ["", "walls vs HBM floor (bytes scaled (N/traceN)^2):"]
        for p in report["placements"]:
            ratio = p["wall_over_floor"]
            lines.append(
                f"  {p['entry']}  {p['backend']}  N={p['n_peers']}  "
                f"wall {p['wall_s_per_tick'] * 1e3:.6f} ms/tick  "
                f"floor {p['hbm_floor_s_per_tick'] * 1e3:.6f} ms  "
                f"wall/floor {ratio if ratio is not None else 'n/a'}"
            )
    elif not report["walls"]:
        lines += ["", "no --walls given -- static plane only"]
    sharded = [r for r in report["entries"] if r["sharded"]]
    if sharded:
        lines += ["", "per-collective link floors (sharded entries):"]
        for r in sharded:
            floors = r.get("link_floor_us")
            if floors:
                body = ", ".join(f"{k}: {v}us" for k, v in floors.items())
                lines.append(f"  {r['entry']:<34} {body}")
    return "\n".join(lines)


def roofline_from_baseline(
    baseline: dict[str, Any], walls: list[dict[str, Any]] | None = None
) -> dict[str, Any]:
    from kaboodle_tpu_torch.analysis.ir.registry import TRACE_N

    return build_report(baseline["entries"], walls or [], trace_n=TRACE_N)
