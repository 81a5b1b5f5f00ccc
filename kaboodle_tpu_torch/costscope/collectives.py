"""Collective-bytes audit: the bytes each entry sends to other ranks.

The port of ``kaboodle_tpu/costscope/collectives.py``. The JAX module
parses the collectives XLA's partitioner put into the compiled HLO; in the
port the collectives are the port's own code (``parallel/collectives.py``)
and there is no HLO, so ``parse_collectives`` has no counterpart. Instead
every ``dist`` call of that module is logged while
``record_collectives()`` is open, under HLO's kind names, so the port's
records and the JAX package's read alike:

- ``all-gather`` (``gather_rows``; ``gather_many`` and the cell fetch go
  through it), ``all-reduce`` (``_all_reduce``: the gates, the reductions,
  the scatters' min/max), ``all-to-all`` (``transpose``), and
  ``collective-permute`` for a ring step (``ring``: an
  ``all_to_all_single`` with one non-empty send split).

``ici_bytes`` keeps its schema key and means the bytes this rank sends to
other ranks, counted on the wire (after ``_wire``; R = the result's bytes
on this rank, D = the group's ranks):

- all-reduce:          ``2 * R * (D - 1) / D`` (the ring formula, copied)
- all-gather:          ``R * (D - 1) / D``     (R is the gathered size)
- all-to-all:          the send splits that go to other ranks, exactly
- collective-permute:  the send split, exactly (the whole block)

Counts are per call of the entry (one tick, one leap), the unit PERF.md
reasons in. A one-rank group sends nothing: 0 bytes.
"""

from __future__ import annotations

from typing import Any

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def _ici_bytes(kind: str, result_bytes: int, d: int) -> int:
    if d <= 1:
        return 0
    if kind == "all-reduce":
        return int(2 * result_bytes * (d - 1) / d)
    if kind == "all-gather":
        return int(result_bytes * (d - 1) / d)
    if kind == "reduce-scatter":
        return int(result_bytes * (d - 1))
    if kind == "all-to-all":
        return int(result_bytes * (d - 1) / d)
    return int(result_bytes)  # collective-permute: the whole buffer moves


def row_ici_bytes(row: dict[str, Any]) -> int:
    """One logged call's bytes to other ranks (module docstring)."""
    if row["group_size"] <= 1:
        return 0
    if row.get("sent_bytes") is not None:
        return int(row["sent_bytes"])
    return _ici_bytes(row["kind"], row["result_bytes"], row["group_size"])


def collective_audit(log: list[dict[str, Any]]) -> dict[str, Any]:
    """Audit one entry's logged calls: per-kind counts + total ICI bytes."""
    counts: dict[str, dict[str, int]] = {}
    total = 0
    for row in log:
        ici = row_ici_bytes(row)
        agg = counts.setdefault(row["kind"], {"count": 0, "result_bytes": 0, "ici_bytes": 0})
        agg["count"] += 1
        agg["result_bytes"] += int(row["result_bytes"])
        agg["ici_bytes"] += ici
        total += ici
    return {"ici_bytes": total, "counts": counts}
