"""Committed cost baseline + graftlint-style shrink-only gating.

The port of ``kaboodle_tpu/costscope/baseline.py``, whole: the schema, the
gated fields, their tolerance and floor, and the gate. The port's baseline
is a file of its own, ``kaboodle_tpu_torch/costscope/baseline.json``
(beside this module, whatever the working directory), holding the
per-entry static records of the port's full registry.  Gate semantics
mirror `analysis/cli.py`:

- an entry measured but absent from the baseline fails (the surface can
  only grow through an explicit `--write-baseline` commit);
- a gated field growing past tolerance fails — the CI regression gate on
  bytes-per-dispatch / peak-HBM / ICI bytes;
- under `--no-baseline-growth`, stale baseline entries (no longer in the
  registry) and significant shrinks also fail: improvements must be
  banked, so the baseline only ever ratchets down.

Tolerance absorbs jitter across PyTorch releases (an op decomposed one
way or another); the gate is for shape-class regressions (a doubled dtype
is +100%, far outside the band).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

DEFAULT_BASELINE = str(Path(__file__).resolve().with_name("baseline.json"))
BASELINE_SCHEMA = "kaboodle-costscope/1"

# Fields the gate watches, each with (relative tolerance, absolute floor
# in bytes) — small entries wobble more in relative terms.
GATED_FIELDS: dict[str, tuple[float, int]] = {
    "bytes_accessed": (0.05, 4096),
    "peak_bytes": (0.05, 4096),
    "ici_bytes": (0.05, 1024),
}


def load_baseline(path: str | Path) -> dict[str, Any] | None:
    """Load a baseline file; None if absent; ValueError on bad schema."""
    p = Path(path)
    if not p.exists():
        return None
    data = json.loads(p.read_text())
    if not isinstance(data, dict) or data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{p}: not a {BASELINE_SCHEMA} baseline")
    entries = data.get("entries")
    if not isinstance(entries, dict):
        raise ValueError(f"{p}: missing 'entries' map")
    return data


def write_baseline(path: str | Path, measured: dict[str, dict[str, Any]]) -> None:
    payload = {"schema": BASELINE_SCHEMA, "entries": measured}
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


def _out_of_band(new: int, old: int, rel: float, floor: int) -> bool:
    return abs(new - old) > max(rel * max(old, 1), floor)


def gate_measurements(
    measured: dict[str, dict[str, Any]],
    baseline: dict[str, Any] | None,
    *,
    no_growth: bool = False,
    subset: bool = False,
) -> list[str]:
    """Compare measured records against the baseline; return failures.

    `subset` marks a `--entry`-filtered run: stale-entry checking is
    skipped because the live set is deliberately partial.
    """
    failures: list[str] = []
    if baseline is None:
        for name in sorted(measured):
            failures.append(
                f"{name}: no baseline — run with --write-baseline and commit "
                f"{DEFAULT_BASELINE}"
            )
        return failures
    base_entries = baseline["entries"]
    for name in sorted(measured):
        rec = measured[name]
        base = base_entries.get(name)
        if base is None:
            failures.append(
                f"{name}: entry not in baseline (new surface — bank it with "
                "--write-baseline)"
            )
            continue
        for field, (rel, floor) in GATED_FIELDS.items():
            new = int(rec.get(field, 0))
            old = int(base.get(field, 0))
            if not _out_of_band(new, old, rel, floor):
                continue
            if new > old:
                failures.append(
                    f"{name}: {field} grew {old} -> {new} "
                    f"({100.0 * (new - old) / max(old, 1):+.1f}%) — compiler-plane "
                    "regression; fix it or re-bank deliberately"
                )
            elif no_growth:
                failures.append(
                    f"{name}: {field} shrank {old} -> {new} — improvement must be "
                    "banked (--write-baseline) so the gate ratchets down"
                )
    if no_growth and not subset:
        live = set(measured)
        for name in sorted(set(base_entries) - live):
            failures.append(
                f"{name}: stale baseline entry (not in registry) — delete it via "
                "--write-baseline"
            )
    return failures
