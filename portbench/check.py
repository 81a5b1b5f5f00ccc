"""How ``correct`` is decided: what a side produced, held to the reference.

The reference (the engine's ``Reference``, float32) follows the same mix from
the same seed after the window has closed: the boot behind a converged
start, one run (every run of a cell is the same run, so one reference run
answers all of them) as far as the program's furthest tick, and the mesh
at the window's end. Four numbers are compared, each against its limit in
the configuration's ``limits``:

- ``state_cells_differ``: cells of every plane and vector of the
  window-end mesh that differ (float planes bit for bit, NaN equal to NaN);
- ``run_summaries_differ``: fields of ``window.summary`` that differ, over
  every finished run and the converged start's boot;
- ``tick_metrics_differ``: integer metrics (messages delivered, the
  convergence flag, the fingerprint min and max) that differ over every
  tick the side ran, plus each boot's ticks to agreement and flag;
- ``float_metric_gap``: the largest relative gap of the float metrics
  (agree fraction, mean membership) over those ticks.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.program import fields
from portbench.window import FLOAT_METRICS, INT_METRICS, metrics_host, summary, to_host


@dataclasses.dataclass
class Followed:
    boot: dict | None = None
    tick_metrics: dict = dataclasses.field(default_factory=dict)  # field -> [ticks] host
    run_summary: dict | None = None  # a finished run's summary
    runs: list = dataclasses.field(default_factory=list)  # boot runs
    end_state: object = None


def follow(ref, produced, traffic: dict, sched, seed: int) -> Followed:
    """Run the reference over what ``produced`` covers."""
    out = Followed()
    start = None
    if traffic["start"] == "converged":
        st, ticks, conv, m0 = ref.boot(ref.fresh(seed))
        out.boot = {"ticks": ticks, "converged": conv, "summary": to_host(summary(st)),
                    "m0": None if m0 is None else to_host(fields(m0))}
        start = st
    if produced.mode == "run":
        st, ticks, conv, m0 = ref.boot(ref.fresh(seed))
        out.runs.append({"ticks": ticks, "converged": conv, "summary": to_host(summary(st)),
                         "m0": None if m0 is None else to_host(fields(m0))})
        out.end_state = st
        return out
    need = max([i + 1 for _, i in produced.tick_pos] + [produced.end_index])
    st = start if start is not None else ref.fresh(seed)
    start = None
    inputs = ref.inputs(sched)
    rows = []
    for i in range(need):
        st, m = ref.tick(st, inputs, i)
        rows.append(m)
        if i + 1 == produced.end_index:
            out.end_state = st
    if need == sched.ticks and produced.runs:
        out.run_summary = to_host(summary(st))
    out.tick_metrics = metrics_host(rows)
    return out


def _rel_tiny(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return float(((a64 - b64).abs() / b64.abs().clamp(min=1e-30)).max())


def _summary_diff(p: dict, r: dict) -> int:
    """Fields of two summaries that differ."""
    differ = len(set(p) ^ set(r))
    for k in set(p) & set(r):
        if p[k].shape != r[k].shape or not torch.equal(p[k], r[k]):
            differ += 1
    return differ


def _metrics_diff(p: dict, r: dict, idx: list) -> tuple[int, float, list]:
    """Integer metrics that differ, the largest float gap, and the ticks with
    an integer metric that differs."""
    if not idx:
        return 0, 0.0, []
    at = torch.tensor(idx, dtype=torch.long)
    bad = torch.zeros(len(idx), dtype=torch.bool)
    for k in INT_METRICS:
        bad |= p[k].to(torch.int64) != r[k][at].to(torch.int64)
    differ = int(sum(int((p[k].to(torch.int64) != r[k][at].to(torch.int64)).sum())
                     for k in INT_METRICS))
    gap = 0.0
    for k in FLOAT_METRICS:
        g = (p[k].to(torch.float64) - r[k][at].to(torch.float64)).abs() / r[k][at].to(
            torch.float64).abs().clamp(min=1e-30)
        gap = max(gap, float(g.max()))
    return differ, gap, bad.tolist()


def _state_diff(p, r, rows: int = 4096) -> int:
    """Cells of two meshes that differ (NaN equal to NaN), in row chunks."""
    pf, rf = fields(p), fields(r)
    differ = 0
    for name in sorted(set(pf) | set(rf)):
        a, b = pf.get(name), rf.get(name)
        if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
            differ += max(0 if a is None else a.numel(), 0 if b is None else b.numel())
            continue
        b = b.to(a.device)
        chunks = [(a, b)] if a.dim() < 2 else [
            (a[r0:r0 + rows], b[r0:r0 + rows]) for r0 in range(0, a.shape[0], rows)]
        for x, y in chunks:
            same = x == y
            if x.is_floating_point():
                same |= torch.isnan(x) & torch.isnan(y)
            differ += int((~same).sum())
    return differ


def compare(produced, followed: Followed) -> tuple[dict, list]:
    """The numbers compared, and per unit the side produced (ticks, or boot
    runs, in order) whether an exact output of it differs."""
    sums_differ, float_gap, ticks_differ = 0, 0.0, 0
    failed = []
    if produced.boot is not None:
        sums_differ += _summary_diff(produced.boot["summary"], followed.boot["summary"])
        ticks_differ += int(produced.boot["ticks"] != followed.boot["ticks"])
        ticks_differ += int(produced.boot["converged"] != followed.boot["converged"])
    if produced.mode == "run":
        want = followed.runs[0]
        for run in produced.runs:
            d = _summary_diff(run["summary"], want["summary"])
            t = int(run["ticks"] != want["ticks"]) + int(run["converged"] != want["converged"])
            if run["m0"] is not None:
                for k in INT_METRICS:
                    t += int(not torch.equal(run["m0"][k], want["m0"][k]))
                for k in FLOAT_METRICS:
                    float_gap = max(float_gap, _rel_tiny(run["m0"][k].reshape(1),
                                                         want["m0"][k].reshape(1)))
            sums_differ += d
            ticks_differ += t
            failed.append(bool(d or t or not run["converged"]))
    else:
        idx = [i for _, i in produced.tick_pos]
        d, float_gap, failed = _metrics_diff(produced.tick_metrics, followed.tick_metrics, idx)
        ticks_differ += d
        for run in produced.runs:
            sums_differ += (_summary_diff(run["summary"], followed.run_summary)
                            if followed.run_summary is not None else 1)
    numbers = {
        "state_cells_differ": _state_diff(produced.end_state, followed.end_state),
        "run_summaries_differ": sums_differ,
        "tick_metrics_differ": ticks_differ,
        "float_metric_gap": float_gap,
    }
    return numbers, failed


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}`` for the result line."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v <= limits[k] for k, v in numbers.items()), shown
