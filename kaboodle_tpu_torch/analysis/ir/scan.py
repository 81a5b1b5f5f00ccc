"""The graftscan driver: trace the registry, run the passes, gate the debt.

The port of ``kaboodle_tpu/analysis/ir/scan.py``. :func:`run_scan` traces
each selected entry of ``registry.py`` once (``walk.py::trace_entry``: its
three recorded runs), runs KB401-KB404 on that trace, adds KB405 from the
compile-surface exercise (``surface.py``), and returns every finding
*before* baseline filtering, so the CLI applies the same
baseline/no-growth plumbing the AST lane uses. One trace feeds both traced
lanes: :func:`trace_registry` also builds each entry's key-provenance
graph for the rng lane (``analysis/rng/``).

The one-device entries run in this process on ``device`` (the card unless
``"cpu"``). The sharded entries need a process group: on the CPU they run
in one gloo job of ``world`` ranks (``parallel/worker.py``'s ``analysis``
case, as costscope's records do), findings united over the ranks; on the
card, or when this process already has a group, they run here on the
process's group (on the card a one-rank NCCL group, ``parallel.make_mesh``,
as the smoke's ``costscope`` phase does).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from kaboodle_tpu_torch.analysis.core import Finding

MESH_DEVICES = 8  # the IR lane's gloo job (costscope's)
RNG_WORLD = 1  # the rng lane's: the JAX report's sharded fleet is E = 4 on <= 4 devices


@dataclasses.dataclass
class EntryResult:
    """One entry's trace, read: IR findings, host syncs per call, graph."""

    findings: list
    syncs: int
    graph: object = None
    counts: dict = dataclasses.field(default_factory=dict)  # KB402 key -> syncs per run


@dataclasses.dataclass
class ScanResult:
    findings: list[Finding]
    surface_measured: dict[str, int]
    entries_scanned: int
    syncs: dict = dataclasses.field(default_factory=dict)  # entry -> KB402 syncs per call
    counts: dict = dataclasses.field(default_factory=dict)  # KB402 key -> syncs per run


def read_entry(entry, device=None, rng: bool = True) -> EntryResult:
    """Trace one entry and read it: KB401-KB404 and, with ``rng``, its graph."""
    from kaboodle_tpu_torch.analysis.ir.passes import PASSES, sync_count, sync_counts
    from kaboodle_tpu_torch.analysis.ir.walk import trace_entry

    traces = trace_entry(entry, device, rng=rng)
    findings = [f for p in PASSES for f in p(entry, traces)]
    graph = None
    if rng:
        from kaboodle_tpu_torch.analysis.rng.provenance import build_graph

        graph = build_graph(entry.name, [t.rng for t in traces])
    return EntryResult(findings, sync_count(traces), graph, sync_counts(entry, traces))


def _run_job(names: list[str], world: int, rng: bool, timeout_s: float = 300.0) -> dict:
    """Sharded entries in one gloo job of ``world`` ranks: ``{name:
    EntryResult}`` with the findings of every rank, rank 0's counts and graph."""
    import tempfile
    from pathlib import Path

    from kaboodle_tpu_torch.analysis.rng.provenance import graph_from_dict
    from kaboodle_tpu_torch.parallel.worker import start_workers

    with tempfile.TemporaryDirectory() as tmp:
        case = {"name": "analysis", "kind": "analysis", "entries": list(names), "rng": rng}
        spec = {"device": "cpu", "timeout_s": timeout_s, "cases": [case]}
        digests = start_workers(world, spec, str(Path(tmp) / "cases.json"),
                                timeout_s=timeout_s).wait()["analysis"]
    out = {}
    for name in names:
        findings: dict[str, Finding] = {}
        for d in digests:
            for f in d["entries"][name]["findings"]:
                findings.setdefault(Finding(**f).key, Finding(**f))
        first = digests[0]["entries"][name]
        graph = graph_from_dict(first["graph"]) if first["graph"] else None
        counts = {k: tuple(v) for k, v in first["counts"].items()}
        out[name] = EntryResult(list(findings.values()), first["syncs"], graph, counts)
    return out


def trace_registry(entries, device=None, ir_world: int = MESH_DEVICES,
                   rng_world: int = RNG_WORLD, rng: bool = True, progress=None) -> dict:
    """``{entry name: EntryResult}`` over ``entries``: the IR findings of the
    sharded ones from a job of ``ir_world`` ranks, their graphs from one of
    ``rng_world`` (module docstring); on the card, or in a process that
    has a group, every entry runs here."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    had_group = dist.is_initialized()
    jobs = dev.type == "cpu" and not had_group
    out = {}
    for e in entries:
        if e.sharded and jobs:
            continue
        if progress:
            progress(f"graftscan: tracing {e.name}")
        out[e.name] = read_entry(e, dev, rng=rng)
    if not had_group and dist.is_initialized():  # the sharded builders made one here
        dist.destroy_process_group()
    sharded = [e.name for e in entries if e.sharded]
    if sharded and jobs:
        if progress:
            progress(f"graftscan: tracing {len(sharded)} sharded entries over gloo")
        if rng and ir_world == rng_world:  # one job reads both lanes
            ir = graphs = _run_job(sharded, ir_world, rng=True)
        else:
            ir = _run_job(sharded, ir_world, rng=False)
            graphs = _run_job(sharded, rng_world, rng=True) if rng else {}
        for name in sharded:
            g = graphs[name].graph if rng else None
            out[name] = EntryResult(ir[name].findings, ir[name].syncs, g, ir[name].counts)
    return {e.name: out[e.name] for e in entries}


def run_scan(
    entry_names: Sequence[str] | None = None,
    entries=None,
    device=None,
    with_surface: bool = True,
    progress=None,
    results: dict | None = None,
) -> ScanResult:
    """Trace and audit the registry (or injected ``entries``), then measure
    the compile surface. ``results`` (a :func:`trace_registry` dict) reuses
    traces already made. ``progress(msg)`` gets one line per phase."""
    from kaboodle_tpu_torch.analysis.ir.registry import select_entries

    chosen = entries if entries is not None else select_entries(entry_names)
    if results is None:
        results = trace_registry(chosen, device, rng=False, progress=progress)
    findings = [f for e in chosen for f in results[e.name].findings]
    measured: dict[str, int] = {}
    if with_surface:
        from kaboodle_tpu_torch.analysis.ir import surface as surface_mod

        if progress:
            progress("graftscan: measuring compile surface (dense+warp+fleet+serve+sparse)")
        measured = surface_mod.measure_surface(device=device)
    findings.sort(key=lambda f: (f.path, f.rule, f.symbol))
    return ScanResult(findings, measured, len(chosen),
                      {e.name: results[e.name].syncs for e in chosen},
                      {k: v for e in chosen for k, v in results[e.name].counts.items()})
