"""The port's trace writers and manifest summarizer against the JAX package's.

One tick manifest (a telemetry run of the port, with a leaped gap), one
serve manifest and its journal (a traced lifecycle of the port's engine)
are written once; both packages' writers then read the same files and
must give equal results: ``summarize`` / ``serve_report`` dicts equal,
the Chrome-trace events equal, and ``summary.main``'s printed output and
trace file byte for byte. The port's phase-program tables are pinned to
the JAX planner's ``describe()``.
"""

import contextlib
import io
import json

import pytest

from kaboodle_tpu.telemetry import summary as jsummary
from kaboodle_tpu.telemetry import trace as jtrace
from kaboodle_tpu_torch.telemetry import summary as tsummary
from kaboodle_tpu_torch.telemetry import trace as ttrace

CPU = "cpu"
MODES = ("fused", "full", "span", "blocked")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The shared inputs: a tick manifest, a serve manifest, its journal."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.sim import baseline_scenario, init_state, simulate_with_telemetry
    from kaboodle_tpu_torch.telemetry.counters import counters_table
    from kaboodle_tpu_torch.telemetry.manifest import ManifestWriter

    root = tmp_path_factory.mktemp("trace")
    cfg = SwimConfig(deterministic=True)
    sc = baseline_scenario(3, n=16, ticks=12, seed=1)
    _, metrics, counters, _ = simulate_with_telemetry(
        init_state(16, seed=2, alive=sc.initial_alive(), device=CPU), sc.build(CPU), cfg)
    table = counters_table(counters)
    ticks = str(root / "ticks.jsonl")
    with ManifestWriter(ticks) as w:
        w.write("run", metric="converge_ticks", value=12, unit="ticks", n_peers=16,
                ticks=12, backend="cpu", wall_s=0.5)
        for t in list(range(0, 5)) + list(range(9, 12)):  # ticks 5-8 leaped
            w.write("tick", **{k: int(table[k][t]) for k in table.dtype.names},
                    converged=bool(metrics.converged[t]))
    serve = str(root / "serve.jsonl")
    jdir = str(root / "journal")
    spill = root / "spill"
    spill.mkdir()
    clock = iter(range(0, 10**12, 997_003))  # a deterministic span clock
    from kaboodle_tpu_torch.serve.obsplane import ObsPlane

    with ManifestWriter(serve) as w:
        engine = ServeEngine(
            [LanePool(16, 2, cfg=cfg, chunk=8, device=CPU)], warp=True, max_leap=64,
            spill_after=1, spill_dir=str(spill), journal_dir=jdir,
            obs=ObsPlane(trace=True, clock_ns=lambda: next(clock)),
            on_event=w.write_record)
        engine.warmup()
        kept = engine.submit(ServeRequest(n=16, seed=9, mode="ticks", ticks=8,
                                          scenario="steady", keep=True))
        for i in range(4):
            engine.submit(ServeRequest(n=16, seed=i, mode="ticks" if i % 2 else "converge",
                                       ticks=40, scenario="steady" if i % 2 else "boot"))
        engine.drain()
        engine.settle_spills()
        assert engine.status(kept)["state"] == "spilled"
        assert engine.restore(kept)
        engine.resume(kept, mode="ticks", ticks=4)
        engine.drain()
        engine.close()
    return {"ticks": ticks, "serve": serve, "journal": jdir, "root": root}


@pytest.mark.parametrize("mode", MODES)
def test_phase_program_tables_equal_jax_planner(mode):
    from kaboodle_tpu.config import SwimConfig
    from kaboodle_tpu.phasegraph import build_graph, plan

    graph = build_graph(SwimConfig(deterministic=True), faulty=mode != "span", telemetry=True)
    assert tsummary.PHASE_PROGRAMS[mode] == plan(graph, mode).describe()


def test_summarize_and_serve_report_equal_jax(artifacts):
    paths = [artifacts["ticks"], artifacts["serve"]]
    records = tsummary.load_manifests(paths)
    assert records == jsummary.load_manifests(paths)
    assert tsummary.summarize(records) == jsummary.summarize(records)
    serve = records[artifacts["serve"]]
    report = tsummary.serve_report(serve)
    assert report == jsummary.serve_report(serve)
    assert report["requests"] and "spilled" in report["phases"]


def test_trace_events_equal_jax(artifacts):
    from kaboodle_tpu.serve.journal import read_journal_records as jread
    from kaboodle_tpu_torch.serve.journal import read_journal_records as tread

    recs = tsummary.load_manifests([artifacts["ticks"], artifacts["serve"]])
    rows = [r for r in recs[artifacts["ticks"]] if r["kind"] == "tick"]
    serve = recs[artifacts["serve"]]
    journal = tread(artifacts["journal"])
    assert journal == jread(artifacts["journal"])
    for fn, args in (("chrome_trace_events", (rows,)),
                     ("phase_slice_events", (tsummary.PHASE_PROGRAMS["fused"], rows)),
                     ("serve_trace_events", (serve,)),
                     ("journal_trace_events", (journal,))):
        got = getattr(ttrace, fn)(*args)
        assert got == getattr(jtrace, fn)(*args), fn
        assert got, fn
    names = [e["name"] for e in ttrace.chrome_trace_events(rows)]
    assert "leap" in names  # the gap at ticks 5-8


def _main(mod, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("program", MODES + ("off",))
def test_summary_main_trace_bytes_equal_jax(artifacts, program):
    """``--serve-report --trace --journal``: printed output and the trace
    file byte for byte (the program's pass slices and ``otherData``)."""
    root = artifacts["root"]
    out = {}
    for side, mod in (("jax", jsummary), ("torch", tsummary)):
        path = str(root / f"{side}-{program}.trace.json")
        rc, text = _main(mod, [artifacts["ticks"], artifacts["serve"], "--serve-report",
                               "--trace", path, "--phase-program", program,
                               "--journal", artifacts["journal"]])
        assert rc == 0
        with open(path, "rb") as f:
            out[side] = (text.replace(path, "OUT"), f.read())
    assert out["torch"] == out["jax"]
    doc = json.loads(out["torch"][1])
    procs = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"}
    assert "serve journal (WAL)" in procs


def test_summary_main_check(artifacts, tmp_path):
    """``--check``: 0 on a valid manifest, 1 on an empty one and on a bad
    record, in both packages alike."""
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"schema": "nope", "kind": "run"}) + "\n")
    for path, want in ((artifacts["ticks"], 0), (str(empty), 1), (str(bad), 1)):
        got = [_main(mod, [path, "--check"])[0] for mod in (jsummary, tsummary)]
        assert got == [want, want], path


def test_write_chrome_trace_single_run_equal_jax(artifacts, tmp_path):
    """One run's rows (not a mapping) with a program and metadata."""
    rows = [r for r in tsummary.load_manifests([artifacts["ticks"]])[artifacts["ticks"]]
            if r["kind"] == "tick"]
    blobs = []
    for mod in (jtrace, ttrace):
        path = tmp_path / f"{mod.__name__}.json"
        n = mod.write_chrome_trace(str(path), rows, metadata={"lane": "t"},
                                   program=tsummary.PHASE_PROGRAMS["span"])
        blobs.append((n, path.read_bytes()))
    assert blobs[0] == blobs[1]
