"""The port's load driver, chaos lane and observability lane on the CPU.

``serve/loadgen.py``'s helpers equal the JAX driver's; its three modes,
from its own command line (``--device cpu``), run at n = 16 with 4 lanes
and report the keys of the JAX package's ``BENCH_serve*.json`` with
nothing built in the steady phases. The chaos scenarios run one by one
(``spill_latency``'s 10 % wall-clock bar is held on the card only: a
loaded CPU worker makes it unsteady), and the observability lane's three
phases run in turn. Everything that opens a socket runs under
``asyncio.wait_for``.
"""

import asyncio
import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from kaboodle_tpu.serve import loadgen as jloadgen
from kaboodle_tpu_torch.serve import chaos, loadgen, obsdryrun

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mix_and_latency_stats_equal_jax():
    assert [loadgen._mix_fields(i) for i in range(64)] == [
        jloadgen._mix_fields(i) for i in range(64)]
    lat = [0.5, 0.013, 0.2, 1.75, 0.0031, 0.9, 0.25]
    for k in range(1, len(lat) + 1):
        assert loadgen._latency_stats(lat[:k]) == jloadgen._latency_stats(lat[:k])


def _key_tree(x):
    """A report's shape: nested dict keys, leaves by JSON kind (None, a
    number and a bool count apart; int and float alike)."""
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return type(x).__name__
    return "number" if isinstance(x, (int, float)) else type(x).__name__


@pytest.mark.parametrize("mode,bench", [
    ("default", "BENCH_serve.json"),
    ("--overload", "BENCH_serve_overload.json"),
    ("--slo", "BENCH_serve_slo.json"),
])
def test_loadgen_modes_report_the_jax_keys(tmp_path, mode, bench):
    argv = ["--device", CPU, "--n", "16", "--lanes", "4", "--requests", "6",
            "--concurrency", "3", "--rate", "40", "--out", str(tmp_path / "report.json")]
    args = loadgen.parse_args(argv + ([] if mode == "default" else [mode]))
    report = asyncio.run(asyncio.wait_for(loadgen.run_mode(args), TIMEOUT_S))
    assert report["compiles_steady"] == 0
    want = json.loads((ROOT / bench).read_text())
    assert _key_tree(report) == _key_tree(want)
    if mode == "--slo":
        assert Path(report["trace"]).exists() and Path(report["manifest"]).exists()


@pytest.mark.parametrize("name", ["engine_kill", "spill_write_failure", "corrupt_restore",
                                  "slow_consumer", "submit_flood"])
def test_chaos_scenario_on_cpu(name):
    """Each scenario asserts its own invariant and raises on a breach; the
    two that open sockets run under a timeout."""
    if name in ("slow_consumer", "submit_flood"):
        exercise = getattr(chaos, f"_{name}_exercise")(device=CPU)
        report = asyncio.run(asyncio.wait_for(exercise, TIMEOUT_S))
    else:
        report = getattr(chaos, f"scenario_{name}")(device=CPU)
    assert isinstance(report, dict) and report
    if name == "engine_kill":
        assert report["bit_exact"] and report["duplicate_completions"] == 0
    if name == "submit_flood":
        assert report["compiles_steady"] == 0 and report["queue_full_rejections"] > 0


def test_obs_dryrun_on_cpu(tmp_path):
    """``run_obs_dryrun``'s three phases, the traced lifecycle (the one
    that opens sockets) under a timeout."""
    report = {}
    (tmp_path / "journal").mkdir()
    manifest = asyncio.run(asyncio.wait_for(
        obsdryrun._traced_lifecycle(report, str(tmp_path), CPU), TIMEOUT_S))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):  # the summarizer's report lines
        obsdryrun._exporters(report, manifest, str(tmp_path))
    obsdryrun._ab_purity_and_overhead(report, CPU)
    assert report["compiles_lifecycle"] == 0 and report["compiles_steady_gauge"] == 0
    assert report["bitexact_ab"] and report["trace_events"] > 0
