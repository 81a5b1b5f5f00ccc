"""The port's compile-surface lane (KB405) and STREAM_* register (KB602).

KB405: the JAX package's gate semantics and budget-file cases
(tests/test_graftscan.py) on the port's ``analysis/ir/surface.py``, a
seeded mutation that grows a family (a spurious per-call cache key, after
the JAX package's spurious static argument), and ``python -m
kaboodle_tpu_torch.analysis --ir --device cpu`` in fresh processes (the
trace scoped to one cheap entry: KB401-KB404 have their own file) -- 0 on
the committed ``surface.json``, 1 with a leap cache keyed per call. KB602:
the JAX package's registry cases (tests/test_keyscope.py) on the port's
``analysis/rng/rules.py``, whose pinned table must equal the JAX lane's.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from kaboodle_tpu.analysis.rng import rules as jax_rng_rules
from kaboodle_tpu_torch.analysis import cli
from kaboodle_tpu_torch.analysis.core import BaselineError
from kaboodle_tpu_torch.analysis.ir import surface as ir_surface
from kaboodle_tpu_torch.analysis.rng import rules as rng_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"

# One process per run: the committed counts are a fresh process's.
_IR = "import sys\nfrom kaboodle_tpu_torch.analysis.cli import main\n"
# The mutation: the fleet leap keyed by a call counter, one program per call.
_MUTATED = """
import itertools
from kaboodle_tpu_torch.warp import runner
calls = itertools.count()
def mutated(cfg, K):
    return runner.leap_cache.get((cfg, "fleet", next(calls)), "hybrid", K,
                                 lambda: runner.make_warp_leap(cfg, K, hybrid=True, masked=True))
runner._get_fleet_leap = mutated
"""


def _ir_process(prelude: str):
    code = _IR + prelude + ("sys.exit(main(['--ir', '--device', 'cpu', "
                            "'--entries', 'ops.fused_fp']))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def ir_runs():
    """The lane on the committed budget and under the mutation, at once."""
    procs = {"clean": _ir_process(""), "mutated": _ir_process(_MUTATED)}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=240)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def test_ir_lane_clean_on_the_committed_budget(ir_runs):
    rc, stdout, stderr = ir_runs["clean"]
    assert rc == 0, (stdout, stderr)
    assert "KB405" in stderr and "0 findings" in stderr


def test_ir_lane_fails_on_a_per_call_cache_key(ir_runs):
    rc, stdout, stderr = ir_runs["mutated"]
    assert rc == 1, (stdout, stderr)
    assert "KB405 compile surface grew" in stdout and "ir://surface.serve" in stdout


def test_committed_budget_names_the_jax_families_with_reasons():
    committed = ir_surface.load_surface(REPO / ir_surface.DEFAULT_SURFACE)
    jax_names = [e["entry"] for e in json.loads(
        (REPO / ".graftscan_surface.json").read_text())["entries"]]
    assert sorted(committed) == sorted(jax_names)
    assert [ex.name for ex in ir_surface.EXERCISES] == ["dense", "warp", "fleet", "serve",
                                                        "sparse"]
    assert (ir_surface._EX_N, ir_surface._EX_E) == (32, 4)
    for name, (count, reason) in committed.items():
        assert count >= 0 and len(reason) > 40 and "TODO" not in reason, name
    # The families that dispatch through no program cache commit 0.
    assert committed["dense"][0] == 0 and committed["fleet"][0] == 0


def test_compile_counter_counts_fresh_builds_only():
    from kaboodle_tpu_torch.serve.pool import _reseed_program

    n = 1001  # odd: no pool's class, so a fresh program
    with ir_surface.compile_counter() as box:
        _reseed_program(n, "boot", ())
        _reseed_program(n, "boot", ())  # cache hit
    assert box.count == 1
    with ir_surface.compile_counter() as box2:
        _reseed_program(n, "boot", ())
    assert box2.count == 0
    ir_surface.assert_counter_live()


def test_mutation_spurious_cache_key_grows_a_family():
    """The JAX lane's seeded regression, in the port's terms: the masked
    fleet leap looked up with a per-call key builds one program per call,
    and the measured count exceeds the committed budget."""
    import torch

    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap
    from kaboodle_tpu_torch.warp.runner import leap_cache

    cfg = ir_surface._cfg()

    def prep(dev):
        return {"fleet": init_fleet(16, 2, ring_contacts=15, announced=True, device=dev),
                "dev": dev}

    def run(ctx):
        mesh = ctx["fleet"].mesh
        k_m = torch.zeros((2,), dtype=torch.int32, device=ctx["dev"])
        for i in range(5):  # the mutation: a call counter in the cache key
            leap = leap_cache.get((cfg, "fleet-mutated", i), "hybrid", 8,
                                  lambda: make_warp_leap(cfg, 8, hybrid=True, masked=True))
            mesh = leap(mesh, k_m)

    measured = ir_surface.measure_surface([ir_surface.SurfaceExercise("warp", prep, run)],
                                          device=CPU)
    assert measured["warp"] >= 5
    findings = ir_surface.surface_findings(measured, {"warp": (1, "one masked leap")})
    assert any(f.rule == "KB405" and "grew" in f.message for f in findings)


def test_surface_findings_gate_semantics():
    committed = {"a": (3, "ok"), "b": (2, "ok"), "gone": (1, "ok")}
    # growth always fails; shrink/orphan only under no-growth
    grow = ir_surface.surface_findings({"a": 4, "b": 2}, committed)
    assert [f.symbol for f in grow] == ["surface:a:growth"]
    clean = ir_surface.surface_findings({"a": 3, "b": 2}, committed)
    assert clean == []
    strict = ir_surface.surface_findings({"a": 2, "b": 2}, committed, no_growth=True)
    assert {f.symbol for f in strict} == {"surface:a:stale", "surface:gone:orphan"}
    missing = ir_surface.surface_findings({"new": 1}, {})
    assert [f.symbol for f in missing] == ["surface:new:missing"]


def test_surface_file_roundtrip(tmp_path):
    p = tmp_path / "surface.json"
    assert ir_surface.load_surface(p) == {}
    ir_surface.write_surface(p, {"dense": 3}, {"dense": (9, "old reason")})
    assert ir_surface.load_surface(p) == {"dense": (3, "old reason")}
    p.write_text(json.dumps({"entries": [{"entry": "x", "programs": 1}]}))
    with pytest.raises(BaselineError):
        ir_surface.load_surface(p)  # justification missing
    p.write_text("not json")
    with pytest.raises(BaselineError):
        ir_surface.load_surface(p)


def test_ir_lane_flags_and_usage(tmp_path, capsys):
    # --no-surface runs the trace alone; a malformed budget file is a usage error.
    assert cli.main(["--ir", "--no-surface", "--device", CPU, "--entries", "ops.fused_fp"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("not json")
    assert cli.main(["--ir", "--surface", str(bad), "--device", CPU]) == 2
    for argv in (["--ir", "--write-surface", "--no-surface"], ["--ir", "some/path"],
                 ["--ir", "--leap", "x.json"], ["--ir", "--device"],
                 ["--conc", "--device", CPU], ["--ir", "--rng"], ["--rng", "--surface", "x"],
                 ["--ir", "--entries", "no.such.entry", "--device", CPU]):
        assert cli.main(argv) == 2, argv
    capsys.readouterr()
    assert cli.main(["--help"]) == 0
    help_text = capsys.readouterr().out
    assert "KB401-KB404 over the dispatch trace" in help_text
    assert "key provenance (keyscope, KB6xx)" in help_text


# ---------------------------------------------------------------------------
# KB602: the STREAM_* register


def test_stream_registry_pinned_and_equal_to_the_jax_lanes():
    import kaboodle_tpu_torch.phasegraph.rng as pg_rng
    import kaboodle_tpu_torch.sparseplane as sp

    table = pg_rng.stream_table()
    assert list(table.items()) == list(rng_rules.KEYSCOPE_STREAMS)
    assert rng_rules.KEYSCOPE_STREAMS == jax_rng_rules.KEYSCOPE_STREAMS
    ids = list(table.values())
    assert ids == list(range(len(ids)))  # dense from 0, append-only order
    assert sp.STREAM_PROXY == 0
    assert sp.STREAM_GOSSIP == 5  # the sparse block; tick streams follow
    assert pg_rng.STREAM_TICK_PROXY == 6
    assert pg_rng.STREAM_TICK_DROP == len(ids) - 1
    assert sp.stream_table() == table
    assert rng_rules.check_kb602_stream_registry() == []


def test_stream_registry_drift_detected(monkeypatch):
    import kaboodle_tpu_torch.phasegraph.rng as pg_rng

    monkeypatch.setattr(pg_rng, "STREAM_PING", pg_rng.STREAM_ACK)
    findings = rng_rules.check_kb602_stream_registry()
    assert {f.rule for f in findings} == {"KB602"}
    assert {f.symbol for f in findings} >= {"drift:STREAM_PING", "not-dense"}


def test_stream_registry_unpinned_stream_detected(monkeypatch):
    import kaboodle_tpu_torch.phasegraph.rng as pg_rng

    monkeypatch.setattr(pg_rng, "STREAM_NEW_PHASE", 10, raising=False)
    assert [f.symbol for f in rng_rules.check_kb602_stream_registry()] == [
        "unpinned:STREAM_NEW_PHASE"]


def test_rng_lane_exit_codes(monkeypatch, capsys):
    import kaboodle_tpu_torch.phasegraph.rng as pg_rng

    scoped = ["--device", CPU, "--entries", "ops.crc32"]
    assert cli.main(["--rng", *scoped]) == 0
    assert cli.main(["rng", *scoped]) == 0
    # Two ids swapped: the id set is unchanged, only the register sees it.
    monkeypatch.setattr(pg_rng, "STREAM_PING", pg_rng.STREAM_ACK)
    monkeypatch.setattr(pg_rng, "STREAM_ACK", 3)
    assert cli.main(["--rng", *scoped]) == 1
    out = capsys.readouterr().out
    assert "drift:" not in out and "STREAM_PING is 4 live but pinned 3" in out


def test_rng_lane_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-m", "kaboodle_tpu_torch.analysis", "--rng",
                          "--device", CPU, "--entries", "ops.crc32"],
                         cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "0 findings" in out.stderr


def test_rule_documentation_lists_the_new_lanes(capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("KB405", "KB601", "KB602", "KB603", "KB604", "KB605", "KB501"):
        assert rid in listed, rid
    assert cli.main(["--explain", "KB602"]) == 0
    assert "Registry" in capsys.readouterr().out
    assert cli.main(["--explain", "kb601"]) == 0
    assert "run by the rng lane" in capsys.readouterr().out
