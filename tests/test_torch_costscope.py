"""costscope on the port: the counter, the gate, the audit, the roofline, the microbench.

``kaboodle_tpu_torch/costscope`` is held to the JAX package's
``kaboodle_tpu/costscope`` where the two share code (the gate's verdicts
on a seeded sweep of synthetic records and JAX's own gate cases, the ring
formulas, the microbench's agreement attribution), and to its own
contract elsewhere: the dispatch counter's units on known shapes, records
that are the same run to run, the sharded <-> bytes-to-other-ranks
invariant on the committed baseline and on a fresh extract, a doctored
baseline and two live regressions (a widened plane, an int64 ``[N, N]``
product) turning the gate red while the honest baseline passes, the H100
roofline from the committed baseline, and the ``--icibench --dryrun`` sweep
on 8 gloo ranks. The full-registry gate runs once, through the package
CLI, in a module fixture.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kaboodle_tpu.costscope import baseline as jbaseline
from kaboodle_tpu.costscope import collectives as jcoll
from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS
from kaboodle_tpu_torch.costscope import baseline as tbaseline
from kaboodle_tpu_torch.costscope import cli as tcli
from kaboodle_tpu_torch.costscope import collectives as tcoll
from kaboodle_tpu_torch.costscope.extract import CostCounter, extract_entries
from kaboodle_tpu_torch.ops import _cuda

REPO = Path(__file__).resolve().parent.parent
COMMITTED = REPO / "kaboodle_tpu_torch" / "costscope" / "baseline.json"
ONE_DEVICE = [e.name for e in ENTRY_POINTS if not e.sharded]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def full_gate(tmp_path_factory):
    """``python -m kaboodle_tpu_torch costscope --no-baseline-growth`` against
    the committed baseline, once: ``(exit code, the measured records)``."""
    from kaboodle_tpu_torch.cli import main

    path = tmp_path_factory.mktemp("costscope") / "measured.json"
    rc = main(["costscope", "--no-baseline-growth", "--json", str(path)])
    return rc, json.loads(path.read_text())


# ---------------------------------------------------------------- the gate


def _rec(**over):
    base = {"flops": 1000, "bytes_accessed": 100_000, "peak_bytes": 200_000,
            "ici_bytes": 50_000, "sharded": True}
    base.update(over)
    return base


def _verdicts(gate, default, measured, baseline, **kw):
    return [f.replace(default, "<baseline>") for f in gate(measured, baseline, **kw)]


def test_gate_constants_equal_jax():
    assert tbaseline.BASELINE_SCHEMA == jbaseline.BASELINE_SCHEMA
    assert tbaseline.GATED_FIELDS == jbaseline.GATED_FIELDS


@pytest.mark.parametrize("seed", range(4))
def test_gate_verdicts_equal_jax_on_a_seeded_sweep(seed):
    """Random records against random baselines (missing, stale, grown and
    shrunk entries, wobbles inside and outside the band): both gates give
    the same failures, in the same order, in every mode."""
    rng = np.random.default_rng(seed)
    names = [f"e{i}" for i in range(24)]
    base, live = {}, {}
    for name in names:
        old = {f: int(rng.integers(0, 1 << 20)) for f in ("bytes_accessed", "peak_bytes",
                                                           "ici_bytes", "flops")}
        kind = rng.integers(0, 4)
        if kind != 0:  # 0: a new entry, unbanked
            base[name] = {**old, "sharded": bool(rng.integers(0, 2))}
        if kind != 1:  # 1: a stale entry, banked but gone
            scale = {f: float(rng.choice([0.5, 0.97, 1.0, 1.03, 1.08, 2.0])) for f in old}
            live[name] = {f: int(v * scale[f]) + int(rng.integers(-3000, 3000)) * (f != "flops")
                          for f, v in old.items()}
            live[name] = {f: max(v, 0) for f, v in live[name].items()}
    jdoc = {"schema": jbaseline.BASELINE_SCHEMA, "entries": base}
    for baseline in (None, jdoc):
        for kw in ({}, {"no_growth": True}, {"no_growth": True, "subset": True}):
            want = _verdicts(jbaseline.gate_measurements, jbaseline.DEFAULT_BASELINE, live,
                             baseline, **kw)
            got = _verdicts(tbaseline.gate_measurements, tbaseline.DEFAULT_BASELINE, live,
                            baseline, **kw)
            assert got == want and (baseline is None or len(got) > 0)


def test_gate_cases_of_the_jax_suite():
    gate, schema = tbaseline.gate_measurements, tbaseline.BASELINE_SCHEMA
    # unbaselined
    fails = gate({"e": _rec()}, None)
    assert len(fails) == 1 and "no baseline" in fails[0]
    fails = gate({"e": _rec()}, {"schema": schema, "entries": {}})
    assert len(fails) == 1 and "not in baseline" in fails[0]
    # within tolerance
    baseline = {"schema": schema, "entries": {"e": _rec()}}
    wobble = _rec(bytes_accessed=102_000, peak_bytes=198_000, ici_bytes=51_000)
    assert gate({"e": wobble}, baseline) == []
    assert gate({"e": wobble}, baseline, no_growth=True) == []
    # growth, each gated field on its own
    fails = gate({"e": _rec(bytes_accessed=200_000)}, baseline)
    assert len(fails) == 1 and "grew" in fails[0]
    grown = _rec(bytes_accessed=200_000, peak_bytes=400_000, ici_bytes=100_000)
    assert len(gate({"e": grown}, baseline)) == len(tbaseline.GATED_FIELDS)
    # shrink-only under no_growth
    shrunk = {"e": _rec(bytes_accessed=50_000)}
    assert gate(shrunk, baseline) == []
    fails = gate(shrunk, baseline, no_growth=True)
    assert len(fails) == 1 and "shrank" in fails[0]
    # stale
    two = {"schema": schema, "entries": {"e": _rec(), "gone": _rec()}}
    assert gate({"e": _rec()}, two) == []
    fails = gate({"e": _rec()}, two, no_growth=True)
    assert len(fails) == 1 and "stale" in fails[0]
    assert gate({"e": _rec()}, two, no_growth=True, subset=True) == []


def test_baseline_roundtrip_and_bad_schema(tmp_path):
    path = tmp_path / "b.json"
    assert tbaseline.load_baseline(path) is None
    tbaseline.write_baseline(path, {"e": _rec()})
    assert tbaseline.load_baseline(path)["entries"]["e"]["bytes_accessed"] == 100_000
    path.write_text(json.dumps({"schema": "wrong/1", "entries": {}}))
    with pytest.raises(ValueError):
        tbaseline.load_baseline(path)


# ------------------------------------------------------- the collective audit


@pytest.mark.parametrize("kind", tcoll.COLLECTIVE_KINDS)
def test_ring_formulas_equal_jax(kind):
    assert tcoll.COLLECTIVE_KINDS == jcoll.COLLECTIVE_KINDS
    for d in range(1, 9):
        for nbytes in (0, 1, 7, 96, 1024, 4096 + 3):
            assert tcoll._ici_bytes(kind, nbytes, d) == jcoll._ici_bytes(kind, nbytes, d)


def test_audit_counts_the_sends_of_every_kind():
    log = [
        {"kind": "all-reduce", "group_size": 8, "result_bytes": 128, "sent_bytes": None},
        {"kind": "all-gather", "group_size": 4, "result_bytes": 256, "sent_bytes": None},
        {"kind": "all-to-all", "group_size": 8, "result_bytes": 96, "sent_bytes": 84},
        {"kind": "collective-permute", "group_size": 8, "result_bytes": 100, "sent_bytes": 100},
        {"kind": "all-reduce", "group_size": 1, "result_bytes": 128, "sent_bytes": None},
    ]
    audit = tcoll.collective_audit(log)
    assert audit["counts"]["all-reduce"] == {"count": 2, "result_bytes": 256, "ici_bytes": 224}
    assert audit["counts"]["all-gather"]["ici_bytes"] == 192
    assert audit["counts"]["all-to-all"]["ici_bytes"] == 84
    assert audit["counts"]["collective-permute"]["ici_bytes"] == 100
    assert audit["ici_bytes"] == 224 + 192 + 84 + 100


# ------------------------------------------------------------- the counter


def _count(fn, *args):
    counter = CostCounter()
    with counter:
        _cuda.counter = counter
        try:
            out = fn(*args)
        finally:
            _cuda.counter = None
    return counter, out


def test_counter_int32_add_and_matmul():
    a = torch.arange(100, dtype=torch.int32)
    c, _ = _count(torch.add, a, a)
    assert (c.flops, c.bytes_accessed) == (100, 3 * 100 * 4)
    x = torch.ones((8, 16), dtype=torch.int32)
    y = torch.ones((16, 4), dtype=torch.int32)
    c, out = _count(torch.mm, x, y)
    assert int(out[0, 0]) == 16
    assert (c.flops, c.bytes_accessed) == (2 * 8 * 16 * 4, (8 * 16 + 16 * 4 + 8 * 4) * 4)
    assert c.peak_bytes((x, y), out) == (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_counter_views_and_allocations_move_nothing():
    a = torch.arange(64, dtype=torch.int32)
    c, _ = _count(lambda t: (t.view(8, 8)[2:4].transpose(0, 1), torch.empty((1024,))), a)
    assert (c.flops, c.bytes_accessed) == (0, 0)


def test_kernel_unit_counts_its_arguments_and_outputs_only():
    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count
    from kaboodle_tpu_torch.phasegraph.exec import _bool_matmul

    state = torch.zeros((128, 128), dtype=torch.int8)
    ident = torch.ones((128,), dtype=torch.int32)
    c, (fp, cnt) = _count(fused_fp_count, state, ident)
    assert dict(c.by_op) == {"unit:fused_fp_count": [1, 128 * 128 + 128 * 4 + 2 * 128 * 4,
                                                     128 * 128]}
    a = torch.ones((32, 32), dtype=torch.bool)
    c, out = _count(_bool_matmul, a, a)
    assert dict(c.by_op) == {"unit:_bool_matmul": [1, 3 * 32 * 32, 2 * 32 * 32 * 32]}
    assert bool(out.all())
    # with no counter open, the wrapper is the wrapper
    assert torch.equal(fused_fp_count(state, ident)[1], cnt)


def test_records_are_deterministic():
    first = extract_entries(ONE_DEVICE)
    assert extract_entries(ONE_DEVICE) == first
    for name, rec in first.items():
        assert rec["generated_code_bytes"] == 0 and rec["collectives"] == {}, name
        assert rec["temp_bytes"] == max(
            rec["peak_bytes"] - rec["argument_bytes"] - rec["output_bytes"], 0), name
        assert rec["peak_bytes"] >= rec["argument_bytes"], name


# -------------------------------------------------------- the committed gate


def test_committed_baseline_gates_clean(full_gate):
    rc, measured = full_gate
    assert rc == 0
    committed = tbaseline.load_baseline(COMMITTED)
    assert set(committed["entries"]) == set(measured) == {e.name for e in ENTRY_POINTS}
    assert tbaseline.gate_measurements(measured, committed) == []


def test_sharded_entries_and_only_they_pay_link_bytes(full_gate):
    _, measured = full_gate
    committed = tbaseline.load_baseline(COMMITTED)["entries"]
    for records in (committed, measured):
        for e in ENTRY_POINTS:
            rec = records[e.name]
            assert rec["sharded"] is e.sharded, e.name
            assert (rec["ici_bytes"] > 0) is e.sharded, e.name
            assert (rec["collectives"] != {}) is e.sharded, e.name
    tick = measured["phasegraph.tick.sharded"]["collectives"]
    assert {"all-gather", "all-reduce", "all-to-all"} <= set(tick)
    assert measured["phasegraph.tick.faulty"]["ici_bytes"] == 0


def test_doctored_baseline_turns_the_gate_red(tmp_path, capsys):
    honest = extract_entries(["ops.fused_fp"])
    path = tmp_path / "base.json"
    tbaseline.write_baseline(path, honest)
    argv = ["--entry", "ops.fused_fp", "--baseline", str(path)]
    assert tcli.main([*argv, "--no-baseline-growth"]) == 0
    rec = honest["ops.fused_fp"]
    tbaseline.write_baseline(path, {"ops.fused_fp": {
        **rec, "bytes_accessed": rec["bytes_accessed"] // 2, "peak_bytes": rec["peak_bytes"] // 2}})
    assert tcli.main(argv) == 1
    assert "grew" in capsys.readouterr().out
    assert tcli.main(["--entry", "no.such.entry", "--baseline", str(path)]) == 2
    path.write_text('{"schema": "wrong/1"}')
    assert tcli.main(argv) == 2


def test_widened_plane_turns_the_gate_red(monkeypatch, capsys):
    """The lean leap's int16 timer plane widened to int32."""
    from kaboodle_tpu_torch.analysis.ir import registry

    lean = registry._lean_state

    def widened(device, n=registry.TRACE_N, converged=False):
        st = lean(device, n, converged)
        st.timer = st.timer.to(torch.int32)
        return st

    argv = ["--entry", "phasegraph.leap.lean", "--baseline", str(COMMITTED)]
    assert tcli.main(argv) == 0
    monkeypatch.setattr(registry, "_lean_state", widened)
    assert tcli.main(argv) == 1
    assert "phasegraph.leap.lean: bytes_accessed grew" in capsys.readouterr().out


def test_int64_square_temp_turns_the_gate_red(monkeypatch, capsys):
    """The gossip union as an int64 ``[N, N]`` product instead of the
    card's int8 one (a plain op, not the counted unit)."""
    from kaboodle_tpu_torch.phasegraph import exec as X

    monkeypatch.setattr(X, "_bool_matmul",
                        lambda a, b: (a.to(torch.int64) @ b.to(torch.int64)) > 0)
    assert tcli.main(["--entry", "phasegraph.tick.lean", "--baseline", str(COMMITTED)]) == 1
    out = capsys.readouterr().out
    assert "phasegraph.tick.lean: peak_bytes grew" in out


def test_write_baseline_merges_a_subset_and_manifest(tmp_path):
    from kaboodle_tpu_torch.telemetry.manifest import read_manifest

    path = tmp_path / "base.json"
    tbaseline.write_baseline(path, {"other.entry": _rec()})
    manifest = tmp_path / "m.jsonl"
    assert tcli.main(["--entry", "ops.crc32", "--baseline", str(path), "--write-baseline",
                      "--manifest", str(manifest)]) == 0
    assert set(tbaseline.load_baseline(path)["entries"]) == {"other.entry", "ops.crc32"}
    (rec,) = read_manifest(str(manifest))
    assert rec["kind"] == "costscope" and rec["entry"] == "ops.crc32"
    assert rec["ici_bytes"] == 0 and rec["sharded"] is False


# ------------------------------------------------------------- the roofline


def test_roofline_from_the_committed_baseline():
    from kaboodle_tpu_torch.costscope.roofline import (
        H100_HBM_GBPS,
        render_report,
        roofline_from_baseline,
    )

    baseline = tbaseline.load_baseline(COMMITTED)
    report = roofline_from_baseline(baseline)
    assert report["hbm_gbps"] == H100_HBM_GBPS == 3350.0
    assert "H100" in report["card"]
    rows = {r["entry"]: r for r in report["entries"]}
    assert set(rows) == set(baseline["entries"])
    for name, row in rows.items():
        assert row["hbm_floor_us"] > 0, name
        if baseline["entries"][name]["sharded"]:
            floors = row["link_floor_us"]
            assert floors["pcie5x16"] > floors["nvlink4"] > 0, name
        else:
            assert "link_floor_us" not in row, name
    assert report["placements"] == [] and "phasegraph.tick.sharded" in render_report(report)


def test_roofline_reads_no_bench_files_and_places_given_walls(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({
        "metric": "simulated_peers_ticks_per_sec_per_chip", "value": 1e9, "n_peers": 8192,
        "backend": "tpu"}))
    out = tmp_path / "report.json"
    assert tcli.main(["--report", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["placements"] == []
    walls = tmp_path / "walls.jsonl"
    walls.write_text(json.dumps({"n_peers": 8192, "ticks": 64, "wall_s": 1.28,
                                 "backend": "NVIDIA H100 80GB HBM3, 700.00 W"}) + "\n")
    assert tcli.main(["--report", "--walls", str(walls), "--json", str(out)]) == 0
    (p,) = json.loads(out.read_text())["placements"]
    assert p["entry"] == "phasegraph.tick.faulty" and p["wall_s_per_tick"] == 0.02
    assert p["hbm_floor_s_per_tick"] > 0 and p["backend"].startswith("NVIDIA H100")
    walls.write_text(json.dumps({"n_peers": 8192, "ticks": 64, "wall_s": 1.28}) + "\n")
    assert tcli.main(["--report", "--walls", str(walls)]) == 2
    assert tcli.main(["--report", "--icibench"]) == 2


# ----------------------------------------------------------- the microbench


def test_icibench_dryrun_on_8_gloo_ranks(tmp_path):
    from kaboodle_tpu.costscope.icibench import run_sweep as jax_sweep

    out = tmp_path / "ici.json"
    assert tcli.main(["--icibench", "--dryrun", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["schema"] == "kaboodle-costscope-ici/1"
    assert (report["backend"], report["n_devices"]) == ("gloo", 8)
    rows = {(r["collective"], r["n"]): r for r in report["results"]}
    assert {c for c, _ in rows} == {"agreement_all_reduce", "union_ring"}
    for r in report["results"]:
        assert r["payload_bytes"] > 0 and r["ici_bytes_ring"] > 0 and r["wall_s_best"] > 0
        assert r["wire_ici_bytes"] > 0
    union = rows[("union_ring", 8)]
    assert union["wire_ici_bytes"] == union["ici_bytes_ring"] == 7 * 64
    (want,) = [r for r in jax_sweep(sizes=(256,), repeats=1)["results"]
               if r["collective"] == "agreement_all_reduce"]
    got = rows[("agreement_all_reduce", 256)]
    assert (got["payload_bytes"], got["ici_bytes_ring"]) == (
        want["payload_bytes"], want["ici_bytes_ring"])
