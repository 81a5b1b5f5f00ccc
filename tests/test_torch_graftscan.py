"""The port's IR lane (graftscan: KB401-KB404 over the dispatch trace).

The acceptance contract is the JAX lane's (``tests/test_graftscan.py``),
mutation-tested: the clean registry equals its committed baseline
(``kaboodle_tpu_torch/analysis/ir/baseline.json``), and each seeded
mutation turns the lane red through ``cli.main``: an f64 cast in the tick
(KB401), an ``.item()`` in the tick (KB402), a second gate in the dense
tick's ``_rest``, which already syncs (KB402 by its recorded count, since
its key is baselined), a spurious per-call cache key
(KB405), a 64 KB host table uploaded per call (KB403) and a sharded block
cut off the spec (KB404). Then the lean-widening detector's allow and deny
cases, ``terminal_consumers`` through views, and the CPU trace of a
kernel-flag entry holding each hand kernel as one unit. The registry is
traced once per process (``torch_registry_trace.py``), on the CPU.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from kaboodle_tpu_torch.analysis import cli
from kaboodle_tpu_torch.analysis.core import load_baseline, load_counts
from kaboodle_tpu_torch.analysis.ir import registry
from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS, EntryPoint
from kaboodle_tpu_torch.analysis.ir.scan import read_entry, run_scan
from kaboodle_tpu_torch.analysis.ir.walk import run_traced, terminal_consumers, trace_entry
from torch_registry_trace import registry_results

REPO = pathlib.Path(__file__).resolve().parent.parent
BASELINE = REPO / "kaboodle_tpu_torch/analysis/ir/baseline.json"
CPU = "cpu"
BY_NAME = {e.name: e for e in ENTRY_POINTS}


@pytest.fixture(scope="module")
def results():
    return registry_results()


def _wrapped(name: str, wrap, **kw) -> EntryPoint:
    """Registry entry ``name`` with its fn wrapped: ``wrap(fn) -> fn``."""
    base = BY_NAME[name]

    def build(device=None):
        fn, args = base.build(device)
        return wrap(fn), args

    return EntryPoint(name, build, lean=base.lean, sharded=kw.get("sharded", base.sharded))


def _red(monkeypatch, capsys, entry: EntryPoint, rule: str, *extra) -> str:
    """The lane on ``entry`` alone, through cli.main: exit 1 with ``rule``."""
    monkeypatch.setattr(registry, "select_entries", lambda names: (entry,))
    rc = cli.main(["--ir", "--device", CPU, "--entries", entry.name, "--no-surface",
                   "--baseline", str(BASELINE), *extra])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert rule in out, out
    return out


# ---------------------------------------------------------------------------
# the clean registry


def test_clean_registry_equals_its_baseline(results):
    scan = run_scan(entries=ENTRY_POINTS, with_surface=False, results=results)
    keys = {f.key for f in scan.findings}
    assert keys == set(load_baseline(BASELINE)), sorted(keys ^ set(load_baseline(BASELINE)))
    data = json.loads(BASELINE.read_text())
    assert all(e["reason"].strip() and "TODO" not in e["reason"] for e in data["entries"])


def test_clean_registry_sync_counts_equal_the_recorded(results):
    scan = run_scan(entries=ENTRY_POINTS, with_surface=False, results=results)
    recorded = load_counts(BASELINE)
    assert scan.counts == recorded, sorted(set(scan.counts.items()) ^ set(recorded.items()))
    # Every KB402 entry records its syncs per run (as is, gates forced true, false).
    assert {k for k in load_baseline(BASELINE) if "::KB402::" in k} == set(recorded)
    assert all(len(c) == 3 for c in recorded.values())
    assert sum(scan.counts[k][0] for k in scan.counts
               if k.startswith("ir://phasegraph.tick.faulty::")) == scan.syncs[
                   "phasegraph.tick.faulty"]


@pytest.mark.parametrize("name", [e.name for e in ENTRY_POINTS])
def test_entry_findings_are_baselined(results, name):
    base = load_baseline(BASELINE)
    assert [f.key for f in results[name].findings if f.key not in base] == []


def test_kb403_budgets_equal_jax():
    from kaboodle_tpu.analysis.ir import registry as jreg

    assert ([(e.name, e.const_budget_bytes) for e in ENTRY_POINTS]
            == [(e.name, e.const_budget_bytes) for e in jreg.ENTRY_POINTS])


def test_host_syncs_per_call(results):
    syncs = {name: r.syncs for name, r in results.items()}
    # The sparse tick and every leap derive their keys on the device and
    # gate nothing on the host; the dense ticks gate their phases.
    for name in ("phasegraph.tick.sparse", "phasegraph.leap", "phasegraph.leap.hybrid",
                 "serve.leap", "ops.fused_fp", "ops.crc32"):
        assert syncs[name] == 0, name
    for name in ("phasegraph.tick.faulty", "phasegraph.tick.blocked", "phasegraph.serve.step"):
        assert syncs[name] > 0, name
    # The row-sharded tick takes the dense tick's gates, once each.
    assert syncs["phasegraph.tick.sharded"] == syncs["phasegraph.tick.faultfree"]


def test_kernel_flag_entry_runs_each_kernel_as_one_unit():
    traces = trace_entry(BY_NAME["phasegraph.tick.faulty"], CPU)
    names = {op.name for t in traces for op in t.ops}
    assert {"unit:fused_suspicion", "unit:fused_fp_count", "unit:fused_oldest_k"} <= names
    # Nothing of a plain version is recorded: the wrappers are opaque.
    files = {op.src.file for t in traces for op in t.ops}
    assert not files & {"fused_fp.py", "fused_suspicion.py", "fused_oldest_k.py"}


# ---------------------------------------------------------------------------
# seeded mutations, each red through cli.main


def test_mutation_f64_cast_turns_kb401_red(monkeypatch, capsys):
    def wrap(tick):
        def mutated(st, inp):
            st, m = tick(st, inp)
            st.timer.to(torch.float64).sum()
            return st, m
        return mutated

    out = _red(monkeypatch, capsys, _wrapped("phasegraph.tick.faulty", wrap), "KB401")
    assert "float64" in out


def test_mutation_item_in_tick_turns_kb402_red(monkeypatch, capsys):
    def wrap(tick):
        def mutated(st, inp):
            st.tick.item()
            return tick(st, inp)
        return mutated

    _red(monkeypatch, capsys, _wrapped("phasegraph.tick.faulty", wrap), "KB402")


def _mutated_exec(old: str, new: str):
    """``phasegraph/exec.py`` with ``old`` replaced by ``new``, compiled under
    the module's own file name, so the trace attributes its ops to exec.py's
    functions as it does the real module's."""
    import types

    from kaboodle_tpu_torch.phasegraph import exec as real

    src = pathlib.Path(real.__file__).read_text()
    assert old in src, f"mutation anchor missing: {old!r}"
    mod = types.ModuleType(real.__name__)
    mod.__file__ = real.__file__
    exec(compile(src.replace(old, new, 1), real.__file__, "exec"), mod.__dict__)
    return mod


def test_mutation_second_gate_in_rest_turns_kb402_red(monkeypatch, capsys):
    """A new sync at a site that already syncs makes no new key: the site's
    recorded count is what turns red."""
    from kaboodle_tpu_torch.phasegraph import derive

    gate = "            joining = bool(any_join)\n"
    mod = _mutated_exec(gate, gate + "            _joining_again = bool(any_join)\n")
    monkeypatch.setattr(derive, "make_tick_fn", mod.make_tick_fn)
    out = _red(monkeypatch, capsys, BY_NAME["phasegraph.tick.faulty"], "KB402")
    assert out.count("KB402") == 1, out
    assert ("exec.py:make_tick_fn.tick._rest:_local_scalar_dense: the baselined finding's "
            "count rose to [6, 6, 0] from the recorded [5, 5, 0]") in out, out


def test_mutation_host_table_per_call_turns_kb403_red(monkeypatch, capsys):
    def wrap(tick):
        def mutated(st, inp):
            torch.tensor(np.arange(16384, dtype=np.int32))  # 64 KB uploaded per call
            return tick(st, inp)
        return mutated

    out = _red(monkeypatch, capsys, _wrapped("phasegraph.tick.faulty", wrap), "KB403")
    assert "65536 bytes > budget 4096" in out


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process (the sharded entries' mesh)."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=CPU)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_mutation_block_off_the_spec_turns_kb404_red(one_rank_group, monkeypatch, capsys):
    from kaboodle_tpu_torch.parallel import collectives as C
    from kaboodle_tpu_torch.parallel.mesh import peer_group

    group = peer_group(one_rank_group)

    def wrap(tick):
        def mutated(st, inp):
            C.gather_rows(st.state[:, :5], group, dim=-1)  # 5 columns, not the row split
            return tick(st, inp)
        return mutated

    # Pristine: the row-sharded tick's collectives all carry the spec's split.
    clean = read_entry(BY_NAME["phasegraph.tick.sharded"], CPU, rng=False)
    assert not [f for f in clean.findings if f.rule == "KB404"]
    out = _red(monkeypatch, capsys, _wrapped("phasegraph.tick.sharded", wrap), "KB404")
    assert "gather_rows" in out


def test_sharded_entry_with_no_collective_is_kb404():
    dense = _wrapped("phasegraph.tick.faultfree", lambda fn: fn, sharded=True)
    res = read_entry(dense, CPU, rng=False)
    assert [f.symbol for f in res.findings if f.rule == "KB404"] == ["missing-collectives"]


def test_mutation_spurious_cache_key_turns_kb405_red(monkeypatch, capsys):
    import itertools

    from kaboodle_tpu_torch.warp import runner

    calls = itertools.count()

    def mutated(cfg, K):
        return runner.leap_cache.get((cfg, "fleet", next(calls)), "hybrid", K,
                                     lambda: runner.make_warp_leap(cfg, K, hybrid=True,
                                                                   masked=True))

    monkeypatch.setattr(runner, "_get_fleet_leap", mutated)
    rc = cli.main(["--ir", "--device", CPU, "--entries", "ops.fused_fp",
                   "--baseline", str(BASELINE)])
    out = capsys.readouterr().out
    assert rc == 1 and "KB405" in out, out


# ---------------------------------------------------------------------------
# the lean-widening detector


def _lean_entry(fn) -> EntryPoint:
    def build(device=None):
        from kaboodle_tpu_torch.analysis.ir.registry import _lean_state

        return fn, (_lean_state(device),)

    return EntryPoint("test.lean", build, lean=True)


def test_lean_widening_allowlisted_age_arithmetic():
    def ages(st):
        age = st.tick.to(torch.int32) - st.timer.to(torch.int32)
        return (age > 3) & (st.timer.view(-1).to(torch.int32).view(st.timer.shape) <= 7)

    res = read_entry(_lean_entry(ages), CPU, rng=False)
    assert not [f for f in res.findings if f.rule == "KB401"]


def test_lean_widening_into_a_write_is_kb401():
    def leak(st):
        return torch.where(st.alive[:, None], st.timer.to(torch.int32), 0)

    res = read_entry(_lean_entry(leak), CPU, rng=False)
    (f,) = [f for f in res.findings if f.rule == "KB401"]
    assert "int16->int32" in f.symbol and "where" in f.symbol
    # Widened by promotion inside an op outside the allowlist, with no cast.
    floor = torch.zeros((1,), dtype=torch.int32)  # a dimensioned operand promotes
    res = read_entry(_lean_entry(lambda st: torch.maximum(st.timer, floor)), CPU, rng=False)
    assert [f.symbol for f in res.findings if f.rule == "KB401"] == [
        "test_torch_graftscan.py:test_lean_widening_into_a_write_is_kb401.<lambda>"
        ":int16->int32:maximum"]


def test_terminal_consumers_follow_views():
    def fn(x):
        y = x.to(torch.int32)
        z = y.view(-1).reshape(4, 4).t()
        return (z - 1, y.sum())

    trace = run_traced("t", fn, (torch.zeros((4, 4), dtype=torch.int16),))
    i = next(i for i, op in enumerate(trace.ops) if op.name == "aten._to_copy")
    got = terminal_consumers(trace.ops, i, trace.ops[i].outs[0].tid)
    assert got == {"sub", "sum"}


# ---------------------------------------------------------------------------
# the CLI


def test_cli_ir_usage():
    assert cli.main(["--ir", "kaboodle_tpu_torch"]) == 2
    assert cli.main(["--ir", "--entries", "no.such.entry", "--device", CPU]) == 2
    assert cli.main(["--ir", "--write-surface", "--no-surface"]) == 2
    assert cli.main(["--explain", "KB404"]) == 0
