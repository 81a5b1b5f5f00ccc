"""The port's rng lane (keyscope: KB601-KB605) against the JAX package's.

The test that holds the port against the reference: the port's leap report
(the key provenance recorded at its counter-RNG calls, every registry entry
traced on the CPU) equals the JAX lane's committed ``KEYSCOPE_LEAP.json``
in every entry's counts and in the multiset of its sinks, every field but
``site`` (the port's file:line) -- 25 counter-keyed sinks, 0 chain-coupled,
0 impure. Then the JAX lane's provenance cases in the port's terms (key
reuse, split rows, a const seed, a stream collision, an unregistered id,
KB604 divergence, draws on exclusive gate arms, a chunked draw as one sink),
its three seeded mutations red through ``cli.main`` (the ping key reused
for the bern draw, STREAM_PING and STREAM_ACK swapped, ``prng_key(0)``
past the cursor), and the leap report's determinism, staleness and missing
file. The registry is traced once per process (``torch_registry_trace.py``).
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from kaboodle_tpu_torch.analysis import cli
from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS, EntryPoint
from kaboodle_tpu_torch.analysis.ir.walk import run_traced, trace_entry
from kaboodle_tpu_torch.analysis.rng import rules as rng_rules
from kaboodle_tpu_torch.analysis.rng import scan as rng_scan
from kaboodle_tpu_torch.analysis.rng.provenance import build_graph, graph_from_dict, graph_to_dict
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.phasegraph import rng as pg_rng
from torch_registry_trace import registry_results

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_LEAP = json.loads((REPO / "KEYSCOPE_LEAP.json").read_text())
PORT_LEAP = REPO / rng_scan.DEFAULT_LEAP_REPORT
CPU = "cpu"
D = torch.device(CPU)


@pytest.fixture(scope="module")
def graphs():
    return {name: r.graph for name, r in registry_results().items()}


@pytest.fixture(scope="module")
def report(graphs):
    return rng_scan.build_leap_report(graphs)


def _sinks_but_site(entry: dict) -> list:
    return sorted(json.dumps({k: v for k, v in s.items() if k != "site"}, sort_keys=True)
                  for s in entry["sinks"])


def _graph(fn, *args, name="test.fn"):
    trace = run_traced(name, fn, args, rng=True)
    return build_graph(name, [trace.rng])


def rules_of(findings) -> set:
    return {f.rule for f in findings}


def _key(a: int = 0, b: int = 5):
    return (torch.tensor(a, dtype=torch.int64), torch.tensor(b, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the port's leap report against the JAX lane's


@pytest.mark.parametrize("name", sorted(JAX_LEAP["entries"]))
def test_leap_entry_equals_jax(report, name):
    want, got = JAX_LEAP["entries"][name], report["entries"][name]
    for field in ("chain_coupled", "counter_keyed", "impure"):
        assert got[field] == want[field], field
    assert _sinks_but_site(got) == _sinks_but_site(want)


def test_leap_totals_and_streams_equal_jax(report):
    assert set(report["entries"]) == set(JAX_LEAP["entries"])
    assert report["totals"] == JAX_LEAP["totals"]
    assert report["totals"]["counter_keyed"] == 25
    assert report["streams"] == JAX_LEAP["streams"]
    assert report["schema"] == JAX_LEAP["schema"]


def test_committed_port_leap_report_is_fresh(graphs):
    from kaboodle_tpu_torch.costscope.baseline import DEFAULT_BASELINE

    assert rng_scan.leap_findings(graphs, PORT_LEAP, costscope_path=DEFAULT_BASELINE) == []


def test_clean_registry_has_no_findings(graphs):
    res = rng_scan.run_rng_scan(entries=ENTRY_POINTS, results=registry_results())
    assert res.findings == []
    assert json.loads((REPO / "kaboodle_tpu_torch/analysis/rng/baseline.json").read_text())[
        "entries"] == []


def test_graph_round_trips_through_json(graphs):
    g = graphs["phasegraph.tick.fleet.sharded"]
    back = graph_from_dict(json.loads(json.dumps(graph_to_dict(g))))
    assert back.sink_descrs() == g.sink_descrs()
    assert [s.shape for s in back.sinks] == [s.shape for s in g.sinks]


# ---------------------------------------------------------------------------
# provenance cases (the JAX lane's, in the port's terms)


def test_dense_chain_rows_and_classes():
    def f(key):
        kp, kq = threefry.split(key, 2)
        return threefry.uniform(kp, (4,), D) + threefry.uniform(kq, (4,), D)

    g = _graph(f, _key())
    assert sorted(s.descr() for s in g.sinks) == ["carried_key/split2[0]", "carried_key/split2[1]"]
    assert all(rng_rules.classify(s) == rng_rules.CLASS_CHAIN for s in g.sinks)
    assert rng_rules.check_kb601_key_reuse(g) == []


def test_counter_chain_classified_counter_keyed():
    def f(seed, cursor):
        return threefry.uniform(pg_rng.stream_key(seed, cursor, 3), (4,), D)

    g = _graph(f, torch.tensor(1), torch.tensor(2))
    (sink,) = g.sinks
    assert sink.descr() == "counter_seed/fold[?]/fold[3]"
    assert rng_rules.classify(sink) == rng_rules.CLASS_COUNTER
    assert rng_rules.check_kb603_resume_impurity(g) == []


def test_kb601_same_key_drawn_twice():
    def f(key):
        return threefry.uniform(key, (4,), D) + threefry.uniform(key, (4,), D)

    assert rules_of(rng_rules.check_kb601_key_reuse(_graph(f, _key()))) == {"KB601"}


def test_kb601_loop_invariant_key():
    def f(key):
        return sum(threefry.uniform(key, (4,), D) for _ in range(3))

    findings = rng_rules.check_kb601_key_reuse(_graph(f, _key()))
    assert rules_of(findings) == {"KB601"}
    assert any("loop-invariant" in f.message for f in findings)


def test_kb601_key_refolded_each_iteration_is_clean():
    def f(key):
        return sum(threefry.uniform(threefry.fold_in(key, i), (4,), D) for i in range(3))

    g = _graph(f, _key())
    assert rng_rules.check_kb601_key_reuse(g) == []
    (sink,) = g.sinks  # one draw site, one sink
    assert sink.descr() == "carried_key/fold[?]"


def test_kb601_exclusive_gate_arms():
    # The dispatched dense tick's shape: the full and the fused program
    # draw the same key on the two arms of one gate -- not reuse.
    def build(device=None):
        def fn(pred, key):
            if bool(pred):
                return threefry.uniform(key, (4,), D)
            return threefry.uniform(key, (4,), D) * 2.0
        return fn, (torch.tensor(True), _key())

    traces = trace_entry(EntryPoint("test.arms", build), CPU, rng=True)
    g = build_graph("test.arms", [t.rng for t in traces])
    assert len(g.sinks) == 2
    assert rng_rules.check_kb601_key_reuse(g) == []


def test_kb602_colliding_stream_constants():
    def f(seed, cursor):
        a = threefry.uniform(pg_rng.stream_key(seed, cursor, 2), (4,), D)
        b = threefry.uniform(pg_rng.stream_key(seed, cursor + 0, 2), (4,), D)
        return a + b

    findings = rng_rules.check_kb602_stream_collision(_graph(f, torch.tensor(1), torch.tensor(2)))
    assert any(f.symbol.startswith("collide:") for f in findings), findings


def test_kb602_unregistered_stream_id():
    def f(seed, cursor):
        return threefry.uniform(pg_rng.stream_key(seed, cursor, 77), (4,), D)

    findings = rng_rules.check_kb602_stream_collision(_graph(f, torch.tensor(1), torch.tensor(2)))
    assert any(f.symbol == "unregistered:77" for f in findings)


def test_kb603_const_seed_draw():
    def f(x):
        return x + threefry.uniform(threefry.prng_key(0), (4,), D)

    findings = rng_rules.check_kb603_resume_impurity(_graph(f, torch.zeros(4)))
    assert rules_of(findings) == {"KB603"}


def test_kb604_group_divergence(monkeypatch):
    def one(key):
        kp, _ = threefry.split(key, 2)
        return threefry.uniform(kp, (4,), D)

    def other(key):
        kp, kq = threefry.split(key, 2)
        return threefry.uniform(kp, (4,), D) + threefry.uniform(kq, (4,), D)

    graphs = {"eng.a": _graph(one, _key(), name="eng.a"),
              "eng.b": _graph(other, _key(), name="eng.b")}
    monkeypatch.setattr(rng_rules, "CHAIN_GROUPS", (("pair", ("eng.a", "eng.b")),))
    assert rules_of(rng_rules.check_kb604_chain_divergence(graphs)) == {"KB604"}
    assert rng_rules.check_kb604_chain_divergence({"eng.a": graphs["eng.a"]}) == []


def test_chunked_draw_is_one_sink(monkeypatch):
    # The dense tick's drop draw split into many row chunks (as at N = 8,192)
    # is one sink of the draw's logical shape, as at N = 32 in one piece.
    entry = next(e for e in ENTRY_POINTS if e.name == "phasegraph.tick.faulty")
    monkeypatch.setattr(threefry, "CHUNK_CELLS", 64)
    traces = trace_entry(entry, CPU, rng=True)
    g = build_graph(entry.name, [t.rng for t in traces])
    want = JAX_LEAP["entries"][entry.name]["sinks"]
    assert [(s.descr(), list(s.shape)) for s in g.sinks] == [(w["key"], w["shape"]) for w in want]


# ---------------------------------------------------------------------------
# the leap report file


def _toy_graphs():
    def dense(key):
        return threefry.uniform(threefry.split(key, 5)[1], (4,), D)

    def sparse(seed, cursor):
        return threefry.uniform(pg_rng.stream_key(seed, cursor, 3), (4,), D)

    return {"toy.dense": _graph(dense, _key(), name="toy.dense"),
            "toy.sparse": _graph(sparse, torch.tensor(1), torch.tensor(2), name="toy.sparse")}


def test_leap_report_classifies_and_is_deterministic():
    graphs = _toy_graphs()
    r1, r2 = rng_scan.build_leap_report(graphs), rng_scan.build_leap_report(_toy_graphs())
    assert r1 == r2
    assert r1["entries"]["toy.dense"]["chain_coupled"] == 1
    assert r1["entries"]["toy.dense"]["sinks"][0]["layout_row"] == "ping"
    assert r1["entries"]["toy.sparse"]["counter_keyed"] == 1
    assert "toy.dense" in rng_scan.render_leap_report(r1)


def test_leap_findings_missing_stale_and_growth(tmp_path):
    graphs = _toy_graphs()
    path = tmp_path / "leap.json"
    assert [f.symbol for f in rng_scan.leap_findings(graphs, path)] == ["missing"]
    rng_scan.write_leap_report(rng_scan.build_leap_report(graphs), path)
    assert rng_scan.leap_findings(graphs, path) == []
    data = json.loads(path.read_text())
    data["entries"]["toy.sparse"]["counter_keyed"] = 9
    data["totals"]["chain_coupled"] = 0
    path.write_text(json.dumps(data))
    assert sorted(f.symbol for f in rng_scan.leap_findings(graphs, path)) == ["growth", "stale"]
    path.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError):
        rng_scan.load_leap_report(path)


# ---------------------------------------------------------------------------
# the JAX lane's seeded mutations, red through cli.main


def _rng(entries: str, capsys) -> tuple[int, str]:
    rc = cli.main(["--rng", "--device", CPU, "--entries", entries, "--no-baseline"])
    return rc, capsys.readouterr().out


def test_mutation_ping_reuse_red(monkeypatch, capsys):
    assert _rng("phasegraph.tick.random", capsys)[0] == 0
    orig = pg_rng.tick_draw_keys

    def reused(key, tick):  # bern <- ping: one counter row drawn twice
        kp, kping, _, kd = orig(key, tick)
        return kp, kping, kping, kd

    monkeypatch.setattr(pg_rng, "tick_draw_keys", reused)
    rc, out = _rng("phasegraph.tick.random", capsys)
    assert rc == 1 and "KB601" in out, out


def test_mutation_stream_swap_red(monkeypatch, capsys):
    ping, ack = pg_rng.STREAM_PING, pg_rng.STREAM_ACK
    monkeypatch.setattr(pg_rng, "STREAM_PING", ack)
    monkeypatch.setattr(pg_rng, "STREAM_ACK", ping)
    rc, out = _rng("ops.crc32", capsys)
    assert rc == 1 and "KB602" in out and "renumber" in out, out


def test_mutation_const_key_red(monkeypatch, capsys):
    import kaboodle_tpu_torch.sparseplane.rng as sprng

    def const(seed, cursor, streams):  # prng_key(0) past the cursor
        return tuple(threefry.prng_key(0) for _ in streams)

    monkeypatch.setattr(sprng, "stream_keys", const)
    rc, out = _rng("phasegraph.tick.sparse", capsys)
    assert rc == 1 and "KB603" in out, out


def test_cli_rng_usage(capsys):
    assert cli.main(["--rng", "kaboodle_tpu_torch"]) == 2
    assert cli.main(["--rng", "--write-leap", "--entries", "ops.crc32", "--device", CPU]) == 2
    assert cli.main(["rng", "--entries", "no.such.entry", "--device", CPU]) == 2
    for rid in ("KB601", "KB602", "KB603", "KB604", "KB605"):
        assert cli.main(["--explain", rid]) == 0
        assert capsys.readouterr().out.startswith(rid)
