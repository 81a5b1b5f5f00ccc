"""The harness finds every cell's configuration, traffic and metric readers by name."""

import json

import pytest

from portbench import spec
from portbench.spec import end_to_end_reader

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    cell = spec.find_cell(workload)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert cell.traffic["start"] in ("fresh", "converged")
    assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader_found(metric):
    assert callable(spec.metric_reader(metric))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_end_to_end_reader_found(metric):
    assert callable(end_to_end_reader(metric))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(entry):
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key in cfg


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no_such_cell")


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    """A cell, a mix and a metric added as files and entries need no code."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    cfg = json.loads((spec.ROOT / "portbench/configs/swim8k_full.json").read_text())
    (tmp_path / "portbench/configs/x.json").write_text(json.dumps(cfg))
    bench = {"configs": [{"name": "x", "file": "portbench/configs/x.json"}],
             "workloads": [{"name": "w", "config": "x", "traffic": "rest", "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "syncs_per_tick", "workloads": ["w"]},
                           {"name": "boot_device_s", "workloads": ["other"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("w", root=tmp_path)
    assert cell.config["n"] == cfg["n"] and cell.traffic == spec.load_traffic("rest")
    assert [m["name"] for m in cell.per_layer] == ["syncs_per_tick"]


@pytest.mark.parametrize("side", ["Program", "Reference"])
def test_each_configuration_has_its_engine(side):
    for entry in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / entry["file"]).read_text())
        assert isinstance(getattr(spec.engine(cfg["engine"]["tick"]), side), type)


def test_unknown_engine_fails_on_both_sides(tmp_path):
    """A configuration naming an engine with no file is refused before set-up,
    and neither the program's nor the reference's side can be built."""
    from portbench.control import control_factory
    from portbench.run import port

    with pytest.raises(KeyError, match="no engines file"):
        spec.engine("no_such_engine")
    cfg = json.loads((spec.ROOT / "portbench/configs/swim8k_full.json").read_text())
    cfg["engine"] = {"tick": "no_such_engine"}
    for factory in (port, control_factory):
        with pytest.raises(KeyError, match="no_such_engine"):
            factory(cfg, spec.load_traffic("rest"), "cpu")
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench/configs/x.json").write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "x", "file": "portbench/configs/x.json"}],
        "workloads": [{"name": "w", "config": "x", "traffic": "rest", "chips": 1}],
        "end_to_end": [], "per_layer": []}))
    with pytest.raises(KeyError, match="no_such_engine"):
        spec.find_cell("w", root=tmp_path)


def test_a_new_engine_is_a_file(tmp_path):
    """An engine added as a file is found by its name, with its own hooks."""
    (tmp_path / "engines").mkdir()
    (tmp_path / "engines" / "fake.py").write_text(
        "class Program: pass\nclass Reference: pass\ndef follow(*a): return 'own'\n")
    eng = spec.engine("fake", pkg=tmp_path)
    assert eng.follow() == "own" and not hasattr(eng, "Session")


@pytest.mark.parametrize("name,base", [("peer_ticks_per_s.rest", "peer_ticks_per_s"),
                                       ("tick_ms_p95.anything", "tick_ms_p95")])
def test_split_name_falls_back_to_its_base(name, base):
    assert spec.end_to_end_reader(name) is spec.end_to_end_reader(base)


def test_split_fallback_is_for_metrics_only():
    with pytest.raises(KeyError):
        spec.metric_reader("no_such_metric.part")
    with pytest.raises(KeyError):
        spec.engine("dense.part")
