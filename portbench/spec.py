"""Finding a cell's pieces by name: its configuration, traffic and metric readers.

``BENCHMARK.json`` at the root of the checkout names every cell, its
configuration and its traffic mix, and every metric. A configuration is
read from the file its entry names, its engine from
``portbench/engines/<engine.tick>.py``, a traffic mix from
``portbench/traffic/<traffic>.json``, a per-layer metric's reader from
``portbench/metrics/<metric>.py`` and an end-to-end metric's from
``portbench/end_to_end/<metric>.py``. A split metric name
(``<base>.<part>``, one quantity with a bound or a cell list of its own)
with no file of its own is read by ``<base>.py``. Adding a cell, a mix, an
engine or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its pieces loaded."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    engine(config["engine"]["tick"])  # an unknown engine fails here, before any set-up
    return Cell(
        name=name, config=config, traffic=load_traffic(w["traffic"]), chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load(kind: str, name: str, split: bool = False, pkg: Path = PKG):
    """The module of ``<pkg>/<kind>/<name>.py``, loaded once. With ``split``
    a name ``<base>.<part>`` that has no file of its own falls back to
    ``<base>.py``. A name with no file raises ``KeyError``."""
    d = pkg / kind
    path = d / f"{name}.py"
    if split and not path.is_file():
        path = d / f"{name.split('.', 1)[0]}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file for {name!r}: {d / (name + '.py')} is missing")
    key = f"portbench.{kind}.{path.stem.replace('.', '_')}"
    if pkg != PKG:
        key = f"{key}@{pkg}"
    mod = sys.modules.get(key)
    if mod is None:
        s = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(s)
        sys.modules[key] = mod
        try:
            s.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


def engine(name: str, pkg: Path = PKG):
    """The engine ``portbench/engines/<name>.py``: its ``Program`` and
    ``Reference`` adapters, and any ``Session``, ``follow`` or ``compare``
    of its own (``engines/__init__.py``)."""
    return load("engines", name, pkg=pkg)


def metric_reader(name: str):
    """The ``read(trace_ctx)`` of the per-layer metric ``name``."""
    return load("metrics", name, split=True).read


def end_to_end_reader(name: str):
    """The ``read(window_ctx)`` of the end-to-end metric ``name``."""
    return load("end_to_end", name, split=True).read
