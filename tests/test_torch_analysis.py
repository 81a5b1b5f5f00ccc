"""The port's AST lane (graftlint: KB1xx-KB3xx) against the JAX package's.

KB101-KB104 are rule for rule the JAX lane's: every source snippet of the
JAX package's own fixtures (``tests/test_analysis.py``) and every file of
``kaboodle_tpu_torch/`` give the same KB1xx findings through both
analyzers. KB2xx/KB3xx have their torch meanings (a Python branch or a
coercion on a device value in per-tick code is a host sync; a counter-RNG
key drawn twice; host copies and dtype-less constructors): a positive and
a negative fixture each. Then the lane through ``cli.main``: the tree is
clean under ``kaboodle_tpu_torch/analysis/baseline.json``, and one seeded
mutation of the real ``phasegraph/exec.py`` per rule family turns it red.
Pure AST: nothing here runs torch.
"""

from __future__ import annotations

import ast
import json
import pathlib
import shutil
import textwrap

import pytest

from kaboodle_tpu.analysis import analyze_source as jax_analyze_source
from kaboodle_tpu.analysis.core import analyze_path as jax_analyze_path
from kaboodle_tpu_torch.analysis import analyze_source
from kaboodle_tpu_torch.analysis.cli import main
from kaboodle_tpu_torch.analysis.core import DEFAULT_BASELINE, analyze_path, noqa_codes

REPO = pathlib.Path(__file__).resolve().parent.parent
EXEC = "kaboodle_tpu_torch/phasegraph/exec.py"
HOT = "kaboodle_tpu_torch/phasegraph/exec.py"


def _kb1(findings) -> list[tuple]:
    return sorted((f.rule, f.line, f.symbol, f.message) for f in findings
                  if f.rule.startswith("KB1"))


def rules_of(src: str, path: str = "module.py") -> list[str]:
    return [f.rule for f in analyze_source(textwrap.dedent(src), path)]


def _jax_snippets() -> list[str]:
    """Every string constant of the JAX lane's fixture file that parses as
    a module: the fixtures its rule tests feed the analyzer."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "\n" in node.value:
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            if src.strip() and src not in out:
                out.append(src)
    return out


SNIPPETS = _jax_snippets()
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "kaboodle_tpu_torch").rglob("*.py"))


# ---------------------------------------------------------------------------
# KB1xx: the JAX lane's findings, rule for rule


def test_jax_fixture_snippets_were_found():
    assert len(SNIPPETS) >= 20


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_kb1xx_equal_on_jax_fixture(i):
    src = SNIPPETS[i]
    for path in ("module.py", "kaboodle_tpu_torch/ops/crc32.py"):
        assert _kb1(analyze_source(src, path)) == _kb1(jax_analyze_source(src, path)), src


@pytest.mark.parametrize("path", PORT_FILES)
def test_kb1xx_equal_on_port_file(path):
    p = REPO / path
    assert _kb1(analyze_path(p)) == _kb1(jax_analyze_path(p)), path


def test_kb1xx_cases():
    assert "KB101" in rules_of("x = deleted_function()\n")
    assert "KB102" in rules_of("import os\n")
    assert "KB102" not in rules_of("from __future__ import annotations\nfrom x import y\n"
                                   "__all__ = ['y']\n")
    assert "KB103" in rules_of("def f(a, b=[]):\n    return b\n")
    assert "KB104" in rules_of("def f(type):\n    return type\n")
    assert "KB104" not in rules_of("id = 3  # noqa: KB104\n")
    assert noqa_codes("x = 1  # noqa: KB104, KB201") == frozenset({"KB104", "KB201"})


# ---------------------------------------------------------------------------
# KB2xx: the JAX tracer rules' torch meanings, in per-tick code

TICK = """
import torch

def make_tick_fn(cfg, faulty=True):
    def tick(st, inp):
{body}
        return st
    return tick
"""


def _tick(body: str) -> str:
    return TICK.format(body=textwrap.indent(textwrap.dedent(body), " " * 8))


def test_kb201_branch_on_device_value():
    assert rules_of(_tick("if st.alive.any():\n    st = st\n"), HOT).count("KB201") == 1
    assert rules_of(_tick("while inp.kill.any():\n    break\n"), HOT).count("KB201") == 1
    assert rules_of(_tick("x = st.alive or inp.kill\n"), HOT).count("KB201") == 1
    assert rules_of(_tick("x = 1 if st.alive.any() else 0\n"), HOT).count("KB201") == 1


def test_kb201_structural_and_static_exempt():
    src = _tick("""
        n = st.state.shape[-1]
        if n > 4 and st.latency is not None and st.state.dtype == torch.int8:
            st = st
        if faulty:
            st = st
        if isinstance(st.tick, torch.Tensor) and st.device.type == "cuda":
            st = st
        """)
    assert "KB201" not in rules_of(src, HOT)
    # The builder itself runs once on the host: a branch there is not hot.
    assert "KB201" not in rules_of("def make_tick_fn(cfg):\n    if cfg.x:\n        pass\n", HOT)
    # Only the engine builders' closures are seeds.
    assert "KB201" not in rules_of(_tick("if st.alive.any():\n    st = st\n"),
                                   "kaboodle_tpu_torch/serve/server.py")


def test_kb202_coercions():
    src = _tick("""
        a = int(st.tick)
        b = st.alive.any().item()
        c = st.key.tolist()
        d = int(st.state.shape[0])
        """)
    assert rules_of(src, HOT).count("KB202") == 3
    # The coerced value is a host value: branching on it is not a second sync.
    src = _tick("go = bool(st.alive.any())\nif go:\n    st = st\n")
    assert rules_of(src, HOT).count("KB202") == 1 and "KB201" not in rules_of(src, HOT)


def test_kb203_print():
    assert rules_of(_tick("print(st.tick)\n"), HOT).count("KB203") == 1
    assert "KB203" not in rules_of("def f(x):\n    print(x)\n    return x\n", HOT)


def test_pragma_seeds_a_per_tick_function():
    src = """
    def step(st):  # graftlint: traced
        if st.alive.any():
            return st
        return st
    """
    assert "KB201" in rules_of(src)
    assert "KB201" not in rules_of(src.replace("  # graftlint: traced", ""))


KEYS = """
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.phasegraph import rng

def f(seed, cursor, dev):
    k = rng.stream_key(seed, cursor, rng.STREAM_PING)
{body}
"""


def test_kb204_key_reuse():
    two = "a = threefry.uniform(k, (4,), dev)\nb = threefry.uniform(k, (4,), dev)\n"
    src = KEYS.format(body=textwrap.indent(two, "    "))
    assert rules_of(src).count("KB204") == 1
    refold = ("a = threefry.uniform(k, (4,), dev)\nk = threefry.fold_in(k, 1)\n"
              "b = threefry.uniform(k, (4,), dev)\n")
    assert "KB204" not in rules_of(KEYS.format(body=textwrap.indent(refold, "    ")))
    arms = ("if seed:\n    a = threefry.uniform(k, (4,), dev)\nelse:\n"
            "    a = threefry.gumbel_order_bits(k, (4,), dev)\n")
    assert "KB204" not in rules_of(KEYS.format(body=textwrap.indent(arms, "    ")))


def test_kb205_documented_never_fires():
    src = "import jax\nf = jax.jit(lambda x: x, donate_argnums=0)\ndef g(x):\n    f(x)\n    return x\n"
    assert "KB205" in [f.rule for f in jax_analyze_source(src)]
    assert "KB205" not in rules_of(src)


# ---------------------------------------------------------------------------
# KB3xx: hot-path scoping


def test_kb301_host_copies_in_per_tick_code():
    src = _tick("""
        a = st.key.cpu()
        b = st.tick.to("cpu")
        torch.cuda.synchronize()
        """)
    assert rules_of(src, HOT).count("KB301") == 3
    assert "KB301" not in rules_of(src, "kaboodle_tpu_torch/transport/codec.py")
    src = "import numpy as np\nimport torch\n" + _tick("a = np.asarray(st.state)\nb = np.zeros(4)\n")
    assert rules_of(src, HOT).count("KB301") == 1  # numpy on a device value only


def test_kb302_dtype_discipline():
    src = "import torch\nx = torch.zeros((4, 4))\ny = torch.arange(4)\n"
    ok = "import torch\nx = torch.zeros((4, 4), dtype=torch.int8)\ny = torch.arange(4, dtype=torch.int32)\n"
    assert rules_of(src, "kaboodle_tpu_torch/ops/crc32.py").count("KB302") == 2
    assert "KB302" not in rules_of(ok, "kaboodle_tpu_torch/ops/crc32.py")
    assert "KB302" not in rules_of(src, "kaboodle_tpu_torch/transport/codec.py")
    assert "KB302" not in rules_of(src, "kaboodle_tpu_torch/analysis/core.py")
    for path in ("kaboodle_tpu_torch/fleet/core.py", "kaboodle_tpu_torch/phasegraph/blocked.py",
                 "kaboodle_tpu_torch/sparseplane/repair.py"):
        assert "KB302" in rules_of(src, path), path


# ---------------------------------------------------------------------------
# the lane through cli.main


def test_tree_is_clean_under_its_baseline(monkeypatch):
    monkeypatch.chdir(REPO)
    assert main(["--no-baseline-growth"]) == 0
    data = json.loads((REPO / DEFAULT_BASELINE).read_text())
    assert data["entries"] and all(e["reason"].strip() for e in data["entries"])


def test_baseline_roundtrip_and_justification(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.py").write_text("import os\n")
    bl = ["--baseline", "bl.json"]
    assert main([*bl, "a.py"]) == 1
    assert main([*bl, "--write-baseline", "a.py"]) == 0
    assert main([*bl, "a.py"]) == 0
    data = json.loads((tmp_path / "bl.json").read_text())
    data["entries"].append({"key": "gone.py::KB102::os", "reason": "stale"})
    (tmp_path / "bl.json").write_text(json.dumps(data))
    assert main([*bl, "a.py"]) == 0
    assert main([*bl, "--no-baseline-growth", "a.py"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    (tmp_path / "bl.json").write_text(json.dumps({"entries": [{"key": "a.py::KB102::os"}]}))
    assert main([*bl, "a.py"]) == 2
    (tmp_path / "b.py").write_text("def broken(:\n")
    assert main(["--no-baseline", "b.py"]) == 1
    assert "KB100" in capsys.readouterr().out


def test_baseline_records_how_often_each_key_occurs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.py").write_text("def f():\n    list = 1\n    return list\n")
    bl = ["--baseline", "bl.json"]
    assert main([*bl, "--write-baseline", "a.py"]) == 0
    data = json.loads((tmp_path / "bl.json").read_text())
    assert [(e["key"], e["count"]) for e in data["entries"]] == [("a.py::KB104::list", [1])]
    # A second occurrence under the same key: baselined, but its count rose.
    (tmp_path / "a.py").write_text("def f():\n    list = 1\n    list = 2\n    return list\n")
    capsys.readouterr()
    assert main([*bl, "a.py"]) == 1
    assert "rose to [2] from the recorded [1]" in capsys.readouterr().out
    # A count that fell passes, but not under --no-baseline-growth.
    data["entries"][0]["count"] = [3]
    (tmp_path / "bl.json").write_text(json.dumps(data))
    assert main([*bl, "a.py"]) == 0
    assert main([*bl, "--no-baseline-growth", "a.py"]) == 1
    assert "fell to [2] from the recorded [3]" in capsys.readouterr().out
    # A baselined key with no recorded count is red; a malformed count is a usage error.
    del data["entries"][0]["count"]
    (tmp_path / "bl.json").write_text(json.dumps(data))
    assert main([*bl, "a.py"]) == 1
    assert "has no recorded count" in capsys.readouterr().out
    data["entries"][0]["count"] = "1"
    (tmp_path / "bl.json").write_text(json.dumps(data))
    assert main([*bl, "a.py"]) == 2


def test_count_gate_semantics():
    from kaboodle_tpu_torch.analysis.core import count_findings

    base = {"a.py::KB202::f.bool()": "a gate", "b.py::KB202::g.int()": "a gate"}
    recorded = {"a.py::KB202::f.bool()": (2, 3, 1)}

    def symbols(measured, no_growth=False):
        return sorted(f.symbol for f in count_findings(measured, recorded, base, no_growth))

    key = "a.py::KB202::f.bool()"
    assert symbols({key: (2, 3, 1)}, True) == []
    assert symbols({key: (2, 4, 1)}) == ["f.bool():count-rose"]
    assert symbols({key: (3, 2, 0)}) == ["f.bool():count-rose"]  # any run that rose
    assert symbols({key: (1, 3, 1)}) == []
    assert symbols({key: (1, 3, 1)}, True) == ["f.bool():count-fell"]
    assert symbols({"b.py::KB202::g.int()": (1,)}) == ["g.int():count-missing"]
    assert symbols({"c.py::KB202::h.int()": (5,)}) == []  # unbaselined: a finding already


MUTATIONS = {
    # An .item() in a make_tick_fn closure: a host sync every tick.
    "item_in_tick": ("        t = st.tick  # read on the device, never fetched\n",
                     "        t = st.tick  # read on the device, never fetched\n"
                     "        _t_host = st.tick.item()\n", "KB202"),
    # A dtype-less arange in a dtype-disciplined file.
    "dtypeless_arange": ("        idx = torch.arange(n, dtype=torch.int32, device=dev)",
                         "        idx = torch.arange(n, device=dev).to(torch.int32)", "KB302"),
    # A second gate in the tick, whose gates are baselined: no new key
    # (keys name the function), only the key's recorded count rises.
    "second_gate_in_tick": ("        return _rest() if bool(pred) else _fast()\n",
                            "        _pred_again = bool(pred)\n"
                            "        return _rest() if bool(pred) else _fast()\n", "count rose"),
    # One key drawn twice.
    "key_reused": ("        key_proxy, key_ping, key_bern, key_drop = "
                   "pg_rng.state_draw_keys(st.key, t)\n",
                   "        key_proxy, key_ping, key_bern, key_drop = "
                   "pg_rng.state_draw_keys(st.key, t)\n"
                   "        _u0 = threefry.uniform(key_ping, (n,), dev)\n"
                   "        _u1 = threefry.uniform(key_ping, (n,), dev)\n", "KB204"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_seeded_mutation_turns_the_lane_red(name, tmp_path, monkeypatch, capsys):
    old, new, rule = MUTATIONS[name]
    dst = tmp_path / EXEC
    dst.parent.mkdir(parents=True)
    shutil.copy(REPO / EXEC, dst)
    monkeypatch.chdir(tmp_path)
    bl = ["--baseline", str(REPO / DEFAULT_BASELINE)]
    assert main([*bl, EXEC]) == 0  # the pristine copy is clean under the baseline
    src = dst.read_text()
    assert old in src, f"mutation anchor missing: {old!r}"
    dst.write_text(src.replace(old, new, 1))
    capsys.readouterr()
    assert main([*bl, EXEC]) == 1
    out = capsys.readouterr().out
    assert rule in out, out
