"""No JAX: the reference's imports by AST, a run's modules by whole top-level name."""

import subprocess
import sys

from portbench import guard, spec


def test_reference_imports_nothing_forbidden():
    assert guard.reference_forbidden() == {}
    names = set().union(*(guard.imports_of(p) for p in guard.REFERENCE_DIR.glob("*.py")))
    assert names <= {"__future__", "dataclasses", "torch", "portbench"}, names


def test_top_level_names_are_compared_whole(tmp_path):
    assert guard.loaded_forbidden({"kaboodle_tpu_torch", "kaboodle_tpu_torch.sim"}) == []
    assert guard.loaded_forbidden({"kaboodle_tpu.sim", "jaxlib", "jax_extra"}) == [
        "jaxlib", "kaboodle_tpu.sim"]
    bad = tmp_path / "x.py"
    bad.write_text("import kaboodle_tpu_torch.sim\nfrom jax import numpy\n")
    (tmp_path / "ok.py").write_text("import kaboodle_tpu_torchy\n")
    assert guard.reference_forbidden(tmp_path) == {"x.py": ["jax", "kaboodle_tpu_torch"]}


def test_a_harness_run_loads_no_jax():
    """Import everything a run imports, drive a small cell, list what loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.conftest import run_small\n"
        "from portbench.run import port\n"
        "from portbench import guard\n"
        "r, _ = run_small('steady8k', port, seconds=0.2)\n"
        "assert r['correct']\n"
        "print(guard.loaded_forbidden())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "churn8k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
