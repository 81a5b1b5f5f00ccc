"""The port's graftconc lane (KB501-KB506) against the JAX package's.

Every KB5xx fixture of ``tests/test_conc.py`` runs through both rule sets,
at a path in each package's scope (``kaboodle_tpu_torch/serve/`` for the
port, ``kaboodle_tpu/serve/`` for JAX), and must give the same rule ids.
The fixtures that make a device value are written in torch for the port
(``torch.zeros`` for ``jnp.zeros``; ``.cpu()`` / ``.item()`` / ``.tolist()``
/ ``torch.cuda.synchronize()`` for the JAX fetches), each with a positive
and a negative case. Then the port's CLI lane: its exit codes, its
baseline round trip, the gate on the tree, and seeded mutations of the
port's real serve sources turning it red.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from kaboodle_tpu.analysis import analyze_source as jax_analyze_source
from kaboodle_tpu_torch.analysis import analyze_source
from kaboodle_tpu_torch.analysis.cli import main
from kaboodle_tpu_torch.analysis.core import REGISTRY, _load_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVE = "kaboodle_tpu_torch/serve/fixture.py"
JAX_SERVE = "kaboodle_tpu/serve/fixture.py"


def conc_of(src: str, path: str = SERVE) -> list[str]:
    """KB5xx rule ids the port's rules give on a dedented fixture."""
    return [f.rule for f in analyze_source(textwrap.dedent(src), path)
            if f.rule.startswith("KB5")]


def jax_conc_of(src: str, path: str = JAX_SERVE) -> list[str]:
    return [f.rule for f in jax_analyze_source(textwrap.dedent(src), path)
            if f.rule.startswith("KB5")]


# (fixture name, source, path suffix under the package or a bare path). The
# sources are tests/test_conc.py's, each arm of a case on its own.
SHARED = {
    "kb501_sleep_in_async": ("""
        import time
        async def handler():
            time.sleep(1)
        """, None),
    "kb501_await_sleep": ("""
        import asyncio
        async def handler():
            await asyncio.sleep(1)
        """, None),
    "kb501_lock_acquire": ("""
        async def handler(self):
            self._lock.acquire()
        """, None),
    "kb501_open": ("""
        async def handler(path):
            with open(path) as f:
                return f.read()
        """, None),
    "kb501_interprocedural": ("""
        import os
        def _flush_to_disk(fd):
            os.fsync(fd)
        async def handler(fd):
            _flush_to_disk(fd)
        """, None),
    "kb501_pragma_seeds": ("""
        import time
        def step(self):  # conc: event-loop
            time.sleep(0.1)
        """, None),
    "kb501_no_pragma": ("""
        import time
        def step(self):
            time.sleep(0.1)
        """, None),
    "kb501_offload_exempt": ("""
        import asyncio, time
        async def handler():
            await asyncio.to_thread(time.sleep, 1)
        """, None),
    "scope_server": ("""
        import time
        async def handler():
            time.sleep(1)
        """, "serve/server.py"),
    "scope_outside_package": ("""
        import time
        async def handler():
            time.sleep(1)
        """, "swim/kernels.py"),
    "scope_bare_module": ("""
        import time
        async def handler():
            time.sleep(1)
        """, "module.py"),
    "kb502_unguarded": ("""
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cache = {}  # guarded_by: _lock
            def good(self):
                with self._lock:
                    self._cache[1] = 2
            def bad(self):
                return self._cache
        """, None),
    "kb502_init_exempt": ("""
        import threading
        class C:
            def __init__(self):
                self._cache = {}  # guarded_by: _lock
                self._lock = threading.Lock()
            def get(self):
                with self._lock:
                    return self._cache
        """, None),
    "kb502_guarded_def_bad": ("""
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded_by: _lock
            @property
            def n(self):  # guarded_by: _lock
                return self._n
            def peek(self):
                return self.n
        """, None),
    "kb502_guarded_def_good": ("""
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded_by: _lock
            @property
            def n(self):  # guarded_by: _lock
                return self._n
            def peek(self):
                with self._lock:
                    return self.n
        """, None),
    "kb502_helper_inferred": ("""
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cache = {}  # guarded_by: _lock
            def outer(self):
                with self._lock:
                    self._evict()
            def _evict(self):
                self._cache.clear()
        """, None),
    "kb504_replace_without_fsync": ("""
        import os
        def publish(path, data):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)
        """, None),
    "kb504_full_protocol": ("""
        import os
        def publish(path, data):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        """, None),
    "kb505_abba": ("""
        def one():
            with _a:
                with _b:
                    pass
        def two():
            with _b:
                with _a:
                    pass
        """, None),
    "kb505_same_order": ("""
        def one():
            with _a:
                with _b:
                    pass
        def two():
            with _a:
                with _b:
                    pass
        """, None),
    "kb505_through_call": ("""
        class C:
            def alpha(self):
                with self._x:
                    self._grab_y()
            def _grab_y(self):
                with self._y:
                    pass
            def beta(self):
                with self._y:
                    with self._x:
                        pass
        """, None),
    "kb506_queue": ("import queue\nq = queue.Queue()\n", None),
    "kb506_asyncio_queue": ("import asyncio\nq = asyncio.Queue()\n", None),
    "kb506_deque": ("import collections\nd = collections.deque()\n", None),
    "kb506_simple_queue": ("import queue\nq = queue.SimpleQueue()\n", None),
    "kb506_bounded_queue": ("import queue\nq = queue.Queue(maxsize=8)\n", None),
    "kb506_bounded_deque_positional": ("import collections\nd = collections.deque([], 64)\n",
                                       None),
    "kb506_bounded_deque_kw": ("import collections\nd = collections.deque(maxlen=64)\n", None),
    "noqa_named": ("import queue\nq = queue.Queue()  # noqa: KB506\n", None),
    "noqa_foreign_code": ("import queue\nq = queue.Queue()  # noqa: KB501\n", None),
    "noqa_bare": ("import queue\nq = queue.Queue()  # noqa\n", None),
}

# KB504's checkpoint arm names each package's own checkpoint module.
CHECKPOINT_SAVE = """
    from {pkg} import checkpoint
    def spill(tree, path):
        checkpoint.save(tree, path{kw})
    """


def _paths(where):
    if where is None:
        return SERVE, JAX_SERVE
    if where == "module.py":
        return where, where
    return f"kaboodle_tpu_torch/{where}", f"kaboodle_tpu/{where}"


@pytest.mark.parametrize("name", sorted(SHARED))
def test_fixture_gives_the_jax_rule_ids(name):
    src, where = SHARED[name]
    port_path, jax_path = _paths(where)
    assert conc_of(src, port_path) == jax_conc_of(src, jax_path)


@pytest.mark.parametrize("kw, where", [("", "serve/fixture.py"),
                                       (", atomic=True", "serve/fixture.py"),
                                       ("", "checkpoint.py")])
def test_kb504_checkpoint_save_gives_the_jax_rule_ids(kw, where):
    port = conc_of(CHECKPOINT_SAVE.format(pkg="kaboodle_tpu_torch", kw=kw),
                   f"kaboodle_tpu_torch/{where}")
    assert port == jax_conc_of(CHECKPOINT_SAVE.format(pkg="kaboodle_tpu", kw=kw),
                               f"kaboodle_tpu/{where}")
    assert ("KB504" in port) == (kw == "" and where.startswith("serve/"))


def test_the_jax_fixtures_fire_as_test_conc_says():
    """The expectations of tests/test_conc.py, on the port's ids."""
    fires = {name: bool(conc_of(src, _paths(where)[0])) for name, (src, where) in SHARED.items()}
    quiet = {"kb501_await_sleep", "kb501_no_pragma", "kb501_offload_exempt",
             "scope_outside_package", "scope_bare_module", "kb502_init_exempt",
             "kb502_guarded_def_good", "kb502_helper_inferred", "kb504_full_protocol",
             "kb505_same_order", "kb506_bounded_queue", "kb506_bounded_deque_positional",
             "kb506_bounded_deque_kw", "noqa_named", "noqa_bare"}
    assert {n for n, f in fires.items() if not f} == quiet
    assert conc_of(SHARED["kb502_unguarded"][0]).count("KB502") == 1


# Device-value fixtures: JAX's in jnp, the port's rewritten in torch.
# (JAX source, torch source): the two must give the same ids.
DEVICE = {
    "kb503_into_queue": ("""
        import jax.numpy as jnp
        def producer(q):
            dev = jnp.zeros((4,))
            q.put(dev)
        """, """
        import torch
        def producer(q):
            dev = torch.zeros((4,), device="cuda")
            q.put(dev)
        """),
    "kb503_np_asarray_cuts": ("""
        import jax.numpy as jnp
        import numpy as np
        def producer(q):
            dev = jnp.zeros((4,))
            q.put(np.asarray(dev))
        """, """
        import torch
        import numpy as np
        def producer(q):
            dev = torch.zeros((4,), device="cuda")
            q.put(np.asarray(dev.cpu()))
        """),
    "kb503_item_cuts": ("""
        import jax.numpy as jnp
        def producer(q):
            dev = jnp.zeros(())
            q.put(dev.item())
        """, """
        import torch
        def producer(q):
            dev = torch.zeros((), device="cuda")
            q.put(dev.item())
        """),
    "kb503_cpu_cuts": ("""
        import jax
        import jax.numpy as jnp
        def producer(q):
            dev = jnp.zeros((4,))
            q.put(jax.device_get(dev))
        """, """
        import torch
        def producer(q):
            dev = torch.zeros((4,), device="cuda")
            q.put(dev.cpu())
        """),
    "kb503_tolist_cuts": ("""
        import jax.numpy as jnp
        def producer(q):
            dev = jnp.zeros((4,))
            q.put(dev.tolist())
        """, """
        import torch
        def producer(q):
            dev = torch.zeros((4,), device="cuda")
            q.put(dev.tolist())
        """),
    "kb503_derived_value": ("""
        import jax.numpy as jnp
        def producer(q):
            dev = jnp.zeros((4,))
            total = dev.sum()
            q.put(total)
        """, """
        import torch
        def producer(q):
            dev = torch.zeros((4,), device="cuda")
            total = dev.sum()
            q.put(total)
        """),
    "kb503_thread_args": ("""
        import threading
        import jax.numpy as jnp
        def spawn():
            x = jnp.ones((2,))
            t = threading.Thread(target=print, args=(x,))
            t.start()
        """, """
        import threading
        import torch
        def spawn():
            x = torch.ones((2,), device="cuda")
            t = threading.Thread(target=print, args=(x,))
            t.start()
        """),
    "kb503_to_thread_args": ("""
        import asyncio
        import jax.numpy as jnp
        async def spawn():
            x = jnp.ones((2,))
            await asyncio.to_thread(print, x)
        """, """
        import asyncio
        import torch
        async def spawn():
            x = torch.ones((2,), device="cuda")
            await asyncio.to_thread(print, x)
        """),
    "kb501_fetch_on_loop": ("""
        import numpy as np
        async def handler(x):
            return np.asarray(x)
        """, """
        async def handler(x):
            return x.item()
        """),
    "kb501_cpu_fetch_on_loop": ("""
        import jax
        async def handler(x):
            return jax.device_get(x)
        """, """
        async def handler(x):
            return x.cpu()
        """),
    "kb501_tolist_on_loop": ("""
        import numpy as np
        def step(self, x):  # conc: event-loop
            return np.asarray(x)
        """, """
        def step(self, x):  # conc: event-loop
            return x.tolist()
        """),
    "kb501_synchronize_on_loop": ("""
        async def handler(x):
            x.block_until_ready()
        """, """
        import torch
        async def handler(x):
            torch.cuda.synchronize()
        """),
    "kb501_fetch_offloaded": ("""
        import asyncio
        import numpy as np
        async def handler(x):
            return await asyncio.to_thread(np.asarray, x)
        """, """
        import asyncio
        async def handler(x):
            return await asyncio.to_thread(x.item)
        """),
    "kb501_fetch_off_loop": ("""
        import numpy as np
        def worker(x):
            return np.asarray(x)
        """, """
        def worker(x):
            return x.cpu().numpy()
        """),
}


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_torch_rewrite_gives_the_jax_rule_ids(name):
    jax_src, torch_src = DEVICE[name]
    got = conc_of(torch_src)
    assert got == jax_conc_of(jax_src)
    positive = name in {"kb503_into_queue", "kb503_derived_value", "kb503_thread_args",
                        "kb503_to_thread_args", "kb501_fetch_on_loop",
                        "kb501_cpu_fetch_on_loop", "kb501_tolist_on_loop",
                        "kb501_synchronize_on_loop"}
    assert bool(got) == positive, got


def test_port_scope_is_the_port_packages():
    src = SHARED["kb501_sleep_in_async"][0]
    # The JAX package's paths are out of the port's scope, and the reverse.
    assert conc_of(src, JAX_SERVE) == []
    assert jax_conc_of(src, SERVE) == []
    for path in ("kaboodle_tpu_torch/checkpoint.py", "kaboodle_tpu_torch/telemetry/manifest.py",
                 "kaboodle_tpu_torch/analysis/conc/sanitizer.py"):
        assert conc_of(src, path) == ["KB501"]


# ---------------------------------------------------------------- the CLI lane


def _write_mixed_fixture(tmp_path) -> pathlib.Path:
    """One KB506 finding at an in-scope path of the port."""
    d = tmp_path / "kaboodle_tpu_torch" / "serve"
    d.mkdir(parents=True)
    p = d / "m.py"
    p.write_text("import os\nimport queue\nq = queue.Queue()\n")
    return p


def test_cli_conc_lane_and_refused_lanes(tmp_path, monkeypatch, capsys):
    _write_mixed_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert main(["--conc", "--no-baseline", "kaboodle_tpu_torch"]) == 1
    cap = capsys.readouterr()
    assert "KB506" in cap.out and "graftconc:" in cap.err
    assert main(["conc", "--no-baseline", "kaboodle_tpu_torch"]) == 1
    assert "KB506" in capsys.readouterr().out
    # With no lane flag the AST lane (graftlint) runs: the fixture's unused
    # import is KB102, and the conc rule stays out of it; --all takes no path.
    for argv in ([], ["--no-baseline", "kaboodle_tpu_torch"]):
        assert main(argv) == 1, argv
        cap = capsys.readouterr()
        assert "KB102" in cap.out and "KB506" not in cap.out and "graftlint:" in cap.err
    assert main(["--all", "kaboodle_tpu_torch"]) == 2
    assert "does not take paths" in capsys.readouterr().err


def test_conc_baseline_roundtrip(tmp_path, monkeypatch, capsys):
    _write_mixed_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    bl = ["--baseline", "bl.json"]
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 1
    assert main(["--conc", *bl, "--write-baseline", "kaboodle_tpu_torch"]) == 0
    assert (tmp_path / "bl.json").exists()
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 0
    assert main(["--conc", *bl, "--no-baseline-growth", "kaboodle_tpu_torch"]) == 0
    assert main(["--conc", "--no-baseline", "kaboodle_tpu_torch"]) == 1
    capsys.readouterr()

    # A stale entry fails the growth gate, not the plain run.
    data = json.loads((tmp_path / "bl.json").read_text())
    data["entries"].append({"key": "gone.py::KB506::Queue", "reason": "stale"})
    (tmp_path / "bl.json").write_text(json.dumps(data))
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 0
    assert main(["--conc", *bl, "--no-baseline-growth", "kaboodle_tpu_torch"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out

    # A new finding fails both.
    (tmp_path / "kaboodle_tpu_torch" / "serve" / "n.py").write_text(
        "import collections\nd = collections.deque()\n")
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 1
    assert "KB506" in capsys.readouterr().out


def test_conc_baseline_requires_justification(tmp_path, monkeypatch):
    _write_mixed_fixture(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "bl.json").write_text(json.dumps({"entries": [{"key": "a.py::KB506::Queue"}]}))
    assert main(["--conc", "--baseline", "bl.json", "kaboodle_tpu_torch"]) == 2


def test_cli_explain_and_list_cover_kb5(capsys):
    _load_rules()
    # The conc rules, beside every other family of the JAX registry.
    assert sorted(r for r in REGISTRY if r.startswith("KB5")) == [
        "KB501", "KB502", "KB503", "KB504", "KB505", "KB506"]
    assert sorted(REGISTRY) == [
        "KB101", "KB102", "KB103", "KB104", "KB201", "KB202", "KB203", "KB204", "KB205",
        "KB301", "KB302", "KB401", "KB402", "KB403", "KB404", "KB405",
        "KB501", "KB502", "KB503", "KB504", "KB505", "KB506",
        "KB601", "KB602", "KB603", "KB604", "KB605"]
    for rid in REGISTRY:
        assert REGISTRY[rid].explain.strip()
    assert main(["--explain", "KB505"]) == 0
    assert main(["--explain", "kb503"]) == 0
    assert "torch." in capsys.readouterr().out
    assert main(["--list-rules"]) == 0
    assert main(["--explain", "KB101"]) == 0
    assert main(["--explain", "KB999"]) == 2


def test_repo_is_conc_clean_under_baseline():
    """The gate on the tree, as it is run: every baselined stall justified,
    no stale entry."""
    proc = subprocess.run(
        [sys.executable, "-m", "kaboodle_tpu_torch.analysis", "--conc", "--no-baseline-growth"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads((REPO / "kaboodle_tpu_torch/analysis/conc/baseline.json").read_text())
    assert data["entries"] and all(e["reason"].strip() for e in data["entries"])


# ---------------------------------------------------------------- seeded mutations


def _copy_serve(tmp_path, *names) -> pathlib.Path:
    """Copy real serve modules of the port into a bare tmp tree."""
    dst = tmp_path / "kaboodle_tpu_torch" / "serve"
    dst.mkdir(parents=True)
    for n in names:
        (dst / n).write_text((REPO / "kaboodle_tpu_torch" / "serve" / n).read_text())
    return dst


MUTANT_ABBA = '''

class _MutantInversion:
    """Seeded KB505: the writer path and the poll path disagree on order."""

    def writer_side(self):
        with self._lock:
            with self._io_lock:
                pass

    def poll_side(self):
        with self._io_lock:
            with self._lock:
                pass
'''

MUTANT_DEVICE = '''

import torch as _mtorch


def _mutant_handoff(q):
    """Seeded KB503: a device tensor crosses into the writer thread."""
    dev = _mtorch.zeros((4,), dtype=_mtorch.int32, device="cuda")
    q.put(dev)
'''


def test_seeded_lock_order_inversion_turns_gate_red(tmp_path, monkeypatch, capsys):
    d = _copy_serve(tmp_path, "spill.py")
    monkeypatch.chdir(tmp_path)
    assert main(["--conc", "--no-baseline", "kaboodle_tpu_torch"]) == 0  # pristine
    with open(d / "spill.py", "a") as f:
        f.write(MUTANT_ABBA)
    capsys.readouterr()
    assert main(["--conc", "--no-baseline", "kaboodle_tpu_torch"]) == 1
    assert "KB505" in capsys.readouterr().out


def test_seeded_device_handoff_turns_gate_red(tmp_path, monkeypatch, capsys):
    d = _copy_serve(tmp_path, "spill.py")
    monkeypatch.chdir(tmp_path)
    with open(d / "spill.py", "a") as f:
        f.write(MUTANT_DEVICE)
    assert main(["--conc", "--no-baseline", "kaboodle_tpu_torch"]) == 1
    assert "KB503" in capsys.readouterr().out


@pytest.mark.parametrize("mutation", ["os.fsync(0)", "torch.cuda.synchronize()"])
def test_seeded_stall_on_round_loop_turns_gate_red(tmp_path, monkeypatch, capsys, mutation):
    d = _copy_serve(tmp_path, "engine.py")
    # engine.py carries justified baselined stalls: run against the port's
    # committed baseline (absent modules' entries are stale, which the
    # plain mode tolerates) so ONLY the mutation is new.
    (tmp_path / "bl.json").write_text(
        (REPO / "kaboodle_tpu_torch/analysis/conc/baseline.json").read_text())
    monkeypatch.chdir(tmp_path)
    bl = ["--baseline", "bl.json"]
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 0  # pristine
    src = (d / "engine.py").read_text()
    marker = "def step(self) -> list[dict]:  # conc: event-loop\n"
    assert marker in src
    (d / "engine.py").write_text(src.replace(marker, marker + f"        {mutation}\n", 1))
    capsys.readouterr()
    assert main(["--conc", *bl, "kaboodle_tpu_torch"]) == 1
    out = capsys.readouterr().out
    assert "KB501" in out and "step" in out


def test_seeded_mutation_red_via_module_entrypoint(tmp_path):
    d = _copy_serve(tmp_path, "spill.py")
    with open(d / "spill.py", "a") as f:
        f.write(MUTANT_ABBA)
    proc = subprocess.run(
        [sys.executable, "-m", "kaboodle_tpu_torch.analysis", "--conc", "--no-baseline",
         "kaboodle_tpu_torch"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "KB505" in proc.stdout
