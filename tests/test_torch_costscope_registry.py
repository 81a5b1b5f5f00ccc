"""The port's entry-point registry against the JAX package's, entry by entry.

``kaboodle_tpu_torch/analysis/ir/registry.py`` must carry the JAX
registry's 31 names in its order with the same ``sharded`` flags, and
every entry's outputs must equal the JAX entry's ``fn(*example_args)`` on
the CPU: every leaf bit for bit (``ops.crc32``'s value compared exactly:
the port's CRC is an int64 of the unsigned word, JAX's a uint32). Both
registries build their example arguments from the same fixed seeds. The
JAX entries are jitted once each. The four sharded entries run in one
gloo job of 8 ranks (the costscope case of ``parallel/worker.py``, started
once by a module fixture), rank 0 writing the gathered outputs; JAX runs
its sharded twins on the conftest's 8 virtual CPU devices.
"""

import numpy as np
import pytest
import torch

import jax

from kaboodle_tpu.analysis.ir import registry as jreg
from kaboodle_tpu_torch.analysis.ir import registry as treg

NAMES = [e.name for e in treg.ENTRY_POINTS]
ONE_DEVICE = [e.name for e in treg.ENTRY_POINTS if not e.sharded]
SHARDED = [e.name for e in treg.ENTRY_POINTS if e.sharded]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toy-size tensor ops run fastest on one thread, and leave the other
    test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sharded_outputs(tmp_path_factory):
    """The gloo job of the sharded entries, started before the module's
    JAX compiles so the two overlap; its outputs loaded on first use."""
    from kaboodle_tpu_torch.costscope.extract import MESH_DEVICES
    from kaboodle_tpu_torch.parallel.worker import start_workers

    tmp = tmp_path_factory.mktemp("costscope_registry")
    out = str(tmp / "outputs.npz")
    spec = {"device": "cpu", "timeout_s": 300,
            "cases": [{"name": "costscope", "kind": "costscope", "entries": SHARDED,
                       "out": out}]}
    job = start_workers(MESH_DEVICES, spec, str(tmp / "cases.json"), timeout_s=300)
    loaded = {}

    def get(name):
        if not loaded:
            job.wait()
            with np.load(out) as z:
                loaded.update({k: z[k] for k in z.files})
        return {k.split("|", 1)[1]: v for k, v in loaded.items() if k.startswith(name + "|")}

    yield get
    if not loaded:
        job.wait()


def _jax_outputs(name: str) -> dict:
    fn, args = jreg.select_entries([name])[0].build()
    return treg.output_arrays(jax.jit(fn)(*args))


def _assert_same(want: dict, got: dict, name: str):
    assert sorted(got) == sorted(want), name
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{name}: {k} {g.shape} != {w.shape}"
        if w.dtype == np.uint32 and g.dtype == np.int64:  # the port's wide CRC word
            np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=f"{name}: {k}")
            continue
        # uint32 leaves are the port's int32 bits of the same words.
        assert g.dtype == w.dtype or (w.dtype == np.uint32 and g.dtype == np.int32), (
            f"{name}: {k} {g.dtype} != {w.dtype}")
        assert g.tobytes() == w.tobytes(), f"{name}: {k} differs"


def test_names_order_and_flags_equal_jax():
    assert NAMES == [e.name for e in jreg.ENTRY_POINTS]
    assert len(NAMES) == 31
    assert [e.sharded for e in treg.ENTRY_POINTS] == [e.sharded for e in jreg.ENTRY_POINTS]
    assert [e.lean for e in treg.ENTRY_POINTS] == [e.lean for e in jreg.ENTRY_POINTS]
    assert (treg.TRACE_N, treg.TRACE_E, treg.LEAP_K) == (jreg.TRACE_N, jreg.TRACE_E, jreg.LEAP_K)
    assert treg.select_entries(["ops.crc32", "serve.leap"]) == (
        treg.ENTRY_POINTS[-1], treg.ENTRY_POINTS[23])
    with pytest.raises(KeyError):
        treg.select_entries(["no.such.entry"])


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_entry_outputs_equal_jax(sharded_outputs, name):
    fn, args = treg.select_entries([name])[0].build("cpu")
    _assert_same(_jax_outputs(name), treg.output_arrays(fn(*args)), name)


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_entry_outputs_equal_jax(sharded_outputs, name):
    _assert_same(_jax_outputs(name), sharded_outputs(name), name)


def test_entries_build_on_the_card_unless_told(monkeypatch):
    """No card and no device: a build raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.select_entries(["phasegraph.tick.faulty"])[0].build()
