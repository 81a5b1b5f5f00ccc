"""The port's ``profiling.py`` against the JAX package's, on the same metrics.

Each case of ``tests/test_profiling.py``, held to the JAX function: the
tick table and the log lines of the same 16-peer run through both engines,
the warp tables and summaries (degenerate shapes included) on the same
inputs, the fleet summary of the same ``[T, E]`` metrics, and the
bit-equality predicates on the same pairs. ``trace`` writes a Chrome trace
on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kaboodle_tpu import profiling as jprof
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.sim import idle_inputs as jax_idle_inputs
from kaboodle_tpu.sim import init_state as jax_init_state
from kaboodle_tpu.sim import simulate as jax_simulate
from kaboodle_tpu.sim.state import TickMetrics as JaxTickMetrics
from kaboodle_tpu_torch import profiling as tprof
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.sim.runner import simulate
from kaboodle_tpu_torch.sim.state import TickMetrics, idle_inputs, init_state

N, TICKS = 16, 6


@pytest.fixture(scope="module")
def runs():
    """The same boot run through both engines: ``(jax_metrics, metrics)``."""
    _, jm = jax_simulate(jax_init_state(N, seed=1), jax_idle_inputs(N, ticks=TICKS),
                         JaxSwimConfig())
    _, tm = simulate(init_state(N, seed=1, device="cpu"),
                     idle_inputs(N, ticks=TICKS, device="cpu"), SwimConfig())
    return jm, tm


def assert_tables_equal(want: np.ndarray, got: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    for name in want.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def both_metrics(rows: dict):
    """One set of per-tick numpy columns as JAX and as port ``TickMetrics``
    (uint32 fingerprints carried as int32 bits in the port)."""
    jm = JaxTickMetrics(**rows)
    tm = TickMetrics(**{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                        for k, v in rows.items()})
    return jm, tm


def test_tick_stats_table_matches_jax(runs):
    jm, tm = runs
    table = tprof.tick_stats(tm)
    assert_tables_equal(jprof.tick_stats(jm), table)
    assert table.shape == (TICKS,)
    assert table["converged"][-1] and table["mean_membership"][-1] == float(N)
    assert (table["fingerprint_min"] == table["fingerprint_max"])[-1]


def test_log_run_lines_match_jax(runs):
    jm, tm = runs
    want, got = [], []
    jprof.log_run(jm, emit=want.append)
    tprof.log_run(tm, emit=got.append)
    assert got == want and len(got) == TICKS
    assert all(line.startswith("tick ") for line in got) and "CONVERGED" in got[-1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        simulate(init_state(8, seed=1, device="cpu"), idle_inputs(8, ticks=2, device="cpu"),
                 SwimConfig())
    files = list(tmp_path.rglob("*.pt.trace.json"))
    assert files, "profiler trace produced no files"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_warp_stats_all_leaped_is_empty_table():
    want = jprof.warp_stats(np.zeros((0,), np.int32), None)
    got = tprof.warp_stats(np.zeros((0,), np.int32), None)
    assert got.shape == (0,) and got.dtype == want.dtype
    assert "messages_delivered" in got.dtype.names


def test_warp_stats_rewrites_tick_column():
    jm, tm = both_metrics(dict(
        messages_delivered=np.asarray([3, 4], np.int32),
        converged=np.asarray([False, True]),
        agree_fraction=np.asarray([0.5, 1.0], np.float32),
        mean_membership=np.asarray([2.0, 2.0], np.float32),
        fingerprint_min=np.asarray([1, 0xFFFFFFF2], np.uint32),
        fingerprint_max=np.asarray([9, 0xFFFFFFF2], np.uint32),
    ))
    ticks = np.asarray([7, 19], np.int32)
    got = tprof.warp_stats(ticks, tm)
    assert_tables_equal(jprof.warp_stats(ticks, jm), got)
    np.testing.assert_array_equal(got["tick"], [7, 19])


@pytest.mark.parametrize("dense, total", [(0, 64), (0, 0), (3, 8)])
def test_warp_summary_matches_jax(dense, total):
    ticks = np.arange(dense, dtype=np.int32)
    rows = dict(messages_delivered=np.arange(dense, dtype=np.int32) * 5,
                converged=np.ones(dense, bool), agree_fraction=np.ones(dense, np.float32),
                mean_membership=np.ones(dense, np.float32),
                fingerprint_min=np.zeros(dense, np.uint32),
                fingerprint_max=np.zeros(dense, np.uint32))
    jm, tm = both_metrics(rows) if dense else (None, None)
    got = tprof.warp_summary(ticks, total, tm)
    assert got == jprof.warp_summary(ticks, total, jm)
    if not dense:
        assert got["dense_fraction"] == 0.0 and got["mean_msgs_per_dense_tick"] == 0.0
        assert got["leaped_fraction"] == (1.0 if total else 0.0)


def test_warp_summary_rejects_impossible_counts():
    with pytest.raises(ValueError):
        jprof.warp_summary(np.arange(4), 2, None)
    with pytest.raises(ValueError):
        tprof.warp_summary(np.arange(4), 2, None)


def test_warp_summary_of_a_warped_run_matches_jax():
    """The port's warped run (``test_torch_warp.py`` holds it bit-exact
    against JAX's) summarized by both functions."""
    from kaboodle_tpu_torch.warp.runner import simulate_warped

    n, ticks = 12, 24
    st = init_state(n, seed=0, ring_contacts=n - 1, announced=True, device="cpu")
    inputs = idle_inputs(n, ticks=ticks, device="cpu")
    inputs.manual_target[10, 0] = 3
    _, dense_ticks, m = simulate_warped(st, inputs, SwimConfig(), faulty=True, recheck_every=4)
    jm = JaxTickMetrics(**{k: v.numpy() for k, v in vars(m).items()})
    got = tprof.warp_summary(dense_ticks, ticks, m)
    assert got == jprof.warp_summary(dense_ticks, ticks, jm)
    assert 0.0 < got["dense_fraction"] < 1.0
    assert got["messages_delivered"] == int(m.messages_delivered.sum())


def test_fleet_run_stats_matches_jax():
    rng = np.random.default_rng(3)
    t, e = 5, 4
    rows = dict(messages_delivered=rng.integers(0, 50, (t, e), dtype=np.int32),
                converged=rng.random((t, e)) < 0.5,
                agree_fraction=rng.random((t, e), dtype=np.float32),
                mean_membership=rng.random((t, e), dtype=np.float32) * 8,
                fingerprint_min=rng.integers(0, 2**32, (t, e), dtype=np.uint32),
                fingerprint_max=rng.integers(0, 2**32, (t, e), dtype=np.uint32))
    jm, tm = both_metrics(rows)
    got = tprof.fleet_run_stats(tm)
    assert_tables_equal(jprof.fleet_run_stats(jm), got)
    np.testing.assert_array_equal(got["converged_members"], rows["converged"].sum(axis=1))


def _pairs():
    nan = np.float32("nan")
    a = np.asarray([1.0, nan, 3.0], np.float32)
    return [
        (a, a.copy()),  # NaN positions coincide
        (a, np.asarray([1.0, 2.0, 3.0], np.float32)),  # NaN vs a value
        (np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int64)),  # dtype
        (np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32).reshape(2, 2)),  # shape
        (np.arange(4, dtype=np.int32), np.asarray([0, 1, 2, 4], np.int32)),  # one bit
        (np.zeros(3, bool), np.zeros(3, bool)),
    ]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_leaf_equal_matches_jax(i):
    a, b = _pairs()[i]
    want = jprof.leaf_equal(a, b)
    assert tprof.leaf_equal(a, b) == want
    assert tprof.leaf_equal(torch.from_numpy(a), torch.from_numpy(b)) == want


def test_state_equal_matches_jax(runs):
    jm, tm = runs
    pairs = _pairs()
    assert tprof.state_equal(tuple(p[0] for p in pairs), tuple(p[0] for p in pairs))
    for a, b in pairs:
        assert tprof.state_equal((a, [a, None]), (a, [b, None])) == jprof.state_equal(
            (a, [a, None]), (a, [b, None]))
    assert tprof.state_equal(tm, tm) and jprof.state_equal(jm, jm)
    shifted = TickMetrics(**{**vars(tm), "messages_delivered": tm.messages_delivered + 1})
    assert not tprof.state_equal(tm, shifted)
    # A None leaf is an empty subtree (jax.tree.leaves drops it).
    st = init_state(4, seed=0, device="cpu", track_latency=False)
    assert tprof.state_equal(st, st)
    assert not tprof.state_equal(st, init_state(4, seed=0, device="cpu"))
