"""The reference agrees with the port at small N on the CPU, for every mix.

Each cell of BENCHMARK.json at 64 peers (blocks of 16) runs through the
harness with the port as the side under test and comes out correct; and
the reference's tick is held cell for cell to the port's over a whole run
of each mix."""

import pytest
import torch

from portbench import spec
from portbench import traffic as traffic_mod
from portbench.check import _state_diff
from portbench.program import fields
from portbench.run import port
from portbench.tests.conftest import run_small, small_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_at_small_n(workload):
    result, shown = run_small(workload, port)
    assert result["correct"], shown
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["value"] == 0 for v in shown.values()), shown


@pytest.mark.parametrize("workload", CELLS)
def test_reference_tick_equals_the_port_tick(workload):
    cell = small_cell(workload)
    seed = 2**32 + 77  # wider than 32 bits: the key takes its low word
    eng = spec.engine(cell.config["engine"]["tick"])
    prog = eng.Program(cell.config, cell.traffic, "cpu")
    ref = eng.Reference(cell.config, cell.traffic, "cpu")
    p_st, r_st = prog.fresh(seed), ref.fresh(seed)
    if cell.traffic["start"] == "converged" or cell.traffic.get("until_converged"):
        p_st, p_ticks, p_conv, _ = prog.boot(p_st)
        r_st, r_ticks, r_conv, _ = ref.boot(r_st)
        assert (p_ticks, p_conv) == (r_ticks, r_conv) and p_conv
        assert _state_diff(p_st, r_st) == 0
    sched = traffic_mod.schedule(cell.traffic, cell.config["n"], seed)
    if sched is None:
        return
    p_in, r_in = prog.inputs(sched), ref.inputs(sched)
    for t in range(sched.ticks):
        p_st, p_m = prog.tick(p_st, p_in, t)
        r_st, r_m = ref.tick(r_st, r_in, t)
        for k, v in fields(r_m).items():
            assert torch.equal(fields(p_m)[k], v), (t, k)
        assert _state_diff(p_st, r_st) == 0, t


def test_churn_mix_draws_from_the_seed():
    a = traffic_mod.schedule(spec.load_traffic("churn"), 256, 11)
    b = traffic_mod.schedule(spec.load_traffic("churn"), 256, 11)
    c = traffic_mod.schedule(spec.load_traffic("churn"), 256, 12)
    assert (a.kill == b.kill).all() and (a.revive == b.revive).all()
    assert (a.kill != c.kill).any()
    assert not a.kill[:, 0].any()  # peer 0 is protected
    assert not a.kill[0].any() and not a.kill[32:].any()  # churn over ticks 1-31
    assert 0.02 < a.kill[1:32].mean() / a.alive_after()[:31].mean() < 0.08
