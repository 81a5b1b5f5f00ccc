"""The metric arithmetic: rates over all work and time, the p95 over every
tick, busy and idle share from overlapping device intervals, attribution."""

import statistics

import pytest

from portbench import spec
from portbench.run import WindowContext
from portbench.spec import end_to_end_reader
from portbench.trace import Context, DeviceOp, Trace, breakdown

MS = 1_000_000  # ns


def wctx(unit="tick", units=10, window_s=2.0, unit_ms=None, peak=3 * 2**30, setup=12.5):
    return WindowContext(unit=unit, n=8192, units=units, window_s=window_s,
                         unit_ms=unit_ms or [100.0] * units, peak_bytes=peak, setup_s=setup)


@pytest.mark.parametrize("name", ["peer_ticks_per_s", "peer_ticks_per_s.rest",
                                  "peer_ticks_per_s.blocked"])
def test_rate_is_all_work_over_all_time(name):
    assert end_to_end_reader(name)(wctx(units=10, window_s=2.0)) == 8192 * 10 / 2.0
    assert end_to_end_reader(name)(wctx(unit="run")) is None


def test_converge_s_is_window_over_boots():
    assert end_to_end_reader("converge_s")(wctx(unit="run", units=4, window_s=30.0)) == 7.5


def test_p95_is_over_every_tick():
    ms = [float(i) for i in range(1, 201)]  # 200 ticks: 10 beyond the 95th percentile
    got = end_to_end_reader("tick_ms_p95")(wctx(units=200, unit_ms=ms))
    assert got == statistics.quantiles(ms, n=20)[18]
    assert 190 < got < 191
    assert sum(m > got for m in ms) == 10


def test_peak_and_setup():
    assert end_to_end_reader("peak_mem_gib")(wctx()) == 3.0
    assert end_to_end_reader("setup_s")(wctx()) == 12.5


def _trace():
    # Two units (0-10 ms, 10-20 ms on the host); device ops overlap at 2-4 ms.
    ops = [DeviceOp("k_a", 1 * MS, 3 * MS, 1), DeviceOp("k_b", 2 * MS, 2 * MS, 2),
           DeviceOp("Memcpy DtoH (Device -> Pinned)", 8 * MS, 1 * MS, 3),
           DeviceOp("k_c", 12 * MS, 4 * MS, 4)]
    launch = {1: int(0.5 * MS), 2: int(1.5 * MS), 3: 7 * MS, 4: 11 * MS}
    host = [(0, 10 * MS, "portbench.tick"), (1 * MS, 2 * MS, "aten::_int_mm"),
            (1 * MS + 10, 1 * MS + 20, "cudaLaunchKernel"), (4 * MS, 8 * MS, "aten::item"),
            (10 * MS, 20 * MS, "portbench.tick")]
    host.sort()
    return Trace(units=[(0, 10 * MS), (10 * MS, 20 * MS)], device_ops=ops, launch_at=launch,
                 host_ops=host, window=(0, 20 * MS))


def test_busy_is_the_union_of_overlapping_intervals():
    tr = _trace()
    # [1, 4] + [8, 9] + [12, 16] ms: overlaps counted once.
    assert tr.busy_s() == pytest.approx(8e-3)
    assert tr.device_total_s() == pytest.approx(10e-3)
    ctx = Context(trace=tr, unit="tick", config={}, alive=[], launches={})
    for name in ("device_idle_share.ticks", "device_idle_share.boot"):
        assert spec.metric_reader(name)(ctx) == pytest.approx(60.0)


def test_idle_gaps_are_labelled_by_the_open_host_op():
    gaps = dict()
    for label, s in _trace().idle_gaps():
        gaps[label] = gaps.get(label, 0) + s
    # 0-1 ms and 9-10 under the first unit, 4-8 under aten::item, 10-12 and
    # 16-20 under the second unit.
    assert gaps["aten::item"] == pytest.approx(4e-3)
    assert gaps["portbench.tick"] == pytest.approx(8e-3)
    assert sum(gaps.values()) == pytest.approx(12e-3)
    bd = breakdown(_trace())
    assert bd["device_ops"][0] == ["k_c", pytest.approx(4e-3)]
    assert len(bd["idle_gaps"]) <= 10


def test_attribution_to_units_and_host_ops():
    tr = _trace()
    assert [tr.unit_of(op) for op in tr.device_ops] == [0, 0, 0, 1]
    # k_b's launch (1.5 ms) lies inside aten::_int_mm (1-2 ms); k_a's does not.
    assert tr.time_under("aten::_int_mm") == pytest.approx(2e-3)
    ctx = Context(trace=tr, unit="tick", config={}, alive=[], launches={})
    assert spec.metric_reader("int_mm_share.ticks")(ctx) == pytest.approx(20.0)
    assert spec.metric_reader("syncs_per_tick")(ctx) == 0.5
    assert spec.metric_reader("tick_device_ms.blocked")(
        Context(trace=tr, unit="tick", config={"engine": {"tick": "blocked"}}, alive=[],
                launches={})) == pytest.approx(4.0)


def test_int64_elementwise_by_kernel_name():
    is_int64_elementwise = spec.load("metrics", "int64_ew_share").is_int64_elementwise

    assert is_int64_elementwise(
        "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<long, long, "
        "long, at::native::bitwise_xor_kernel_cuda(at::TensorIteratorBase&)"
        "::{lambda(long, long)#1}>")
    assert not is_int64_elementwise(
        "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<int, int, "
        "int, at::native::AddFunctor<int> >, std::array<char*, 3ul> >")
    assert not is_int64_elementwise("void at::native::reduce_kernel<512, 1, long>")


def test_roofline_counts_what_the_launch_needs():
    from portbench import yardstick

    cfg = {"n": 8192, "state": {"instant_identity": False, "timer_dtype": "int32"},
           "protocol": {"num_candidate_target_peers": 5}}
    n = 8192
    want = yardstick.bound_s("fused_suspicion", n, n, 8000, 4)
    ops = [DeviceOp("void fused_suspicion_kernel<int>(...)", 0, int(2 * want * 1e9), 1)]
    tr = Trace(units=[(0, 10)], device_ops=ops, launch_at={1: 5}, host_ops=[], window=(0, 10))
    ctx = Context(trace=tr, unit="tick", config=cfg, alive=[8000],
                  launches={"fused_suspicion": 1})
    for name in ("hand_kernel_roofline", "hand_kernel_roofline.rest"):
        assert spec.metric_reader(name)(ctx) == pytest.approx(50.0, rel=1e-4)
    empty = Context(trace=Trace([(0, 10)], [], {}, [], (0, 10)), unit="tick", config=cfg,
                    alive=[8000], launches={})
    assert spec.metric_reader("hand_kernel_roofline")(empty) is None


@pytest.mark.parametrize("launches", [{}, {"fused_suspicion": 2},
                                      {"fused_suspicion": 1, "fused_oldest_k": 1}])
def test_roofline_is_left_out_where_the_counter_disagrees(launches, capsys):
    """A launch the trace's kernel names miss, or one they match wrongly,
    leaves the reading out rather than report a wrong share."""
    cfg = {"n": 8192, "state": {"instant_identity": False, "timer_dtype": "int32"},
           "protocol": {"num_candidate_target_peers": 5}}
    ops = [DeviceOp("void fused_suspicion_kernel<int>(...)", 0, 1_000_000, 1)]
    tr = Trace(units=[(0, 10)], device_ops=ops, launch_at={1: 5}, host_ops=[], window=(0, 10))
    ctx = Context(trace=tr, unit="tick", config=cfg, alive=[8000], launches=launches)
    assert spec.metric_reader("hand_kernel_roofline")(ctx) is None
    assert "left out" in capsys.readouterr().err


def test_a_traced_run_carries_the_trace_keys():
    """A ``--trace 1`` run on the CPU: the profiler is read, nothing ran on a
    device, so the device readings are left out rather than read as 0."""
    from portbench.run import port
    from portbench.tests.conftest import run_small

    result, _ = run_small("steady8k", port, trace=True, seconds=0.3)
    assert result["correct"]
    assert set(result["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"] == {}
    assert list(result)[-1] == "checks"
