"""The port's CUDA kernels on the card: each against its plain version, bit for bit.

These tests need a CUDA card and nvcc; without a card each skips. The card's
machine has no JAX, so this file imports only PyTorch and the port, and is
run there without the repo's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import _cuda
from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count, fused_fp_count_plain
from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k, fused_oldest_k_plain
from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion, fused_suspicion_plain
from kaboodle_tpu_torch.phasegraph.exec import _bool_matmul
from kaboodle_tpu_torch.sim import (
    baseline_scenario,
    init_state,
    make_chunked_tick_fn,
    make_tick_fn,
)
from kaboodle_tpu_torch.sim.state import metrics_to_numpy, state_to_numpy
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, timer_dtype, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    state = torch.randint(0, 4, (n, n), generator=g, device=dev, dtype=torch.int8)
    timer = torch.randint(-12, 40, (n, n), generator=g, device=dev, dtype=torch.int32)
    timer = torch.where(torch.rand((n, n), generator=g, device=dev) < 0.05,
                        torch.iinfo(timer_dtype).max, timer).to(timer_dtype)
    alive = torch.rand((n,), generator=g, device=dev) < 0.8
    idv = torch.randint(-2**31, 2**31 - 1, (n, n), generator=g, device=dev, dtype=torch.int32)
    return state, timer, alive, idv


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 33, 256, 1000, 1024, 2048, 4100, 4112, 8192])
def test_fused_fp_on_card(card, n):
    state, _, _, idv = _inputs(n, torch.int32, n, card)
    before = _cuda.launches["fused_fp_idv"]
    _equal(fused_fp_count(state, idv), fused_fp_count_plain(state, idv))
    _equal(fused_fp_count(state, idv[0]), fused_fp_count_plain(state, idv[0]))
    assert _cuda.launches["fused_fp_idv"] == before + 1


@pytest.mark.parametrize("n", [1, 33, 256, 1000, 1024, 2048, 4100, 4112, 8192])
@pytest.mark.parametrize("timer_dtype", [torch.int16, torch.int32])
def test_fused_suspicion_on_card(card, n, timer_dtype):
    state, timer, alive, _ = _inputs(n, timer_dtype, n + 1, card)
    for thr in (-3, 9):
        _equal(fused_suspicion(state, timer, alive, thr),
               fused_suspicion_plain(state, timer, alive, thr))


def _edge_rows(n, timer_dtype, alive_mode, seed):
    """Planes whose rows probe the row kernels' edges (numpy, then torch).

    Timers come from the dtype's min and max, their neighbours and the
    values around the thresholds the tests use (0, 9), so ties are common.
    Row 0: every cell WaitingForPing at one tied timer (jstar is the lowest
    column); row 1: WaitingForPing only at the dtype's max and min, the min
    at a column above the row's first chunk; row 2: the only Known cell is
    the diagonal (has_cand false); row 3: WaitingForIndirectPing at
    exactly 9; row 4: WaitingForPing at one timer in two far chunks, lower
    timers only on other states. ``alive_mode`` is "all", "none" or
    "mixed"."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(timer_dtype)
    vals = np.array([info.min, info.min + 1, -1, 0, 1, 8, 9, 10, info.max - 1, info.max])
    state = rng.integers(0, 4, (n, n)).astype(np.int8)
    timer = rng.choice(vals, (n, n)).astype(timer_dtype)
    alive = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
             "mixed": rng.random(n) < 0.5}[alive_mode]
    if n > 0:
        state[0], timer[0] = WAITING_FOR_PING, 9
    if n > 1:
        state[1] = WAITING_FOR_PING
        timer[1] = info.max
        timer[1, n // 2 + n % 2::3] = info.min
    if n > 2:
        state[2] = 0
        state[2, 2] = KNOWN
    if n > 3:
        state[3], timer[3] = WAITING_FOR_INDIRECT_PING, 9
    if n > 4:
        state[4] = np.where(state[4] == WAITING_FOR_PING, 0, state[4])
        timer[4] = np.where(state[4] > 0, info.min, timer[4])
        for j in (n // 3, n - 1):
            state[4, j], timer[4, j] = WAITING_FOR_PING, -1
    return state, timer, alive


def _edge_thresholds(timer_dtype):
    """Below every timer, at the dtype's min, at 9 (row 3's timers), at the
    dtype's max and, for int16, above it."""
    info = np.iinfo(timer_dtype)
    above = [info.max + 1] if info.max < np.iinfo(np.int32).max else []
    return [info.min - 1] * (info.min > np.iinfo(np.int32).min) + [info.min, 9, info.max] + above


@pytest.mark.parametrize("n", [1, 33, 1024, 4112, 8192])
@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("alive_mode", ["all", "none", "mixed"])
def test_row_kernels_edge_rows_on_card(card, n, timer_dtype, alive_mode):
    """fused_suspicion and both fused_fp modes on edge rows: ties at one
    timer, timers at thr and at the dtype's extremes, all rows dead or all
    alive, the diagonal as the only Known cell."""
    s, t, a = _edge_rows(n, timer_dtype, alive_mode, n)
    state, timer = torch.from_numpy(s).to(card), torch.from_numpy(t).to(card)
    alive = torch.from_numpy(a).to(card)
    for thr in _edge_thresholds(timer_dtype):
        _equal(fused_suspicion(state, timer, alive, thr),
               fused_suspicion_plain(state, timer, alive, thr))
    idv = torch.from_numpy(t.astype(np.int32) * 40503).to(card)
    _equal(fused_fp_count(state, idv), fused_fp_count_plain(state, idv))
    _equal(fused_fp_count(state, idv[min(1, n - 1)]),
           fused_fp_count_plain(state, idv[min(1, n - 1)]))


@pytest.mark.parametrize("n", [1, 33, 256, 1000, 2048, 4112])
@pytest.mark.parametrize("timer_dtype", [torch.int16, torch.int32])
def test_fused_oldest_k_on_card(card, n, timer_dtype):
    """Any k, one 32-wide round or several, and k above the eligible count;
    the 16-byte route (n % 16 == 0) and the scalar one; a row with no
    eligible cell, a row of one tied timer, and timers at the dtype's min."""
    state, timer, alive, _ = _inputs(n, timer_dtype, n + 2, card)
    tmin = torch.iinfo(timer_dtype).min
    alive[: min(n, 4)] = True
    state[0] = 0                                    # no eligible cell
    if n > 1:
        state[1], timer[1] = 1, 3                   # every cell KNOWN, one tied timer
    if n > 2:
        timer[2, ::2] = tmin                        # the dtype's min, ties among them
    if n > 3:
        timer[3] = torch.where(state[3] == 1, tmin, timer[3])
    before = _cuda.launches["fused_oldest_k"]
    ks = (1, 3, 5, 8, 9, 16, 40)
    for k in ks:
        _equal(fused_oldest_k(state, timer, alive, k), fused_oldest_k_plain(state, timer, alive, k))
    assert _cuda.launches["fused_oldest_k"] == before + len(ks)


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (13, 40, 7), (24, 20, 16)])
def test_bool_matmul_on_card(card, m, k, n):
    """``torch._int_mm`` direct (sides it accepts) and zero-padded, with a
    transposed operand as the tick passes it, against the CPU's int32 product."""
    g = torch.Generator(device=card)
    g.manual_seed(m + k + n)
    a = torch.rand((k, m), generator=g, device=card) < 0.3
    b = torch.rand((k, n), generator=g, device=card) < 0.3
    assert torch.equal(_bool_matmul(a.T, b).cpu(), _bool_matmul(a.T.cpu(), b.cpu()))


@pytest.mark.parametrize("det", [False, True])
def test_tick_on_card_equals_cpu(card, det):
    cfg = SwimConfig(deterministic=det, use_pallas_fp=True, use_pallas_oldest_k=True,
                     use_pallas_suspicion=True)
    sc = baseline_scenario(3, n=256, ticks=12, seed=4)
    tick = make_tick_fn(cfg)
    sides = {d: (init_state(256, seed=1, alive=sc.initial_alive(), device=d), sc.build(d))
             for d in ("cuda", "cpu")}
    for t in range(sc.ticks):
        out = {}
        for d, (st, inp) in sides.items():
            st, m = tick(st, inp.at(t))
            sides[d] = (st, inp)
            out[d] = {**state_to_numpy(st), **metrics_to_numpy(m)}
        for k, w in out["cpu"].items():
            g = out["cuda"][k]
            if k == "latency":
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                np.testing.assert_allclose(g, w, rtol=1e-5)
            elif w is not None:
                np.testing.assert_array_equal(g, w, err_msg=f"tick {t} {k}")


@pytest.mark.parametrize("det", [False, True])
def test_chunked_tick_on_card_equals_cpu(card, det):
    """The row-blocked tick (block 128 of N=512) on the card against the CPU
    under BASELINE config 5's drop and partition plus kills and a revive:
    the per-block drop draws, escalation proxies and join replies included."""
    sc = baseline_scenario(5, n=512, ticks=12, seed=4).kill_at(2, [5, 6]).revive_at(9, [5])
    tick = make_chunked_tick_fn(SwimConfig(deterministic=det), block=128)
    sides = {d: (init_state(512, seed=1, device=d), sc.build(d)) for d in ("cuda", "cpu")}
    for t in range(sc.ticks):
        out = {}
        for d, (st, inp) in sides.items():
            st, m = tick(st, inp.at(t))
            sides[d] = (st, inp)
            out[d] = {**state_to_numpy(st), **metrics_to_numpy(m)}
        for k, w in out["cpu"].items():
            g = out["cuda"][k]
            if k == "latency":
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                np.testing.assert_allclose(g, w, rtol=1e-5)
            elif w is not None:
                np.testing.assert_array_equal(g, w, err_msg=f"tick {t} {k}")


@pytest.mark.parametrize("det", [False, True])
def test_telemetry_tick_on_card_equals_cpu(card, det):
    """The telemetry build on the card (kernels) against the CPU (plain
    versions): state, metrics, every counter and the digest plane, per tick."""
    cfg = SwimConfig(deterministic=det, use_pallas_fp=True, use_pallas_oldest_k=True,
                     use_pallas_suspicion=True)
    sc = baseline_scenario(3, n=256, ticks=12, seed=4)
    tick = make_tick_fn(cfg, telemetry=True)
    sides = {d: (init_state(256, seed=1, alive=sc.initial_alive(), device=d), sc.build(d))
             for d in ("cuda", "cpu")}
    _cuda.reset_launches()
    for t in range(sc.ticks):
        out = {}
        for d, (st, inp) in sides.items():
            st, tel = tick(st, inp.at(t))
            sides[d] = (st, inp)
            out[d] = {**state_to_numpy(st), **metrics_to_numpy(tel.metrics), "fp": tel.fp.cpu(),
                      **{f"c_{k}": v.cpu() for k, v in vars(tel.counters).items()}}
        for k, w in out["cpu"].items():
            g = out["cuda"][k]
            if k == "latency":
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                np.testing.assert_allclose(g, w, rtol=1e-5)
            elif isinstance(w, torch.Tensor):
                assert torch.equal(g, w), f"tick {t} {k}"
            elif w is not None:
                np.testing.assert_array_equal(g, w, err_msg=f"tick {t} {k}")
    assert all(_cuda.launches[k] > 0 for k in ("fused_fp_idv", "fused_suspicion",
                                                 "fused_oldest_k"))


def _facade_script(device) -> list:
    """A facade run (start, converge, stop, set_identity, re-converge) with
    what every instance saw after each tick."""
    from kaboodle_tpu_torch import Kaboodle, SimNetwork

    cfg = SwimConfig(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)
    net = SimNetwork(64, cfg=cfg, seed=5, device=device)
    nodes = [Kaboodle(net, f"peer-{i}") for i in range(24)]
    queues = [(k.discover_peers(), k.discover_departures(), k.discover_fingerprint_changes())
              for k in nodes]
    log = []
    orig = net.tick

    def tick(ticks=1):
        for _ in range(ticks):
            m = orig(1)
            log.append(([tuple(list(q) for q in qs) for qs in queues],
                        [k.fingerprint() for k in nodes], state_to_numpy(net.state)))
            for qs in queues:
                for q in qs:
                    q.clear()
        return m

    net.tick = tick
    for k in nodes:
        k.start()
    net.tick_until_converged(max_ticks=32)
    for k in nodes[:4]:
        k.stop()
    net.tick(12)
    nodes[5].set_identity(b"renamed")
    net.tick(3)
    return log


def test_facade_on_card_equals_cpu(card):
    want, got = _facade_script("cpu"), _facade_script("cuda")
    assert len(got) == len(want)
    for t, ((we, wf, ws), (ge, gf, gs)) in enumerate(zip(want, got)):
        assert ge == we and gf == wf, f"tick {t}"
        for k, w in ws.items():
            if k == "latency":
                np.testing.assert_array_equal(np.isnan(gs[k]), np.isnan(w))
                np.testing.assert_allclose(gs[k], w, rtol=1e-5)
            elif w is not None:
                np.testing.assert_array_equal(gs[k], w, err_msg=f"tick {t} {k}")


def test_fleet_on_card_equals_cpu(card):
    """The fleet tick on the card against the CPU: E = 4 meshes of N = 64,
    random mode, faulty, per-member drop rates and a stacked churn schedule
    (the broadcast boot's gossip union multiplies per member), in the
    telemetry-off and telemetry-on builds: every leaf, metric, counter and
    digest equal per tick."""
    from kaboodle_tpu_torch.fleet import (
        init_fleet,
        scan_axis_first,
        simulate_fleet,
        stack_member_inputs,
    )
    from kaboodle_tpu_torch.sim import Scenario
    from kaboodle_tpu_torch.sim.state import fleet_to_numpy

    n, e, ticks = 64, 4, 10
    rates = [0.0, 0.1, 0.2, 0.3]
    scenarios = [Scenario(n, ticks).kill_at(2, [m + 1, m + 9]).revive_at(6, [m + 1])
                 .partition_at(3, np.arange(n) % 2, until=5) for m in range(e)]
    for telemetry in (False, True):
        res = {}
        for d in ("cuda", "cpu"):
            inputs = scan_axis_first(stack_member_inputs([sc.build(d) for sc in scenarios]))
            inputs.drop_rate = torch.tensor(rates, device=d).expand(ticks, e)
            fleet = init_fleet(n, e, drop_rates=rates, device=d)
            out, m = simulate_fleet(fleet, inputs, SwimConfig(), faulty=True, telemetry=telemetry)
            res[d] = (fleet_to_numpy(out)["mesh"], m)
        for k, w in res["cpu"][0].items():
            g = res["cuda"][0][k]
            if k == "latency":
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                np.testing.assert_allclose(g, w, rtol=1e-5)
            elif w is not None:
                np.testing.assert_array_equal(g, w, err_msg=k)
        gm, wm = res["cuda"][1], res["cpu"][1]
        if telemetry:
            assert torch.equal(gm.fp.cpu(), wm.fp)
            for f in dataclasses.fields(wm.counters):
                assert torch.equal(getattr(gm.counters, f.name).cpu(),
                                   getattr(wm.counters, f.name)), f.name
            gm, wm = gm.metrics, wm.metrics
        for k, w in metrics_to_numpy(wm).items():
            np.testing.assert_array_equal(metrics_to_numpy(gm)[k], w, err_msg=k)


def _mid_drain(n, cfg, timer_dtype, dev):
    """A converged mesh with 8 victims killed, every survivor's cell for them
    armed ``WaitingForPing`` now, and half the rows already rid of victim 0
    (fingerprints disagree, so anti-entropy fires every tick)."""
    from kaboodle_tpu_torch.sim import Scenario
    from kaboodle_tpu_torch.spec import WAITING_FOR_PING

    st = init_state(n, seed=1, ring_contacts=n - 1, announced=True, timer_dtype=timer_dtype,
                    device=dev)
    victims = [(i * n) // 9 + 1 for i in range(8)]
    st = make_tick_fn(cfg, faulty=True)(st, Scenario(n, 1).kill_at(0, victims).build(dev).at(0))[0]
    S, T, alive = st.state.clone(), st.timer.clone(), st.alive
    for v in victims:
        S[alive, v] = WAITING_FOR_PING
        T[alive, v] = int(st.tick)
    S[alive & (torch.arange(n, device=dev) >= n // 2), victims[0]] = 0
    return dataclasses.replace(st, state=S, timer=T)


@pytest.mark.parametrize("timer_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("det", [True, False])
def test_hybrid_leap_on_card_equals_dense(card, timer_dtype, det):
    """The hybrid leap on the card against the port's dense ticks on the
    card at N = 512, from a mid-drain state: bit-equal. In deterministic
    mode the first step has mutual pings, so the leap's scatter-max and its
    segment write-back both see duplicate cells."""
    from kaboodle_tpu_torch.ops.sampling import choose_one_of_oldest_k
    from kaboodle_tpu_torch.sim import idle_inputs
    from kaboodle_tpu_torch.spec import KNOWN
    from kaboodle_tpu_torch.warp.horizon import decode_signature, make_signature_fn
    from kaboodle_tpu_torch.warp.leap import make_leap_fn

    n, k = 512, 32
    cfg = SwimConfig(deterministic=det, ping_timeout_ticks=4 * k)
    st = _mid_drain(n, cfg, timer_dtype, card)
    assert decode_signature(make_signature_fn(cfg)(st)).mode == "hybrid"
    if det:
        idx = torch.arange(n, device=card)
        elig = st.alive[:, None] & (st.state == KNOWN) & (idx[:, None] != idx[None, :])
        tgt = choose_one_of_oldest_k(st.timer, elig, 5, (0, 0), True).long()
        assert bool(((tgt >= 0) & (tgt[tgt.clamp(min=0)] == idx)).any()), "no mutual ping"
    tick = make_tick_fn(cfg, faulty=False)
    idle = idle_inputs(n, device=card)
    want = st
    for _ in range(k):
        want, _ = tick(want, idle)
    got = make_leap_fn(cfg, k, hybrid=True)(st)
    masked = make_leap_fn(cfg, 2 * k, hybrid=True, masked=True)(st, k)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None:
            assert getattr(got, f.name) is None
            continue
        for g in (getattr(got, f.name), getattr(masked, f.name)):
            assert g.dtype == w.dtype and g.device == w.device, f.name
            if w.is_floating_point():
                assert torch.equal(torch.isnan(g), torch.isnan(w)), f.name
                assert torch.equal(torch.nan_to_num(g, nan=0.0), torch.nan_to_num(w, nan=0.0))
            else:
                assert torch.equal(g, w), f.name
    assert bool((got.kpr_partner >= 0).any()), "anti-entropy never fired"


def test_serve_on_card_equals_cpu(card, tmp_path):
    """The serving slice's lifecycle script (``serve/dryrun.py::
    parity_script``: converge boots, leaped steady runs, a kept request
    spilled, restored and resumed, a cancel) on the card and on the CPU:
    status rows, every record and the final pool equal, bit for bit."""
    from kaboodle_tpu_torch.serve.dryrun import parity_script

    res = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        root.mkdir()
        res[dev] = parity_script(dev, str(root), n=32, lanes=4)
    got, want = res["cuda"], res["cpu"]
    assert got["status"] == want["status"]
    assert got["records"] == want["records"]
    assert {r["engine"] for r in want["rounds"]} >= {"chunk", "leap"}
    assert np.array_equal(got["generation"], want["generation"])
    for part in ("pool", "kept_member"):
        for k, w in want[part].items():
            g = got[part][k]
            assert (w is None) == (g is None), k
            if w is not None:
                assert g.dtype == w.dtype and np.array_equal(
                    g, w, equal_nan=bool(np.issubdtype(w.dtype, np.floating))), (part, k)


def test_oracle_parity_on_card(card):
    """``chip_smoke.py``'s oracle parity: the dense tick on the card with
    all four kernels on, held tick by tick to the lockstep oracle (the
    N = 256 broadcast boot with the share cap, lean and int16; then a
    random-fault N = 128 run whose dense and blocked telemetry ticks match
    the oracle's counters). It raises on any difference; each kernel must
    have launched."""
    import chip_smoke

    out = chip_smoke.phase_oracle_parity(device=card)
    assert all(out["launches"][k] > 0 for k in chip_smoke.ORACLE_KERNELS), out["launches"]
    assert out["boot"]["converged"]


def test_fed_serve_on_card_small_classes(card):
    """``chip_smoke.py``'s federation phase at classes 16/32: two servers
    on the card behind the router, the open-loop level with churn, e1
    killed mid-round; no lost terminal, no double completion in a journal,
    the spilled request adopted by e0 and equal to its standalone run,
    nothing built; then ``fedload --dryrun`` on the card."""
    import chip_smoke

    out = chip_smoke.phase_fed_serve(device="cuda", classes=(16, 32), lanes=((4, 2), (4,)))
    assert out["compiles_steady"] == 0 and not out["journal_duplicates"]
    assert out["adopted"]["equal"] and out["adopted"]["engine"] == "e0"
    assert out["dryrun"]["report"]["fedserve_dryrun"] == "ok"


@pytest.mark.parametrize("n", [23, 64])
@pytest.mark.parametrize("det", [True, False])
def test_sparse_tick_on_card_equals_cpu(card, n, det):
    """The sparse tick on the card against the CPU, tick by tick, int32 and
    int16 timers: rows whose boot slots are all timed-out WaitingForPing at
    one stamp (argmax ties: the first slot escalates), kills, revivals and a
    30 % drop (undelivered pings, whose sender-marks and insert candidates
    are dropped)."""
    from kaboodle_tpu_torch.sparseplane import (
        SparseSpec,
        SparseTickInputs,
        init_sparse_state,
        make_sparse_tick_fn,
    )
    from kaboodle_tpu_torch.sparseplane.state import (
        sparse_metrics_to_numpy,
        sparse_state_to_numpy,
    )

    rng = np.random.default_rng(n)
    ticks = 16
    inp = SparseTickInputs(kill=torch.as_tensor(rng.random((ticks, n)) < 0.05),
                           revive=torch.as_tensor(rng.random((ticks, n)) < 0.1),
                           drop_rate=torch.full((ticks,), 0.3))
    for timer in ("int32", "int16"):
        spec = SparseSpec(k=8, gossip_fanout=4, boot_contacts=6, timer_dtype=timer)
        tick = make_sparse_tick_fn(SwimConfig(join_broadcast_enabled=False, deterministic=det),
                                   spec)
        st = init_sparse_state(n, spec, seed=n, device="cpu")
        st.nbr_state[::2, :6] = WAITING_FOR_PING
        st.tick = torch.tensor(5, dtype=torch.int32)
        devices = {"cpu": torch.device("cpu"), "card": card}
        sides = {d: st.to(dev) for d, dev in devices.items()}
        escalated = 0
        for t in range(ticks):
            got = {}
            for d, dev in devices.items():
                sides[d], m = tick(sides[d], inp.at(t).to(dev))
                got[d] = {**sparse_state_to_numpy(sides[d]), **sparse_metrics_to_numpy(m)}
            for f, want in got["cpu"].items():
                assert np.array_equal(got["card"][f], want), f"{timer} tick {t}: {f}"
            escalated += int((sides["cpu"].nbr_state == WAITING_FOR_INDIRECT_PING).sum())
        assert escalated
