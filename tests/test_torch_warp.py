"""The port's warp (signature, leaps, runners, memo, fleet warp) against the JAX warp.

The same states and schedules, made from numpy seeds (the states by the
port's own dense tick on the CPU, carried across to JAX through numpy),
go through the JAX warp and the port's. Tolerance: bit-exact, every leaf
and metric; ``latency`` with NaN positions equal and every other value
equal. The JAX leaps are jitted once per (config, k, variant) and cached
by this module; the JAX runners keep their own caches (one dense tick per
config, one program per span bucket), so the runner tests share one
config, ``RCFG``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.fleet.core import FleetState as JaxFleetState
from kaboodle_tpu.phasegraph.graph import build_graph
from kaboodle_tpu.phasegraph.plan import plan
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.warp import horizon as jhorizon
from kaboodle_tpu.warp import runner as jrunner
from kaboodle_tpu.warp.leap import make_leap_fn as jax_make_leap_fn
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import FleetState, member_state
from kaboodle_tpu_torch.ops.sampling import choose_one_of_oldest_k
from kaboodle_tpu_torch.phasegraph import derive, span
from kaboodle_tpu_torch.sim import Scenario
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.sim.state import (
    idle_inputs,
    init_state,
    metrics_to_numpy,
    state_to_numpy,
)
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_PING
from kaboodle_tpu_torch.telemetry import FIELDS
from kaboodle_tpu_torch.warp import horizon, runner
from kaboodle_tpu_torch.warp.leap import make_leap_fn

CPU = "cpu"
N = 24
LEAN = dict(track_latency=False, instant_identity=True, timer_dtype=torch.int16)
FULL = dict()
# The runner tests' config: a timeout that opens drain windows inside
# ``churn_inputs``' schedule.
RCFG_KW = dict(ping_timeout_ticks=24)
PLANNER_VARIANTS = [dict(), dict(join_broadcast_enabled=False), dict(deterministic=True),
                    dict(faithful_failed_broadcast=False), dict(ping_timeout_ticks=48),
                    RCFG_KW]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfgs(**kw):
    return SwimConfig(**kw), JaxSwimConfig(**kw)


# ---------------------------------------------------------------- carrying across


def _np_leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def to_jax(st) -> jstate.MeshState:
    return jstate.MeshState(**{k: None if v is None else jnp.asarray(v)
                               for k, v in state_to_numpy(st).items()})


def inputs_to_jax(inp) -> jstate.TickInputs:
    return jstate.TickInputs(**{f.name: None if getattr(inp, f.name) is None
                                else jnp.asarray(getattr(inp, f.name).numpy())
                                for f in dataclasses.fields(inp)})


def assert_same(want: dict, got: dict, where: str):
    """Bit for bit; float leaves with NaN positions equal and every other value equal."""
    assert want.keys() == got.keys(), where
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {k} {w.dtype} {g.dtype}"
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


def assert_state(want, got, where: str):
    """``want``: a JAX or port state; ``got``: a port state."""
    w = state_to_numpy(want) if isinstance(want.state, torch.Tensor) else _np_leaves(want)
    assert_same(w, state_to_numpy(got), where)


# ---------------------------------------------------------------- states (port, CPU)


def converged(seed=0, n=N, **kw):
    return init_state(n, seed=seed, ring_contacts=n - 1, announced=True, device=CPU, **kw)


def dense(st, cfg, ticks):
    tick = make_tick_fn(cfg, faulty=False)
    idle = idle_inputs(st.n, device=CPU)
    for _ in range(ticks):
        st, _ = tick(st, idle)
    return st


def kill(st, cfg, victims):
    inp = Scenario(st.n, 1).kill_at(0, list(victims)).build(CPU)
    return make_tick_fn(cfg, faulty=True)(st, inp.at(0))[0]


@functools.lru_cache(maxsize=None)
def drain_state(cfg, victims=(5, 11), seed=3, n=N, lean=False):
    """A mid-drain state built by the port's engine: kill ``victims``, then
    tick densely until the signature classes it ``hybrid``."""
    st = kill(converged(seed, n, **(LEAN if lean else FULL)), cfg, victims)
    sig = horizon.make_signature_fn(cfg)
    tick = make_tick_fn(cfg, faulty=False)
    idle = idle_inputs(n, device=CPU)
    for _ in range(8 * n):
        if horizon.decode_signature(sig(st)).mode == "hybrid":
            return st
        st, _ = tick(st, idle)
    raise AssertionError("the drain never reached the hybrid class")


def ae_state(cfg, lean=False):
    """A drain state whose fingerprints disagree: half the survivors have
    already removed victim 5, so anti-entropy fires every tick."""
    st = drain_state(cfg, lean=lean)
    S = st.state.clone()
    rows = (torch.arange(N) >= N // 2) & st.alive
    S[rows, 5] = 0
    return dataclasses.replace(st, state=S)


def _replace(st, **planes):
    return dataclasses.replace(st, **{k: torch.as_tensor(v) for k, v in planes.items()})


def signature_states(cfg):
    """The signature variants: (name, state)."""
    conv = converged(seed=1)
    dead = dense(kill(converged(seed=2), cfg, [N // 2]), cfg, 4 * N)
    words = np.where(np.arange(N) == 3, 99, np.arange(N) + 1).astype(np.int32)
    stale = _replace(conv, identity=words)
    kpr_p = np.full(N, -1, np.int32)
    kpr_p[0] = 1
    live_kpr = _replace(conv, kpr_partner=kpr_p, kpr_n=np.full(N, N + 5, np.int32))
    waiting_alive = conv.state.clone()
    waiting_alive[0, 1] = WAITING_FOR_PING
    return [
        ("converged", conv),
        ("boot", init_state(N, seed=0, ring_contacts=2, device=CPU)),
        ("drain", drain_state(cfg)),
        ("dead_rows", dead),
        ("stale_identity", stale),
        ("live_kpr", live_kpr),
        ("waiting_on_alive", _replace(conv, state=waiting_alive)),
        ("lean_int16_drain", drain_state(cfg, lean=True)),
        ("lean_int16_converged", converged(seed=4, **LEAN)),
    ]


# ---------------------------------------------------------------- JAX builders


@functools.lru_cache(maxsize=None)
def jax_leap(jcfg, k, hybrid=False, masked=False):
    return jax.jit(jax_make_leap_fn(jcfg, k, hybrid=hybrid, masked=masked))


# ---------------------------------------------------------------- pins


@pytest.mark.parametrize("kw", PLANNER_VARIANTS)
def test_pass_sets_and_signature_terms_pinned_to_planner(kw):
    cfg, jcfg = cfgs(**kw)
    for mode, want in (("span", span._SPAN_PASSES), ("hybrid", span._HYBRID_PASSES)):
        prog = plan(build_graph(jcfg, faulty=False), mode)
        assert {p.name: p.op_names for p in prog.tail} == want, mode
        assert make_leap_fn(cfg, 8, hybrid=mode == "hybrid").passes == want
    want_terms = plan(build_graph(jcfg, faulty=False), "hybrid").pred_terms
    assert horizon.hybrid_pred_terms(cfg) == tuple(want_terms)
    assert set(want_terms) <= set(horizon._OP_TERM_BITS)
    for name in ("DENSE_BITS", "HYBRID_BITS", "_OP_TERM_BITS", "_BUCKET_SHIFT"):
        assert getattr(horizon, name) == getattr(jhorizon, name), name
    assert runner.CHUNK_BUCKETS == jrunner.CHUNK_BUCKETS and runner.MIN_LEAP == jrunner.MIN_LEAP
    assert runner.WARP_MODES == jrunner.WARP_MODES
    assert set(derive.ENGINES) <= set(__import__(
        "kaboodle_tpu.phasegraph.derive", fromlist=["ENGINES"]).ENGINES)


# ---------------------------------------------------------------- horizon


def test_signature_quiescence_expiry_match_jax():
    cfg, jcfg = cfgs(ping_timeout_ticks=48)
    sig, jsig = horizon.make_signature_fn(cfg), jhorizon.make_signature_fn(jcfg)
    q, jq = horizon.make_quiescence_fn(cfg), jhorizon.make_quiescence_fn(jcfg)
    ex, jex = horizon.make_expiry_fn(cfg), jhorizon.make_expiry_fn(jcfg)
    modes = {}
    for name, st in signature_states(cfg):
        js = to_jax(st)
        row = sig(st)
        assert row.dtype == torch.int32 and row.shape == (4,)
        np.testing.assert_array_equal(row.numpy(), np.asarray(jsig(js)), err_msg=name)
        assert bool(q(st)) == bool(jq(js)), name
        assert int(ex(st)) == int(jex(js)), name
        assert horizon.earliest_timer_expiry(st, cfg) == jhorizon.earliest_timer_expiry(js, jcfg)
        cls = horizon.decode_signature(row)
        assert cls.describe() == jhorizon.decode_signature(jsig(js)).describe(), name
        assert (cls.bits == 0) == bool(q(st)), name
        modes[name] = cls.mode
    assert modes["converged"] == "leap" and modes["boot"] == "dense"
    assert modes["drain"] == "hybrid" and modes["lean_int16_drain"] == "hybrid"
    assert modes["waiting_on_alive"] == "dense" and modes["stale_identity"] == "dense"
    assert modes["live_kpr"] == "hybrid"


def test_static_events_and_fleet_signature_reduce_per_member():
    cfg, _ = cfgs(ping_timeout_ticks=48)
    n, T = 8, 12
    sc = (Scenario(n, T).kill_at(2, [1]).revive_at(5, [1]).drop(0.1, start=7, stop=8)
          .manual_ping_at(9, 0, 3))
    inp = sc.build(CPU)
    ev = horizon.static_event_ticks(inp)
    np.testing.assert_array_equal(ev, jhorizon.static_event_ticks(inputs_to_jax(inp)))
    assert list(np.nonzero(ev)[0]) == [2, 5, 7, 9]
    assert horizon.next_static_event(ev, 3) == 5 and horizon.next_static_event(ev, 10) == T
    quiet = dataclasses.replace(idle_inputs(n, ticks=T, device=CPU),
                                drop_ok=torch.ones((T, n, n), dtype=torch.bool),
                                partition=torch.full((T, n), 3, dtype=torch.int32))
    assert not horizon.static_event_ticks(quiet).any()
    # [E] leaves: each member's row is its standalone row.
    members = [st for _, st in signature_states(cfg)[:7]]
    fleet = FleetState(mesh=_stack_states(members), drop_rate=torch.zeros(len(members)))
    rows = runner.fleet_signature(fleet, cfg)
    mask = runner.fleet_quiescence_mask(fleet, cfg)
    for e, st in enumerate(members):
        assert torch.equal(rows[e], horizon.make_signature_fn(cfg)(st)), e
        assert bool(mask[e]) == bool(horizon.make_quiescence_fn(cfg)(st)), e
        assert int(horizon.make_expiry_fn(cfg)(fleet.mesh)[e]) == int(rows[e, 1])


def _stack_states(states):
    return dataclasses.replace(states[0], **{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0]) if getattr(states[0], f.name) is not None})


# ---------------------------------------------------------------- leaps


@pytest.mark.parametrize("det,lean", [(True, False), (False, False), (True, True), (False, True)])
def test_strict_leap_matches_jax_and_port_dense(det, lean):
    """The strict span program from a converged state; the lean span is
    longer than N, so refreshed entries re-enter the oldest-5 rotation."""
    cfg, jcfg = cfgs(deterministic=det)
    k = 40 if lean else 9
    st = converged(seed=3, **(LEAN if lean else FULL))
    got = make_leap_fn(cfg, k)(st)
    assert_state(jax_leap(jcfg, k)(to_jax(st)), got, "strict vs JAX")
    assert_state(dense(st, cfg, k), got, "strict vs port dense")


def test_long_leap_crosses_draw_blocks():
    """A leap longer than one block of batched ping draws (``_DRAW_STEPS``)
    equals as many port dense ticks."""
    cfg, _ = cfgs()
    k = span._DRAW_STEPS + 44
    st = converged(seed=8, n=16, **LEAN)
    assert_state(dense(st, cfg, k), make_leap_fn(cfg, k)(st), "long leap")


@pytest.mark.parametrize("det,lean", [(True, False), (False, False), (True, True), (False, True)])
def test_hybrid_and_masked_leap_match_jax_on_drain(det, lean):
    """The hybrid program over a real mid-drain state (armed timers on dead
    peers); the masked build at k_m = k equals it and k_m = 0 leaves the
    state bit-unchanged."""
    cfg, jcfg = cfgs(deterministic=det, ping_timeout_ticks=48)
    k = 8
    st = drain_state(cfg, lean=lean)
    got = make_leap_fn(cfg, k, hybrid=True)(st)
    assert_state(jax_leap(jcfg, k, hybrid=True)(to_jax(st)), got, "hybrid vs JAX")
    assert_state(dense(st, cfg, k), got, "hybrid vs port dense")
    masked = make_leap_fn(cfg, 16, hybrid=True, masked=True)
    assert_state(got, masked(st, k), "masked k_m=k")
    assert_state(st, masked(st, 0), "masked k_m=0")
    if det == lean:  # the JAX masked program, once per state variant
        jm = jax_leap(jcfg, 16, hybrid=True, masked=True)
        assert_state(jm(to_jax(st), jnp.int32(k)), masked(st, k), "masked vs JAX")
        assert_state(jm(to_jax(st), jnp.int32(0)), masked(st, 0), "masked k_m=0 vs JAX")


@pytest.mark.parametrize("det", [True, False])
def test_hybrid_sterile_ae_with_mutual_pings(det):
    """Disagreeing fingerprints: anti-entropy fires every tick (partner
    selection, request/reply marks, the kpr ledger). In deterministic mode
    the first step has mutual pings, whose duplicate (row, segment) writes
    carry equal values."""
    cfg, jcfg = cfgs(deterministic=det, ping_timeout_ticks=48)
    st = ae_state(cfg)
    cls = horizon.decode_signature(horizon.make_signature_fn(cfg)(st))
    assert cls.mode == "hybrid" and "fp_disagree" in cls.describe()["terms"]
    if det:
        idx = torch.arange(N)
        elig = st.alive[:, None] & (st.state == KNOWN) & (idx[:, None] != idx[None, :])
        tgt = choose_one_of_oldest_k(st.timer, elig, 5, (0, 0), True).long()
        pinged = tgt >= 0
        assert bool((pinged & (tgt[tgt.clamp(min=0)] == idx)).any()), "no mutual ping"
    k = 10
    got = make_leap_fn(cfg, k, hybrid=True)(st)
    assert_state(jax_leap(jcfg, k, hybrid=True)(to_jax(st)), got, "sterile AE vs JAX")
    assert_state(dense(st, cfg, k), got, "sterile AE vs port dense")
    assert bool((got.kpr_partner >= 0).any()), "anti-entropy never fired"


def test_leaps_with_proxy_rebroadcast_and_share_age_off_default():
    """``num_indirect_ping_peers``, ``rebroadcast_interval_ticks`` and
    ``max_peer_share_age_ticks`` off their defaults: the strict leap from a
    converged state and the hybrid leap with anti-entropy firing equal the
    JAX leaps and the port's dense ticks."""
    cfg, jcfg = cfgs(ping_timeout_ticks=48, num_indirect_ping_peers=2,
                     rebroadcast_interval_ticks=4, max_peer_share_age_ticks=6)
    st = converged(seed=5)
    got = make_leap_fn(cfg, 9)(st)
    assert_state(jax_leap(jcfg, 9)(to_jax(st)), got, "strict vs JAX")
    assert_state(dense(st, cfg, 9), got, "strict vs port dense")
    st = ae_state(cfg)
    got = make_leap_fn(cfg, 10, hybrid=True)(st)
    assert_state(jax_leap(jcfg, 10, hybrid=True)(to_jax(st)), got, "hybrid vs JAX")
    assert_state(dense(st, cfg, 10), got, "hybrid vs port dense")
    assert bool((got.kpr_partner >= 0).any()), "anti-entropy never fired"


def test_masked_leap_over_members_equals_standalone():
    """One masked call over [E] leaves, each member at its own k_m (0
    included), equals each member's standalone leap of its own length."""
    cfg, _ = cfgs(ping_timeout_ticks=48)
    members = [converged(seed=0), drain_state(cfg), ae_state(cfg), drain_state(cfg, seed=5)]
    k_m = [16, 8, 0, 5]
    out = make_leap_fn(cfg, 16, hybrid=True, masked=True)(_stack_states(members),
                                                         torch.tensor(k_m, dtype=torch.int32))
    fleet = FleetState(mesh=out, drop_rate=torch.zeros(4))
    for e, (st, k) in enumerate(zip(members, k_m)):
        want = st if k == 0 else make_leap_fn(cfg, k, hybrid=True)(st)
        assert_state(want, member_state(fleet, e), f"member {e}")


# ---------------------------------------------------------------- runners


def churn_inputs(T=112):
    """A kill, a short partition (cross-group pings left waiting on alive
    peers after the heal), a manual ping and a revive, then a calm tail: under
    ``RCFG`` the exact runner takes hybrid and strict spans, and the
    distributional one promotes waiting-on-alive classes as well."""
    return (Scenario(N, T).kill_at(4, [3]).partition_at(40, np.arange(N) % 2, until=44)
            .manual_ping_at(60, 0, 2).revive_at(70, [3]).build(CPU))


def _assert_metrics(jm, tm, where):
    if jm is None:
        assert tm is None, where
        return
    assert_same(_np_leaves(jm), metrics_to_numpy(tm), where)


def test_simulate_warped_matches_jax():
    """Final state, dense ticks and their metrics, boundary states, and the
    ledger's per-class and why-dense tables, against the JAX runner; and
    the final state against the port's dense run."""
    cfg, jcfg = cfgs(**RCFG_KW)
    st = converged(seed=1)
    inp = churn_inputs()
    bounds, jbounds = [], []
    led, jled = runner.WarpLedger(), jrunner.WarpLedger()
    got, ticks, m = runner.simulate_warped(st, inp, cfg, recheck_every=4, ledger=led,
                                           on_boundary=lambda t, s: bounds.append((t, s)))
    want, jticks, jm = jrunner.simulate_warped(to_jax(st), inputs_to_jax(inp), jcfg,
                                               recheck_every=4, ledger=jled,
                                               on_boundary=lambda t, s: jbounds.append((t, s)))
    assert_state(want, got, "final")
    np.testing.assert_array_equal(ticks, jticks)
    _assert_metrics(jm, m, "dense metrics")
    assert [t for t, _ in bounds] == [t for t, _ in jbounds] and len(bounds) >= 2
    for (t, s), (_, js) in zip(bounds, jbounds):
        assert_state(js, s, f"boundary {t}")
    assert led.per_class() == jled.per_class()
    assert led.blocked_histogram() == jled.blocked_histogram()
    assert {r["engine"] for r in led.spans} >= {"leap", "hybrid"}
    tick = make_tick_fn(cfg, faulty=True)
    ref = st
    for t in range(inp.kill.shape[0]):
        ref, _ = tick(ref, inp.at(t))
    assert_state(ref, got, "final vs port dense")


def test_simulate_warped_telemetry_and_memo_match_jax():
    cfg, jcfg = cfgs(**RCFG_KW)
    st = converged(seed=1)
    inp = churn_inputs()
    jst, jinp = to_jax(st), inputs_to_jax(inp)
    # Telemetry: dense counters plus each strict leap's closed form.
    got, ticks, tel, totals = runner.simulate_warped(st, inp, cfg, recheck_every=4,
                                                     telemetry=True)
    want, jticks, jtel, jtotals = jrunner.simulate_warped(jst, jinp, jcfg, recheck_every=4,
                                                          telemetry=True)
    assert_state(want, got, "telemetry final")
    np.testing.assert_array_equal(ticks, jticks)
    assert totals == jtotals and set(totals) == set(FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(tel.counters, f).numpy().astype(np.int64),
            np.asarray(getattr(jtel.counters, f)).astype(np.int64), err_msg=f)
    # Memo: a banking pass, then a replay that is all hits and runs nothing.
    plain, pticks, pm = runner.simulate_warped(st, inp, cfg, recheck_every=4)
    jplain = jrunner.simulate_warped(jst, jinp, jcfg, recheck_every=4)[0]
    memo, jmemo = runner.SpanMemo(), jrunner.SpanMemo()
    for run in range(2):
        led, jled = runner.WarpLedger(), jrunner.WarpLedger()
        w, wt, wm = runner.simulate_warped(st, inp, cfg, recheck_every=4, memo=memo, ledger=led)
        jrunner.simulate_warped(jst, jinp, jcfg, recheck_every=4, memo=jmemo, ledger=jled)
        assert_state(jplain, w, f"memo run {run}")
        assert_state(plain, w, f"memo run {run} vs memo off")
        np.testing.assert_array_equal(wt, pticks)
        assert_same(metrics_to_numpy(pm), metrics_to_numpy(wm), f"memo metrics {run}")
        assert led.per_class() == jled.per_class()
        if run == 1:
            assert all(r["engine"].endswith("+memo") for r in led.spans)
            assert all(r["dispatches"] == 0 for r in led.spans) and not led.blocked
    s = memo.stats()
    assert s["hits"] > 0 and s["hits"] == s["misses"] and s["evictions"] == 0
    assert {k: v for k, v in s.items() if k != "bytes"} == {
        k: v for k, v in jmemo.stats().items() if k != "bytes"}


def test_distributional_matches_jax_bit_for_bit():
    """The distributional tier runs the same programs on the same draws as
    the JAX one, so the runs agree bit for bit, here with classes promoted
    from dense (waiting on alive peers after the partition heals)."""
    cfg, jcfg = cfgs(**RCFG_KW)
    inp = churn_inputs()
    st = converged(seed=1)
    led, jled = runner.WarpLedger(), jrunner.WarpLedger()
    got, ticks, m = runner.simulate_warped(st, inp, cfg, recheck_every=4, ledger=led,
                                           warp_mode="distributional")
    want, jticks, jm = jrunner.simulate_warped(to_jax(st), inputs_to_jax(inp), jcfg,
                                               recheck_every=4, ledger=jled,
                                               warp_mode="distributional")
    assert_state(want, got, "distributional final")
    np.testing.assert_array_equal(ticks, jticks)
    _assert_metrics(jm, m, "distributional metrics")
    assert led.per_class() == jled.per_class()
    assert any("waiting_on_alive" in r["class"]["terms"]
               for r in led.spans if r["engine"] == "hybrid")
    with pytest.raises(ValueError, match="warp_mode"):
        runner.run_warped(st, cfg, 8, warp_mode="fast")


def test_run_warped_drain_crosses_expiry():
    """A budget that crosses the first timer expiry: hybrid spans leap the
    waiting window, the expiry season runs dense; equal to JAX and to the
    port's dense run, with and without the memo and the hybrid program."""
    cfg, jcfg = cfgs(**RCFG_KW)
    st = drain_state(cfg, victims=(7,))
    ticks = (horizon.earliest_timer_expiry(st, cfg) - int(st.tick)) + 24
    led, jled = runner.WarpLedger(), jrunner.WarpLedger()
    got, ran, conv = runner.run_warped(st, cfg, ticks, recheck_every=4, ledger=led)
    want, jran, jconv = jrunner.run_warped(to_jax(st), jcfg, ticks, recheck_every=4,
                                           ledger=jled)
    assert (ran, conv) == (int(jran), bool(jconv)) and ran == ticks
    assert_state(want, got, "run_warped vs JAX")
    assert_state(dense(st, cfg, ticks), got, "run_warped vs port dense")
    assert led.per_class() == jled.per_class()
    assert any(r["engine"] == "hybrid" for r in led.spans)
    off = runner.WarpLedger()
    assert_state(got, runner.run_warped(st, cfg, ticks, hybrid=False, ledger=off)[0], "hybrid off")
    assert not any(r["engine"] == "hybrid" for r in off.spans)
    memo = runner.SpanMemo()
    for _ in range(2):
        assert_state(got, runner.run_warped(st, cfg, ticks, recheck_every=4, memo=memo)[0], "memo")
    assert memo.stats()["hits"] > 0


def test_run_fleet_warped_matches_jax_and_standalone():
    """Converged, mid-drain and mid-boot members on their own clocks: each
    equals the JAX fleet's member and the standalone ``run_warped``; the
    leapable members leap; a memo replay is all hits and bit-equal."""
    cfg, jcfg = cfgs(**RCFG_KW)
    ticks = 24
    members = [converged(seed=0), drain_state(cfg, victims=(12,), seed=1),
               init_state(N, seed=2, ring_contacts=2, device=CPU)]
    fleet = FleetState(mesh=_stack_states(members), drop_rate=torch.zeros(3))
    jfleet = JaxFleetState(mesh=jax.tree.map(lambda *xs: jnp.stack(xs), *map(to_jax, members)),
                           drop_rate=jnp.zeros((3,), jnp.float32))
    led, jled = runner.WarpLedger(), jrunner.WarpLedger()
    out, ran, conv = runner.run_fleet_warped(fleet, cfg, ticks, recheck_every=4, ledger=led)
    jout, jran, jconv = jrunner.run_fleet_warped(jfleet, jcfg, ticks, recheck_every=4,
                                                 ledger=jled)
    assert ran == int(jran) == ticks
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert_state(jout.mesh, out.mesh, "fleet vs JAX")
    for e, st in enumerate(members):
        assert_state(runner.run_warped(st, cfg, ticks, recheck_every=4)[0],
                     member_state(out, e), f"member {e} vs standalone")
    assert led.per_class() == jled.per_class()
    assert led.blocked_histogram() == jled.blocked_histogram()
    assert {r["engine"] for r in led.spans} & {"fleet-leap", "fleet-hybrid"}
    memo = runner.SpanMemo()
    for run in range(2):
        led = runner.WarpLedger()
        got = runner.run_fleet_warped(fleet, cfg, ticks, recheck_every=4, memo=memo, ledger=led)[0]
        assert_state(out.mesh, got.mesh, f"fleet memo run {run}")
    assert memo.stats()["per_kind"]["fleet"]["hits"] > 0
    assert any(r["engine"].endswith("+memo") for r in led.spans)


def test_memo_fleet_leap_cross_member_hits():
    """A delta banked from a 2-member call replays for a 4-member fleet of
    the same member: all hits, no call, bit-equal to the call's result."""
    cfg, _ = cfgs(**RCFG_KW)
    member = converged(seed=0)
    prog = runner._get_fleet_leap(cfg, 8)
    memo = runner.SpanMemo()
    two, four = _stack_states([member] * 2), _stack_states([member] * 4)
    out2, hits2, called2 = runner.memo_fleet_leap("fam", two, np.full(2, 8), memo, prog)
    assert called2 and hits2 == 0
    assert_state(prog(two, torch.full((2,), 8, dtype=torch.int32)), out2, "called")
    out4, hits4, called4 = runner.memo_fleet_leap("fam", four, np.full(4, 8), memo, prog)
    assert not called4 and hits4 == 4
    assert_state(prog(four, torch.full((4,), 8, dtype=torch.int32)), out4, "replayed")
    assert memo.stats()["per_kind"]["fleet"] == {"hits": 4, "misses": 2, "hit_rate": 0.6667}


# ---------------------------------------------------------------- caches


def test_program_cache_refuses_non_buckets_and_stays_bounded():
    with pytest.raises(ValueError, match="power-of-two bucket"):
        runner.leap_cache.get(("fam",), "strict", 12, lambda: None)
    with pytest.raises(ValueError, match="power-of-two bucket"):
        runner.leap_cache.get(("fam",), "strict", runner.MIN_LEAP // 2, lambda: None)
    cfg, _ = cfgs(num_candidate_target_peers=4)  # a family no other test builds
    st = converged(seed=6, n=16)
    before = {k for k in runner.leap_cache._programs if k[0] == cfg}
    for ticks in (9, 11, 13, 17, 21, 27, 33, 41, 53, 61):
        out, ran, conv = runner.run_warped(st, cfg, ticks)
        assert ran == ticks and conv
    new = {k for k in runner.leap_cache._programs if k[0] == cfg} - before
    assert {k[2] for k in new} == {8, 16, 32} and all(k[2] in runner.CHUNK_BUCKETS for k in new)
    stats = runner.leap_cache.stats()
    assert stats["max_family_programs"] <= stats["per_family_bound"]
    assert_state(dense(st, cfg, 61), out, "61 ticks vs port dense")


def test_span_memo_bounds_and_stats():
    memo = runner.SpanMemo(max_bytes=100, max_entries=3)
    memo.put("big", ("x",), 200)  # over the whole budget: never stored
    for key in ("a", "b", "c"):
        memo.put(key, (key,), 10)
    assert memo.get("a") == ("a",)  # "b" is now least recent
    memo.put("d", ("d",), 10)
    assert memo.get("b", kind="dense") is None and memo.get("big") is None
    s = memo.stats()
    assert (s["entries"], s["evictions"], s["bytes"]) == (3, 1, 30)
    assert s["per_kind"]["dense"] == {"hits": 0, "misses": 1, "hit_rate": 0.0}
    memo.put("e", ("e",), 80)  # 110 > 100 bytes: the least recent go
    assert memo.stats()["bytes"] <= 100
    memo.clear()
    assert memo.stats()["entries"] == 0 and memo.stats()["hits"] == 0


def test_memo_replay_rebuilds_each_leaf_in_its_dtype():
    """XOR replay gives back every leaf bit for bit, in its own dtype: int32
    holding uint32 bits, int16 timers, bool, float32 with NaNs."""
    cfg, _ = cfgs(ping_timeout_ticks=48)
    for entry in (converged(seed=9), drain_state(cfg, lean=True)):
        exit_ = make_leap_fn(cfg, 8, hybrid=True)(entry)
        leaves = runner._host_leaves(entry)
        deltas = [runner._xor_delta(a, b) for a, b in zip(leaves, runner._host_leaves(exit_))]
        back = runner._memo_replay(entry, leaves, deltas)
        assert_state(exit_, back, "replay")
        for f in dataclasses.fields(back):
            x = getattr(back, f.name)
            if x is not None:
                assert x.dtype == getattr(exit_, f.name).dtype and x.device == entry.device


# ---------------------------------------------------------------- sharded warp
# ``mesh=``: 2 gloo ranks (kaboodle_tpu_torch.parallel.worker), 12 of the 24
# rows each, started once for the module. The worker holds each warped run
# to the row-sharded dense tick over the same ticks; these tests hold it to
# the port's one-process runs (held to JAX above).

WARP_RANKS = 2


@pytest.fixture(scope="module")
def sharded_warp(tmp_path_factory):
    import json as _json

    from kaboodle_tpu_torch.parallel.worker import start_workers

    tmp = tmp_path_factory.mktemp("sharded_warp")
    inp = churn_inputs()
    np.savez(tmp / "churn.npz", **{f.name: getattr(inp, f.name).numpy()
                                   for f in dataclasses.fields(inp)
                                   if getattr(inp, f.name) is not None})
    drain_ticks = (horizon.earliest_timer_expiry(drain_state(SwimConfig(**RCFG_KW), victims=(7,)),
                                                 SwimConfig(**RCFG_KW))
                   - int(drain_state(SwimConfig(**RCFG_KW), victims=(7,)).tick)) + 24
    cases = [
        dict(name="conv_run", kind="warp", n=N, init=dict(seed=5), ticks=64, memo=True),
        dict(name="drain_run", kind="warp", n=N, init=dict(seed=3), victims=[7], cfg=RCFG_KW,
             ticks=drain_ticks),
        dict(name="churn_sim", kind="warp", n=N, init=dict(seed=1), cfg=RCFG_KW, memo=True,
             inputs=str(tmp / "churn.npz")),
        dict(name="converge_entry", kind="converge", n=N, max_ticks=16,
             init=dict(seed=0, ring_contacts=N - 1, announced=True)),
    ]
    for c in cases:
        c["out"] = str(tmp / f"{c['name']}.npz")
    digests = start_workers(WARP_RANKS, {"device": "cpu", "timeout_s": 60, "cases": cases},
                            str(tmp / "cases.json"), timeout_s=120).wait()
    arrays = {}
    for c in cases:
        with np.load(c["out"]) as z:
            arrays[c["name"]] = {k: z[k] for k in z.files}
    return digests, arrays, drain_ticks, _json


def _sharded_state(arrays) -> dict:
    return {k[len("state."):]: v for k, v in arrays.items() if k.startswith("state.")}


def _assert_sharded(want_state, arrays, where):
    want = {k: v for k, v in state_to_numpy(want_state).items() if v is not None}
    assert_same(want, _sharded_state(arrays), where)


def test_run_warped_sharded_matches_dense(sharded_warp):
    """The leap on the ranks' rows (row-local scatters, the remote refresh
    marks gathered) equals the sharded dense trajectory and the port's
    one-process dense run; a memo pass replays it bit for bit."""
    digests, arrays, _, _ = sharded_warp
    for d in digests["conv_run"]:
        assert d["equal_sharded_dense"] and d["replay_equal"] and d["memo_hits"] > 0
        assert d["engines"] == ["leap"]
    _assert_sharded(dense(converged(seed=5), SwimConfig(), 64), arrays["conv_run"], "conv run")


def test_run_warped_sharded_drain_crosses_expiry(sharded_warp):
    """The drain: hybrid spans on the ranks' rows, the expiry season dense;
    equal to the one-process warped run, span for span."""
    digests, arrays, ticks, _json = sharded_warp
    cfg = SwimConfig(**RCFG_KW)
    st = drain_state(cfg, victims=(7,))
    led = runner.WarpLedger()
    want, _, _ = runner.run_warped(st, cfg, ticks, recheck_every=4, ledger=led)
    _assert_sharded(want, arrays["drain_run"], "sharded drain")
    for d in digests["drain_run"]:
        assert d["equal_sharded_dense"] and "hybrid" in d["engines"]
        assert d["per_class"] == _json.loads(_json.dumps(led.per_class()))


def test_simulate_warped_sharded_matches_one_process(sharded_warp):
    """A schedule of events (its mask OR-reduced over the ranks) through
    ``simulate_warped(mesh=)``: the same spans as the one-process run, the
    same final state, a memo replay equal."""
    digests, arrays, _, _json = sharded_warp
    cfg = SwimConfig(**RCFG_KW)
    led = runner.WarpLedger()
    want, _, _ = runner.simulate_warped(converged(seed=1), churn_inputs(), cfg, recheck_every=4,
                                        ledger=led)
    _assert_sharded(want, arrays["churn_sim"], "sharded churn")
    for d in digests["churn_sim"]:
        assert d["equal_sharded_dense"] and d["replay_equal"]
        assert {"leap", "hybrid"} <= set(d["engines"])
        assert d["per_class"] == _json.loads(_json.dumps(led.per_class()))


def test_converge_loop_entry_check_sharded(sharded_warp):
    """A mesh that agrees at entry: run_until_converged_sharded returns at
    once, ticks 0, the state untouched."""
    digests, arrays, _, _ = sharded_warp
    assert all(d["ticks"] == 0 and d["converged"] for d in digests["converge_entry"])
    _assert_sharded(converged(seed=0), arrays["converge_entry"], "entry state")
