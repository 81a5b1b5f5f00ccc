"""The port's row-blocked tick against the JAX package's, state and metrics per tick.

Both engines start from the same numpy state and inputs and are compared
after every tick, as in ``test_torch_tick.py``: every integer and bool leaf
and metric bit for bit, ``latency`` with NaN positions equal and
``rtol=1e-5``. Random mode is included: the port draws the D10 per-block
streams (escalation proxies, join-reply Bernoulli, random drop) exactly as
the JAX blocked tick does. The port's blocked tick is also held against the
port's dense tick in deterministic mode (the reference's contract), and its
op coverage against the JAX planner's ``blocked`` program.

Each jitted JAX blocked tick costs seconds to compile, so the builds are
cached per module and the cases share them where they can.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.phasegraph.graph import build_graph
from kaboodle_tpu.phasegraph.plan import plan
from kaboodle_tpu.sim import runner as jrunner
from kaboodle_tpu.sim import scenario as jscen
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.sim.chunked import make_chunked_tick_fn as jax_make_chunked_tick_fn
from kaboodle_tpu.spec import WAITING_FOR_INDIRECT_PING
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph.blocked import BLOCKED_OPS
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sim.chunked import make_chunked_tick_fn
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.sim.runner import converge_loop
from kaboodle_tpu_torch.telemetry import FIELDS

CPU = "cpu"
N = 64
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_chunked():
    """One jitted JAX blocked tick per build, shared by the module."""
    cache = {}

    def get(cfg, **kw):
        key = (cfg, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax.jit(jax_make_chunked_tick_fn(cfg, **kw))
        return cache[key]

    return get


def _leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same(want: dict, got: dict, where: str):
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {k} {w.dtype} {g.dtype}"
        if k == "latency":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


def _counters(c) -> dict:
    """Counters as uint32-free numpy: ``gossip_bytes`` as its 32 bits."""
    return {f: np.asarray(getattr(c, f)).astype(np.int64) & 0xFFFFFFFF for f in FIELDS}


def _jax_state(n, lean, **kw):
    return jstate.init_state(n, track_latency=not lean, instant_identity=lean,
                             timer_dtype=jnp.int16 if lean else jnp.int32, **kw)


def _fault_schedule(n: int, ticks: int) -> jstate.TickInputs:
    """Every fault path (``tests/test_chunked.py``): kills (escalations,
    removals), a revive (join re-entry), a partition window, manual pings
    and a pinned drop mask."""
    rng = np.random.default_rng(7)
    kill = np.zeros((ticks, n), bool)
    kill[5, [3, min(7, n - 1)]] = True
    rev = np.zeros((ticks, n), bool)
    rev[12, 3] = True
    part = np.zeros((ticks, n), np.int32)
    part[15:20, : n // 2] = 1
    man = np.full((ticks, n), -1, np.int32)
    man[8, 0] = min(9, n - 1)
    man[22, 4] = min(17, n - 1)
    return jstate.TickInputs(
        kill=jnp.asarray(kill), revive=jnp.asarray(rev), partition=jnp.asarray(part),
        drop_rate=jnp.zeros((ticks,), jnp.float32), manual_target=jnp.asarray(man),
        drop_ok=jnp.asarray(rng.random((ticks, n, n)) > 0.15),
    )


def _run_both(jtick, ttick, jst, jinp, ticks, telemetry=False):
    """Tick both engines over stacked JAX inputs; compare after every tick.

    Returns the JAX states seen and the port's final state."""
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    seen = []
    for t in range(ticks):
        jst, jout = jtick(jst, jax.tree.map(lambda x: x[t], jinp))
        tst, tout = ttick(tst, tinp.at(t))
        _assert_same(_leaves(jst), tstate.state_to_numpy(tst), f"tick {t} state")
        for f in ("state", "timer", "latency", "id_view"):
            assert getattr(tst, f) is None or getattr(tst, f).is_contiguous(), f
        if telemetry:
            assert _counters(tout.counters) == _counters(jout.counters), f"tick {t} counters"
            np.testing.assert_array_equal(tout.fp.numpy().view(np.uint32), np.asarray(jout.fp))
            jout, tout = jout.metrics, tout.metrics
        _assert_same(_leaves(jout), tstate.metrics_to_numpy(tout), f"tick {t} metrics")
        seen.append(jst)
    return seen, tst


def _escalated(states) -> bool:
    return any(bool(jnp.any(s.state == WAITING_FOR_INDIRECT_PING)) for s in states)


@pytest.mark.parametrize("det,lean,block", [
    (True, False, N // 4), (True, True, N // 4), (False, False, N // 4),
    (False, True, N // 4), (True, False, N // 2), (False, True, N),
])
def test_fault_schedule_per_tick(jax_chunked, det, lean, block):
    """Join avalanche, kills, escalation, removals, a revive, a partition,
    manual pings and a pinned drop mask, over 30 ticks."""
    seen, _ = _run_both(
        jax_chunked(JaxSwimConfig(deterministic=det), block=block),
        make_chunked_tick_fn(SwimConfig(deterministic=det), block=block),
        _jax_state(N, lean, seed=1), _fault_schedule(N, 30), 30)
    assert _escalated(seen)


def test_random_drop_draws(jax_chunked):
    """drop_rate > 0 with drop=True: the per-block D10 drop draws, and the
    escalation proxies they cause, in random mode."""
    ticks = 24
    sc = jscen.Scenario(N, ticks).drop(0.15, stop=16).kill_at(1, [3])
    seen, _ = _run_both(jax_chunked(JaxSwimConfig(), block=N // 4),
                        make_chunked_tick_fn(SwimConfig(), block=N // 4),
                        _jax_state(N, True, seed=12), sc.build(), ticks)
    assert _escalated(seen)


@pytest.mark.parametrize("det", [False, True])
def test_boot_union_then_converge(jax_chunked, det):
    """Tick 0 of a broadcast boot through the closed-form union, then the
    fault-free blocked build until agreement (``converge_loop``)."""
    jcfg, tcfg = JaxSwimConfig(deterministic=det), SwimConfig(deterministic=det)
    idle = jstate.idle_inputs(N, ticks=1)
    seen, tst = _run_both(jax_chunked(jcfg, faulty=False, block=16, boot_union=True),
                          make_chunked_tick_fn(tcfg, faulty=False, block=16, boot_union=True),
                          _jax_state(N, True, seed=6), idle, 1)
    jst, jtick = seen[-1], jax_chunked(jcfg, faulty=False, block=16)
    jconv, jticks = bool(jrunner.state_converged(jst)), 0
    while not jconv and jticks < 16:
        jst, m = jtick(jst, jax.tree.map(lambda x: x[0], idle))
        jconv, jticks = bool(m.converged), jticks + 1
    final, ticks, conv = converge_loop(
        tst, make_chunked_tick_fn(tcfg, faulty=False, block=16), max_ticks=16)
    assert (ticks, conv) == (jticks, jconv) and conv
    _assert_same(_leaves(jst), tstate.state_to_numpy(final), "converged")


def test_boot_union_rejects_faulty_build():
    with pytest.raises(ValueError, match="boot_union"):
        make_chunked_tick_fn(SwimConfig(), faulty=True, boot_union=True)


def test_block_must_divide_n():
    st = tstate.init_state(48, device=CPU)
    with pytest.raises(ValueError, match="does not divide"):
        make_chunked_tick_fn(SwimConfig(), faulty=False, block=5)(
            st, tstate.idle_inputs(48, device=CPU))


@pytest.mark.parametrize("kw,churn", [
    # Failed broadcasts delivered: the blocked Failed-delivery contraction.
    # Peers killed and revived one a tick while others time them out: a
    # revived peer's Join meets its Failed broadcasts on the same tick, so
    # the origin-order rule (a Join(j) wins only against origins i < j) runs.
    (dict(faithful_failed_broadcast=False, faithful_indirect_ack=False), True),
    # The D5 share cap below N: the capped branch of the blocked union.
    (dict(deterministic=True, max_share_peers=8, faithful_failed_broadcast=False), False),
    # The three fields no other case varies, under the kill/revive churn.
    (dict(num_indirect_ping_peers=2, rebroadcast_interval_ticks=4, max_peer_share_age_ticks=6),
     True),
])
def test_protocol_variants(jax_chunked, kw, churn):
    sc = jscen.Scenario(N, 30).kill_at(2, list(range(50, 58)))
    for k in range(8):
        sc.revive_at(6 + k, [50 + k])
    inp = sc.build() if churn else _fault_schedule(N, 30)
    seen, _ = _run_both(jax_chunked(JaxSwimConfig(**kw), block=N // 4),
                        make_chunked_tick_fn(SwimConfig(**kw), block=N // 4),
                        _jax_state(N, False, seed=2), inp, 30)
    assert _escalated(seen)


def test_gossip_boot(jax_chunked):
    """Join broadcasts off, fresh stamps, ring contacts: membership spreads
    by traffic and anti-entropy alone."""
    kw = dict(deterministic=True, join_broadcast_enabled=False, backdate_gossip_inserts=False)
    _run_both(jax_chunked(JaxSwimConfig(**kw), faulty=False, block=N // 4),
              make_chunked_tick_fn(SwimConfig(**kw), faulty=False, block=N // 4),
              _jax_state(N, True, seed=0, ring_contacts=2), jstate.idle_inputs(N, ticks=24), 24)


def test_telemetry_build(jax_chunked):
    """Counters and the digest plane equal to JAX's per tick; the state
    equal to the telemetry-off build's."""
    ticks = 30
    jinp = _fault_schedule(N, ticks)
    jst = _jax_state(N, False, seed=3)
    _, tel_final = _run_both(
        jax_chunked(JaxSwimConfig(), block=N // 4, telemetry=True),
        make_chunked_tick_fn(SwimConfig(), block=N // 4, telemetry=True),
        jst, jinp, ticks, telemetry=True)
    tick = make_chunked_tick_fn(SwimConfig(), block=N // 4)
    st = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    for t in range(ticks):
        st, _ = tick(st, tinp.at(t))
    _assert_same(tstate.state_to_numpy(st), tstate.state_to_numpy(tel_final), "telemetry off/on")


@pytest.mark.parametrize("lean", [False, True])
def test_blocked_equals_dense_deterministic(lean):
    """The reference's contract, on the port alone: in deterministic mode
    the blocked tick is the dense tick (kernel flags on, plain versions)."""
    cfg = SwimConfig(deterministic=True)
    jinp = _fault_schedule(N, 30)
    start = tstate.state_from_numpy(_leaves(_jax_state(N, lean, seed=1)), device=CPU)
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    dense = make_tick_fn(SwimConfig(deterministic=True, **FLAGS))
    blocked = make_chunked_tick_fn(cfg, block=N // 4)
    a = b = start
    for t in range(30):
        a, ma = dense(a, tinp.at(t))
        b, mb = blocked(b, tinp.at(t))
        _assert_same(tstate.state_to_numpy(a), tstate.state_to_numpy(b), f"tick {t} state")
        _assert_same(tstate.metrics_to_numpy(ma), tstate.metrics_to_numpy(mb), f"tick {t}")


def test_op_coverage_pinned_to_planner():
    """Every op of the JAX planner's blocked program, for every flag set the
    tests build, has a body here; together they are exactly BLOCKED_OPS."""
    seen = set()
    for kw in (dict(), dict(join_broadcast_enabled=False), dict(faithful_failed_broadcast=False),
               dict(deterministic=True, max_share_peers=8, faithful_failed_broadcast=False),
               dict(deterministic=True, join_broadcast_enabled=False,
                    backdate_gossip_inserts=False)):
        for faulty in (False, True):
            for telemetry in (False, True):
                ops = set(plan(build_graph(JaxSwimConfig(**kw), faulty=faulty,
                                           telemetry=telemetry), "blocked").op_names())
                assert ops <= BLOCKED_OPS, ops - BLOCKED_OPS
                seen |= ops
    assert seen == BLOCKED_OPS
