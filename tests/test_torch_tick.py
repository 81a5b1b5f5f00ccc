"""The port's dense tick against the JAX package's, state and metrics per tick.

Both engines start from the same numpy state and inputs (the JAX state
carried across with ``state_from_numpy``) and are compared after every
tick: every integer and bool leaf and metric bit for bit, ``latency`` with
NaN positions equal and ``rtol=1e-5`` (an f32 EWMA may be contracted into
FMAs by one compiler and not the other). The JAX side runs its jnp
formulations (kernel flags off, fast to compile); the port runs with its
kernel flags both off and on (on the CPU a flag that is on takes the
kernel's plain version), so the whole tick pins the fused ops too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.sim import runner as jrunner
from kaboodle_tpu.sim import scenario as jscen
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.sim.kernel import make_tick_fn as jax_make_tick_fn
from kaboodle_tpu.spec import WAITING_FOR_INDIRECT_PING
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.sim import runner, scenario
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sim.kernel import make_tick_fn

CPU = "cpu"
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small-N tensor ops run fastest on one thread, and leave the other
    test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tick():
    """One jitted JAX tick per (cfg, faulty, program), shared by the module."""
    cache = {}

    def get(cfg, faulty=True, program=None):
        key = (cfg, faulty, program)
        if key not in cache:
            cache[key] = jax.jit(jax_make_tick_fn(cfg, faulty=faulty, program=program))
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


def _jax_state(n, lean, **kw):
    return jstate.init_state(n, track_latency=not lean, instant_identity=lean,
                             timer_dtype=jnp.int16 if lean else jnp.int32, **kw)


def _run_both(jtick, ttick, jst, jinp, ticks):
    """Tick both engines over stacked JAX inputs; compare after every tick.

    Returns the JAX states seen, for the callers' checks on which paths ran."""
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    seen = []
    for t in range(ticks):
        jst, jm = jtick(jst, jax.tree.map(lambda x: x[t], jinp))
        tst, tm = ttick(tst, tinp.at(t))
        _assert_same(_leaves(jst), tstate.state_to_numpy(tst), f"tick {t} state")
        for f in ("state", "timer", "latency", "id_view"):  # the kernels' layout
            assert getattr(tst, f) is None or getattr(tst, f).is_contiguous(), f
        _assert_same(_leaves(jm), tstate.metrics_to_numpy(tm), f"tick {t} metrics")
        seen.append(jst)
    return seen


def _escalated(states) -> bool:
    return any(bool(jnp.any(s.state == WAITING_FOR_INDIRECT_PING)) for s in states)


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("lean", [False, True])
def test_churn_per_tick(jax_tick, det, lean):
    """Config-3-style churn at N=128 over 48 ticks: kills, revives (Join
    broadcasts + replies + gossip unions), suspicion, escalation, removal."""
    sc = jscen.baseline_scenario(3, n=128, ticks=48, seed=3)
    jst = _jax_state(128, lean, seed=5, alive=jnp.asarray(sc.initial_alive()))
    seen = _run_both(jax_tick(JaxSwimConfig(deterministic=det)),
                     make_tick_fn(SwimConfig(deterministic=det, **FLAGS if lean else {})),
                     jst, sc.build(), 48)
    assert _escalated(seen)


@pytest.mark.parametrize("det", [False, True])
def test_churn_with_kernel_flags_full_state(jax_tick, det):
    sc = jscen.baseline_scenario(3, n=128, ticks=40, seed=8)
    jst = _jax_state(128, False, seed=1)
    seen = _run_both(jax_tick(JaxSwimConfig(deterministic=det)),
                     make_tick_fn(SwimConfig(deterministic=det, **FLAGS)),
                     jst, sc.build(), 40)
    assert _escalated(seen)


@pytest.mark.parametrize("det", [False, True])
def test_boot_run_until_converged(det):
    """Broadcast boot to convergence, and the entry check on a converged mesh."""
    jc, tc = JaxSwimConfig(deterministic=det), SwimConfig(deterministic=det, **FLAGS)
    jst = _jax_state(64, True, seed=9)
    jfinal, jticks, jconv = jrunner.run_until_converged(jst, jc, max_ticks=16)
    tfinal, tticks, tconv = runner.run_until_converged(
        tstate.state_from_numpy(_leaves(jst), device=CPU), tc, max_ticks=16)
    assert (tticks, tconv) == (int(jticks), bool(jconv)) and tconv
    _assert_same(_leaves(jfinal), tstate.state_to_numpy(tfinal), "boot")
    again, ticks0, conv0 = runner.run_until_converged(tfinal, tc, max_ticks=16)
    assert (ticks0, conv0) == (0, True) and again is tfinal


@pytest.mark.parametrize("lean", [False, True])
def test_programs_full_fused_dispatched(jax_tick, lean):
    """On calm steady-state ticks the three programs give the same state,
    and each equals its JAX counterpart."""
    n = 96
    jst = _jax_state(n, lean, seed=4, ring_contacts=n - 1, announced=True)
    jinp = jstate.idle_inputs(n, ticks=10)
    finals = []
    for program in (None, "full", "fused"):
        cfg = JaxSwimConfig()
        seen = _run_both(jax_tick(cfg, faulty=False, program=program),
                         make_tick_fn(SwimConfig(**FLAGS), faulty=False, program=program),
                         jst, jinp, 10)
        finals.append(_leaves(seen[-1]))
    for other in finals[1:]:
        _assert_same(finals[0], other, "program")


@pytest.mark.parametrize("det", [False, True])
def test_gossip_boot_without_broadcasts(jax_tick, det):
    """join_broadcast_enabled=False with ring contacts: membership spreads
    by traffic and anti-entropy alone (the predicate is any_a2 only)."""
    n = 64
    cfg = JaxSwimConfig(join_broadcast_enabled=False, deterministic=det)
    jst = _jax_state(n, False, seed=2, ring_contacts=2)
    _run_both(jax_tick(cfg, faulty=False),
              make_tick_fn(SwimConfig(join_broadcast_enabled=False, deterministic=det),
                           faulty=False),
              jst, jstate.idle_inputs(n, ticks=24), 24)


def test_drop_mask_partition_heal_manual_ping(jax_tick):
    n, ticks = 64, 30
    rng = np.random.default_rng(6)
    sc = (jscen.Scenario(n, ticks).kill_at(2, [7, 8]).revive_at(12, [7])
          .partition_at(4, np.arange(n) % 2, until=16).manual_ping_at(3, 0, 5)
          .manual_ping_at(5, 9, 9).manual_ping_at(6, 1, n + 3))
    jinp = dataclasses.replace(sc.build(), drop_ok=jnp.asarray(rng.random((ticks, n, n)) < 0.9))
    seen = _run_both(jax_tick(JaxSwimConfig()), make_tick_fn(SwimConfig(**FLAGS)),
                     _jax_state(n, False, seed=3), jinp, ticks)
    assert _escalated(seen)


def test_random_drop_rate(jax_tick):
    n, ticks = 64, 24
    sc = jscen.Scenario(n, ticks).drop(0.15, stop=16).kill_at(1, [3])
    _run_both(jax_tick(JaxSwimConfig()), make_tick_fn(SwimConfig()),
              _jax_state(n, True, seed=12), sc.build(), ticks)


@pytest.mark.parametrize("kw", [
    dict(faithful_failed_broadcast=False, faithful_indirect_ack=False),
    dict(deterministic=True, max_share_peers=40, faithful_failed_broadcast=False),
    dict(oldest_k_method="topk", fast_path=False, backdate_gossip_inserts=False),
    dict(num_candidate_target_peers=9, use_pallas_oldest_k=True),
    # The three fields no other case varies: proxies per escalation, the
    # rebroadcast period and the share age (anti-entropy filter, Q6 back-date).
    dict(num_indirect_ping_peers=2, rebroadcast_interval_ticks=4, max_peer_share_age_ticks=6),
])
def test_protocol_variants(jax_tick, kw):
    """Each variant on both engines; a kernel flag is set on the port only
    (the JAX side keeps its jnp formulation, fast to compile)."""
    sc = jscen.baseline_scenario(3, n=128, ticks=24, seed=1)
    jkw = {f: v for f, v in kw.items() if not f.startswith("use_pallas")}
    _run_both(jax_tick(JaxSwimConfig(**jkw)), make_tick_fn(SwimConfig(**kw)),
              _jax_state(128, False, seed=7), sc.build(), 24)


def test_simulate_matches_scan_and_alive_trajectory():
    """The port's simulate against the JAX scan: final state and the metrics
    stacked on [T]; the final alive mask is the scenario's last row."""
    jsc = jscen.baseline_scenario(3, n=64, ticks=20, seed=2)
    tsc = scenario.baseline_scenario(3, n=64, ticks=20, seed=2)
    jst = _jax_state(64, True, seed=3)
    jfinal, jm = jrunner.simulate(jst, jsc.build(), JaxSwimConfig())
    tfinal, tm = runner.simulate(tstate.state_from_numpy(_leaves(jst), device=CPU),
                                 tsc.build(CPU), SwimConfig(**FLAGS))
    _assert_same(_leaves(jfinal), tstate.state_to_numpy(tfinal), "final")
    _assert_same(_leaves(jm), tstate.metrics_to_numpy(tm), "metrics")
    assert tm.converged.shape == (20,)
    np.testing.assert_array_equal(tfinal.alive.numpy(), tsc.alive_trajectory()[-1])
    assert torch.equal(runner.state_agreement(tfinal)[0], tm.converged[-1])


# ---------------------------------------------------------------- row slices
# The row-sharded tick (parallel/) runs each kernel and each draw on a
# rank's rows: a [B, N] slice at row offset row0. The rows of the whole
# must equal the function on the slice.

ROW_N, ROW_B = 48, 12


def _row_inputs(seed=0, timer_dtype=torch.int16):
    g = torch.Generator().manual_seed(seed)
    state = torch.randint(0, 4, (ROW_N, ROW_N), generator=g, dtype=torch.int8)
    timer = torch.randint(-12, 40, (ROW_N, ROW_N), generator=g, dtype=torch.int32)
    sentinel = torch.rand((ROW_N, ROW_N), generator=g) < 0.05
    timer = torch.where(sentinel, torch.iinfo(timer_dtype).max, timer).to(timer_dtype)
    alive = torch.rand((ROW_N,), generator=g) < 0.8
    idv = torch.randint(-2**31, 2**31 - 1, (ROW_N, ROW_N), generator=g, dtype=torch.int32)
    return state, timer, alive, idv


def _kernel_on(name, state, timer, alive, ident, row0, plain):
    """K1-K4 on rows ``row0 ..`` (``ident``: the rows' identity views for
    fp_idv, every peer's record hashes for fp_hash)."""
    from kaboodle_tpu_torch.ops import fused_fp, fused_oldest_k, fused_suspicion

    if name.startswith("fp_"):
        fn = fused_fp.fused_fp_count_plain if plain else fused_fp.fused_fp_count
        return fn(state, ident)
    if name == "suspicion":
        fn = fused_suspicion.fused_suspicion_plain if plain else fused_suspicion.fused_suspicion
        return fn(state, timer, alive, 9, row0)
    fn = fused_oldest_k.fused_oldest_k_plain if plain else fused_oldest_k.fused_oldest_k
    return fn(state, timer, alive, 5, row0)


@pytest.mark.parametrize("name", ["fp_idv", "fp_hash", "suspicion", "oldest_k"])
@pytest.mark.parametrize("timer_dtype", [torch.int16, torch.int32])
def test_kernels_on_row_slices(name, timer_dtype):
    """K1-K4 (their plain versions, and the wrappers on CPU tensors) on a
    [B, N] slice with ``row0``: the rows of the whole mesh's result. A
    slice holding the diagonal's rows is what ``row0`` is for (K3's
    ``has_cand`` and K4's self-exclusion)."""
    from kaboodle_tpu_torch.ops.hashing import peer_record_hash

    state, timer, alive, idv = _row_inputs(timer_dtype=timer_dtype)
    rec = peer_record_hash(torch.arange(ROW_N), idv[0])
    whole = _kernel_on(name, state, timer, alive, rec if name == "fp_hash" else idv, 0, True)
    for row0 in range(0, ROW_N, ROW_B):
        sl = slice(row0, row0 + ROW_B)
        rows = (state[sl].contiguous(), timer[sl].contiguous(), alive[sl].contiguous(),
                rec if name == "fp_hash" else idv[sl].contiguous())
        for plain in (True, False):
            for w, g in zip(whole, _kernel_on(name, *rows, row0, plain)):
                assert torch.equal(w[sl], g), (name, row0, plain)


def test_kernel_wrappers_refuse_rows_outside_the_mesh():
    from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k
    from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion

    state, timer, alive, _ = _row_inputs()
    sl = slice(0, ROW_B)
    with pytest.raises(ValueError):
        fused_suspicion(state[sl], timer[sl], alive[sl], 9, ROW_N - ROW_B + 1)
    with pytest.raises(ValueError):
        fused_oldest_k(state[sl], timer[sl], alive[sl], 5, -1)
    with pytest.raises(ValueError):  # alive must be the rows', not the mesh's
        fused_suspicion(state[sl], timer[sl], alive, 9, 0)


@pytest.mark.parametrize("draw", ["uniform", "uniform_1d", "choose_k", "bernoulli",
                                  "oldest_k_pick", "drop_gate"])
@pytest.mark.parametrize("det", [False, True])
def test_draws_on_row_slices(draw, det):
    """Each matrix-shaped (and row-indexed) draw of the tick, made for rows
    ``row0 .. row0 + B`` only, is those rows of the dense draw: the
    counter of a cell is its place in the whole draw."""
    from kaboodle_tpu_torch.ops import sampling, threefry
    from kaboodle_tpu_torch.phasegraph.exec import _drop_gate

    key = threefry.fold_in(threefry.prng_key(1234), 7)
    g = torch.Generator().manual_seed(3)
    mask = torch.rand((ROW_N, ROW_N), generator=g) < 0.4
    prob = torch.rand((ROW_N, ROW_N), generator=g)
    timer = torch.randint(0, 9, (ROW_N, ROW_N), generator=g, dtype=torch.int32)

    def run(rows, row0):
        sl = slice(row0, row0 + rows)
        if draw == "uniform":
            return (threefry.uniform(key, (rows, ROW_N), CPU, row0),)
        if draw == "uniform_1d":
            return (threefry.uniform(key, (rows,), CPU, row0),)
        if draw == "choose_k":
            return sampling.choose_k_members(mask[sl], 3, key, det, row0)
        if draw == "bernoulli":
            return (sampling.bernoulli_matrix(key, prob[sl], (rows, ROW_N), det, row0),)
        if draw == "oldest_k_pick":
            return (sampling.choose_one_of_oldest_k(timer[sl], mask[sl], 5, key, det,
                                                    row0=row0),)
        return (_drop_gate(mask[sl], key, torch.tensor(0.3), row0),)

    whole = run(ROW_N, 0)
    for row0 in range(0, ROW_N, ROW_B):
        for w, got in zip(whole, run(ROW_B, row0)):
            assert torch.equal(w[row0:row0 + ROW_B], got), (draw, row0)
