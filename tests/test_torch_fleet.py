"""The port's fleet (E meshes as one batched tick) against the JAX package's.

Inputs come from numpy seeds and go through both fleets: member e of the
port's fleet equals member e of the JAX fleet and the port's standalone
single-mesh run from the same seed, every integer and bool leaf and
metric bit for bit (``latency`` NaN positions equal, rtol 1e-5 as in
``test_torch_tick.py``: an f32 EWMA may be contracted into FMAs by one
compiler and not the other). The statistics are held to the JAX
package's on the same vectors with rtol 1e-6 and NaN positions equal
(float32 interpolation and means, reduced in another order). The JAX
builds are jitted once per module (``simulate_fleet`` and
``run_fleet_until_converged`` are jitted there, keyed by config and shape).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu import fleet as jfleet
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.fleet import bench as jbench
from kaboodle_tpu.fleet import stats as jstats
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu_torch import fleet as tfleet
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet import bench as tbench
from kaboodle_tpu_torch.fleet import stats as tstats
from kaboodle_tpu_torch.fleet.core import freeze_members
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.sim import runner
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.telemetry import FIELDS

CPU = "cpu"
STATS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _jax_fleet_numpy(jf) -> dict:
    """The JAX fleet's leaves as writable numpy copies."""
    return {"mesh": {k: None if v is None else v.copy() for k, v in _leaves(jf.mesh).items()},
            "drop_rate": np.array(jf.drop_rate)}


def _to_jax_fleet(host: dict):
    mesh = jstate.MeshState(**{k: None if v is None else jnp.asarray(v)
                               for k, v in host["mesh"].items()})
    return jfleet.FleetState(mesh=mesh, drop_rate=jnp.asarray(host["drop_rate"]))


def _member(host: dict, e: int) -> dict:
    return {k: None if v is None else v[e] for k, v in host.items()}


def _assert_floats(got, want, where: str):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=where)
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL, err_msg=where)


# ---------------------------------------------------------------- schedules

N, E, T = 32, 4, 12
RATES = np.array([0.0, 0.1, 0.25, 0.05], dtype=np.float32)


def _member_schedules(n=N, e=E, ticks=T, seed=7) -> dict:
    """Per-member churn schedules ``[E, T, ...]`` from one numpy seed: a
    kill, a revive of part of it, a two-way partition window, manual pings,
    and a per-member drop rate over the first two thirds."""
    rng = np.random.default_rng(seed)
    kill = np.zeros((e, ticks, n), bool)
    revive = np.zeros((e, ticks, n), bool)
    partition = np.zeros((e, ticks, n), np.int32)
    manual = np.full((e, ticks, n), -1, np.int32)
    drop = np.zeros((e, ticks), np.float32)
    for m in range(e):
        victims = rng.choice(np.arange(1, n), size=3, replace=False)
        kill[m, 1, victims] = True
        revive[m, 7, victims[:2]] = True
        partition[m, 3:6] = rng.integers(0, 2, size=n)
        manual[m, 2, rng.integers(0, n)] = rng.integers(0, n)
        drop[m, : 2 * ticks // 3] = RATES[m]
    return {"kill": kill, "revive": revive, "partition": partition, "manual_target": manual,
            "drop_rate": drop}


def _member_inputs(sched: dict, m: int) -> dict:
    return {k: v[m] for k, v in sched.items()}


def _jax_inputs(fields: dict):
    return jstate.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()}, drop_ok=None)


def _port_inputs(fields: dict):
    return tstate.inputs_from_numpy(fields, device=CPU)


# ---------------------------------------------------------------- member parity


@pytest.mark.parametrize("det", [True, False])
def test_member_parity_faulty_with_churn(det):
    """Faulty build, per-member drop rates and a stacked churn schedule (kill,
    revive, partition, manual pings): the port's fleet equals the JAX fleet
    (every leaf, every metric per tick) and each member equals the port's
    standalone run; ``stack_member_inputs`` + ``scan_axis_first`` on both."""
    sched = _member_schedules()
    jcfg, tcfg = JaxSwimConfig(deterministic=det), SwimConfig(deterministic=det)
    jf = jfleet.init_fleet(N, E, drop_rates=jnp.asarray(RATES))
    jin = jfleet.scan_axis_first(jfleet.stack_member_inputs(
        [_jax_inputs(_member_inputs(sched, m)) for m in range(E)]))
    jout, jm = jfleet.simulate_fleet(jf, jin, jcfg, faulty=True)
    tf = tfleet.init_fleet(N, E, drop_rates=RATES, device=CPU)
    tin = tfleet.scan_axis_first(tfleet.stack_member_inputs(
        [_port_inputs(_member_inputs(sched, m)) for m in range(E)]))
    tout, tm = tfleet.simulate_fleet(tf, tin, tcfg, faulty=True)
    want, got = _jax_fleet_numpy(jout), tstate.fleet_to_numpy(tout)
    _assert_same(want["mesh"], got["mesh"], "fleet vs JAX fleet")
    _assert_same(_leaves(jm), tstate.metrics_to_numpy(tm), "metrics vs JAX fleet")
    assert tm.converged.shape == (T, E)
    for m in range(E):
        st, sm = runner.simulate(tstate.init_state(N, seed=m, device=CPU),
                                 _port_inputs(_member_inputs(sched, m)), tcfg, faulty=True)
        _assert_same(tstate.state_to_numpy(st), _member(got["mesh"], m), f"member {m}")
        for k, v in tstate.metrics_to_numpy(sm).items():
            np.testing.assert_array_equal(tstate.metrics_to_numpy(tm)[k][:, m], v,
                                          err_msg=f"member {m} {k}")


@pytest.mark.parametrize("det", [True, False])
def test_member_parity_fault_free_boot(det):
    """The fault-free build over a broadcast boot, full state (latency,
    identity views, int32 timers): JAX fleet == port fleet == standalone."""
    n, e, ticks = 24, 3, 6
    jcfg, tcfg = JaxSwimConfig(deterministic=det), SwimConfig(deterministic=det)
    jout, jm = jfleet.simulate_fleet(jfleet.init_fleet(n, e, seeds=jnp.asarray([3, 9, 4])),
                                     jfleet.fleet_idle_inputs(n, e, ticks=ticks), jcfg,
                                     faulty=False)
    tout, tm = tfleet.simulate_fleet(
        tfleet.init_fleet(n, e, seeds=[3, 9, 4], device=CPU),
        tfleet.fleet_idle_inputs(n, e, ticks=ticks, device=CPU), tcfg, faulty=False)
    _assert_same(_leaves(jout.mesh), tstate.state_to_numpy(tout.mesh), "fleet vs JAX")
    _assert_same(_leaves(jm), tstate.metrics_to_numpy(tm), "metrics vs JAX")
    for m, seed in enumerate([3, 9, 4]):
        st, _ = runner.simulate(tstate.init_state(n, seed=seed, device=CPU),
                                tstate.idle_inputs(n, ticks=ticks, device=CPU), tcfg, faulty=False)
        _assert_same(tstate.state_to_numpy(st),
                     tstate.state_to_numpy(tfleet.member_state(tout, m)), f"member {m}")


def test_telemetry_fleet_matches_jax_and_keeps_the_states():
    """The telemetry build of the fleet: counters ``[T, E]`` and digests
    ``[T, E, N]`` equal the JAX fleet's, and the states and metrics equal
    the telemetry-off fleet's."""
    sched = _member_schedules(seed=11)
    jcfg, tcfg = JaxSwimConfig(), SwimConfig()
    jf = jfleet.init_fleet(N, E, drop_rates=jnp.asarray(RATES))
    jin = jfleet.scan_axis_first(jfleet.stack_member_inputs(
        [_jax_inputs(_member_inputs(sched, m)) for m in range(E)]))
    jout, jtel = jfleet.simulate_fleet(jf, jin, jcfg, faulty=True, telemetry=True)
    tin = tfleet.scan_axis_first(tfleet.stack_member_inputs(
        [_port_inputs(_member_inputs(sched, m)) for m in range(E)]))
    tf = tfleet.init_fleet(N, E, drop_rates=RATES, device=CPU)
    tout, ttel = tfleet.simulate_fleet(tf, tin, tcfg, faulty=True, telemetry=True)
    assert ttel.fp.shape == (T, E, N)
    np.testing.assert_array_equal(ttel.fp.numpy().view(np.uint32), np.asarray(jtel.fp))
    for f in FIELDS:
        got = getattr(ttel.counters, f).numpy()
        if f == "gossip_bytes":
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(getattr(jtel.counters, f)), err_msg=f)
    assert int(ttel.counters.pings_sent.sum()) > 0 and int(ttel.counters.deaths_declared.sum()) > 0
    _assert_same(_leaves(jtel.metrics), tstate.metrics_to_numpy(ttel.metrics), "metrics")
    off, moff = tfleet.simulate_fleet(tf, tin, tcfg, faulty=True)
    _assert_same(tstate.state_to_numpy(off.mesh), tstate.state_to_numpy(tout.mesh), "on/off")
    _assert_same(tstate.metrics_to_numpy(moff), tstate.metrics_to_numpy(ttel.metrics), "on/off")
    _assert_same(_leaves(jout.mesh), tstate.state_to_numpy(tout.mesh), "vs JAX")


def test_dispatch_and_chunked_draws_keep_member_bits(monkeypatch):
    """The per-tick dispatch (full or fused program, chosen for the whole
    ensemble) on a batched state equals standalone members, and so do the
    draws when a chunk holds one member's rows or several whole members
    (``threefry.draw_chunks``)."""
    n, e, ticks = 16, 3, 10
    cfg = SwimConfig()
    sched = _member_schedules(n=n, e=e, ticks=ticks, seed=5)
    inputs = tfleet.scan_axis_first(tfleet.stack_member_inputs(
        [_port_inputs(_member_inputs(sched, m)) for m in range(e)]))
    want = []
    for m in range(e):
        st, _ = runner.simulate(tstate.init_state(n, seed=m, device=CPU),
                                _port_inputs(_member_inputs(sched, m)), cfg)
        want.append(tstate.state_to_numpy(st))
    tick = make_tick_fn(cfg)  # the dispatch, not the fleet's full-only build
    for cells in (threefry.CHUNK_CELLS, 2 * n * n, n * n // 4):
        monkeypatch.setattr(threefry, "CHUNK_CELLS", cells)
        mesh = tfleet.init_fleet(n, e, device=CPU).mesh
        for t in range(ticks):
            mesh, _ = tick(mesh, inputs.at(t))
        got = tstate.state_to_numpy(mesh)
        for m in range(e):
            _assert_same(want[m], _member(got, m), f"chunk {cells}, member {m}")


# ---------------------------------------------------------------- masked converge loop


def _check_converge(jfl, tfl, jcfg, tcfg, max_ticks, standalone, faulty=False):
    jout, jct, jdone = jfleet.run_fleet_until_converged(jfl, jcfg, max_ticks=max_ticks,
                                                        faulty=faulty)
    tout, tct, tdone = tfleet.run_fleet_until_converged(tfl, tcfg, max_ticks=max_ticks,
                                                        faulty=faulty)
    np.testing.assert_array_equal(tct.numpy(), np.asarray(jct))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    got = tstate.fleet_to_numpy(tout)
    _assert_same(_leaves(jout.mesh), got["mesh"], "frozen states vs JAX")
    for m in range(tfl.ensemble):
        st, ticks_run, conv = runner.run_until_converged(standalone(m), tcfg,
                                                         max_ticks=max_ticks)
        assert (ticks_run, conv) == (int(tct[m]), bool(tdone[m])), m
        _assert_same(tstate.state_to_numpy(st), _member(got["mesh"], m), f"member {m}")
    return tct.numpy(), tdone.numpy()


def test_converge_loop_epidemic_boot_freezes_members_at_their_ticks():
    n, e, max_ticks = 32, 8, 64
    kw = dict(join_broadcast_enabled=False, backdate_gossip_inserts=False)
    ct, done = _check_converge(
        jfleet.init_fleet(n, e, ring_contacts=2),
        tfleet.init_fleet(n, e, ring_contacts=2, device=CPU),
        JaxSwimConfig(**kw), SwimConfig(**kw), max_ticks,
        lambda m: tstate.init_state(n, seed=m, ring_contacts=2, device=CPU))
    assert done.all() and np.unique(ct).size >= 2, ct


def test_converge_loop_runs_unconverged_to_max_ticks_and_stops_converged_at_entry():
    """Members 1-2 never converge in the budget (broadcast-free gossip boot)
    and report ``max_ticks``; member 0 starts converged (a full mesh) and
    reports 0 with its state untouched."""
    n, e, max_ticks = 16, 3, 4
    kw = dict(join_broadcast_enabled=False)
    host = _jax_fleet_numpy(jfleet.init_fleet(n, e, ring_contacts=1))
    full = _leaves(jstate.init_state(n, seed=0, ring_contacts=n - 1, announced=True))
    for k, v in full.items():
        if v is not None:
            host["mesh"][k][0] = v

    def standalone(m):
        return tstate.state_from_numpy(_member(host["mesh"], m), device=CPU)

    ct, done = _check_converge(_to_jax_fleet(host), tstate.fleet_from_numpy(host, device=CPU),
                               JaxSwimConfig(**kw), SwimConfig(**kw), max_ticks, standalone)
    assert list(ct) == [0, max_ticks, max_ticks] and list(done) == [True, False, False]


def test_freeze_members_keeps_every_leaf_of_the_frozen():
    a = tfleet.init_fleet(8, 3, device=CPU).mesh
    b = tfleet.init_fleet(8, 3, seeds=[7, 8, 9], device=CPU, ring_contacts=2).mesh
    out = freeze_members(torch.tensor([True, False, True]), a, b)
    for m, src in ((0, b), (1, a), (2, b)):
        _assert_same(tstate.state_to_numpy(tfleet.member_state(_fl(src), m)),
                     tstate.state_to_numpy(tfleet.member_state(_fl(out), m)), f"member {m}")


def _fl(mesh):
    return tfleet.FleetState(mesh=mesh, drop_rate=torch.zeros(mesh.alive.shape[0]))


# ---------------------------------------------------------------- stats


def _stat_vectors(e=64, seed=3):
    rng = np.random.default_rng(seed)
    conv_tick = rng.integers(0, 24, size=e).astype(np.int32)
    done = rng.random(e) < 0.7
    grid = np.linspace(0.0, 0.3, 4, dtype=np.float32)
    knob = np.repeat(grid, e // 4)
    done[knob == grid[3]] = False  # one bin where nothing converged: NaN
    return conv_tick, done, knob, grid


@pytest.mark.parametrize("qs", [(0.5, 0.9, 0.99), (0.0, 0.25, 1.0)])
def test_stats_match_jax(qs):
    conv_tick, done, knob, grid = _stat_vectors()
    jt = [jnp.asarray(x) for x in (conv_tick, done, knob, grid)]
    tt = [torch.as_tensor(x) for x in (conv_tick, done, knob, grid)]
    _assert_floats(tstats.convergence_quantiles(tt[0], tt[1], qs=qs),
                   jstats.convergence_quantiles(jt[0], jt[1], qs=qs), "quantiles")
    none = torch.zeros_like(tt[1])
    _assert_floats(tstats.convergence_quantiles(tt[0], none, qs=qs),
                   jstats.convergence_quantiles(jt[0], jnp.asarray(none.numpy()), qs=qs),
                   "quantiles, nothing converged")
    _assert_floats(tstats.survival_curve(tt[0], tt[1], max_ticks=24),
                   jstats.survival_curve(jt[0], jt[1], max_ticks=24), "survival")
    tm = tstats.knob_marginals(tt[2], tt[3], tt[0], tt[1])
    jm = jstats.knob_marginals(jt[2], jt[3], jt[0], jt[1])
    np.testing.assert_array_equal(tm["members"].numpy(), np.asarray(jm["members"]))
    for k in ("converged_fraction", "mean_conv_tick"):
        _assert_floats(tm[k], jm[k], k)
    _assert_floats(tstats.knob_quantiles(tt[2], tt[3], tt[0], tt[1], qs=qs),
                   jstats.knob_quantiles(jt[2], jt[3], jt[0], jt[1], qs=qs), "knob quantiles")


def test_agree_fraction_trajectory_matches_jax():
    rng = np.random.default_rng(4)
    t, e = 9, 16
    fields = {
        "messages_delivered": rng.integers(0, 100, (t, e)).astype(np.int32),
        "converged": rng.random((t, e)) < 0.4,
        "agree_fraction": rng.random((t, e)).astype(np.float32),
        "mean_membership": rng.random((t, e)).astype(np.float32),
        "fingerprint_min": rng.integers(0, 2**32, (t, e), dtype=np.uint64).astype(np.uint32),
        "fingerprint_max": rng.integers(0, 2**32, (t, e), dtype=np.uint64).astype(np.uint32),
    }
    jm = jstate.TickMetrics(**{k: jnp.asarray(v) for k, v in fields.items()})
    tm = tstate.TickMetrics(**{k: torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32
                                                  else v) for k, v in fields.items()})
    got, want = tstats.agree_fraction_trajectory(tm), jstats.agree_fraction_trajectory(jm)
    assert set(got) == set(want)
    for k in want:
        _assert_floats(got[k], want[k], k)


# ---------------------------------------------------------------- the sweep


@pytest.mark.parametrize("argv", [
    ["--sweep", "drop_rate=0:0.2:2", "--ensemble", "9", "--n", "16", "--max-ticks", "24"],
    ["--seeds-only", "--ensemble", "6", "--n", "16", "--max-ticks", "8", "--boot", "epidemic",
     "--quantiles", "0.5", "0.75"],
])
def test_run_sweep_matches_jax(argv, capsys):
    want = jbench.run_sweep(jbench.build_parser().parse_args(argv + ["--shard", "none"]))
    got = tbench.run_sweep(tbench.build_parser().parse_args(argv + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert "p50" in out and "ALL" in out
    assert got["backend"] == "cpu"
    json.dumps(got)
    drop = ("wall_s", "backend")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}


def test_sweep_rejects_what_jax_rejects():
    for argv in (["--sweep", "drop_rate=0:0.1:2", "--seeds-only"], ["--sweep", "loss=0:1:2"],
                 ["--sweep", "drop_rate=0:1"], ["--sweep", "drop_rate=0:0.1:4", "--ensemble", "2"]):
        with pytest.raises(SystemExit) as want:
            jbench.run_sweep(jbench.build_parser().parse_args(argv + ["--shard", "none"]))
        with pytest.raises(SystemExit) as got:
            tbench.run_sweep(tbench.build_parser().parse_args(argv + ["--device", "cpu"]))
        assert str(got.value) == str(want.value), argv


# ---------------------------------------------------------------- init, guards, carry


def test_init_fleet_validation_and_pallas_guard_match_jax():
    cases = [((16, 0), {}), ((16, 4), {"seeds": np.arange(3)}),
             ((16, 4), {"drop_rates": np.zeros((2,), np.float32)})]
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            jfleet.init_fleet(*args, **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError) as got:
            tfleet.init_fleet(*args, device=CPU, **kw)
        assert str(got.value) == str(want.value)
    for flag in ("use_pallas_fp", "use_pallas_oldest_k", "use_pallas_suspicion"):
        with pytest.raises(ValueError) as want:
            jfleet.make_fleet_tick_fn(JaxSwimConfig(**{flag: True}), faulty=False)
        with pytest.raises(ValueError) as got:
            tfleet.make_fleet_tick_fn(SwimConfig(**{flag: True}), faulty=False)
        assert str(got.value) == str(want.value)
    fleet = tfleet.init_fleet(8, 2, device=CPU)
    with pytest.raises(ValueError, match="do not support vmap"):
        tfleet.run_fleet_until_converged(fleet, SwimConfig(use_pallas_fp=True))
    with pytest.raises(ValueError, match="do not support vmap"):  # the tick itself refuses
        make_tick_fn(SwimConfig(use_pallas_suspicion=True))(
            fleet.mesh, tfleet.fleet_idle_inputs(8, 2, device=CPU))


def test_init_fleet_equals_jax_and_keys_are_the_standalone_keys():
    seeds = [5, 9, 2, 2**31 + 3]
    kw = dict(track_latency=False, instant_identity=True, ring_contacts=2)
    want = _jax_fleet_numpy(jfleet.init_fleet(12, 4, seeds=jnp.asarray(seeds, jnp.uint32), **kw))
    got = tstate.fleet_to_numpy(tfleet.init_fleet(12, 4, seeds=np.asarray(seeds), device=CPU,
                                                  **kw))
    _assert_same(want["mesh"], got["mesh"], "init")
    np.testing.assert_array_equal(got["drop_rate"], want["drop_rate"])
    for m, seed in enumerate(seeds):
        np.testing.assert_array_equal(got["mesh"]["key"][m],
                                      np.array([0, seed & 0xFFFFFFFF], np.uint32))
        np.testing.assert_array_equal(
            got["mesh"]["key"][m],
            tstate.state_to_numpy(tstate.init_state(12, seed=seed, device=CPU))["key"])


@pytest.mark.parametrize("lean", [False, True])
def test_fleet_numpy_round_trip(lean):
    kw = dict(track_latency=not lean, instant_identity=lean,
              timer_dtype=jnp.int16 if lean else jnp.int32)
    jf = jfleet.init_fleet(8, 3, seeds=jnp.asarray([1, 2, 3]),
                           drop_rates=jnp.asarray([0.0, 0.5, 0.25]), **kw)
    jf, _ = jfleet.simulate_fleet(jf, jfleet.fleet_idle_inputs(8, 3, ticks=2), JaxSwimConfig(),
                                  faulty=False)
    host = _jax_fleet_numpy(jf)
    back = tstate.fleet_to_numpy(tstate.fleet_from_numpy(host, device=CPU))
    _assert_same(host["mesh"], back["mesh"], "round trip")
    np.testing.assert_array_equal(back["drop_rate"], host["drop_rate"])
    assert back["drop_rate"].dtype == np.float32


# ---------------------------------------------------------------------------
# sharded fleets: 4 gloo ranks (kaboodle_tpu_torch.parallel.worker), started
# once for the module; the references are the port's dense fleet and
# standalone runs, which the tests above hold to the JAX package's.

SHARD_RANKS = 4
SWEEP_ARGV = ["--ensemble", "8", "--n", "16", "--sweep", "drop_rate=0:0.3:4", "--max-ticks", "8"]
FLEET_2D_CFG = dict(join_broadcast_enabled=False, backdate_gossip_inserts=False)
SHARDED_FLEET_CASES = {
    # 1-D ensemble mesh: 2 of 8 members a rank, 8 fault-free ticks.
    "fleet_1d": dict(kind="fleet", n=16, ensemble=8, ticks=8, faulty=False),
    # 2-D 2 x 2 mesh: 2 members a rank, 8 of 16 rows each, the masked loop.
    "fleet_2d": dict(kind="fleet", n=16, ensemble=4, max_ticks=64, peer_devices=2,
                     cfg=FLEET_2D_CFG, init=dict(ring_contacts=2)),
    # 2-D, a broadcast boot: the join replies' transposes and ring unions
    # over the peer sub-group, behind the ensemble axis.
    "fleet_2d_boot": dict(kind="fleet", n=16, ensemble=4, ticks=6, peer_devices=2,
                          faulty=False),
}


@pytest.fixture(scope="module")
def sharded_fleets(tmp_path_factory):
    from kaboodle_tpu_torch.parallel.worker import start_workers

    tmp = tmp_path_factory.mktemp("sharded_fleet")
    cases = [dict(name=name, out=str(tmp / f"{name}.npz"), **c)
             for name, c in SHARDED_FLEET_CASES.items()]
    cases += [dict(name="checks", kind="fleet_checks"),
              dict(name="sweep", kind="sweep", argv=SWEEP_ARGV)]
    digests = start_workers(SHARD_RANKS, {"device": "cpu", "timeout_s": 60, "cases": cases},
                            str(tmp / "cases.json"), timeout_s=120).wait()
    arrays = {}
    for name in SHARDED_FLEET_CASES:
        with np.load(tmp / f"{name}.npz") as z:
            arrays[name] = {k: z[k] for k in z.files}
    return digests, arrays


def test_fleet_member_matches_single_mesh_sharded(sharded_fleets):
    """1-D ensemble mesh: members split across 4 ranks, each bit-equal to
    its standalone run; each rank held 2 whole members."""
    digests, arrays = sharded_fleets
    got = arrays["fleet_1d"]
    assert all((d["local_members"], d["local_rows"]) == (2, 16) for d in digests["fleet_1d"])
    cfg = SwimConfig()
    for k in (0, 3, 7):
        ref, rm = runner.simulate(tstate.init_state(16, seed=k, device=CPU),
                                  tstate.idle_inputs(16, ticks=8, device=CPU), cfg, faulty=False)
        want = tstate.state_to_numpy(ref)
        for f, w in want.items():
            if w is not None:
                g = got["state." + f][k]
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f)
                    g, w = np.nan_to_num(g), np.nan_to_num(w)
                np.testing.assert_array_equal(g, w, err_msg=f"member {k}: {f}")
        np.testing.assert_array_equal(got["converged"][:, k], rm.converged.numpy())


def test_fleet_2d_mesh_converge_matches_dense(sharded_fleets):
    """E x peers 2-D mesh: the masked convergence loop over both axes
    equals the dense fleet run bit-exactly."""
    digests, arrays = sharded_fleets
    got = arrays["fleet_2d"]
    assert all((d["local_members"], d["local_rows"]) == (2, 8) for d in digests["fleet_2d"])
    dn, ct, done = tfleet.run_fleet_until_converged(
        tfleet.init_fleet(16, 4, ring_contacts=2, device=CPU), SwimConfig(**FLEET_2D_CFG),
        max_ticks=64)
    np.testing.assert_array_equal(got["conv_tick"], ct.numpy())
    np.testing.assert_array_equal(got["done"], done.numpy())
    for f, w in tstate.state_to_numpy(dn.mesh).items():
        if w is not None:
            np.testing.assert_array_equal(np.nan_to_num(got["state." + f]), np.nan_to_num(w),
                                          err_msg=f)


def test_fleet_shard_divisibility_checks(sharded_fleets):
    """An E the ensemble axis does not divide, an N the peer axis does not
    divide and a mesh bigger than the job each raise ValueError."""
    digests, _ = sharded_fleets
    assert all(d["raised"] == [True, True, True] for d in digests["checks"])


def test_sweep_shard_ensemble_reports_sharded(sharded_fleets, capsys):
    """``--shard ensemble`` over 4 ranks: ``"sharded": true`` in the line,
    every statistic equal to the one-process sweep's."""
    digests, _ = sharded_fleets
    lines = [d["line"] for d in digests["sweep"]]
    assert all(line == lines[0] for line in lines) and lines[0]["sharded"] is True
    want = tbench.run_sweep(tbench.build_parser().parse_args(
        [*SWEEP_ARGV, "--device", "cpu", "--shard", "none"]))
    capsys.readouterr()
    assert want["sharded"] is False
    # Through JSON: a bucket that never converged has a NaN mean on both sides.
    assert json.dumps({k: v for k, v in lines[0].items() if k != "sharded"}, sort_keys=True) == \
        json.dumps({k: v for k, v in want.items() if k not in ("sharded", "wall_s")},
                   sort_keys=True)


def test_fleet_2d_mesh_boot_matches_dense(sharded_fleets):
    """E x peers 2-D mesh, a broadcast boot (joins on every member): the
    sharded fleet tick equals the dense fleet tick, member by member."""
    _, arrays = sharded_fleets
    got = arrays["fleet_2d_boot"]
    fleet = tfleet.init_fleet(16, 4, device=CPU)
    dn, m = tfleet.simulate_fleet(fleet, tfleet.fleet_idle_inputs(16, 4, ticks=6, device=CPU),
                                  SwimConfig(), faulty=False)
    np.testing.assert_array_equal(got["converged"], m.converged.numpy())
    for f, w in tstate.state_to_numpy(dn.mesh).items():
        if w is not None:
            np.testing.assert_array_equal(np.isnan(got["state." + f]) if w.dtype.kind == "f"
                                          else got["state." + f],
                                          np.isnan(w) if w.dtype.kind == "f" else w, err_msg=f)
            np.testing.assert_array_equal(np.nan_to_num(got["state." + f]), np.nan_to_num(w),
                                          err_msg=f)
