"""The port's telemetry build of the tick against the JAX package's, per tick.

Both engines start from the same numpy state and inputs. After every tick
the per-tick ``ProtocolCounters`` and the digest plane ``fp`` are compared
bit for bit, and so are the state and metrics; the port's telemetry-off
tick runs beside them, and its state and metrics must equal the telemetry
build's. The JAX ticks run their jnp formulations, jitted once per module;
the port runs with its kernel flags on in some cases (on the CPU a flag
that is on takes the kernel's plain version).
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
from kaboodle_tpu.telemetry import counters as jcounters
from kaboodle_tpu.telemetry import recorder as jrecorder
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.sim import runner, scenario
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.telemetry import counters, recorder

CPU = "cpu"
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tick():
    """One jitted JAX telemetry tick per (cfg, faulty, program)."""
    cache = {}

    def get(cfg, faulty=True, program=None):
        key = (cfg, faulty, program)
        if key not in cache:
            cache[key] = jax.jit(jax_make_tick_fn(cfg, faulty=faulty, program=program,
                                                  telemetry=True))
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


def _counters_np(c) -> dict:
    """Port counters in the JAX layout (gossip_bytes uint32)."""
    return {f: counters._host_field(c, f).reshape(np.shape(getattr(c, f))) for f in counters.FIELDS}


def _jax_state(n, lean, **kw):
    return jstate.init_state(n, track_latency=not lean, instant_identity=lean,
                             timer_dtype=jnp.int16 if lean else jnp.int32, **kw)


def _run_both(jtick, tcfg, jst, jinp, ticks, faulty=True, program=None):
    """Tick JAX (telemetry), the port (telemetry) and the port (telemetry off)
    over stacked JAX inputs; compare after every tick. Returns the JAX
    per-tick outputs and the port's run totals."""
    ttick = make_tick_fn(tcfg, faulty=faulty, program=program, telemetry=True)
    toff = make_tick_fn(tcfg, faulty=faulty, program=program)
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    off = tst
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    outs, totals = [], counters.zero_counters(CPU)
    for t in range(ticks):
        jst, jout = jtick(jst, jax.tree.map(lambda x: x[t], jinp))
        tst, tout = ttick(tst, tinp.at(t))
        off, moff = toff(off, tinp.at(t))
        got = tstate.state_to_numpy(tst)
        _assert_same(_leaves(jst), got, f"tick {t} state")
        _assert_same(got, tstate.state_to_numpy(off), f"tick {t} telemetry on/off state")
        _assert_same(_leaves(jout.metrics), tstate.metrics_to_numpy(tout.metrics),
                     f"tick {t} metrics")
        _assert_same(tstate.metrics_to_numpy(tout.metrics), tstate.metrics_to_numpy(moff),
                     f"tick {t} telemetry on/off metrics")
        _assert_same(_leaves(jout.counters), _counters_np(tout.counters), f"tick {t} counters")
        np.testing.assert_array_equal(tout.fp.numpy().view(np.uint32), np.asarray(jout.fp),
                                      err_msg=f"tick {t} fp")
        outs.append(jout)
        totals = counters.add_counters(totals, tout.counters)
    return outs, counters.counters_totals(
        counters.ProtocolCounters(**{f: getattr(totals, f)[None] for f in counters.FIELDS}))


@pytest.mark.parametrize("det,lean,program", [
    (False, False, None), (True, True, None), (False, True, "full"), (True, False, "full"),
])
def test_churn_counters_per_tick(jax_tick, det, lean, program):
    """Config-3 churn at N=64: Join broadcasts and replies, suspicion,
    escalation, proxies, removals -- every counter moves."""
    sc = jscen.baseline_scenario(3, n=64, ticks=32, seed=3)
    jst = _jax_state(64, lean, seed=5, alive=jnp.asarray(sc.initial_alive()))
    cfg = dict(deterministic=det)
    _, tot = _run_both(jax_tick(JaxSwimConfig(**cfg), program=program),
                       SwimConfig(**cfg, **(FLAGS if lean else {})),
                       jst, sc.build(), 32, program=program)
    for f in ("pings_sent", "acks_sent", "ping_reqs_sent", "suspicions_raised",
              "deaths_declared", "joins_disseminated", "gossip_bytes", "armed_timers"):
        assert tot[f] > 0, f


@pytest.mark.parametrize("det,lean", [(False, False), (True, True)])
def test_fused_program_counters(jax_tick, det, lean):
    """The fused program alone on a gossip boot (no Join broadcast, no
    timeouts): pings, acks and anti-entropy records; the rest is zero."""
    n = 48
    kw = dict(join_broadcast_enabled=False, deterministic=det)
    jst = _jax_state(n, lean, seed=2, ring_contacts=2, announced=True)
    _, tot = _run_both(jax_tick(JaxSwimConfig(**kw), faulty=False, program="fused"),
                       SwimConfig(**kw, **(FLAGS if lean else {})),
                       jst, jstate.idle_inputs(n, ticks=16), 16, faulty=False, program="fused")
    assert tot["gossip_bytes"] > 0 and tot["pings_sent"] > 0
    assert tot["deaths_declared"] == tot["joins_disseminated"] == 0


def test_all_fault_paths_scenario_counters(jax_tick):
    """Kill, restart, partition, drop and a manual ping per tick; the
    scenario itself equals the JAX package's."""
    n, ticks = 64, 16
    jsc = jscen.all_fault_paths_scenario(n, ticks=ticks)
    tsc = scenario.all_fault_paths_scenario(n, ticks=ticks)
    _assert_same(_leaves(jsc.build()), _leaves(tsc.build(CPU)), "scenario")
    with pytest.raises(ValueError):
        scenario.all_fault_paths_scenario(3)
    _run_both(jax_tick(JaxSwimConfig()), SwimConfig(), _jax_state(n, False, seed=7),
              jsc.build(), ticks)


def test_join_records_over_the_d5_cap(jax_tick):
    """max_share_peers below the map sizes: the capped share arithmetic of
    the join records binds (tick 0 counts fewer bytes than uncapped)."""
    n, cap = 48, 6
    jcfg = JaxSwimConfig(max_share_peers=cap, deterministic=True)
    outs, _ = _run_both(jax_tick(jcfg, faulty=False), SwimConfig(max_share_peers=cap,
                                                                 deterministic=True),
                        _jax_state(n, False, seed=1, ring_contacts=8),
                        jstate.idle_inputs(n, ticks=6), 6, faulty=False)
    uncapped = make_tick_fn(SwimConfig(max_share_peers=0, deterministic=True), faulty=False,
                            telemetry=True)
    st = tstate.state_from_numpy(_leaves(_jax_state(n, False, seed=1, ring_contacts=8)),
                                 device=CPU)
    _, out = uncapped(st, tstate.idle_inputs(n, device=CPU))
    capped = int(np.asarray(outs[0].counters.gossip_bytes))
    assert 0 < capped < int(out.counters.gossip_bytes)


@pytest.mark.parametrize("lean", [False, True])
def test_boot_run_until_converged_telemetry(lean):
    """Boot to convergence: ticks, flag, state, run totals and the recorder
    equal the JAX runner's; the converged mesh returns at zero ticks."""
    n = 48
    jst = _jax_state(n, lean, seed=9)
    jc, tc = JaxSwimConfig(), SwimConfig(**FLAGS)
    jf, jticks, jconv, jtot, jrec = jrunner.run_until_converged_telemetry(jst, jc, max_ticks=8,
                                                                           recorder_len=4)
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tf, ticks, conv, tot, rec = runner.run_until_converged_telemetry(tst, tc, max_ticks=8,
                                                                     recorder_len=4)
    plain = runner.run_until_converged(tst, tc, max_ticks=8)
    assert (ticks, conv) == (int(jticks), bool(jconv)) == plain[1:] and conv
    _assert_same(_leaves(jf), tstate.state_to_numpy(tf), "boot")
    _assert_same(tstate.state_to_numpy(plain[0]), tstate.state_to_numpy(tf), "plain boot")
    _assert_same(_leaves(jtot), _counters_np(tot), "totals")
    want, got = jrecorder.recorder_rows(jrec), recorder.recorder_rows(rec)
    assert want["table"].dtype == got["table"].dtype
    np.testing.assert_array_equal(got["table"], want["table"])
    np.testing.assert_array_equal(got["fp"], want["fp"])
    again, ticks0, conv0, tot0, rec0 = runner.run_until_converged_telemetry(tf, tc)
    assert (ticks0, conv0) == (0, True) and again is tf
    assert counters.counters_totals(counters.ProtocolCounters(
        **{f: getattr(tot0, f)[None] for f in counters.FIELDS})) == dict.fromkeys(
            counters.FIELDS, 0)
    assert recorder.recorder_rows(rec0)["table"].shape == (0,)


@pytest.mark.parametrize("k", [5, 40])
def test_simulate_with_telemetry_and_recorder(jax_tick, k):
    """The runner's stacked counters and its ring against the JAX tick's
    outputs recorded by the JAX ring: k=5 wraps over 12 ticks, k=40 fills
    partly."""
    n, ticks = 64, 12
    sc = jscen.baseline_scenario(3, n=n, ticks=ticks, seed=3)
    jst = _jax_state(n, False, seed=5, alive=jnp.asarray(sc.initial_alive()))
    jtick = jax_tick(JaxSwimConfig())
    jinp = sc.build()
    jrec = jrecorder.init_recorder(k, n)
    jouts, j = [], jst
    for t in range(ticks):
        j, out = jtick(j, jax.tree.map(lambda x: x[t], jinp))
        jrec = jrecorder.record_tick(jrec, j.tick - 1, out)
        jouts.append(out)
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tinp = tstate.inputs_from_numpy(_leaves(jinp), device=CPU)
    final, metrics, tcnt, rec = runner.simulate_with_telemetry(tst, tinp, SwimConfig(),
                                                               recorder_len=k)
    _assert_same(_leaves(j), tstate.state_to_numpy(final), "final")
    plain_final, plain_metrics = runner.simulate(tst, tinp, SwimConfig())
    _assert_same(tstate.state_to_numpy(plain_final), tstate.state_to_numpy(final), "on/off")
    _assert_same(tstate.metrics_to_numpy(plain_metrics), tstate.metrics_to_numpy(metrics),
                 "on/off metrics")
    want_cnt = jax.tree.map(lambda *xs: jnp.stack(xs), *[o.counters for o in jouts])
    np.testing.assert_array_equal(counters.counters_table(tcnt),
                                  jcounters.counters_table(want_cnt))
    assert counters.counters_totals(tcnt) == jcounters.counters_totals(want_cnt)
    want, got = jrecorder.recorder_rows(jrec), recorder.recorder_rows(rec)
    assert got["table"].shape == (min(k, ticks),)
    np.testing.assert_array_equal(got["table"], want["table"])
    np.testing.assert_array_equal(got["fp"], want["fp"])
    assert list(got["table"]["tick"]) == list(range(ticks - min(k, ticks), ticks))
    assert runner.simulate_with_telemetry(tst, tinp, SwimConfig())[3] is None


def test_counter_arithmetic_and_gossip_bytes_wrap():
    """zero/add/scale/leap and the host tables against the JAX functions;
    gossip_bytes is uint32 modular on the device and in the totals."""
    rng = np.random.default_rng(0)
    vals = {f: rng.integers(0, 1 << 20, size=3).astype(np.int32) for f in counters.FIELDS}
    vals["gossip_bytes"] = np.array([0xFFFFFFF0, 0x80000000, 7], dtype=np.uint32)
    jc = jcounters.ProtocolCounters(**{f: jnp.asarray(v) for f, v in vals.items()})
    tc = counters.ProtocolCounters(**{f: torch.from_numpy(v.view(np.int32).copy())
                                      for f, v in vals.items()})
    np.testing.assert_array_equal(counters.counters_table(tc), jcounters.counters_table(jc))
    assert counters.counters_totals(tc) == jcounters.counters_totals(jc)
    assert counters.counters_totals(tc)["gossip_bytes"] == (0xFFFFFFF0 + 0x80000000 + 7) % 2**32

    def row(c, i):
        return type(c)(**{f: getattr(c, f)[i] for f in counters.FIELDS})

    acc_j, acc_t = jcounters.zero_counters(), counters.zero_counters(CPU)
    for i in range(3):
        acc_j = jcounters.add_counters(acc_j, row(jc, i))
        acc_t = counters.add_counters(acc_t, row(tc, i))
    _assert_same(_leaves(acc_j), _counters_np(acc_t), "add")
    for k in (0, 3, 70000):
        _assert_same(_leaves(jcounters.scale_counters(row(jc, 0), k)),
                     _counters_np(counters.scale_counters(row(tc, 0), k)), f"scale {k}")
    _assert_same(_leaves(jcounters.leap_counters(17, 5)),
                 _counters_np(counters.leap_counters(17, 5, device=CPU)), "leap")
    _assert_same(_leaves(jcounters.leap_counters(17, 5)),
                 _counters_np(counters.leap_counters(torch.tensor(17), 5)), "leap tensor")
    with pytest.raises(ValueError):
        recorder.init_recorder(0, 4, device=CPU)
