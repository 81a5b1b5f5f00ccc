"""The port's row-sharded tick on R gloo ranks against its dense tick and JAX's sharded twin.

Every case of the table below runs in ``kaboodle_tpu_torch.parallel.worker``
ranks: R processes joined in one gloo group, each holding its ``N/R`` rows,
started once for the whole module (all three R at once) by a module fixture.
Rank 0 writes the gathered final state, the per-tick metrics and, for a
telemetry case, the counters and digests. The test process meanwhile runs
the same inputs through the port's dense tick and, for the cases marked
``jax``, through the JAX package's ``simulate_sharded`` /
``run_until_converged_sharded`` on R of the conftest's 8 virtual CPU
devices. Inputs are made from numpy seeds. The sharded run must equal the
dense one in every leaf and metric bit for bit (``latency`` with NaNs in
place), and equal JAX's with ``latency`` at ``rtol=1e-5`` (an f32 EWMA may
be contracted into FMAs by one compiler and not the other, as in
tests/test_torch_tick.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.parallel import mesh as jmesh
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel.worker import start_workers
from kaboodle_tpu_torch.sim import runner
from kaboodle_tpu_torch.sim.state import (
    init_state,
    inputs_from_numpy,
    metrics_to_numpy,
    state_to_numpy,
)

CPU = "cpu"
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)
VARIANTS = dict(faithful_failed_broadcast=False, faithful_indirect_ack=False, max_share_peers=8)
LEAN = dict(track_latency=False, instant_identity=True)


def _scenario(n, ticks, seed, drop_rate=0.0, drop_ok=False, idle=False):
    """Stacked numpy inputs: a kill of three peers, two revivals, a
    partition that heals, manual pings and, optionally, drops."""
    rng = np.random.default_rng(seed)
    kill = np.zeros((ticks, n), bool)
    revive = np.zeros((ticks, n), bool)
    part = np.zeros((ticks, n), np.int32)
    man = np.full((ticks, n), -1, np.int32)
    if not idle:
        dead = rng.choice(n, 3, replace=False)
        kill[2, dead] = True
        revive[ticks - 4, dead[:2]] = True
        part[4:7] = np.arange(n) % 2
        man[3, : n // 4] = rng.integers(-1, n + 2, n // 4)
    d = dict(kill=kill, revive=revive, partition=part,
             drop_rate=np.full((ticks,), drop_rate, np.float32), manual_target=man)
    if drop_ok:
        d["drop_ok"] = rng.random((ticks, n, n)) > 0.15
    return d


# name: (R, n, ticks, cfg kwargs, init kwargs, scenario kwargs, faulty, telemetry, jax)
CASES = {
    "r2_random_faulty": (2, 32, 12, {}, dict(seed=7), dict(seed=1, drop_rate=0.1), True, False,
                         True),
    "r2_det_variants": (2, 32, 12, dict(deterministic=True, **VARIANTS), dict(seed=4),
                        dict(seed=2), True, False, False),
    "r2_kernels_lean": (2, 32, 12, FLAGS, dict(seed=5, **LEAN), dict(seed=3, drop_rate=0.2),
                        True, False, False),
    "r2_telemetry": (2, 32, 12, VARIANTS, dict(seed=6), dict(seed=4, drop_rate=0.05), True,
                     True, False),
    "r2_latency_only": (2, 32, 10, {}, dict(seed=8, instant_identity=True), dict(seed=5),
                        True, False, False),
    "r4_random_drop_ok": (4, 32, 12, {}, dict(seed=7), dict(seed=6, drop_ok=True), True, False,
                          True),
    "r4_det_kernels": (4, 32, 12, dict(deterministic=True, **FLAGS), dict(seed=9),
                       dict(seed=7, drop_rate=0.1), True, False, False),
    "r4_telemetry_det": (4, 32, 12, dict(deterministic=True), dict(seed=2, **LEAN),
                         dict(seed=8, drop_ok=True), True, True, False),
    "r4_idview_only": (4, 32, 10, VARIANTS, dict(seed=3, track_latency=False), dict(seed=9),
                       True, False, False),
    "r4_lean_int16_kernels": (4, 32, 12, FLAGS, dict(seed=6, timer_dtype="int16", **LEAN),
                              dict(seed=15, drop_rate=0.1), True, False, False),
    "r4_memory_bound": (4, 64, 10, VARIANTS, dict(seed=1), dict(seed=10, drop_rate=0.1), True,
                        False, False),
    "r8_det_fault_free": (8, 32, 12, dict(deterministic=True), dict(seed=3),
                          dict(seed=11, idle=True), False, False, False),
    "r8_faulty_drop_ok": (8, 32, 10, {}, dict(seed=7), dict(seed=12, drop_ok=True), True,
                          False, True),
    "r8_fast_path": (8, 64, 12, {}, dict(seed=4, ring_contacts=2), dict(seed=13, idle=True),
                     False, False, False),
    "r8_full_program": (8, 64, 12, dict(fast_path=False), dict(seed=4, ring_contacts=2),
                        dict(seed=13, idle=True), False, False, False),
    "r8_telemetry_kernels": (8, 32, 12, FLAGS, dict(seed=5), dict(seed=14, drop_rate=0.1),
                             True, True, False),
}
# name: (R, n, max_ticks, cfg kwargs, init kwargs)
CONVERGE = {
    "r4_converge": (4, 32, 40, {}, dict(seed=11)),
    "r8_converge": (8, 32, 40, {}, dict(seed=11)),
    "r2_converge_entry": (2, 32, 16, {}, dict(seed=0, ring_contacts=31, announced=True)),
}
MEMORY_CASE = "r4_memory_bound"


def _spec(tmp, r):
    cases = []
    for name, (rr, n, ticks, cfg, init, scen, faulty, telemetry, _) in CASES.items():
        if rr != r:
            continue
        path = str(tmp / f"{name}_inputs.npz")
        np.savez(path, **_scenario(n, ticks, **scen))
        cases.append(dict(name=name, kind="simulate", n=n, cfg=cfg, init=init, inputs=path,
                          faulty=faulty, telemetry=telemetry, out=str(tmp / f"{name}.npz"),
                          measure_outputs=name == MEMORY_CASE))
    for name, (rr, n, max_ticks, cfg, init) in CONVERGE.items():
        if rr == r:
            cases.append(dict(name=name, kind="converge", n=n, cfg=cfg, init=init,
                              max_ticks=max_ticks, out=str(tmp / f"{name}.npz")))
    if r == 4:
        cases.append(dict(name="r4_divisible", kind="divisible", n=30))
        cases.append(dict(name="r4_constrain", kind="constrain", n=32))
    return {"device": "cpu", "timeout_s": 120, "cases": cases}


def _init(init):
    """``init_state`` keywords of a case (its ``timer_dtype`` named as a string)."""
    if isinstance(init.get("timer_dtype"), str):
        init = {**init, "timer_dtype": getattr(torch, init["timer_dtype"])}
    return init


def _dense(name):
    """The port's dense run of a case: whole-state leaves, metrics, counters."""
    _, n, ticks, cfg, init, scen, faulty, telemetry, _ = CASES[name]
    st = init_state(n, device=CPU, **_init(init))
    inp = inputs_from_numpy(_scenario(n, ticks, **scen), device=CPU)
    out = {}
    if telemetry:
        final, m, ctr, _ = runner.simulate_with_telemetry(st, inp, SwimConfig(**cfg), faulty)
        out.update({"counters." + f.name: getattr(ctr, f.name).numpy()
                    for f in dataclasses.fields(ctr)})
    else:
        final, m = runner.simulate(st, inp, SwimConfig(**cfg), faulty=faulty)
    out.update({"state." + k: v for k, v in state_to_numpy(final).items() if v is not None})
    out.update({"metrics." + k: v for k, v in metrics_to_numpy(m).items()})
    return out


def _jax_cfg(cfg):
    return JaxSwimConfig(**cfg)


def _jax_sharded(name):
    """JAX's simulate_sharded of a case on R virtual devices, as numpy leaves."""
    r, n, ticks, cfg, init, scen, faulty, _, _ = CASES[name]
    mesh = jmesh.make_mesh(r)
    st = jstate.init_state(n, **init)
    inp = jstate.TickInputs(**{k: np.asarray(v) for k, v in _scenario(n, ticks, **scen).items()})
    final, m = jmesh.simulate_sharded(jmesh.shard_state(st, mesh),
                                      jmesh.shard_inputs(inp, mesh, stacked=True),
                                      _jax_cfg(cfg), mesh, faulty=faulty)
    out = {"state." + f.name: np.asarray(getattr(final, f.name))
           for f in dataclasses.fields(final) if getattr(final, f.name) is not None}
    out.update({"metrics." + f.name: np.asarray(getattr(m, f.name))
                for f in dataclasses.fields(m)})
    return out


def _jax_converge(name):
    r, n, max_ticks, cfg, init = CONVERGE[name]
    mesh = jmesh.make_mesh(r)
    final, ticks, conv = jmesh.run_until_converged_sharded(
        jmesh.shard_state(jstate.init_state(n, **init), mesh), _jax_cfg(cfg), mesh, max_ticks)
    out = {"state." + f.name: np.asarray(getattr(final, f.name))
           for f in dataclasses.fields(final) if getattr(final, f.name) is not None}
    out["ticks"], out["converged"] = np.asarray(ticks), np.asarray(conv)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, once: the worker ranks of R = 2, 4 and 8 run while this
    process computes the dense and the JAX references."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    tmp = tmp_path_factory.mktemp("sharded")
    jobs = {r: start_workers(r, _spec(tmp, r), str(tmp / f"cases_r{r}.json"), timeout_s=150)
            for r in (2, 4, 8)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dense = {name: _dense(name) for name in CASES}
        dense.update({name: _dense_converge(name) for name in CONVERGE})
        ref = {name: _jax_sharded(name) for name, c in CASES.items() if c[-1]}
        ref.update({name: _jax_converge(name) for name in ("r8_converge",)})
    finally:
        torch.set_num_threads(threads)
    digests = {}
    for job in jobs.values():
        digests.update(job.wait())
    got = {}
    for name in list(CASES) + list(CONVERGE):
        with np.load(tmp / f"{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(got=got, dense=dense, ref=ref, digests=digests)


def _dense_converge(name):
    _, n, max_ticks, cfg, init = CONVERGE[name]
    final, ticks, conv = runner.run_until_converged(init_state(n, device=CPU, **init),
                                                    SwimConfig(**cfg), max_ticks)
    out = {"state." + k: v for k, v in state_to_numpy(final).items() if v is not None}
    out["ticks"], out["converged"] = np.asarray(ticks), np.asarray(conv)
    return out


def _assert_equal(want: dict, got: dict, where: str, rtol_latency=None):
    assert set(want) <= set(got), (where, sorted(set(want) - set(got)))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{where}: {k} {g.shape} {w.shape}"
        if k.endswith("latency") or k.endswith("agree_fraction") or k.endswith(
                "mean_membership"):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            if rtol_latency is None or not k.endswith("latency"):
                np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")
            else:
                np.testing.assert_allclose(g, w, rtol=rtol_latency, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype) if g.dtype != w.dtype else g, w,
                                          err_msg=f"{where}: {k}")
            assert g.dtype == w.dtype or k in ("ticks", "converged"), f"{where}: {k} dtype"


@pytest.mark.parametrize("name", list(CASES) + list(CONVERGE))
def test_sharded_equals_dense(runs, name):
    """Every leaf of the final state, every metric (and every counter of a
    telemetry run) of the sharded run equals the port's dense run, and
    every rank gathered the same bits."""
    got = runs["got"][name]
    _assert_equal(runs["dense"][name], {k: v for k, v in got.items() if k != "fp"}, name)
    ranks = runs["digests"][name]
    assert len({d["digest"] for d in ranks}) == 1, f"{name}: ranks disagree"
    if name in CASES:
        r, n = CASES[name][:2]
        assert len(ranks) == r and all(d["rows"] == n // r for d in ranks)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[-1]] + ["r8_converge"])
def test_sharded_equals_jax_sharded(runs, name):
    """The port's sharded run equals the JAX package's sharded twin on R
    virtual devices (``latency`` to ``rtol=1e-5``)."""
    _assert_equal(runs["ref"][name], runs["got"][name], name, rtol_latency=1e-5)


def test_fast_path_matches_full_sharded(runs):
    """The two-program dispatch, its predicate all-reduced, gives the same
    sharded trajectory as the full program alone."""
    a, b = runs["got"]["r8_fast_path"], runs["got"]["r8_full_program"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_telemetry_covers_the_cross_row_paths(runs):
    """The telemetry cases reach the collectives that only the rare phases
    use: escalations with proxies (scatters into other ranks' rows, cell
    fetches), removals, joins and their replies (the transposes and ring
    contractions), anti-entropy replies (the ring row fetch)."""
    for name in ("r2_telemetry", "r4_telemetry_det", "r8_telemetry_kernels"):
        got = runs["got"][name]
        for c in ("suspicions_raised", "ping_reqs_sent", "deaths_declared",
                  "joins_disseminated", "gossip_bytes"):
            assert got["counters." + c].any(), f"{name}: {c} never fired"
        # The per-tick digests are every rank's rows of the dense tick's.
        _, n, ticks, cfg, init, scen, faulty, _, _ = CASES[name]
        st = init_state(n, device=CPU, **init)
        inp = inputs_from_numpy(_scenario(n, ticks, **scen), device=CPU)
        _, _, _, rec = runner.simulate_with_telemetry(st, inp, SwimConfig(**cfg), faulty,
                                                      recorder_len=ticks)
        np.testing.assert_array_equal(got["fp"], rec.fp.numpy().view(np.uint32))


def test_no_rank_materialises_a_whole_plane(runs):
    """At N = 64 on 4 ranks, no op of the sharded tick returns more than
    2 (N/R) N elements on any rank: no rank builds a whole [N, N] plane."""
    r, n = CASES[MEMORY_CASE][:2]
    bound = 2 * (n // r) * n
    for d in runs["digests"][MEMORY_CASE]:
        assert 0 < d["largest_output"] <= bound, (d["largest_output"], d["largest_op"])


def test_converge_stops_on_the_same_tick(runs):
    """run_until_converged_sharded: every rank stops on the dense run's tick,
    and the standalone agreement check holds on the result; a mesh that
    agrees at entry returns at once, untouched."""
    for name in CONVERGE:
        ranks = runs["digests"][name]
        assert len({(d["ticks"], d["converged"]) for d in ranks}) == 1
        assert all(d["check"] == d["converged"] for d in ranks)
    entry = runs["digests"]["r2_converge_entry"][0]
    assert entry["ticks"] == 0 and entry["converged"]
    st = init_state(32, device=CPU, **CONVERGE["r2_converge_entry"][-1])
    for k, v in state_to_numpy(st).items():
        if v is not None:
            np.testing.assert_array_equal(runs["got"]["r2_converge_entry"]["state." + k], v)


def test_divisibility_and_layout_checks(runs):
    """shard_state / shard_inputs refuse an N the mesh does not divide, and
    constrain_state refuses a whole state where the rank's rows belong."""
    for d in runs["digests"]["r4_divisible"]:
        assert d["raised"] == [True, True]
    assert all(d["refused"] for d in runs["digests"]["r4_constrain"])


def test_make_mesh_without_a_card_raises():
    """No silent CPU run: with no card and no device the mesh is refused
    before any process group is made."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not dist.is_initialized()


def test_engines_list_sharded_at_jax_position():
    from kaboodle_tpu.phasegraph.derive import ENGINES as JAX_ENGINES
    from kaboodle_tpu_torch.phasegraph.derive import ENGINES

    assert ENGINES == JAX_ENGINES


@pytest.mark.parametrize("kw", [dict(), dict(join_broadcast_enabled=False)])
def test_sharded_dispatch_terms_pinned_to_jax(kw):
    """The sharded tick's dispatch predicate is the one JAX's sharded tick
    plans (``make_sharded_tick(cfg, mesh).programs["fused"].pred_terms``),
    each term all-reduced before its one host sync."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.parallel import make_mesh, make_sharded_tick

    want = jmesh.make_sharded_tick(_jax_cfg(kw), jmesh.make_mesh(2)).programs["fused"].pred_terms
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")  # a one-rank gloo group, this test's own
    try:
        tick = make_sharded_tick(SwimConfig(**kw), mesh)
        assert tick.pred_terms == tuple(want)
    finally:
        dist.destroy_process_group()
