"""The port's blocked-sparse plane against the JAX package's, on the CPU.

The same states, blocks and scenarios, made from numpy seeds, go through
the JAX sparseplane and the port's. Tolerance: bit-exact, every
``SparseState`` and ``SparseTickMetrics`` field, tick by tick (the float32
metrics included: at these sizes every partial sum is an integer below
2^24). The JAX ticks are jitted once per (config, spec, faulty) and cached
by this module.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.phasegraph.graph import build_graph
from kaboodle_tpu.phasegraph.plan import plan
from kaboodle_tpu.sparseplane import kernel as jkernel
from kaboodle_tpu.sparseplane import repair as jrepair
from kaboodle_tpu.sparseplane import rng as jrng
from kaboodle_tpu.sparseplane import runner as jrunner
from kaboodle_tpu.sparseplane import state as jstate
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.phasegraph import derive
from kaboodle_tpu_torch.sparseplane import (
    SparseSpec,
    SparseTickInputs,
    init_sparse_state,
    make_sparse_tick_fn,
    run_sparse_until_converged,
    simulate_sparse,
    sparse_fingerprint,
    sparse_idle_inputs,
)
from kaboodle_tpu_torch.sparseplane import bench, dryrun, kernel, repair
from kaboodle_tpu_torch.sparseplane import rng as trng
from kaboodle_tpu_torch.sparseplane.state import (
    sparse_metrics_to_numpy,
    sparse_state_from_numpy,
    sparse_state_to_numpy,
)

CPU = "cpu"
STATE_FIELDS = ("nbr_idx", "nbr_state", "nbr_timer", "alive", "identity", "tick", "seed",
                "cursor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfgs(**kw):
    kw.setdefault("join_broadcast_enabled", False)
    return SwimConfig(**kw), JaxSwimConfig(**kw)


def specs(**kw):
    return SparseSpec(**kw), jstate.SparseSpec(**kw)


@functools.lru_cache(maxsize=None)
def jax_tick(jcfg, jspec, faulty=True):
    return jax.jit(jkernel.make_sparse_tick_fn(jcfg, jspec, faulty))


def to_torch(jst):
    return sparse_state_from_numpy({f: np.asarray(getattr(jst, f)) for f in STATE_FIELDS},
                                   device=CPU)


def assert_state_equal(tst, jst, where=""):
    for f, got in sparse_state_to_numpy(tst).items():
        want = np.asarray(getattr(jst, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f"{where} state.{f}"


def assert_metrics_equal(tm, jm, where=""):
    for f, got in sparse_metrics_to_numpy(tm).items():
        want = np.asarray(getattr(jm, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f"{where} metrics.{f}"


def fault_inputs(n, ticks, seed, drop=0.1):
    """``ticks`` of kills (5 %), revives (10 %) and ``drop`` as stacked numpy
    arrays, and both packages' stacked inputs made from them."""
    rng = np.random.default_rng(seed)
    kill = rng.random((ticks, n)) < 0.05
    revive = rng.random((ticks, n)) < 0.10
    rate = np.full((ticks,), drop, np.float32)
    jinp = jstate.SparseTickInputs(kill=jnp.asarray(kill), revive=jnp.asarray(revive),
                                   drop_rate=jnp.asarray(rate))
    tinp = SparseTickInputs(kill=torch.as_tensor(kill), revive=torch.as_tensor(revive),
                            drop_rate=torch.as_tensor(rate))
    return jinp, tinp


def run_both(jcfg, tcfg, jspec, tspec, jst, jinp, tinp, faulty=True):
    """Tick both engines over stacked inputs, comparing after every tick."""
    jt, tt = jax_tick(jcfg, jspec, faulty), make_sparse_tick_fn(tcfg, tspec, faulty)
    tst = to_torch(jst)
    for t in range(tinp.kill.shape[0]):
        jst, jm = jt(jst, jax.tree.map(lambda x, t=t: x[t], jinp))
        tst, tm = tt(tst, tinp.at(t))
        assert_state_equal(tst, jst, f"tick {t}")
        assert_metrics_equal(tm, jm, f"tick {t}")
    return tst, jst, tm


# ---------------------------------------------------------------- state, rng, helpers


@pytest.mark.parametrize("kw", [dict(k=3), dict(k=1), dict(k=8, gossip_fanout=0),
                                dict(k=8, gossip_fanout=9), dict(k=8, boot_contacts=0),
                                dict(k=8, boot_contacts=9), dict(timer_dtype="int8")])
def test_spec_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jstate.SparseSpec(**kw)
    with pytest.raises(ValueError) as got:
        SparseSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,k,contacts,timer", [(10, 8, None, "int32"), (23, 32, 22, "int16"),
                                                (64, 8, 5, "int32")])
def test_init_and_fingerprint_match_jax(n, k, contacts, timer):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 2**32, n, dtype=np.uint32)
    alive = rng.random(n) < 0.8
    tspec, jspec = specs(k=k, boot_contacts=3, timer_dtype=timer)
    jst = jstate.init_sparse_state(n, jspec, seed=2**31 + 5, identities=jnp.asarray(ids),
                                   alive=jnp.asarray(alive), contacts=contacts)
    tst = init_sparse_state(n, tspec, seed=2**31 + 5, identities=ids, alive=alive,
                            contacts=contacts, device=CPU)
    assert_state_equal(tst, jst)
    # a churned block: random occupancy over the fresh ids
    occ = rng.random((n, k)) < 0.5
    idx = np.where(occ, rng.integers(0, n, (n, k)), -1).astype(np.int32)
    jst = dataclasses.replace(jst, nbr_idx=jnp.asarray(idx),
                              nbr_state=jnp.asarray(occ.astype(np.int8)))
    tst = to_torch(jst)
    got = sparse_fingerprint(tst).numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(jstate.sparse_fingerprint(jst)))
    with pytest.raises(ValueError):
        init_sparse_state(1, tspec, device=CPU)


@pytest.mark.parametrize("shape", [(23, 3, 4), (23, 3, 5), (7, 3, 1, 3), (23, 3), (23,)])
def test_stream_uniform_any_rank_matches_jax(shape):
    """Partitionable threefry: a draw's counter is its cell's flat index, so
    the 3-D chain draw is the 2-D draw reshaped -- at odd cell counts too."""
    assert jax.config.jax_threefry_partitionable
    for seed, cursor, stream in ((7, 3, trng.STREAM_CHAIN),
                                 (2**32 - 1, 2**31, trng.STREAM_PROXY)):
        want = np.asarray(jrng.stream_uniform(seed, cursor, stream, shape))
        got = trng.stream_uniform(seed, cursor, stream, shape, CPU).numpy()
        assert got.shape == want.shape and np.array_equal(got, want)
        # the device-side keys (0-d tensors) give the same words
        keys = trng.stream_keys(torch.tensor(seed - (seed >> 31 << 32), dtype=torch.int32),
                                torch.tensor(cursor - (cursor >> 31 << 32), dtype=torch.int32),
                                (stream,))
        assert np.array_equal(threefry.uniform(keys[0], shape, CPU).numpy(), want)


def test_counter_rng_is_positional_and_replayable():
    u = trng.stream_uniform(7, 3, trng.STREAM_DRAW, (5, 4), CPU)
    assert u.dtype == torch.float32 and bool(((u >= 0) & (u < 1)).all())
    assert torch.equal(u, trng.stream_uniform(7, 3, trng.STREAM_DRAW, (5, 4), CPU))
    for other in ((7, 4, trng.STREAM_DRAW), (7, 3, trng.STREAM_PING), (8, 3, trng.STREAM_DRAW)):
        assert not torch.equal(u, trng.stream_uniform(*other, (5, 4), CPU))
    assert trng.stream_table() == jrng.stream_table()


def _random_blocks(rng, n, k, timer_dtype=np.int32):
    """Blocks with no duplicate id per row (the repair invariant), random
    occupancy, states and timers."""
    idx = np.stack([rng.permutation(max(n, k))[:k] for _ in range(n)]).astype(np.int32)
    idx = np.where(idx < n, idx, -1)
    occ = (rng.random((n, k)) < 0.6) & (idx >= 0)
    idx = np.where(occ, idx, np.where(rng.random((n, k)) < 0.5, -1, idx))
    state = np.where(occ, rng.integers(1, 4, (n, k)), 0).astype(np.int8)
    timer = rng.integers(-5, 40, (n, k)).astype(timer_dtype)
    return idx, state, timer


@pytest.mark.parametrize("n,k,c,timer", [(12, 8, 5, np.int32), (33, 16, 2, np.int16),
                                         (40, 32, 5, np.int32)])
def test_repair_blocks_matches_jax(n, k, c, timer):
    rng = np.random.default_rng(n + k)
    idx, state, tm = _random_blocks(rng, n, k, timer)
    # candidates: new ids, ids already in the block, self, -1, duplicates
    cand = rng.integers(-1, n, (n, c)).astype(np.int32)
    cand[:, -1] = cand[:, 0]
    cand[: n // 3, 1 % c] = np.arange(n // 3)
    stamp = rng.integers(-3, 50, (n, c)).astype(timer)
    want = jrepair.repair_blocks(*map(jnp.asarray, (idx, state, tm, cand, stamp)))
    got = repair.repair_blocks(*map(torch.as_tensor, (idx, state, tm, cand, stamp)))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("timer", [np.int32, np.int16])
def test_reseed_revived_matches_jax(timer):
    rng = np.random.default_rng(5)
    n, k = 17, 8
    idx, state, tm = _random_blocks(rng, n, k, timer)
    revived = rng.random(n) < 0.4
    for b in (2, 8, 40):
        want = jrepair.reseed_revived(*map(jnp.asarray, (idx, state, tm, revived)), b,
                                      jnp.asarray(33, timer))
        got = repair.reseed_revived(*map(torch.as_tensor, (idx, state, tm, revived)), b,
                                    torch.tensor(33, dtype=torch.from_numpy(tm).dtype))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_rank_pick_and_first_argmax_match_jax():
    rng = np.random.default_rng(9)
    mask = rng.random((50, 16)) < 0.3
    mask[:5] = False  # empty rows: slot 0, not ok
    mask[5:10] = True  # full rows: every rank exists
    want_r = rng.integers(-1, 18, (50, 4)).astype(np.int32)
    ws, wo = jkernel._rank_pick(jnp.asarray(mask), jnp.asarray(want_r))
    gs, go = kernel._rank_pick(torch.as_tensor(mask), torch.as_tensor(want_r))
    assert np.array_equal(gs.numpy(), np.asarray(ws)) and np.array_equal(go.numpy(), np.asarray(wo))
    # ties: the first index of the maximum, as jnp.argmax
    scores = rng.integers(-2, 3, (64, 16)).astype(np.int32)
    assert np.array_equal(kernel._first_argmax(torch.as_tensor(scores)).numpy(),
                          np.asarray(jnp.argmax(jnp.asarray(scores), axis=1)))


def test_validate_errors_match_jax():
    for kw in (dict(join_broadcast_enabled=True), dict(faithful_failed_broadcast=False),
               dict(faithful_indirect_ack=False)):
        tcfg, jcfg = cfgs(**kw)
        with pytest.raises(ValueError) as want:
            jkernel.make_sparse_tick_fn(jcfg, jstate.SparseSpec())
        with pytest.raises(ValueError) as got:
            make_sparse_tick_fn(tcfg, SparseSpec())
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the tick


TICK_CASES = [
    # n, k, timer, cfg kwargs, spec kwargs, faulty
    (20, 8, "int32", dict(deterministic=True), dict(gossip_fanout=4), True),
    (20, 32, "int16", dict(), dict(gossip_fanout=1), True),
    (23, 8, "int16", dict(oldest_k_method="topk"), dict(gossip_fanout=4), True),
    (23, 32, "int32", dict(deterministic=True, oldest_k_method="topk"), dict(gossip_fanout=1),
     True),
    (64, 8, "int32", dict(ping_timeout_ticks=1, num_indirect_ping_peers=2), dict(gossip_fanout=4),
     True),
    (64, 32, "int16", dict(deterministic=True, backdate_gossip_inserts=False),
     dict(gossip_fanout=4, boot_contacts=1), True),
    (64, 8, "int32", dict(num_candidate_target_peers=9), dict(gossip_fanout=1), False),
    (23, 8, "int16", dict(deterministic=True), dict(gossip_fanout=4), False),
]


@pytest.mark.parametrize("n,k,timer,ckw,skw,faulty", TICK_CASES)
def test_tick_matches_jax(n, k, timer, ckw, skw, faulty):
    tcfg, jcfg = cfgs(**ckw)
    tspec, jspec = specs(k=k, timer_dtype=timer, **{"boot_contacts": 2, **skw})
    jst = jstate.init_sparse_state(n, jspec, seed=n * 7 + k)
    jinp, tinp = fault_inputs(n, 24, seed=n + k, drop=0.1 if faulty else 0.0)
    tst, _, _ = run_both(jcfg, tcfg, jspec, tspec, jst, jinp, tinp, faulty)
    assert int(tst.tick) == 24


def test_int16_timers_wrap_like_jax():
    """From tick 32,760 the int16 stamps wrap past 32,767 to negative values;
    ages, the backdated gossip stamp and the draw order wrap as in JAX."""
    n, k = 23, 8
    tcfg, jcfg = cfgs(ping_timeout_ticks=1)
    tspec, jspec = specs(k=k, timer_dtype="int16", boot_contacts=2)
    jst = jstate.init_sparse_state(n, jspec, seed=4)
    occ = np.asarray(jst.nbr_state) > 0
    jst = dataclasses.replace(
        jst, tick=jnp.int32(32760),
        nbr_timer=jnp.asarray(np.where(occ, 32755, 0).astype(np.int16)))
    jinp, tinp = fault_inputs(n, 20, seed=3, drop=0.1)
    tst, _, _ = run_both(jcfg, tcfg, jspec, tspec, jst, jinp, tinp)
    assert int(tst.tick) == 32780 and int(tst.nbr_timer.min()) < 0


def test_simulate_and_converge_runners_match_jax():
    tcfg, jcfg = cfgs()
    tspec, jspec = specs(k=32, boot_contacts=2)
    n = 24
    jst = jstate.init_sparse_state(n, jspec, seed=1)
    jfin, jticks, jconv = jrunner.run_sparse_until_converged(jst, jcfg, jspec, max_ticks=64)
    tfin, tticks, tconv = run_sparse_until_converged(to_torch(jst), tcfg, tspec, 64, device=CPU)
    assert (tticks, tconv) == (int(jticks), bool(jconv)) and tconv and tticks > 0
    assert_state_equal(tfin, jfin)
    # a converged mesh at entry runs zero ticks
    again = run_sparse_until_converged(tfin, tcfg, tspec, 64, device=CPU)
    assert again[1:] == (0, True)
    # the scan: final state and the metrics stacked on [T]
    jinp, tinp = fault_inputs(n, 10, seed=8)
    jf, jm = jrunner.simulate_sparse(jfin, jinp, jcfg, jspec)
    tf, tm = simulate_sparse(tfin, tinp, tcfg, tspec, device=CPU)
    assert_state_equal(tf, jf)
    assert_metrics_equal(tm, jm)
    assert tm.pings_sent.shape == (10,)


@pytest.mark.parametrize("faulty", [True, False])
def test_sparse_passes_pinned_to_the_planner(faulty):
    _, jcfg = cfgs()
    prog = plan(build_graph(jcfg, faulty=faulty, layout="blocked_topk"), "sparse")
    assert {p.name: p.op_names for p in prog.tail} == derive.SPARSE_PASSES
    assert tuple(derive.SPARSE_PASSES) == kernel.SPARSE_TAIL_PASSES == jkernel.SPARSE_TAIL_PASSES
    tick = derive.make_sparse_tick(cfgs()[0], SparseSpec(k=8), faulty=faulty)
    assert tick.passes == derive.SPARSE_PASSES
    assert "sparse" in derive.ENGINES
    n = 12
    st, m = tick(init_sparse_state(n, SparseSpec(k=8), device=CPU),
                 sparse_idle_inputs(n, device=CPU))
    assert int(st.tick) == 1 and int(st.cursor) == 1 and 0.0 <= float(m.block_fill) <= 1.0


# ---------------------------------------------------------------- the JAX stat pins, on the port


def test_sparse_boot_converges_to_full_agreement():
    cfg, spec = cfgs()[0], SparseSpec(k=32, boot_contacts=2)
    n = 24
    fin, ticks, conv = run_sparse_until_converged(
        init_sparse_state(n, spec, seed=1, device=CPU), cfg, spec, 64, device=CPU)
    assert conv and 0 < ticks <= 64
    fp = sparse_fingerprint(fin)
    assert bool((fp == fp[0]).all())
    assert bool(((fin.nbr_state > 0).sum(dim=1) == min(spec.k, n - 1)).all())


def test_killed_peers_expire_from_every_block():
    cfg, spec = cfgs(ping_timeout_ticks=2)[0], SparseSpec(k=32, boot_contacts=2)
    n = 20
    st, _, conv = run_sparse_until_converged(
        init_sparse_state(n, spec, seed=2, device=CPU), cfg, spec, 64, device=CPU)
    assert conv
    dead = [3, 11]
    inp = sparse_idle_inputs(n, ticks=40, device=CPU)
    inp.kill[0, dead] = True
    fin, _ = simulate_sparse(st, inp, cfg, spec, device=CPU)
    idx, occ, alive = fin.nbr_idx.numpy(), fin.nbr_state.numpy() > 0, fin.alive.numpy()
    assert not alive[dead].any()
    for i in np.nonzero(alive)[0]:
        assert not np.isin(idx[i, occ[i]], dead).any(), f"row {i} still carries a dead peer"
    fp = sparse_fingerprint(fin).numpy()[alive]
    assert (fp == fp[0]).all()


def test_revived_peer_rejoins_through_repair():
    cfg, spec = cfgs(ping_timeout_ticks=2)[0], SparseSpec(k=16, boot_contacts=2)
    n, ticks = 16, 56
    st, _, _ = run_sparse_until_converged(
        init_sparse_state(n, spec, seed=3, device=CPU), cfg, spec, 64, device=CPU)
    inp = sparse_idle_inputs(n, ticks=ticks, device=CPU)
    inp.kill[0, 5] = True
    inp.revive[20, 5] = True
    fin, _ = simulate_sparse(st, inp, cfg, spec, device=CPU)
    assert bool(fin.alive.all())
    idx, occ = fin.nbr_idx.numpy(), fin.nbr_state.numpy() > 0
    carries = np.array([(idx[i, occ[i]] == 5).any() for i in range(n)])
    assert carries[np.arange(n) != 5].all()


# ---------------------------------------------------------------- dryrun, bench, entry points


def test_dryrun_stat_leg_matches_jax():
    from kaboodle_tpu.sparseplane.dryrun import _stat_check as jax_stat_check

    got = dryrun._stat_check(0, CPU)
    want = jax_stat_check(0)
    assert (got["dense_ticks"], got["sparse_ticks"]) == (want["dense_ticks"], want["sparse_ticks"])
    assert got["checks"] == want["checks"] and all(got["checks"].values())
    assert got["compiles_steady"] == 0


def test_dryrun_main_on_cpu(capsys):
    assert dryrun.main(["--device", "cpu", "--smoke-n", "512", "--smoke-ticks", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["device"] == "cpu" and out["smoke"]["advanced"]
    assert set(out) == {"metric", "device", "stat", "smoke", "ok"}


def test_bench_main_writes_torch_sparse_json(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert bench.main(["--n", "256", "--ticks", "16", "--chunk", "8", "--device", "cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["torch_sparse.json"]
    rec = json.loads((tmp_path / "torch_sparse.json").read_text())
    assert rec["compiles_steady"] == 0 and rec["n"] == 256 and rec["ticks"] == 16
    assert [c["tick"] for c in rec["curve"]] == [8, 16]
    assert rec["sub_quadratic"]["ratio_8x_n"] is None and rec["sub_quadratic"]["reason"]
    assert rec["s_per_tick"] > 0 and rec["device"] == "cpu"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert init_sparse_state(16, SparseSpec(k=8)).nbr_idx.is_cuda
        return
    cfg, spec = cfgs()[0], SparseSpec(k=8)
    st = init_sparse_state(16, spec, device=CPU)
    idle = sparse_idle_inputs(16, ticks=2, device=CPU)
    for call in (lambda: init_sparse_state(16, spec), lambda: sparse_idle_inputs(16),
                 lambda: simulate_sparse(st, idle, cfg, spec),
                 lambda: run_sparse_until_converged(st, cfg, spec, 8),
                 lambda: dryrun.main(["--skip-smoke"]), lambda: bench.main(["--n", "64"]),
                 lambda: dryrun._stat_check(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
