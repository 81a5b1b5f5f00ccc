"""The PyTorch port's ops against the JAX package, bit for bit, on the CPU.

Covers hashing (uint32 words carried as int32 bits), the threefry RNG and
its counter-keyed tick streams, every sampling primitive, the state and
scenario carriers, the package's isolation from JAX, and the entry
points' device default. Inputs come from numpy seeds and go through both
engines.
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.ops import hashing as jhash
from kaboodle_tpu.ops import sampling as jsamp
from kaboodle_tpu.phasegraph import rng as jrng
from kaboodle_tpu.phasegraph.graph import build_graph
from kaboodle_tpu.phasegraph.plan import plan
from kaboodle_tpu.sim import scenario as jscen
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import hashing, sampling, threefry
from kaboodle_tpu_torch.phasegraph import rng
from kaboodle_tpu_torch.phasegraph.exec import dispatch_pred_terms
from kaboodle_tpu_torch.sim import scenario
from kaboodle_tpu_torch.sim import state as tstate

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small-N tensor ops run fastest on one thread, and leave the other
    test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(a) -> torch.Tensor:
    """uint32 numpy words as the port's int32-bit tensor."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())


def _np_u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _jkey(key) -> jax.Array:
    return jnp.asarray(np.asarray(key, dtype=np.uint32))


# ---------------------------------------------------------------- hashing


@pytest.mark.parametrize("seed", [0, 1])
def test_mix32_and_record_hash_match(seed):
    rng_ = np.random.default_rng(seed)
    x = rng_.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    ids = rng_.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    np.testing.assert_array_equal(_np_u32(hashing.mix32(_u32(x))), np.asarray(jhash.mix32(x)))
    pid = np.arange(4096, dtype=np.uint32)
    np.testing.assert_array_equal(
        _np_u32(hashing.peer_record_hash(torch.arange(4096), _u32(ids))),
        np.asarray(jhash.peer_record_hash(pid, ids)),
    )


@pytest.mark.parametrize("chunk_cells", [None, 5 * 96])
@pytest.mark.parametrize("views", [False, True])
def test_membership_fingerprint_matches(views, chunk_cells, monkeypatch):
    """Whole, and in row chunks of 5 rows (the last chunk short)."""
    if chunk_cells:
        monkeypatch.setattr(threefry, "CHUNK_CELLS", chunk_cells)
    rng_ = np.random.default_rng(3)
    n = 96
    member = rng_.random((n, n)) < 0.6
    shape = (n, n) if views else (n,)
    ids = rng_.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    got = hashing.membership_fingerprint(torch.from_numpy(member), _u32(ids))
    np.testing.assert_array_equal(_np_u32(got), np.asarray(jhash.membership_fingerprint(member, ids)))


def test_fingerprint_agreement_unsigned_order():
    # Fingerprints with the high bit set sort above the others as uint32;
    # as int32 bits they are negative, which must not change min/max.
    fp = np.array([0x80000001, 0x00000005, 0xFFFFFFF0, 0x7FFFFFFF], dtype=np.uint32)
    for alive in ([True, True, True, True], [True, False, True, False],
                  [False, False, False, False], [False, False, True, False]):
        alive = np.array(alive)
        conv, lo, hi, na = hashing.fingerprint_agreement(torch.from_numpy(alive), _u32(fp))
        jc, jlo, jhi, jna = jhash.fingerprint_agreement(jnp.asarray(alive), jnp.asarray(fp))
        assert bool(conv) == bool(jc)
        assert int(na) == int(jna)
        assert _np_u32(lo) == np.asarray(jlo) and _np_u32(hi) == np.asarray(jhi)


def test_wrap_sum_is_mod_2_32():
    w = np.full((3, 1000), 0xFFFFFFFF, dtype=np.uint32)
    got = _np_u32(hashing.wrap_sum(_u32(w)))
    np.testing.assert_array_equal(got, np.asarray(jnp.sum(jnp.asarray(w), axis=-1, dtype=jnp.uint32)))


# ---------------------------------------------------------------- threefry


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(np.uint32(seed))
    assert tuple(int(v) for v in np.asarray(jk)) == threefry.prng_key(seed)
    for d in (0, 1, 12345, 2**32 - 1):
        assert tuple(int(v) for v in np.asarray(jax.random.fold_in(jk, np.uint32(d)))) == \
            threefry.fold_in(threefry.prng_key(seed), d)


@pytest.mark.parametrize("tick", [0, 1, 77, 32000])
def test_tick_draw_keys_match(tick):
    key = (0x1234ABCD, 0xF00DF00D)
    jkeys = jrng.tick_draw_keys(_jkey(key), jnp.int32(tick))
    for jk, tk in zip(jkeys, rng.tick_draw_keys(key, tick)):
        assert tuple(int(v) for v in np.asarray(jk)) == tk
    assert tuple(int(v) for v in np.asarray(jrng.stream_key(jnp.uint32(9), jnp.int32(tick), 4))) \
        == rng.stream_key(9, tick, 4)


@pytest.mark.parametrize("shape", [(37,), (64,), (23, 41), (128, 128)])
def test_uniform_bits_match(shape):
    for tick in (0, 5):
        for stream in (rng.STREAM_TICK_PING, rng.STREAM_TICK_DROP):
            key = rng.tick_stream_key((3, 9), tick, stream)
            want = np.asarray(jax.random.uniform(_jkey(key), shape, dtype=jnp.float32))
            got = threefry.uniform(key, shape, CPU).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(
        rng.stream_uniform(4, 2, rng.STREAM_DRAW, shape, CPU).numpy(),
        np.asarray(jrng.stream_uniform(jnp.uint32(4), jnp.int32(2), rng.STREAM_DRAW, shape)),
    )


def test_row_chunked_draws_equal_whole_draw(monkeypatch):
    key = rng.tick_stream_key((1, 2), 3, rng.STREAM_TICK_BERN)
    want = np.asarray(jax.random.uniform(_jkey(key), (50, 70), dtype=jnp.float32))
    monkeypatch.setattr(threefry, "CHUNK_CELLS", 3 * 70 + 5)
    assert len(list(threefry.row_chunks(50, 70))) == 17
    np.testing.assert_array_equal(threefry.uniform(key, (50, 70), CPU).numpy(), want)


@pytest.mark.parametrize("tick", [0, 4, 301])
def test_gumbel_order_bits_order_the_gumbel_draw(tick):
    key = rng.tick_stream_key((11, tick), tick, rng.STREAM_TICK_PROXY)
    g = np.asarray(jax.random.gumbel(_jkey(key), (64, 256), dtype=jnp.float32))
    b = threefry.gumbel_order_bits(key, (64, 256), CPU).numpy()
    # Equal bits <=> equal draws, and the orders agree everywhere.
    for i in range(64):
        o = np.lexsort((np.arange(256), -g[i]))
        p = np.lexsort((np.arange(256), -b[i]))
        np.testing.assert_array_equal(o, p)


# ---------------------------------------------------------------- sampling


def _scores(rng_, n, dtype, tie=False):
    hi = 4 if tie else 60
    s = rng_.integers(-12, hi, size=(n, n)).astype(dtype)
    s[rng_.random((n, n)) < 0.3] = np.iinfo(dtype).max  # sentinel cells
    return s


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("tie", [False, True])
def test_stable_k_smallest_match(dtype, tie):
    rng_ = np.random.default_rng(5)
    s = _scores(rng_, 40, dtype, tie)
    tmax = int(np.iinfo(dtype).max)
    for k in (1, 5):
        ji, jv = jsamp._stable_k_smallest_iter(jnp.asarray(s), k, jnp.asarray(tmax, dtype))
        ti, tv = sampling._stable_k_smallest_iter(torch.from_numpy(s), k, tmax)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        ki, kv = jsamp._stable_k_smallest_topk(jnp.asarray(s), k, tmax)
        pi, pv = sampling._stable_k_smallest_topk(torch.from_numpy(s), k, tmax)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(kv))
        np.testing.assert_array_equal(np.where(pv, pi, -1), np.where(kv, ki, -1))


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("method", ["iter", "topk"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_choose_one_of_oldest_k_match(det, method, dtype):
    rng_ = np.random.default_rng(8)
    n = 48
    timer = rng_.integers(-12, 6, size=(n, n)).astype(dtype)  # tie pile-ups
    elig = rng_.random((n, n)) < 0.5
    elig[3] = False
    for tick in (0, 9):
        key = rng.tick_stream_key((5, 6), tick, rng.STREAM_TICK_PING)
        want = jsamp.choose_one_of_oldest_k(jnp.asarray(timer), jnp.asarray(elig), 5,
                                            _jkey(key), det, method=method)
        got = sampling.choose_one_of_oldest_k(torch.from_numpy(timer), torch.from_numpy(elig),
                                              5, key, det, method=method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("det", [False, True])
def test_choose_among_candidates_and_pick(det):
    rng_ = np.random.default_rng(9)
    idx = rng_.integers(0, 30, size=(30, 5)).astype(np.int32)
    cnt = rng_.integers(0, 6, size=30)
    valid = np.arange(5)[None, :] < cnt[:, None]
    key = rng.tick_stream_key((0, 3), 2, rng.STREAM_TICK_PING)
    want = jsamp.choose_among_candidates(jnp.asarray(idx), jnp.asarray(valid), _jkey(key), det)
    got = sampling.choose_among_candidates(torch.from_numpy(idx), torch.from_numpy(valid), key, det)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = np.nextafter(np.float32(1), np.float32(0)) * np.ones(30, np.float32)  # floor clamp edge
    np.testing.assert_array_equal(
        sampling.pick_candidate(torch.from_numpy(idx), torch.from_numpy(valid),
                                torch.from_numpy(u)).numpy(),
        np.asarray(jsamp.pick_candidate(jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(u))),
    )


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("density", [0.02, 0.5])
def test_choose_k_members_match(det, density, monkeypatch):
    rng_ = np.random.default_rng(10)
    n = 300
    elig = rng_.random((n, n)) < density  # sparse rows: fewer than k members
    monkeypatch.setattr(threefry, "CHUNK_CELLS", 7 * n)  # several row chunks
    for tick in (1, 4):
        key = rng.tick_stream_key((8, 1), tick, rng.STREAM_TICK_PROXY)
        ji, jv = jsamp.choose_k_members(jnp.asarray(elig), 3, _jkey(key), det)
        ti, tv = sampling.choose_k_members(torch.from_numpy(elig), 3, key, det)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("det", [False, True])
def test_bernoulli_matrix_and_reply_prob(det):
    rng_ = np.random.default_rng(12)
    known = rng_.integers(0, 20, size=(64, 64)).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.broadcast_reply_prob(torch.from_numpy(known)).numpy(),
        np.asarray(jsamp.broadcast_reply_prob(jnp.asarray(known))),
    )
    p = np.array(jsamp.broadcast_reply_prob(jnp.asarray(known)))
    key = rng.tick_stream_key((2, 2), 0, rng.STREAM_TICK_BERN)
    np.testing.assert_array_equal(
        sampling.bernoulli_matrix(key, torch.from_numpy(p), (64, 64), det).numpy(),
        np.asarray(jsamp.bernoulli_matrix(_jkey(key), jnp.asarray(p), (64, 64), det)),
    )


# ---------------------------------------------------------------- state, inputs


def _jax_leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_leaves_equal(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, k
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, (k, w.dtype, g.dtype, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(seed=3, ring_contacts=5, announced=True),
    dict(seed=2**32 - 2, track_latency=False, instant_identity=True, lean=True),
])
def test_init_state_matches_and_round_trips(opts):
    opts = dict(opts)
    lean = opts.pop("lean", False)
    n = 24
    alive = np.arange(n) % 5 != 0
    ids = (np.arange(n, dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    js = jstate.init_state(n, identities=jnp.asarray(ids), alive=jnp.asarray(alive),
                           timer_dtype=jnp.int16 if lean else jnp.int32,
                           **{k: (np.uint32(v) if k == "seed" else v) for k, v in opts.items()})
    ts = tstate.init_state(n, identities=ids, alive=alive, device=CPU,
                           timer_dtype=torch.int16 if lean else torch.int32, **opts)
    _assert_leaves_equal(_jax_leaves(js), tstate.state_to_numpy(ts))
    back = tstate.state_to_numpy(tstate.state_from_numpy(_jax_leaves(js), device=CPU))
    _assert_leaves_equal(_jax_leaves(js), back)


@pytest.mark.parametrize("ring_contacts", [0, 3])
def test_init_state_plane_matches_in_row_chunks(ring_contacts, monkeypatch):
    """The int8 plane, written in row chunks (here of 2 rows, so every chunk
    boundary and the ring's wrap-around are crossed), equals JAX's."""
    monkeypatch.setattr(threefry, "CHUNK_CELLS", 2 * 20)
    js = jstate.init_state(20, seed=1, ring_contacts=ring_contacts)
    ts = tstate.init_state(20, seed=1, ring_contacts=ring_contacts, device=CPU)
    assert ts.state.dtype == torch.int8 and ts.state.is_contiguous()
    _assert_leaves_equal(_jax_leaves(js), tstate.state_to_numpy(ts))


def test_idle_inputs_and_scenarios_match():
    _assert_leaves_equal(_jax_leaves(jstate.idle_inputs(16, ticks=4)),
                         _torch_inputs(tstate.idle_inputs(16, ticks=4, device=CPU)))
    for cfg, n, ticks in ((1, None, None), (2, 64, 8), (3, 128, 48), (4, 32, 4), (5, 96, 30)):
        js = jscen.baseline_scenario(cfg, n=n, ticks=ticks, seed=4)
        ts = scenario.baseline_scenario(cfg, n=n, ticks=ticks, seed=4)
        _assert_leaves_equal(_jax_leaves(js.build()), _torch_inputs(ts.build(CPU)))
        np.testing.assert_array_equal(ts.alive_trajectory(), js.alive_trajectory())
    sc = scenario.Scenario(8, 6).kill_at(1, [2]).revive_at(3, [2]).partition_at(
        0, np.arange(8) % 2, until=2).manual_ping_at(4, 0, 5).drop(0.1, 2, 4)
    jsc = jscen.Scenario(8, 6).kill_at(1, [2]).revive_at(3, [2]).partition_at(
        0, np.arange(8) % 2, until=2).manual_ping_at(4, 0, 5).drop(0.1, 2, 4)
    _assert_leaves_equal(_jax_leaves(jsc.build()), _torch_inputs(sc.build(CPU)))


def _torch_inputs(inp) -> dict:
    return {f.name: None if getattr(inp, f.name) is None else getattr(inp, f.name).numpy()
            for f in dataclasses.fields(inp)}


def test_inputs_from_numpy_carries_drop_ok():
    rng_ = np.random.default_rng(1)
    leaves = _jax_leaves(jstate.idle_inputs(8, ticks=3))
    leaves["drop_ok"] = rng_.random((3, 8, 8)) < 0.5
    got = tstate.inputs_from_numpy(leaves, device=CPU)
    _assert_leaves_equal(leaves, _torch_inputs(got))
    assert got.at(2).drop_ok.shape == (8, 8)


# ---------------------------------------------------------------- predicate


@pytest.mark.parametrize("kw", [
    dict(), dict(join_broadcast_enabled=False), dict(faithful_failed_broadcast=False),
    dict(deterministic=True, use_pallas_fp=True, use_pallas_oldest_k=True,
         use_pallas_suspicion=True),
])
@pytest.mark.parametrize("faulty", [False, True])
def test_dispatch_predicate_pinned_to_planner(kw, faulty):
    want = plan(build_graph(JaxSwimConfig(**kw), faulty=faulty), "fused").pred_terms
    assert dispatch_pred_terms(SwimConfig(**kw)) == tuple(want)


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(JaxSwimConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SwimConfig)}
    assert jf == tf
    with pytest.raises(ValueError):
        SwimConfig(oldest_k_method="sort")
    with pytest.raises(ValueError):
        SwimConfig(ping_timeout_ticks=0)


# ---------------------------------------------------------------- isolation, device


def test_package_imports_without_jax_or_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for blocked in ("jax", "jaxlib", "kaboodle_tpu"):
            sys.modules[blocked] = None  # any import of them raises ImportError
        import kaboodle_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(kaboodle_tpu_torch.__path__,
                                                      "kaboodle_tpu_torch.")]
        # A __main__ module runs its command line when imported (the node
        # mode never returns): the --help subprocess below covers them.
        mains = [n for n in names if n.endswith(".__main__")]
        assert set(mains) == {"kaboodle_tpu_torch.__main__",
                              "kaboodle_tpu_torch.analysis.__main__"}, mains
        for name in names:
            if name not in mains:
                importlib.import_module(name)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kaboodle_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        fleet = {"kaboodle_tpu_torch.fleet", "kaboodle_tpu_torch.fleet.core",
                 "kaboodle_tpu_torch.fleet.stats", "kaboodle_tpu_torch.fleet.bench",
                 "kaboodle_tpu_torch.phasegraph.derive"}
        assert fleet <= set(names), fleet - set(names)
        serve = {"kaboodle_tpu_torch.serve", "kaboodle_tpu_torch.serve.admission",
                 "kaboodle_tpu_torch.serve.client", "kaboodle_tpu_torch.serve.dryrun",
                 "kaboodle_tpu_torch.serve.engine", "kaboodle_tpu_torch.serve.journal",
                 "kaboodle_tpu_torch.serve.obsplane", "kaboodle_tpu_torch.serve.pool",
                 "kaboodle_tpu_torch.serve.server", "kaboodle_tpu_torch.serve.spill",
                 "kaboodle_tpu_torch.analysis.conc.sanitizer",
                 "kaboodle_tpu_torch.telemetry.manifest", "kaboodle_tpu_torch.profiling"}
        assert serve <= set(names), serve - set(names)
        slice9 = {"kaboodle_tpu_torch.oracle.engine", "kaboodle_tpu_torch.oracle.lockstep",
                  "kaboodle_tpu_torch.telemetry.trace", "kaboodle_tpu_torch.telemetry.summary",
                  "kaboodle_tpu_torch.analysis.ir", "kaboodle_tpu_torch.analysis.ir.surface",
                  "kaboodle_tpu_torch.serve.loadgen", "kaboodle_tpu_torch.serve.chaos",
                  "kaboodle_tpu_torch.serve.obsdryrun", "kaboodle_tpu_torch.serve.federation",
                  "kaboodle_tpu_torch.serve.federation.ring",
                  "kaboodle_tpu_torch.serve.federation.router",
                  "kaboodle_tpu_torch.serve.federation.fedload"}
        assert slice9 <= set(names), slice9 - set(names)
        slice10 = {"kaboodle_tpu_torch.sparseplane", "kaboodle_tpu_torch.sparseplane.state",
                   "kaboodle_tpu_torch.sparseplane.rng", "kaboodle_tpu_torch.sparseplane.repair",
                   "kaboodle_tpu_torch.sparseplane.kernel", "kaboodle_tpu_torch.sparseplane.runner",
                   "kaboodle_tpu_torch.sparseplane.dryrun", "kaboodle_tpu_torch.sparseplane.bench",
                   "kaboodle_tpu_torch.transport", "kaboodle_tpu_torch.transport.codec",
                   "kaboodle_tpu_torch.transport.native", "kaboodle_tpu_torch.transport.real",
                   "kaboodle_tpu_torch.checkpoint", "kaboodle_tpu_torch.spec",
                   "kaboodle_tpu_torch.config"}
        assert slice10 <= set(names), slice10 - set(names)
        slice11 = {"kaboodle_tpu_torch.cli", "kaboodle_tpu_torch.phasegraph.dryrun",
                   "kaboodle_tpu_torch.analysis.core", "kaboodle_tpu_torch.analysis.conc.rules",
                   "kaboodle_tpu_torch.analysis.cli"}
        assert slice11 <= set(names), slice11 - set(names)
        slice12 = {"kaboodle_tpu_torch.parallel", "kaboodle_tpu_torch.parallel.collectives",
                   "kaboodle_tpu_torch.parallel.mesh", "kaboodle_tpu_torch.parallel.worker",
                   "kaboodle_tpu_torch.fleet.sharding"}
        assert slice12 <= set(names), slice12 - set(names)
        slice13 = {"kaboodle_tpu_torch.serve.shardpool", "kaboodle_tpu_torch.analysis.rng",
                   "kaboodle_tpu_torch.analysis.rng.rules", "kaboodle_tpu_torch.analysis.rules_rng",
                   "kaboodle_tpu_torch.analysis.rules_ir"}
        assert slice13 <= set(names), slice13 - set(names)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parent.parent))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 75
    # The command lines, with the same two packages blocked.
    block = ("import runpy, sys\n"
             "for blocked in ('jax', 'jaxlib', 'kaboodle_tpu'):\n"
             "    sys.modules[blocked] = None\n"
             "sys.argv = ['kaboodle_tpu_torch', '--help']\n"
             "runpy.run_module('kaboodle_tpu_torch', run_name='__main__', alter_sys=True)\n")
    out = subprocess.run([sys.executable, "-c", block], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parent.parent))
    assert out.returncode == 0, out.stderr
    assert "--sim" in out.stdout and "--device" in out.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert tstate.init_state(64).state.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.init_state(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.idle_inputs(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario.baseline_scenario(3, n=16, ticks=4).build()
    assert tstate.init_state(64, device="cpu").state.device.type == "cpu"
