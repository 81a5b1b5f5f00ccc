"""The port's ``.npz`` checkpoints against the JAX package's, both ways.

An archive written by either package loads in the other with every leaf
and dtype equal (uint32 words as uint32, int16 timers as int16, optional
planes absent), and a run resumed from it equals the uninterrupted run.
The guards raise ``CheckpointError`` in the cases the JAX package raises
its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaboodle_tpu import checkpoint as jckpt
from kaboodle_tpu import errors as jerrors
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.sim.kernel import make_tick_fn as jax_make_tick_fn
from kaboodle_tpu_torch import checkpoint
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.errors import CheckpointError, KaboodleError
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sim.kernel import make_tick_fn

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same(want: dict, got: dict, where: str, latency_rtol: float = 0.0):
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {k} {w.dtype} {g.dtype}"
        if k == "latency":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            np.testing.assert_allclose(g, w, rtol=latency_rtol, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


def _jax_state(n, latency, views, int16, seed=13):
    return jstate.init_state(n, seed=seed, track_latency=latency, instant_identity=not views,
                             timer_dtype=jnp.int16 if int16 else jnp.int32)


def test_jax_archive_resumes_in_the_port(tmp_path):
    """7 JAX ticks, a JAX archive, 9 port ticks from it == 9 more JAX ticks."""
    n, cfg = 24, JaxSwimConfig()
    jtick = jax.jit(jax_make_tick_fn(cfg, faulty=False))
    idle = jstate.idle_inputs(n)
    st = _jax_state(n, True, True, False)
    for _ in range(7):
        st, _ = jtick(st, idle)
    path = tmp_path / "jax.npz"
    jckpt.save(path, st)
    resumed = checkpoint.load(path, device=CPU)
    _assert_same(_leaves(st), tstate.state_to_numpy(resumed), "loaded")
    ttick = make_tick_fn(SwimConfig(), faulty=False)
    tidle = tstate.idle_inputs(n, device=CPU)
    for _ in range(9):
        st, _ = jtick(st, idle)
        resumed, _ = ttick(resumed, tidle)
    _assert_same(_leaves(st), tstate.state_to_numpy(resumed), "resumed", latency_rtol=1e-5)


def test_port_archive_loads_in_jax(tmp_path):
    """A port archive (after a churn run, owner-stamped, atomic) loads in
    JAX, and both continue to the same state."""
    n = 32
    jst = _jax_state(n, True, True, True, seed=4)
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    ttick = make_tick_fn(SwimConfig(deterministic=True))
    from kaboodle_tpu.sim import scenario as jscen

    inp = tstate.inputs_from_numpy(_leaves(jscen.baseline_scenario(3, n=n, ticks=10).build()),
                                   device=CPU)
    for t in range(10):
        tst, _ = ttick(tst, inp.at(t))
    path = tmp_path / "port.npz"
    checkpoint.save(path, tst, atomic=True, owner="engine-a")
    assert checkpoint.checkpoint_owner(path) == jckpt.checkpoint_owner(path) == "engine-a"
    back = jckpt.load(path, expect_owner="engine-a")
    _assert_same(tstate.state_to_numpy(tst), _leaves(back), "loaded in jax")
    jtick = jax.jit(jax_make_tick_fn(JaxSwimConfig(deterministic=True), faulty=False))
    ttick = make_tick_fn(SwimConfig(deterministic=True), faulty=False)
    tidle = tstate.idle_inputs(n, device=CPU)
    for _ in range(4):
        back, _ = jtick(back, jstate.idle_inputs(n))
        tst, _ = ttick(tst, tidle)
    _assert_same(_leaves(back), tstate.state_to_numpy(tst), "continued", latency_rtol=1e-5)


@pytest.mark.parametrize("latency,views", [(True, True), (True, False), (False, True),
                                           (False, False)])
@pytest.mark.parametrize("int16", [False, True])
def test_round_trips_and_schema(tmp_path, latency, views, int16):
    """Every lean/full combination, int16 and int32 timers: the port's
    archive has the JAX archive's entries, names and dtypes, and each
    package reads the other's back exactly."""
    jst = _jax_state(12, latency, views, int16, seed=7)
    tst = tstate.state_from_numpy(_leaves(jst), device=CPU)
    tpath, jpath = tmp_path / "t.npz", tmp_path / "j.npz"
    checkpoint.save(tpath, tst)
    jckpt.save(jpath, jst)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for name in j.files:
            assert t[name].dtype == j[name].dtype and t[name].shape == j[name].shape, name
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
        assert ("latency" in t.files) == latency and ("id_view" in t.files) == views
    _assert_same(_leaves(jst), tstate.state_to_numpy(checkpoint.load(jpath, device=CPU)), "j->t")
    _assert_same(tstate.state_to_numpy(tst), _leaves(jckpt.load(tpath)), "t->j")
    back = checkpoint.load(tpath, device=CPU)
    assert back.timer.dtype == (torch.int16 if int16 else torch.int32)
    _assert_same(tstate.state_to_numpy(tst), tstate.state_to_numpy(back), "t->t")


def _raises_in_both(path, **kw):
    with pytest.raises(CheckpointError):
        checkpoint.load(path, device=CPU, **kw)
    with pytest.raises(jerrors.CheckpointError):
        jckpt.load(path, **kw)


def test_guards_raise_checkpoint_error(tmp_path):
    """Version, missing fields, torn and alien files, a missing file, owner
    mismatch and a missing owner stamp; the atomic write leaves one file."""
    st = tstate.init_state(8, seed=1, device=CPU)
    bad = tmp_path / "bad.npz"
    np.savez(bad, __version__=np.int32(99))
    _raises_in_both(bad)
    fields_missing = tmp_path / "trunc.npz"
    np.savez(fields_missing, __version__=np.int32(1), state=np.zeros((2, 2)))
    _raises_in_both(fields_missing)
    no_version = tmp_path / "noversion.npz"
    np.savez(no_version, state=np.zeros((2, 2)))
    _raises_in_both(no_version)

    good = tmp_path / "good.npz"
    checkpoint.save(good, st)
    data = good.read_bytes()
    torn = tmp_path / "torn.npz"
    torn.write_bytes(data[: len(data) // 3])
    _raises_in_both(torn)
    alien = tmp_path / "alien.npz"
    alien.write_bytes(b"definitely not a zip archive\n" * 4)
    _raises_in_both(alien)
    _raises_in_both(tmp_path / "missing.npz")
    with pytest.raises(CheckpointError):
        checkpoint.checkpoint_owner(tmp_path / "missing.npz")

    _raises_in_both(good, expect_owner="engine-a")  # no stamp
    assert checkpoint.checkpoint_owner(good) is None
    owned = tmp_path / "owned.npz"
    checkpoint.save(owned, st, owner="engine-b")
    _raises_in_both(owned, expect_owner="engine-a")
    assert checkpoint.load(owned, expect_owner="engine-b", device=CPU).n == 8
    assert issubclass(CheckpointError, KaboodleError)

    atomic_dir = tmp_path / "atomic"
    atomic_dir.mkdir()
    path = atomic_dir / "a.npz"
    checkpoint.save(path, st, atomic=True)
    assert list(atomic_dir.iterdir()) == [path]
    _assert_same(tstate.state_to_numpy(st),
                 tstate.state_to_numpy(checkpoint.load(path, device=CPU)), "atomic")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.load(path)


# ---------------------------------------------------------------- fleet archives


def _jax_fleet(lean: bool):
    from kaboodle_tpu import fleet as jfleet

    kw = dict(track_latency=not lean, instant_identity=lean,
              timer_dtype=jnp.int16 if lean else jnp.int32)
    fl = jfleet.init_fleet(12, 3, seeds=jnp.asarray([4, 1, 7]),
                           drop_rates=jnp.asarray([0.0, 0.2, 0.1]), **kw)
    fl, _ = jfleet.simulate_fleet(fl, jfleet.fleet_idle_inputs(12, 3, ticks=3),
                                  JaxSwimConfig(), faulty=False)
    return fl


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("generation", [None, [3, 0, 9]])
def test_fleet_archives_both_ways(tmp_path, lean, generation):
    """``save_fleet`` / ``load_fleet`` on the JAX fleet schema: a JAX archive
    loads in the port and a port archive (atomic) loads in JAX, every
    stacked leaf, the drop rates and the lane generations equal; the two
    archives hold the same entries, names and dtypes."""
    jfl = _jax_fleet(lean)
    want = {"mesh": _leaves(jfl.mesh), "drop_rate": np.asarray(jfl.drop_rate)}
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jgen = None if generation is None else jnp.asarray(generation, dtype=jnp.int32)
    jckpt.save_fleet(jpath, jfl, generation=jgen)
    tfl, tgen = checkpoint.load_fleet(jpath, device=CPU)
    got = tstate.fleet_to_numpy(tfl)
    _assert_same(want["mesh"], got["mesh"], "jax -> port")
    np.testing.assert_array_equal(got["drop_rate"], want["drop_rate"])
    assert (tgen is None) == (generation is None)
    if generation is not None:
        assert tgen.dtype == torch.int32 and tgen.tolist() == generation

    checkpoint.save_fleet(tpath, tfl, generation=tgen, atomic=True)
    assert not (tmp_path / "t.npz.tmp").exists()
    back, bgen = jckpt.load_fleet(tpath)
    _assert_same(got["mesh"], _leaves(back.mesh), "port -> jax")
    np.testing.assert_array_equal(np.asarray(back.drop_rate), want["drop_rate"])
    assert (bgen is None) == (generation is None)
    if generation is not None:
        np.testing.assert_array_equal(np.asarray(bgen), generation)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for name in j.files:
            assert t[name].dtype == j[name].dtype and t[name].shape == j[name].shape, name
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_fleet_archive_guards(tmp_path):
    """A single-mesh archive is no fleet archive (and the other way round),
    and a fleet archive missing its drop rates or a field is refused, in
    both packages."""
    from kaboodle_tpu_torch.fleet import init_fleet

    single = tmp_path / "single.npz"
    checkpoint.save(single, tstate.init_state(8, seed=1, device=CPU))
    fleet = tmp_path / "fleet.npz"
    checkpoint.save_fleet(fleet, init_fleet(8, 2, device=CPU))
    with pytest.raises(CheckpointError, match="not a fleet checkpoint"):
        checkpoint.load_fleet(single, device=CPU)
    with pytest.raises(jerrors.CheckpointError, match="not a fleet checkpoint"):
        jckpt.load_fleet(single)
    _raises_in_both(fleet)
    with np.load(fleet) as z:
        entries = {k: z[k] for k in z.files}
    for drop in ("drop_rate", "mesh.state"):
        broken = tmp_path / f"no_{drop}.npz"
        np.savez(broken, **{k: v for k, v in entries.items() if k != drop})
        with pytest.raises(CheckpointError):
            checkpoint.load_fleet(broken, device=CPU)
        with pytest.raises(jerrors.CheckpointError):
            jckpt.load_fleet(broken)
    assert checkpoint.load_fleet(fleet, device=CPU)[0].ensemble == 2


# ---------------------------------------------------------------- sparse archives


def _sparse_pair(timer="int32"):
    from kaboodle_tpu.sparseplane import state as jsparse
    from kaboodle_tpu_torch.sparseplane import SparseSpec

    kw = dict(k=16, gossip_fanout=4, boot_contacts=2, timer_dtype=timer)
    return (SwimConfig(join_broadcast_enabled=False), SparseSpec(**kw),
            JaxSwimConfig(join_broadcast_enabled=False), jsparse.SparseSpec(**kw))


def _sparse_leaves(jst) -> dict:
    from kaboodle_tpu.sparseplane import SparseState as JaxSparseState

    return {f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(JaxSparseState)}


def _sparse_inputs(n, ticks, seed):
    """Kills, revives and drops as stacked numpy arrays for both packages."""
    from kaboodle_tpu.sparseplane import SparseTickInputs as JaxInputs
    from kaboodle_tpu_torch.sparseplane import SparseTickInputs

    rng = np.random.default_rng(seed)
    kill, revive = rng.random((ticks, n)) < 0.05, rng.random((ticks, n)) < 0.1
    rate = np.full((ticks,), 0.1, np.float32)
    return (JaxInputs(kill=jnp.asarray(kill), revive=jnp.asarray(revive),
                      drop_rate=jnp.asarray(rate)),
            SparseTickInputs(kill=torch.as_tensor(kill), revive=torch.as_tensor(revive),
                             drop_rate=torch.as_tensor(rate)))


@pytest.mark.parametrize("timer", ["int32", "int16"])
def test_sparse_archives_both_ways(tmp_path, timer):
    """A JAX-written sparse archive loads in the port and a port-written one
    in JAX, every plane and dtype equal (``seed``/``cursor`` as uint32); a
    run resumed from either equals the unbroken run."""
    from kaboodle_tpu.sparseplane import init_sparse_state as jinit
    from kaboodle_tpu.sparseplane import simulate_sparse as jsimulate
    from kaboodle_tpu_torch.sparseplane import simulate_sparse
    from kaboodle_tpu_torch.sparseplane.state import (
        sparse_state_from_numpy,
        sparse_state_to_numpy,
    )

    cfg, spec, jcfg, jspec = _sparse_pair(timer)
    n = 20
    jinp, tinp = _sparse_inputs(n, 12, seed=3)
    half = lambda inp, a, b: dataclasses.replace(  # noqa: E731
        inp, kill=inp.kill[a:b], revive=inp.revive[a:b], drop_rate=inp.drop_rate[a:b])
    jmid, _ = jsimulate(jinit(n, jspec, seed=2**31 + 9), half(jinp, 0, 6), jcfg, jspec)
    jend, _ = jsimulate(jmid, half(jinp, 6, 12), jcfg, jspec)

    jpath = tmp_path / "jax_sparse.npz"
    jckpt.save_sparse(jpath, jmid)
    tmid = checkpoint.load_sparse(jpath, device=CPU)
    _assert_same(_sparse_leaves(jmid), sparse_state_to_numpy(tmid), "jax -> port")
    tend, _ = simulate_sparse(tmid, half(tinp, 6, 12), cfg, spec, device=CPU)
    _assert_same(_sparse_leaves(jend), sparse_state_to_numpy(tend), "port resumed")

    tpath = tmp_path / "port_sparse.npz"
    checkpoint.save_sparse(tpath, tmid, atomic=True)
    with np.load(tpath) as z:
        assert z["sparse.seed"].dtype == np.uint32 and z["sparse.cursor"].dtype == np.uint32
        assert z["sparse.nbr_timer"].dtype == np.dtype(timer) and "__sparse__" in z.files
    back = jckpt.load_sparse(tpath)
    _assert_same(_sparse_leaves(jmid), _sparse_leaves(back), "port -> jax")
    jend2, _ = jsimulate(back, half(jinp, 6, 12), jcfg, jspec)
    _assert_same(_sparse_leaves(jend), _sparse_leaves(jend2), "jax resumed")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax_sparse.npz", "port_sparse.npz"]
    # the unbroken port run equals the resumed one
    start = sparse_state_from_numpy(_sparse_leaves(jinit(n, jspec, seed=2**31 + 9)), device=CPU)
    whole, _ = simulate_sparse(start, tinp, cfg, spec, device=CPU)
    _assert_same(sparse_state_to_numpy(whole), sparse_state_to_numpy(tend), "unbroken")


def test_sparse_checkpoint_guards(tmp_path):
    """The JAX guards: the three checkpoint families never cross-restore, a
    torn, alien or missing file and a missing plane raise CheckpointError."""
    from kaboodle_tpu_torch.sparseplane import init_sparse_state

    _, spec, _, _ = _sparse_pair()
    st = init_sparse_state(16, spec, seed=3, device=CPU)
    sp = tmp_path / "sparse.npz"
    checkpoint.save_sparse(sp, st)
    with pytest.raises(CheckpointError):
        checkpoint.load(sp, device=CPU)
    with pytest.raises(CheckpointError):
        checkpoint.load_fleet(sp, device=CPU)
    dense = tmp_path / "dense.npz"
    checkpoint.save(dense, tstate.init_state(8, seed=1, device=CPU))
    with pytest.raises(CheckpointError, match="not a sparse checkpoint"):
        checkpoint.load_sparse(dense, device=CPU)
    fleet = tmp_path / "fleet.npz"
    jckpt.save_fleet(fleet, __import__("kaboodle_tpu.fleet.core", fromlist=["init_fleet"])
                     .init_fleet(8, 2))
    with pytest.raises(CheckpointError, match="not a sparse checkpoint"):
        checkpoint.load_sparse(fleet, device=CPU)

    torn = tmp_path / "torn.npz"
    torn.write_bytes(sp.read_bytes()[: sp.stat().st_size // 3])
    alien = tmp_path / "alien.npz"
    alien.write_bytes(b"definitely not a zip archive\n" * 4)
    for bad in (torn, alien, tmp_path / "missing.npz"):
        with pytest.raises(CheckpointError):
            checkpoint.load_sparse(bad, device=CPU)

    with np.load(sp) as z:
        entries = {k: np.asarray(v) for k, v in z.items()}
    for drop, match in (("sparse.cursor", "cursor"), ("__version__", "no version entry")):
        short = tmp_path / f"short_{drop}.npz"
        np.savez(short, **{k: v for k, v in entries.items() if k != drop})
        with pytest.raises(CheckpointError, match=match):
            checkpoint.load_sparse(short, device=CPU)
    wrong = tmp_path / "wrong_version.npz"
    np.savez(wrong, **{**entries, "__version__": np.int32(99)})
    with pytest.raises(CheckpointError, match="unsupported checkpoint version 99"):
        checkpoint.load_sparse(wrong, device=CPU)
    # the JAX package raises the same on the port's archive
    with pytest.raises(jerrors.CheckpointError):
        jckpt.load(sp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.load_sparse(sp)


# ---------------------------------------------------------------------------
# sharded checkpoints: 4 gloo ranks save and load, then 2 ranks load what
# the 4 saved (kaboodle_tpu_torch.parallel.worker; one job each, started
# once for the module).

SHARD_N, SHARD_TICKS = 32, 6


def _port_run(n, ticks, **init):
    st = tstate.init_state(n, device=CPU, **init)
    return runner_simulate(st, ticks)


def runner_simulate(st, ticks):
    from kaboodle_tpu_torch.sim.runner import simulate

    return simulate(st, tstate.idle_inputs(st.n, ticks=ticks, device=CPU), SwimConfig(),
                    faulty=False)[0]


LEAN_INIT = dict(track_latency=False, instant_identity=True, timer_dtype=torch.int16)


@pytest.fixture(scope="module")
def sharded_ckpt(tmp_path_factory):
    from kaboodle_tpu_torch.parallel.worker import start_workers

    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    # JAX archives (written by the JAX package) of two states the port's
    # dense tick reached: the full state and the lean one.
    for name, init in (("full", dict(seed=2)), ("lean", dict(seed=4, **LEAN_INIT))):
        st = _port_run(SHARD_N, 3, **init)
        jst = jstate.MeshState(**{k: None if v is None else jnp.asarray(v)
                                  for k, v in tstate.state_to_numpy(st).items()})
        jckpt.save(str(tmp / f"jax_{name}.npz"), jst)
    four = [
        dict(name="load_full", kind="checkpoint", op="load_npz", path=str(tmp / "jax_full.npz")),
        dict(name="load_lean", kind="checkpoint", op="load_npz", path=str(tmp / "jax_lean.npz")),
        dict(name="save_npz", kind="checkpoint", op="save_npz", n=SHARD_N, ticks=SHARD_TICKS,
             init=dict(seed=6), path=str(tmp / "saved.npz")),
        dict(name="save_async", kind="checkpoint", op="save_async", n=SHARD_N,
             ticks=SHARD_TICKS, init=dict(seed=6), path=str(tmp / "dcp")),
    ]
    two = [dict(name="load_dcp", kind="checkpoint", op="load_dcp", n=SHARD_N, init=dict(seed=6),
                path=str(tmp / "dcp"))]
    for c in four + two:
        c["out"] = str(tmp / f"{c['name']}_out.npz")
    digests = start_workers(4, {"device": "cpu", "timeout_s": 60, "cases": four},
                            str(tmp / "four.json"), timeout_s=90).wait()
    digests.update(start_workers(2, {"device": "cpu", "timeout_s": 60, "cases": two},
                                 str(tmp / "two.json"), timeout_s=90).wait())
    arrays = {}
    for c in four + two:
        with np.load(c["out"]) as z:
            arrays[c["name"]] = {k[len("state."):]: z[k] for k in z.files}
    return tmp, digests, arrays


@pytest.mark.parametrize("name", ["full", "lean"])
def test_load_with_mesh_gives_each_rank_its_rows(sharded_ckpt, name):
    """``load(mesh=)`` of a JAX archive: each of 4 ranks holds its 8 rows,
    equal to ``shard_state`` of the whole load; gathered, the archive."""
    tmp, digests, arrays = sharded_ckpt
    for d in digests[f"load_{name}"]:
        assert d["rows_equal"] and d["rows"] == SHARD_N // 4
    want = _leaves(jckpt.load(str(tmp / f"jax_{name}.npz")))
    _assert_same({k: v for k, v in want.items() if v is not None}, arrays[f"load_{name}"],
                 f"load {name}")


def test_sharded_save_writes_the_jax_schema(sharded_ckpt):
    """``save(mesh=)``: the ranks' rows gathered, rank 0 writes one archive
    the JAX package loads, equal to the port's dense run."""
    tmp, _, _ = sharded_ckpt
    want = tstate.state_to_numpy(_port_run(SHARD_N, SHARD_TICKS, seed=6))
    got = _leaves(jckpt.load(str(tmp / "saved.npz")))
    _assert_same({k: v for k, v in want.items() if v is not None},
                 {k: v for k, v in got.items() if v is not None}, "sharded save")


def test_save_async_at_four_ranks_loads_at_two(sharded_ckpt):
    """A DCP save of the ranks' rows at R = 4 loads back at R = 2 through
    ``load_orbax(mesh=)`` (a ``meta`` template), bit-equal: DCP reshards."""
    _, digests, arrays = sharded_ckpt
    assert all(d["rows"] == SHARD_N // 2 for d in digests["load_dcp"])
    _assert_same(arrays["save_async"], arrays["load_dcp"], "dcp 4 -> 2")
    want = tstate.state_to_numpy(_port_run(SHARD_N, SHARD_TICKS, seed=6))
    _assert_same({k: v for k, v in want.items() if v is not None}, arrays["load_dcp"],
                 "dcp vs dense")


def test_save_async_without_a_mesh_round_trips(tmp_path):
    """One process, no group: ``save_async`` / ``load_orbax`` of a whole
    state round-trip every leaf in its own dtype."""
    import torch.distributed as dist

    st = _port_run(16, 3, seed=1, timer_dtype=torch.int16)
    checkpoint.save_async(tmp_path / "dcp", st).wait_until_finished()
    back = checkpoint.load_orbax(tmp_path / "dcp", tstate.init_state(
        16, device="meta", timer_dtype=torch.int16), device=CPU)
    _assert_same(tstate.state_to_numpy(st), tstate.state_to_numpy(back), "dcp no mesh")
    assert not dist.is_initialized()
