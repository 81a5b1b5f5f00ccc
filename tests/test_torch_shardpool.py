"""The port's sharded lane pool on R gloo ranks against its lane pool and JAX's two pools.

Every multi-rank case runs in ``kaboodle_tpu_torch.parallel.worker`` ranks
(R processes in one gloo group, rank 0 serving, the others following its
pool calls), started once for the module, all jobs at once, by a module
fixture. The schedule is the JAX package's sharded-pool parity schedule
(tests/test_fedserve.py: N = 16, 4 lanes, chunk 4, three admissions, six
steps) plus a refused admission, a fourth admission and one leap round with
the serve engine's ``k_m``, on a plain and on a telemetry pool, at R = 2
(a 1-D ensemble mesh) and R = 4 (a 2 x 2 ``E x peers`` mesh). The test
process meanwhile runs the same schedule through the port's ``LanePool``,
JAX's ``LanePool`` and JAX's ``ShardedLanePool`` on ``make_fleet_mesh(2,
2)`` over 4 of the conftest's 8 virtual CPU devices. Every member leaf and
run vector must be equal bit for bit (``latency`` with NaNs in place).
Every job has a hard deadline (``start_workers``), so no test can hang.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.fleet.sharding import make_fleet_mesh as jax_fleet_mesh
from kaboodle_tpu.serve.pool import LanePool as JaxLanePool
from kaboodle_tpu.serve.shardpool import ShardedLanePool as JaxShardedLanePool
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel.worker import pool_arrays, pool_script, start_workers
from kaboodle_tpu_torch.serve.pool import LanePool
from kaboodle_tpu_torch.warp.runner import MIN_LEAP

CPU = "cpu"
N, LANES, CHUNK = 16, 4, 4
DET = dict(deterministic=True)
OPS = ([["admit", 0, 0, True, 16, "boot"], ["admit", 1, 1, False, 16, "steady"],
        ["admit", 2, 2, True, 16, "boot"], ["refused", 1]]
       + [["step"]] * 6
       + [["admit", 3, 3, False, 80, "steady"], ["leap"], ["step"], ["step"]])
# name: (R, peer_devices, telemetry)
POOLS = {"r2_plain": (2, 1, False), "r2_telemetry": (2, 1, True),
         "r4_plain": (4, 2, False), "r4_telemetry": (4, 2, True)}
# Public pool calls the leader announces for OPS and pool_arrays: 4 admits,
# the refused one, 8 steps, signature + leap + advance_leaped, 4 member
# gathers.
CALLS = 4 + 1 + 8 + 3 + LANES


def _pool_case(name, tmp):
    r, pd, tel = POOLS[name]
    return dict(name=name, kind="shardpool", n=N, lanes=LANES, chunk=CHUNK, cfg=DET, ops=OPS,
                peer_devices=pd, telemetry=tel, out=str(tmp / f"{name}.npz"))


def _specs(tmp):
    r2 = [_pool_case(k, tmp) for k in POOLS if POOLS[k][0] == 2]
    r4 = [_pool_case(k, tmp) for k in POOLS if POOLS[k][0] == 4]
    r4 += [dict(name="r4_spill", kind="shardpool_spill", n=N, lanes=LANES, chunk=CHUNK,
                cfg=DET, peer_devices=2, dir=str(tmp)),
           dict(name="r4_fedload", kind="fedload", argv=["--dryrun"]),
           dict(name="r4_fedload_no_shard", kind="fedload", argv=["--dryrun", "--no-shard"])]
    # Rank 0 fails after the schedule: its followers must end with its error.
    failing = [{**_pool_case("r2_plain", tmp), "name": "r2_leader_fails",
                "out": None, "fail": "injected failure on the leading rank"}]
    return {"r2": (2, r2), "r4": (4, r4), "r2_fail": (2, failing)}


def _jax_pool(sharded: bool, telemetry: bool):
    kw = dict(n=N, lanes=LANES, cfg=JaxSwimConfig(**DET), chunk=CHUNK, telemetry=telemetry)
    if sharded:
        return JaxShardedLanePool(device_mesh=jax_fleet_mesh(2, 2), **kw)
    return JaxLanePool(**kw)


def _run_ref(pool):
    rounds = pool_script(pool, OPS)
    arrays = pool_arrays(pool, range(LANES))
    arrays["k_m"] = np.asarray(rounds, dtype=np.int32).reshape(len(rounds), -1)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job at once; the three references in this process meanwhile."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    tmp = tmp_path_factory.mktemp("shardpool")
    jobs = {}
    for key, (r, cases) in _specs(tmp).items():
        jobs[key] = start_workers(r, {"device": CPU, "timeout_s": 60, "cases": cases},
                                  str(tmp / f"{key}.json"), timeout_s=170)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = {}
        for tel in (False, True):
            ref[("port", tel)] = _run_ref(LanePool(N, LANES, cfg=SwimConfig(**DET), chunk=CHUNK,
                                                   telemetry=tel, device=CPU))
            ref[("jax", tel)] = _run_ref(_jax_pool(False, tel))
            ref[("jax_sharded", tel)] = _run_ref(_jax_pool(True, tel))
    finally:
        torch.set_num_threads(threads)
    digests = {}
    for key in ("r2", "r4"):
        digests.update(jobs[key].wait())
    try:
        jobs["r2_fail"].wait()
        failed = None
    except RuntimeError as e:
        failed = str(e)
    got = {}
    for name in POOLS:
        with np.load(tmp / f"{name}.npz") as z:
            got[name] = {k: z[k] for k in z.files}
    return dict(got=got, ref=ref, digests=digests, failed=failed)


def _assert_equal(want: dict, got: dict, where: str) -> None:
    assert set(want) == set(got), (where, sorted(set(want) ^ set(got)))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{where}: {k} {g.shape} {w.shape}"
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            g, w = np.nan_to_num(g), np.nan_to_num(w)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"{where}: {k}")


@pytest.mark.parametrize("name", list(POOLS))
def test_sharded_pool_equals_the_ports_lane_pool(runs, name):
    _assert_equal(runs["ref"][("port", POOLS[name][2])], runs["got"][name], name)


@pytest.mark.parametrize("name", list(POOLS))
def test_sharded_pool_equals_jax_lane_pool(runs, name):
    _assert_equal(runs["ref"][("jax", POOLS[name][2])], runs["got"][name], name)


@pytest.mark.parametrize("name", list(POOLS))
def test_sharded_pool_equals_jax_sharded_pool(runs, name):
    _assert_equal(runs["ref"][("jax_sharded", POOLS[name][2])], runs["got"][name], name)


def test_schedule_leaps_and_counts():
    """The schedule's leap round leaps a horizon lane a whole bucket, and
    its telemetry pool counts protocol events (so the parity above holds
    the counters to something)."""
    pool = LanePool(N, LANES, cfg=SwimConfig(**DET), chunk=CHUNK, telemetry=True, device=CPU)
    rounds = pool_script(pool, OPS)
    assert len(rounds) == 1 and max(rounds[0]) >= MIN_LEAP and rounds[0][:3] == [0, 0, 0]
    assert pool.counter_totals["pings_sent"].sum() > 0
    assert pool.ticks_run[3] > max(rounds[0])  # dense ticks after the leap too


@pytest.mark.parametrize("name", list(POOLS))
def test_every_rank_followed_every_call(runs, name):
    r, pd, _ = POOLS[name]
    rows = runs["digests"][name]
    assert len(rows) == r
    want = {"ensemble": r // pd, **({"peers": pd} if pd > 1 else {})}
    assert rows[0]["device_mesh"] == want
    assert [row["followed"] for row in rows[1:]] == [CALLS] * (r - 1)


def test_spill_cycle_builds_nothing_after_warmup(runs):
    """JAX's zero-recompile cycle on the 2 x 2 mesh: submit, drain, park,
    spill, restore, resume; no program built after warmup. Each spill file
    the sharded pool wrote loads into a single-device pool equal to the
    sharded pool's member restored from it."""
    row = runs["digests"]["r4_spill"][0]
    assert row["fresh"] == 0
    assert row["device_mesh"] == {"ensemble": 2, "peers": 2}
    assert row["spilled"] == ["spilled"] * 3
    assert row["plain_equal"] == [True] * 3
    assert all(r["followed"] > 0 for r in runs["digests"]["r4_spill"][1:])


def test_fedload_sharded_arm_on_four_ranks(runs):
    rows = runs["digests"]["r4_fedload"]
    line = rows[0]["line"]
    assert rows[0]["rc"] == 0 and line["fedserve_dryrun"] == "ok"
    assert line["sharded_pool"] is True and line["compiles_steady"] == 0
    chaos = line["chaos"]
    assert chaos["lost_terminals"] == 0 and chaos["resolved"] == chaos["requests"]
    assert chaos["killed"] == "e1" and chaos["adopted_resume_engine"] == "e0"
    assert all(r["rc"] == 0 and r["line"]["calls"] > 0 for r in rows[1:])


def test_fedload_no_shard_on_four_ranks(runs):
    rows = runs["digests"]["r4_fedload_no_shard"]
    assert rows[0]["line"]["sharded_pool"] is False and rows[0]["line"]["compiles_steady"] == 0
    assert all(r["rc"] == 0 and r["line"] is None for r in rows[1:])


def test_leader_failure_ends_the_followers(runs):
    """Rank 0 raises after the schedule and closes the pool with its error:
    the follower raises it too, and the job ends well inside its deadline."""
    assert runs["failed"] is not None
    assert "rank 0: exit 1" in runs["failed"] and "rank 1: exit 1" in runs["failed"]
    assert "closed the pool with an error" in runs["failed"]
    assert "timed out" not in runs["failed"]


def test_sharded_pool_refuses_bad_layouts_before_any_collective():
    """An ensemble size or a peer size the pool does not divide raises the
    fleet layer's ValueError (``_check_fleet_divisible``)."""
    from kaboodle_tpu_torch.fleet.sharding import _check_fleet_divisible

    class _Mesh:
        mesh_dim_names = ("ensemble", "peers")

        def size(self, i):
            return 2

    with pytest.raises(ValueError, match="E=3"):
        _check_fleet_divisible(3, 16, _Mesh())
    with pytest.raises(ValueError, match="N=15"):
        _check_fleet_divisible(4, 15, _Mesh())


def test_member_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    from kaboodle_tpu_torch.serve.shardpool import member_sharding

    class _Mesh:
        def __init__(self, names):
            self.mesh_dim_names = names

    two_d = member_sharding(_Mesh(("ensemble", "peers")))
    one_d = member_sharding(_Mesh(("ensemble",)))
    assert two_d.state == (Shard(0),) and two_d.tick == (Replicate(),)
    assert all(getattr(one_d, f.name) == (Replicate(),) for f in dataclasses.fields(one_d))
