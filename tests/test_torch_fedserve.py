"""The port's federation (ring, router, fedload) against the JAX package's.

Placement is pure host logic, so the port's ring and router placement are
held equal to the JAX package's on the same keys and loads; the failover
plan is held to what the JAX journal fold says of the same journal; and the
port's router runs end to end on the CPU in front of two port servers (a
kill, failover, adoption, results equal to standalone runs), with
``fedload --dryrun``. No JAX server or router is started: both hang in
``close`` on Python 3.12 (their listener is awaited before their
connections end). Every test that opens a socket bounds itself with
``asyncio.wait_for``.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from kaboodle_tpu.serve.federation import ring as jring
from kaboodle_tpu.serve.federation import router as jrouter
from kaboodle_tpu.serve.journal import replay_journal as jreplay
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
from kaboodle_tpu_torch.serve.federation import fedload
from kaboodle_tpu_torch.serve.federation import ring as tring
from kaboodle_tpu_torch.serve.federation import router as trouter
from kaboodle_tpu_torch.serve.journal import replay_journal as treplay
from kaboodle_tpu_torch.serve.pool import LanePool

CPU = "cpu"
CFG = SwimConfig(deterministic=True)
TIMEOUT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- ring and placement --------------------------------------------------------


def test_stable_hash_and_preference_equal_jax():
    """1,000 keys over a member set that grows, loses members and regains
    them: every hash, ``place`` and full ``preference`` walk equal."""
    keys = [f"t{i % 3}:{16 << (i % 3)}:{i}" for i in range(1000)]
    assert [tring.stable_hash(k) for k in keys] == [jring.stable_hash(k) for k in keys]
    rings = {"jax": jring.HashRing(vnodes=16), "torch": tring.HashRing(vnodes=16)}
    steps = [("add", f"e{i}") for i in range(5)] + [("remove", "e2"), ("remove", "e0"),
                                                    ("add", "e2"), ("add", "e9")]
    for op, member in steps:
        views = {}
        for side, ring in rings.items():
            getattr(ring, op)(member)
            views[side] = (ring.size, [ring.preference(k) for k in keys],
                           [ring.place(k) for k in keys])
        assert views["torch"] == views["jax"], (op, member)


def _placement_router(mod):
    """``tests/test_fedserve.py::_placement_router`` for either package."""
    r = mod.FedRouter([mod.EngineMember("e0", "h", 1), mod.EngineMember("e1", "h", 2),
                       mod.EngineMember("e2", "h", 3)])
    for mid in ("e0", "e1", "e2"):
        r.ring.add(mid)
        r.alive.add(mid)
        r._inflight[mid] = 0
    r._classes = {"e0": {16, 32}, "e1": {16}, "e2": {16}}
    return r


def test_place_equal_jax_under_load():
    """The class filter and the load-slack overflow of
    ``tests/test_fedserve.py``'s placement tests, on random loads."""
    routers = {"jax": _placement_router(jrouter), "torch": _placement_router(trouter)}
    rng = np.random.default_rng(5)
    for trial in range(40):
        load = {m: int(rng.integers(0, 8)) for m in ("e0", "e1", "e2")}
        picks = {}
        for side, r in routers.items():
            r._inflight.update(load)
            picks[side] = [r._place(f"t{i % 2}:{n}:{i}", n)
                           for i in range(25) for n in (16, 32)]
        assert picks["torch"] == picks["jax"], (trial, load)
        assert all(p == "e0" for p in picks["torch"][1::2])  # only e0 serves 32
    for side, r in routers.items():
        with pytest.raises(ValueError, match="N-class 64"):
            r._place("default:64:0", 64)
    assert (trouter._lane_n_class(1000), trouter._lane_n_class(3)) == (1024, 8)


def test_parse_members_equal_jax():
    spec = "e0=127.0.0.1:7501, e1=localhost:7502,,e2=::1:7503"
    assert ([tuple(vars(m).values()) for m in trouter.parse_members(spec)]
            == [tuple(vars(m).values()) for m in jrouter.parse_members(spec)])
    for bad in ("e0", "e0=host", "=h:1"):
        with pytest.raises(ValueError, match="want id=host:port"):
            trouter.parse_members(bad)


# -- the failover plan ---------------------------------------------------------


def _dead_engine_journal(root) -> tuple[str, dict]:
    """A port engine ``e1`` left for dead with one request of each fate:
    harvested, spilled, cancelled and still running. Returns its journal
    directory and ``{fate: rid}``."""
    engine = ServeEngine([LanePool(16, 2, cfg=CFG, chunk=8, device=CPU)], warp=False,
                         spill_after=0, spill_dir=str(root / "spill"),
                         journal_dir=str(root / "journal"), engine_id="e1")
    engine.warmup()
    rids = {"spilled": engine.submit(ServeRequest(n=16, seed=13, mode="ticks", ticks=8,
                                                  scenario="steady", keep=True)),
            "harvested": engine.submit(ServeRequest(n=16, seed=2, mode="converge", ticks=40))}
    for _ in range(400):
        engine.step()
        if (engine.status(rids["spilled"])["state"] == "spilled"
                and engine.status(rids["harvested"])["state"] == "done"):
            break
    engine.settle_spills()  # the spill is journaled once it is durable
    assert engine.status(rids["spilled"])["state"] == "spilled"
    rids["cancelled"] = engine.submit(ServeRequest(n=16, seed=3, mode="ticks", ticks=800))
    assert engine.cancel(rids["cancelled"])
    rids["running"] = engine.submit(ServeRequest(n=16, seed=5, mode="ticks", ticks=800,
                                                 scenario="steady"))
    engine.step()
    return str(root / "journal" / "e1"), rids  # no close(): the engine died


def test_failover_plan_equals_jax_fold(tmp_path):
    """Each dead route is served from the fold, adopted or re-submitted,
    exactly as the JAX package's fold of the same journal says it should
    be; the port's own fold equals the JAX fold."""
    jdir, rids = _dead_engine_journal(tmp_path)
    table, next_rid = treplay(jdir)
    assert (table, next_rid) == jreplay(jdir)

    r = _placement_router(trouter)
    r.journal_root = str(tmp_path / "journal")
    forwarded = []

    async def member_rpc(mid, **op):
        rid = 100 + len(forwarded)
        forwarded.append((rid, op["op"]))
        return {"ok": True, "request_id": rid}

    r._member_rpc = member_rpc
    r.members["e1"] = trouter.EngineMember("e1", "h", 2)
    for fate, member_rid in rids.items():
        r._routes[member_rid] = {
            "member": "e1", "member_rid": member_rid, "fields": {"n": 16, "seed": 0},
            "key": f"default:16:{member_rid}", "n_class": 16, "cached": None, "open": True}
        r._inflight["e1"] += 1

    asyncio.run(asyncio.wait_for(r._fail_member("e1"), TIMEOUT_S))
    want = {}
    for fate, member_rid in rids.items():
        jrow = jreplay(jdir)[0][member_rid]  # the JAX fold decides the disposition
        if jrow["op"] in ("cancelled", "shed"):
            want[fate] = "cancelled"
        elif jrow.get("spill_path") and os.path.exists(jrow["spill_path"]):
            want[fate] = "adopt"
        elif jrow.get("result") is not None:
            want[fate] = "done"
        else:
            want[fate] = "submit"
    ops = dict(forwarded)
    got = {}
    for fate, member_rid in rids.items():
        route = r._routes[member_rid]
        got[fate] = (route["cached"]["state"] if route["member"] == "e1"
                     else ops[route["member_rid"]])
    assert got == want
    assert want == {"spilled": "adopt", "harvested": "done", "cancelled": "cancelled",
                    "running": "submit"}
    assert r._routes[rids["harvested"]]["cached"]["result"] == table[rids["harvested"]]["result"]
    assert "e1" not in r.alive and r._inflight["e1"] == 0


# -- end to end on the CPU -----------------------------------------------------


def test_federation_end_to_end_with_kill(tmp_path):
    """``chip_smoke.py``'s federation exercise at classes 16/32 on the CPU:
    two port servers (e0: 16 and 32, e1: 16) behind the port's router, the
    open-loop level with churn, then e1 killed mid-round. No lost
    terminal, no request completed twice in a journal, the request spilled
    on e1 adopted by e0 and resumed equal to its standalone run, sampled
    results equal to standalone runs, nothing built."""
    import chip_smoke

    res = asyncio.run(asyncio.wait_for(
        chip_smoke.fed_exercise(tmp_path, CPU, (16, 32), ((4, 2), (4,))), TIMEOUT_S))
    assert res["compiles"] == 0
    assert res["chaos"]["lost_terminals"] == 0 and res["chaos"]["failovers"] == 1
    for eid, recs in res["journals"].items():
        twice = {rid: hr for rid, hr in chip_smoke.journal_completions(recs).items()
                 if hr[0] > 1 + hr[1]}
        assert not twice, (eid, twice)
    kept = res["adopted"]
    assert kept["engine"] == "e0"
    want, _ = chip_smoke.standalone_want(CFG, 16, kept["seed"], "ticks", 10, device=CPU)
    assert chip_smoke.result_matches(kept["result"], want, "ticks")
    for i in chip_smoke.FED_SAMPLES:
        fields = fedload._mix_fields(i)
        n = fedload._class_of(i)
        want, _ = chip_smoke.standalone_want(CFG, n, fields["seed"], fields["mode"],
                                             fields["ticks"], device=CPU)
        assert chip_smoke.result_matches(res["rows"][i]["result"], want, fields["mode"]), i


def test_fedload_dryrun_on_cpu():
    """``fedload --dryrun --device cpu``: the driver's own CI sizes and
    asserts (the checks ``main`` makes of a dryrun, made here)."""
    args = fedload.parse_args(["--dryrun", "--device", CPU])
    report = asyncio.run(asyncio.wait_for(fedload._run(args), TIMEOUT_S))
    assert report["compiles_steady"] == 0 and report["sharded_pool"] is False
    assert report["chaos"]["lost_terminals"] == 0 and report["chaos"]["failovers"] == 1
    assert list(report["levels"]) == ["2x"]


def test_router_close_returns_with_a_client_connection_open():
    """The router ends its client and member connections before it waits
    for its listener, so ``close()`` returns while a client still holds a
    connection open (the JAX router's order waits on it for ever)."""
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.server import ServeServer

    async def go():
        engine = ServeEngine([LanePool(16, 2, cfg=CFG, chunk=8, device=CPU)])
        server = ServeServer(engine, port=0)
        engine.warmup()
        await server.start()
        router = trouter.FedRouter([trouter.EngineMember("e0", "127.0.0.1", server.port)])
        await router.start()
        client = await ServeClient.connect(port=router.port)
        rid = await client.submit(16, seed=1)
        assert (await client.wait(rid))["state"] == "done"
        await asyncio.wait_for(router.close(), 10)  # the client is still connected
        await client.close()
        await server.close()

    asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
