"""fed-load: the federation proof-under-fire driver.

The port of ``kaboodle_tpu/serve/federation/fedload.py``. Builds a real
two-engine federation in one process — two
:class:`~kaboodle_tpu_torch.serve.server.ServeServer` engines on loopback
sharing one spill root and one journal root (namespaced per engine-id),
one :class:`~kaboodle_tpu_torch.serve.federation.router.FedRouter` in
front — and drives it three ways, all inside the compile counter
(``analysis/ir/surface.py``: programs built):

- **SLO levels**: open-loop waves of mixed N-classes (16 and 32) at
  multiples of a base open-loop rate, with park/resume churn riding along
  (every 8th request is kept, then resumed and cancelled after its first
  harvest). Each level reports per-N-class latency percentiles — the
  federated SLO curves.
- **chaos**: a mixed batch including kept-and-spilled requests, then
  ``ServeServer.kill()`` on one engine mid-round (listener gone,
  connections RST, round loop cancelled — the engine object is NOT
  closed, exactly a crash). Every outstanding ``wait`` must resolve
  through the router's WAL failover with exactly one result per request,
  and a request that had spilled on the dead engine must restore+resume
  on the survivor (checkpoint adoption across the owner stamp).
- **the gate**: ``compiles_steady == 0`` across all of it — placement,
  failover, adoption and churn ride the programs built at warmup.

    python -m kaboodle_tpu_torch.serve.federation.fedload --dryrun --device cpu

Engine e0's N=32 pool is a :class:`~kaboodle_tpu_torch.serve.shardpool.
ShardedLanePool` on a ``world/2 x 2`` device mesh (2 x 2 at 4 ranks) when
the driver runs as rank 0 of a ``torch.distributed`` job of 4 or more
ranks (an even number), so the sharded pool serves real federated traffic
under the same build gate; the other ranks build the same pool and follow
its calls (``shardpool.follow``). Launched by ``torchrun``::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m kaboodle_tpu_torch.serve.federation.fedload --dryrun --device cpu

The chaos adoption moves a spill file written by the dead engine into the
survivor, so checkpoints are engine-portable: a spill file holds the same
bytes whichever pool wrote it. Only ONE engine gets a sharded pool: both
engines share the event loop thread, which keeps every collective call in
one order. A single process, or ``--no-shard``, builds plain pools and
reports ``"sharded_pool": false``. The pools run on the card unless
``--device`` names another.

``--dryrun`` is the same machinery at toy sizes with hard asserts.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time

from kaboodle_tpu_torch.serve.loadgen import _latency_stats, _mix_fields

_WAIT_S = 60.0


CLASSES = (16, 32)  # the level mix's (small, big) N-classes


def _class_of(i: int, classes=CLASSES) -> int:
    """The level mix: every 4th request is the big class."""
    return classes[1] if i % 4 == 3 else classes[0]


def _world() -> int:
    """Ranks of the ``torch.distributed`` job this process is in (1 with none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _sharded_pool(lanes: int, chunk: int, device=None):
    """e0's big class pool over every rank: a ``world/2 x 2`` fleet mesh
    (each lane's rows split over two ranks). Every rank builds it, in the
    same order."""
    from kaboodle_tpu_torch.fleet.sharding import make_fleet_mesh
    from kaboodle_tpu_torch.serve.shardpool import ShardedLanePool

    world = _world()
    return ShardedLanePool(CLASSES[1], lanes, chunk=chunk,
                           device_mesh=make_fleet_mesh(world // 2, 2, device=device))


def _build_engines(scratch: str, lanes: int, chunk: int, device=None, shard: bool = True):
    """Two engines on one shared spill/journal root, each with a 16 and a
    32 pool. e0's 32 pool is sharded when the job has 4 or more ranks
    (``shard``); e1 is all single-device -- adoption across the two proves
    the spill format is placement-agnostic."""
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.pool import LanePool

    spill_root = os.path.join(scratch, "spill")
    journal_root = os.path.join(scratch, "journal")
    sharded = shard and _world() >= 4
    engines = []
    for eid in ("e0", "e1"):
        pools = [LanePool(CLASSES[0], lanes, chunk=chunk, device=device)]
        if eid == "e0" and sharded:
            pools.append(_sharded_pool(lanes, chunk, device=device))
        else:
            pools.append(LanePool(CLASSES[1], lanes, chunk=chunk, device=device))
        engines.append(ServeEngine(
            pools, warp=True, max_leap=64, spill_after=2,
            spill_dir=spill_root, journal_dir=journal_root,
            engine_id=eid,
        ))
    return engines, spill_root, journal_root, sharded


async def _open_level(client_factory, submit_client, requests: int,
                      rate: float, classes=CLASSES, rows: dict | None = None):
    """One open-loop federated level: scheduled submits on the shared
    router connection, each completion waited on its own connection;
    every 8th request exercises the park -> resume -> cancel churn.
    ``rows``, if given, receives each request's first terminal row under
    its mix index."""
    lat: dict[int, list] = {n: [] for n in classes}
    waiters: list[asyncio.Task] = []

    async def complete(i: int, rid: int, t0: float) -> None:
        from kaboodle_tpu_torch.serve.client import ServeError

        c = await client_factory()
        try:
            row = await c.wait(rid)
            lat[_class_of(i, classes)].append(time.perf_counter() - t0)
            if rows is not None:
                rows[i] = row
            if i % 8 == 0:  # churn: the kept lane parks after harvest
                # The lane may already have idled out and spilled (or be
                # mid-spill) by the time the resume lands — that IS the
                # churn: restore and retry until the resume sticks.
                for _ in range(200):
                    try:
                        await c.resume(rid, mode="ticks", ticks=4)
                        break
                    except ServeError:
                        try:
                            await c.restore(rid)
                        except ServeError:
                            await asyncio.sleep(0.02)
                else:
                    raise RuntimeError(f"resume never stuck for {rid}")
                await c.wait(rid)
                await c.cancel(rid)  # release the lane
        finally:
            await c.close()

    start = time.perf_counter()
    for i in range(requests):
        delay = start + i / rate - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        fields = _mix_fields(i)
        fields["keep"] = i % 8 == 0
        t0 = time.perf_counter()
        rid = await submit_client.submit(_class_of(i, classes), **fields)
        waiters.append(asyncio.create_task(complete(i, rid, t0)))
    await asyncio.wait_for(asyncio.gather(*waiters), _WAIT_S)
    elapsed = time.perf_counter() - start
    return lat, elapsed


async def _submit_on(client, router_client_factory, target: str, n: int,
                     max_tries: int, **fields) -> int | None:
    """Submit requests until one PLACES on ``target`` (placement is a
    deterministic hash of tenant:class:seed, so varying the seed walks
    the ring). Returns its router rid, or None after ``max_tries``."""
    base_seed = int(fields.pop("seed", 0))
    for t in range(max_tries):
        rid = await client.submit(n, seed=base_seed + 1000 * t, **fields)
        c = await router_client_factory()
        try:
            row = await c.status(rid)
        finally:
            await c.close()
        if row and row.get("engine") == target:
            return rid
        await client.cancel(rid)
    return None


async def _chaos(client_factory, server_kill, victim: str, n: int = 16,
                 adopted: dict | None = None) -> dict:
    """Kill one engine under load and account for every request.

    Pre-kill state staged on the victim: one request harvested, parked
    and SPILLED (the adoption path), plus long ticks-mode runs still
    RUNNING (the re-queue path). Requests on the survivor ride along as
    the control group. After ``kill()``, every wait must resolve exactly
    once, and the spilled request must restore+resume on the survivor.
    Every request is of class ``n``; ``adopted``, if given, is updated
    with the spilled request's resumed row (its seed and result)."""
    client = await client_factory()
    outcomes: dict[int, dict] = {}

    # 1. A kept request on the victim, run to harvest, then spilled.
    kept_rid = await _submit_on(
        client, client_factory, victim, n, 40,
        mode="ticks", ticks=6, scenario="steady", keep=True,
    )
    assert kept_rid is not None, f"no kept request placed on {victim}"
    await client.wait(kept_rid)
    deadline = time.perf_counter() + _WAIT_S
    while True:
        row = await client.status(kept_rid)
        if row["state"] == "spilled":
            break
        assert time.perf_counter() < deadline, \
            f"kept request never spilled: {row}"
        await asyncio.sleep(0.05)

    # 2. Long runners: some pinned to the victim (they will die mid-run
    # and re-queue from seed), the rest landing wherever the ring says.
    run_rids: list[int] = []
    for k in range(2):
        rid = await _submit_on(
            client, client_factory, victim, n, 40, seed=50 + k,
            mode="ticks", ticks=160, scenario="steady",
        )
        assert rid is not None, f"no runner placed on {victim}"
        run_rids.append(rid)
    for k in range(6):
        fields = _mix_fields(k)
        fields["seed"] = 200 + k
        run_rids.append(await client.submit(n, **fields))

    async def complete(rid: int) -> None:
        c = await client_factory()
        try:
            row = await c.wait(rid)
            outcomes[rid] = row
        finally:
            await c.close()

    waiters = [asyncio.create_task(complete(rid)) for rid in run_rids]
    await asyncio.sleep(0.1)  # let the victim's lanes start ticking
    await server_kill()
    await asyncio.wait_for(asyncio.gather(*waiters), _WAIT_S)

    # Zero lost terminals, exactly one resolution per request.
    assert len(outcomes) == len(run_rids), (len(outcomes), len(run_rids))
    assert len(set(run_rids)) == len(run_rids)
    for rid in run_rids:
        row = outcomes[rid]
        assert row.get("result") is not None or row["state"] == "done", row
    # The spilled request adopts onto the survivor and keeps working.
    await client.restore(kept_rid)
    await client.resume(kept_rid, mode="ticks", ticks=4)
    resumed = await asyncio.wait_for(client.wait(kept_rid), _WAIT_S)
    assert resumed.get("result") is not None, resumed
    assert resumed.get("engine") != victim, resumed
    if adopted is not None:
        adopted.update(resumed)
    await client.cancel(kept_rid)

    metrics = await client.metrics()
    failovers = sum(
        metrics["counters"].get("fed_failovers_total", {}).values()
    )
    moves = sum(
        metrics["counters"].get("fed_rebalance_moves_total", {}).values()
    )
    assert failovers == 1, metrics["counters"]
    assert moves >= 1, metrics["counters"]
    await client.close()
    return {
        "killed": victim,
        "requests": len(run_rids) + 1,
        "resolved": len(outcomes) + 1,
        "lost_terminals": 0,
        "failovers": int(failovers),
        "rebalance_moves": int(moves),
        "adopted_resume_engine": resumed.get("engine"),
    }


async def _run(args) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import assert_counter_live

    assert_counter_live()
    scratch = tempfile.mkdtemp(prefix="kaboodle-fed-")
    engines, spill_root, journal_root, sharded = _build_engines(
        scratch, args.lanes, args.chunk, device=args.device, shard=not args.no_shard
    )
    try:
        return await _serve_and_measure(args, engines, spill_root, journal_root, sharded)
    except BaseException as e:
        for eng in engines:  # a sharded pool's followers end with the error
            for pool in eng.pools.values():
                pool.close(error=repr(e))
        raise


async def _serve_and_measure(args, engines, spill_root, journal_root, sharded) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.federation.router import EngineMember, FedRouter
    from kaboodle_tpu_torch.serve.server import ServeServer

    t0 = time.perf_counter()
    for eng in engines:
        eng.warmup()
    warmup_s = time.perf_counter() - t0

    servers = [ServeServer(eng, port=0) for eng in engines]
    for srv in servers:
        await srv.start()
    router = FedRouter(
        [EngineMember(eng.engine_id, "127.0.0.1", srv.port)
         for eng, srv in zip(engines, servers)],
        journal_root=journal_root, spill_root=spill_root, port=0,
    )
    await router.start()

    async def client_factory():
        return await ServeClient.connect(port=router.port)

    # Warm wave through the router (uncounted): both classes, spread
    # seeds so both engines see wire traffic before measurement.
    warm = await client_factory()
    for i in range(4 * args.lanes):
        rid = await warm.submit(_class_of(i), **_mix_fields(i))
        await warm.wait(rid)
    await warm.close()

    levels: dict[str, dict] = {}
    with compile_counter() as box:
        submit_client = await client_factory()
        for mult in args.levels:
            rate = args.base_rate * mult
            requests = max(args.requests, int(rate * args.level_seconds))
            lat, elapsed = await _open_level(
                client_factory, submit_client, requests, rate
            )
            done = sum(len(v) for v in lat.values())
            levels[f"{mult:g}x"] = {
                "offered_rps": round(rate, 2),
                "requests": requests,
                "elapsed_s": round(elapsed, 3),
                "achieved_rps": round(done / elapsed, 2),
                "latency_by_class": {
                    str(n): _latency_stats(v) for n, v in lat.items() if v
                },
            }
        await submit_client.close()
        chaos = await _chaos(client_factory, servers[1].kill,
                             engines[1].engine_id)
    compiles = box.count

    probe = await client_factory()
    stats = await probe.stats()
    metrics = await probe.metrics()
    await probe.shutdown()
    await probe.close()
    await router.close()
    await servers[0].close()  # closes engine e0
    engines[1].close()  # e1's server was killed, not closed

    return {
        "bench": "fedserve",
        "members": len(engines),
        "sharded_pool": sharded,
        "lanes": args.lanes,
        "chunk": args.chunk,
        "base_rate_rps": args.base_rate,
        "warmup_s": round(warmup_s, 3),
        "compiles_steady": compiles,
        "levels": levels,
        "chaos": chaos,
        "router": {
            "alive": stats["alive"],
            "routes": stats["routes"],
            "submits": metrics["counters"].get("fed_submits_total", {}),
            "ring_size": metrics["gauges"].get("fed_ring_size", {}),
        },
    }


def parse_args(argv=None):
    """The driver's command line; ``--dryrun`` sets the CI sizes."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kaboodle_tpu_torch.serve.federation.fedload",
        description="two-engine federation load driver with kill-one-"
                    "engine chaos",
    )
    parser.add_argument("--lanes", type=int, default=8, help="lanes per pool")
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--requests", type=int, default=48,
                        help="minimum measured requests per level")
    parser.add_argument("--base-rate", type=float, default=50.0,
                        help="1x offered req/s (the single-engine "
                             "open-loop baseline rate)")
    parser.add_argument("--levels", default="2,5,10",
                        help="comma-separated offered-load multiples")
    parser.add_argument("--level-seconds", type=float, default=1.0,
                        help="minimum offered-schedule length per level")
    parser.add_argument("--no-shard", action="store_true",
                        help="plain pools everywhere (skip the sharded "
                             "pool of a job of 4 or more ranks)")
    parser.add_argument("--device", default=None,
                        help="torch device of the pools (default: the card; "
                             "'cpu' runs the plain path on the host)")
    parser.add_argument("--dryrun", action="store_true",
                        help="CI sizes: tiny levels, full chaos asserts, "
                             "one-line JSON tail, no report file")
    parser.add_argument("--out", default="torch_fedserve.json")
    args = parser.parse_args(argv)
    if args.dryrun:
        args.levels = [2.0]
        args.requests = 24
        args.level_seconds = 0.0
    else:
        args.levels = [float(tok) for tok in args.levels.split(",")]
    return args


def _join_job(args) -> int:
    """Join the ``torch.distributed`` job ``torchrun`` describes (its
    environment), if any; returns the world size."""
    import torch.distributed as dist

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from kaboodle_tpu_torch.parallel.mesh import make_mesh

        make_mesh(device=args.device)
    world = _world()
    if not args.no_shard and world >= 4 and world % 2:
        raise ValueError(f"the sharded pool's world/2 x 2 mesh needs an even world, not {world}")
    return world


def main(argv=None) -> int:
    """``python -m kaboodle_tpu_torch.serve.federation.fedload`` —
    federated load + chaos (rank 0 drives; the other ranks of a sharded
    job follow e0's sharded pool)."""
    import torch.distributed as dist

    args = parse_args(argv)
    if _join_job(args) > 1 and dist.get_rank() != 0:
        if args.no_shard or _world() < 4:
            return 0  # nothing to follow: rank 0 runs plain pools
        from kaboodle_tpu_torch.serve.shardpool import follow

        calls = follow(_sharded_pool(args.lanes, args.chunk, device=args.device))
        print(json.dumps({"fedload_follower": dist.get_rank(), "calls": calls}))
        return 0
    report = asyncio.run(_run(args))
    if args.dryrun:
        assert report["compiles_steady"] == 0, report["compiles_steady"]
        assert report["chaos"]["lost_terminals"] == 0
        assert report["chaos"]["failovers"] == 1
        print(json.dumps({
            "fedserve_dryrun": "ok",
            "sharded_pool": report["sharded_pool"],
            "levels": list(report["levels"]),
            "chaos": report["chaos"],
            "compiles_steady": report["compiles_steady"],
        }))
        return 0
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report))
    if report["compiles_steady"] != 0:
        print(f"FAIL: {report['compiles_steady']} programs built in the "
              "steady phase (zero-rebuild gate)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
