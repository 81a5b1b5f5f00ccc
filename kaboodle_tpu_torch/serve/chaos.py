"""Deterministic fault injection for the serve stack (the chaos lane).

The port of ``kaboodle_tpu/serve/chaos.py``. ``python -m
kaboodle_tpu_torch.serve.server --chaos-dryrun [--device cpu]`` runs six
scripted failure scenarios against real engines/servers in this process,
each asserting the invariant that makes it worth having:

1. **spill_latency** — the round loop must not stall on spill I/O: with
   large-member spills in flight, per-round latency stays within 10% (+ a
   small absolute timer-noise floor) of a no-spill run, beside the
   synchronous write path the async path replaces. The three arms step in
   turn, round by round (the JAX lane measures them one after another), so
   drift in the host's speed falls on all three alike.
2. **engine_kill** — an engine abandoned mid-service (journal + spill
   files left behind) recovers: completed requests keep their results and
   are never re-run (no duplicate completion in the journal), spilled
   requests re-attach and their restore→resume continuations land
   leaf-for-leaf on an uninterrupted twin engine's states, in-flight
   requests re-queue and complete.
3. **spill_write_failure** — an injected write failure degrades the lane
   back to parked with a loud ``spill_failed`` event (never an exception
   mid-round), the next idle countdown retries and succeeds, and the
   request survives restore+resume. Service to other lanes continues
   throughout.
4. **corrupt_restore** — a truncated spill file turns restore into a
   structured ``CheckpointError`` + ``restore_failed`` event; the request
   stays spilled (retryable), the engine keeps serving new work.
5. **slow_consumer** — a stream subscriber that stops reading loses
   events into a counted ``stream_gap`` record instead of wedging the
   server; ops and other requests are unaffected while it stalls.
6. **submit_flood** — an open-loop burst 10× over capacity against
   admission control: rejections are structured ``queue_full`` errors
   carrying retry-after, higher-priority arrivals shed the lowest queued,
   every admitted request completes within a (generous) SLO, quota'd
   tenants get ``quota`` rejections that a retrying client rides out.

Every device-touching phase runs after warmup under the compile counter
(``analysis/ir/surface.py``: programs built) and asserts that none was
built — chaos must not cost the zero-rebuild contract. All schedules are
fixed-seed deterministic. Each scenario and :func:`run_chaos_dryrun` run
on the card unless ``device`` names another.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time

import numpy as np

from kaboodle_tpu_torch.serve.dryrun import _leaves_equal

CHAOS_SEED = 1207  # fixed: every schedule below derives from constants

_WAIT_S = 60.0


def _percentile_ms(lat_s, q) -> float:
    # Host-list percentile over a few hundred floats, not a device fetch.
    return float(np.percentile(np.asarray(lat_s, dtype=np.float64) * 1e3, q))  # noqa: KB501


# -- 1. spill latency: the async round loop never stalls on disk -----------


def scenario_spill_latency(device=None) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool

    cfg = SwimConfig(deterministic=True)
    rounds = 40

    def setup(sync: bool | None):
        """One arm's engine up to its measurement: a long horizon runner
        plus 3 kept lanes parked, and (unless ``sync`` is None, the
        no-spill baseline) their spill armed so all 3 spill in the first
        measured rounds. Returns ``(engine, runner, kept)``."""
        engine = ServeEngine(
            [LanePool(32, 4, cfg=cfg, chunk=8, device=device)], warp=False,
            sync_spill=bool(sync),
        )
        engine.warmup()
        runner = engine.submit(ServeRequest(
            n=32, seed=1, mode="ticks", ticks=8 * (rounds + 8),
            scenario="steady",
        ))
        kept = [
            engine.submit(ServeRequest(n=32, seed=10 + i, mode="ticks",
                                       ticks=8, scenario="steady",
                                       keep=True))
            for i in range(3)
        ]
        while any(engine.status(r)["state"] != "parked" for r in kept):
            engine.step()
        if sync is not None:
            engine.spill_dir = tempfile.mkdtemp(prefix="kaboodle-chaos-spill-")
            engine.spill_after = 0
        return engine, runner, kept

    # Prime the n=32 program family once, outside the counter: each arm's
    # pool rebuild then re-dispatches the process-cached programs.
    prime = ServeEngine([LanePool(32, 4, cfg=cfg, chunk=8, device=device)],
                        warp=False)
    prime.warmup()
    with compile_counter() as box:
        arms = {sync: setup(sync) for sync in (None, True, False)}
        lat: dict = {sync: [] for sync in arms}
        # The arms step in turn, round by round: a round here is ~10^4
        # small launches from the host, whose speed drifts by more than
        # the gate's 10 % between arms measured one after another, so
        # each arm's rounds must see the same host. A background writer
        # competing for cores is not a stall (below); a step that blocks
        # on I/O still lands in its own arm's round.
        for _ in range(rounds):
            for sync, (engine, _, _) in arms.items():
                t0 = time.perf_counter()
                engine.step()
                lat[sync].append(time.perf_counter() - t0)
        for sync, (engine, runner, kept) in arms.items():
            assert engine.status(runner)["state"] == "running", "runner starved"
            if sync is not None:
                engine.settle_spills()
                for r in kept:
                    assert engine.status(r)["state"] == "spilled", (
                        r, engine.status(r))
            engine.close()
    assert box.count == 0, f"{box.count} fresh compiles during spill arms"
    base, sync_arm, async_arm = lat[None], lat[True], lat[False]

    def _mean_ms(lat_s) -> float:
        return float(np.mean(np.asarray(lat_s, dtype=np.float64)) * 1e3)

    out = {
        "rounds": rounds,
        "no_spill_mean_ms": _mean_ms(base),
        "no_spill_p50_ms": _percentile_ms(base, 50),
        "no_spill_p99_ms": _percentile_ms(base, 99),
        "sync_mean_ms": _mean_ms(sync_arm),
        "sync_p50_ms": _percentile_ms(sync_arm, 50),
        "sync_p99_ms": _percentile_ms(sync_arm, 99),
        "async_mean_ms": _mean_ms(async_arm),
        "async_p50_ms": _percentile_ms(async_arm, 50),
        "async_p99_ms": _percentile_ms(async_arm, 99),
    }
    # The acceptance gate: mean round latency with spills in flight within
    # 10% of the no-spill baseline (+0.5ms absolute floor so micro-round
    # timer noise cannot flake CI). Mean, not p99: over 40 rounds p99 is
    # the max, and a background writer briefly competing for cores is not
    # a round-loop stall — the sync baseline, which DOES stall the loop
    # for every write+fsync, is what this gate separates us from.
    limit = out["no_spill_mean_ms"] * 1.10 + 0.5
    assert out["async_mean_ms"] <= limit, (
        f"async spill stalls the round loop: mean "
        f"{out['async_mean_ms']:.3f}ms > {limit:.3f}ms "
        f"(no-spill mean {out['no_spill_mean_ms']:.3f}ms)"
    )
    out["async_within_10pct"] = True
    return out


# -- 2. engine kill: journal recovery, bit-exact continuations -------------


def scenario_engine_kill(device=None) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool

    cfg = SwimConfig(deterministic=True)
    tmp = tempfile.mkdtemp(prefix="kaboodle-chaos-kill-")
    jdir = os.path.join(tmp, "journal")
    sdir = os.path.join(tmp, "spill")
    os.makedirs(sdir)

    reqs = [
        ServeRequest(n=16, seed=13, mode="ticks", ticks=24,
                     scenario="steady", keep=True),   # parks -> spills
        ServeRequest(n=16, seed=2, mode="converge", ticks=40),  # completes
        # Long enough that it CANNOT finish between admission and the kill
        # point however slow the spill write is — the kill must interrupt
        # it mid-flight so recovery has something to re-queue.
        ServeRequest(n=16, seed=5, mode="ticks", ticks=800,
                     scenario="steady"),
    ]

    def drive_to_kill_point(engine, rids):
        for _ in range(400):
            engine.step()
            if (engine.status(rids[0])["state"] == "spilled"
                    and engine.status(rids[1])["state"] == "done"):
                return
        raise AssertionError("kill point never reached")

    # Uninterrupted twin: the ground truth for every request.
    twin = ServeEngine(
        [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
        spill_after=0, spill_dir=os.path.join(tmp, "twin-spill"),
    )
    os.makedirs(twin.spill_dir, exist_ok=True)
    twin.warmup()

    victim = ServeEngine(
        [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
        spill_after=0, spill_dir=sdir, journal_dir=jdir,
    )
    victim.warmup()

    with compile_counter() as box:
        t_rids = [twin.submit(r) for r in reqs]
        drive_to_kill_point(twin, t_rids)
        assert twin.restore(t_rids[0])
        # Disarm idle-spill: the continuation parks again (keep=True) and
        # must still hold its lane when the member is fetched below.
        twin.spill_after = None
        twin.resume(t_rids[0], mode="ticks", ticks=16)
        twin.drain()
        want_member = twin.pools[16].member(twin.status(t_rids[0])["lane"])
        want = {rid: twin.status(rid)["result"] for rid in t_rids}

        v_rids = [victim.submit(r) for r in reqs]
        drive_to_kill_point(victim, v_rids)
        pre_kill_r1 = victim.status(v_rids[1])["result"]
        # KILL: abandon the engine object mid-service. No close(), no
        # flush — exactly what a crashed process leaves behind: the WAL
        # (flushed per append) and the durable spill files.
        del victim

        recovered = ServeEngine(
            [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
            spill_dir=sdir, journal_dir=jdir,
        )
        recovered.warmup()
        counts = recovered.recover()
        assert counts == {"done": 1, "spilled": 1, "requeued": 1,
                          "cancelled": 0, "dropped": 0}, counts

        # Replay nothing twice: the completed request keeps its pre-crash
        # result verbatim and is not re-admitted.
        r_done = recovered.status(v_rids[1])
        assert r_done["state"] == "done"
        assert r_done["result"] == pre_kill_r1 == want[t_rids[1]]

        # The spilled request re-attaches and its continuation lands
        # bit-exactly on the uninterrupted twin's state.
        assert recovered.status(v_rids[0])["state"] == "spilled"
        assert recovered.restore(v_rids[0])
        recovered.resume(v_rids[0], mode="ticks", ticks=16)
        drained = recovered.drain()
        row0 = recovered.status(v_rids[0])
        assert row0["result"] == want[t_rids[0]], (row0["result"],
                                                   want[t_rids[0]])
        got_member = recovered.pools[16].member(row0["lane"])
        diff = _leaves_equal(got_member, want_member)
        assert not diff, (
            "recovered continuation diverged from the uninterrupted twin", diff
        )

        # The in-flight request re-queued and re-ran to the same answer.
        row2 = recovered.status(v_rids[2])
        assert row2["state"] == "done"
        assert row2["result"] == want[t_rids[2]]
    assert box.count == 0, f"{box.count} fresh compiles across kill+recovery"

    # No duplicate completion: recovery compacted the journal, so the WAL
    # holds only post-recovery transitions — none may belong to the
    # already-completed request.
    with open(os.path.join(jdir, "wal.jsonl")) as f:
        dup = [rec for rec in map(json.loads, f) if rec["rid"] == v_rids[1]]
    assert not dup, f"journal replayed the completed request: {dup}"
    terminal = [e for e in drained if e.get("request_id") == v_rids[1]
                and e.get("event") in ("converged", "completed", "exhausted")]
    assert not terminal, "duplicate completion event after recovery"
    recovered.close()
    return {"recovered": counts, "bit_exact": True,
            "duplicate_completions": 0}


# -- 3. spill write failure: degrade loudly, retry, never lose -------------


def scenario_spill_write_failure(device=None) -> dict:
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool

    cfg = SwimConfig(deterministic=True)
    tmp = tempfile.mkdtemp(prefix="kaboodle-chaos-wfail-")
    engine = ServeEngine(
        [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
        spill_after=1, spill_dir=tmp,
    )
    engine.warmup()
    kept = engine.submit(ServeRequest(n=16, seed=13, mode="ticks", ticks=16,
                                      scenario="steady", keep=True))
    engine.drain()
    assert engine.status(kept)["state"] == "parked"

    engine.spiller.fail_next(1)
    events: list[dict] = []
    for _ in range(200):
        events.extend(engine.step())
        if any(e.get("event") == "spill_failed" for e in events):
            break
        # With nothing running a round is microseconds — give the writer
        # thread a slice, or 200 rounds spin before it ever executes.
        time.sleep(0.002)
    else:
        raise AssertionError("injected spill failure never surfaced")
    row = engine.status(kept)
    assert row["state"] == "parked", row  # degraded, lane held, no raise
    assert row["lane"] is not None

    # Service continues while the retry rides the next idle countdown.
    other = engine.submit(ServeRequest(n=16, seed=3, mode="converge",
                                       ticks=40))
    for _ in range(400):
        events.extend(engine.step())
        if engine.status(kept)["state"] == "spilled":
            break
        time.sleep(0.002)
    else:
        raise AssertionError("spill retry never succeeded")
    assert engine.status(other)["state"] == "done"
    assert os.path.exists(engine.status(kept)["spill_path"])

    # The request is intact end to end: restore + resume completes.
    assert engine.restore(kept)
    engine.resume(kept, mode="ticks", ticks=8)
    engine.drain()
    assert engine.status(kept)["result"]["ticks_run"] == 24
    engine.close()
    kinds = [e.get("event") for e in events]
    return {"spill_failed_events": kinds.count("spill_failed"),
            "recovered_spill": True}


# -- 4. corrupt spill file: structured restore failure, service intact -----


def scenario_corrupt_restore(device=None) -> dict:
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.errors import CheckpointError
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool

    cfg = SwimConfig(deterministic=True)
    tmp = tempfile.mkdtemp(prefix="kaboodle-chaos-corrupt-")
    events: list[dict] = []
    engine = ServeEngine(
        [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
        spill_after=0, spill_dir=tmp, on_event=events.append,
    )
    engine.warmup()
    kept = engine.submit(ServeRequest(n=16, seed=13, mode="ticks", ticks=16,
                                      scenario="steady", keep=True))
    engine.drain()
    engine.settle_spills()
    path = engine.status(kept)["spill_path"]
    assert engine.status(kept)["state"] == "spilled"

    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])  # truncated mid-write, post-rename

    try:
        engine.restore(kept)
        raise AssertionError("restore of a truncated spill did not raise")
    except CheckpointError:
        pass
    assert engine.status(kept)["state"] == "spilled"  # retryable, not lost
    assert any(e.get("event") == "restore_failed" for e in events)

    # The engine is unharmed: new work runs to completion.
    other = engine.submit(ServeRequest(n=16, seed=4, mode="converge",
                                       ticks=40))
    engine.drain()
    assert engine.status(other)["state"] == "done"
    engine.close()
    return {"structured_failure": True, "engine_survived": True}


# -- 5. slow stream consumer: bounded queues, gap records ------------------


async def _slow_consumer_exercise(device=None) -> dict:
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer, _Subscriber
    from kaboodle_tpu_torch.telemetry.manifest import run_record

    # The queue mechanics, driven to overflow deterministically.
    sub = _Subscriber(maxsize=4)
    for i in range(20):
        sub.push(run_record("serve_event", event="x", lane=-1, i=i))
    drained = []
    while not sub.q.empty():
        drained.append(sub.q.get_nowait())
    assert len(drained) == 4 and sub.dropped == 16, (len(drained), sub.dropped)
    sub.push(run_record("serve_event", event="y", lane=-1))
    gap = sub.q.get_nowait()
    assert gap["kind"] == "stream_gap" and gap["dropped"] == 16, gap
    assert sub.q.get_nowait()["event"] == "y"

    # The live shape: a subscriber that never reads must not stall ops or
    # other requests.
    cfg = SwimConfig(deterministic=True)
    engine = ServeEngine([LanePool(16, 2, cfg=cfg, chunk=8, device=device)],
                         warp=False)
    server = ServeServer(engine, port=0, stream_queue=8)
    engine.warmup()
    await server.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
    writer.write(json.dumps({"op": "stream"}).encode() + b"\n")
    await writer.drain()
    await reader.readline()  # ack — then never read again

    client = await ServeClient.connect(port=server.port)
    rids = [
        await client.submit(16, seed=i, mode="converge", ticks=40,
                            timeout=_WAIT_S)
        for i in range(6)
    ]
    for rid in rids:
        row = await client.wait(rid, timeout=_WAIT_S)
        assert row["state"] == "done", row
    stats = await client.stats(timeout=_WAIT_S)
    await client.shutdown()
    await server.close()
    writer.close()
    return {"gap_records": True, "dropped_counted": 16,
            "requests_served_past_stalled_stream": len(rids),
            "rounds": stats["round"]}


def scenario_slow_consumer(device=None) -> dict:
    return asyncio.run(_slow_consumer_exercise(device))


# -- 6. submit flood: admission control under 10x overload -----------------


async def _submit_flood_exercise(device=None) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.admission import AdmissionController
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer

    cfg = SwimConfig(deterministic=True)
    admission = AdmissionController(
        max_queue=6, quotas={"metered": (2.0, 2.0)}
    )
    engine = ServeEngine(
        [LanePool(16, 2, cfg=cfg, chunk=8, device=device)], warp=False,
        admission=admission, spill_after=None,
        spill_dir=tempfile.mkdtemp(prefix="kaboodle-chaos-flood-"),
    )
    events: list[dict] = []
    server = ServeServer(engine, port=0)
    downstream = engine.on_event

    def tap(rec):
        events.append(rec)
        downstream(rec)

    engine.on_event = tap
    engine.warmup()
    await server.start()
    client = await ServeClient.connect(port=server.port)

    # Warm wave (uncounted): both request shapes through the pool.
    for i in range(2):
        rid = await client.submit(16, seed=i, timeout=_WAIT_S,
                                  **_flood_fields(i))
        await client.wait(rid, timeout=_WAIT_S)

    capacity = 2 + admission.max_queue  # lanes + queue slots
    flood = 10 * capacity
    admitted: list[int] = []
    rejected: list[dict] = []
    with compile_counter() as box:
        t0 = time.perf_counter()
        # Open-loop burst: pipeline every submit line on a raw connection
        # BEFORE reading any response. A closed-loop client can never
        # outrun the engine — every awaited roundtrip lets rounds retire
        # work — so overload has to arrive as buffered back-to-back ops.
        f_reader, f_writer = await asyncio.open_connection(
            "127.0.0.1", server.port
        )
        for i in range(flood):
            op = {"op": "submit", "n": 16, "seed": 100 + i,
                  "tenant": f"t{i % 3}", "priority": i % 3,
                  **_flood_fields(i)}
            f_writer.write(json.dumps(op).encode() + b"\n")
        await f_writer.drain()
        for _ in range(flood):
            resp = json.loads(await asyncio.wait_for(
                f_reader.readline(), _WAIT_S))
            if resp.get("ok"):
                admitted.append(resp["request_id"])
            else:
                assert resp.get("kind") == "queue_full", resp
                assert resp.get("retry_after_s", 0) > 0, (
                    "queue_full without retry-after")
                rejected.append(resp)
        f_writer.close()
        lat: list[float] = []
        completed = 0
        for rid in admitted:
            row = await client.wait(rid, timeout=_WAIT_S)
            if row["state"] == "done":
                completed += 1
                lat.append(time.perf_counter() - t0)  # burst-to-completion
            else:
                assert row["state"] == "cancelled", row  # shed
        elapsed = time.perf_counter() - t0
    assert box.count == 0, f"{box.count} fresh compiles during the flood"

    sheds = [e for e in events if e.get("event") == "shed"]
    rejects = [e for e in events if e.get("event") == "rejected"]
    assert rejected, "a 10x flood produced no queue_full backpressure"
    assert len(rejects) >= len(rejected)
    assert sheds, "no higher-priority arrival ever shed the lowest queued"
    assert completed, "nothing survived admission"
    p99 = _percentile_ms(lat, 99) if lat else 0.0
    assert p99 < 30_000, f"admitted p99 {p99:.0f}ms blew the SLO"

    # Quota arm: a metered tenant runs dry with retry-after, and the
    # retrying client path rides it out. The 5 submits are pipelined like
    # the flood (the JAX lane sends them one at a time, each after the
    # last one's wait): a round here can outlast the bucket's 0.5 s refill,
    # so paced submits would never find it empty.
    q_reader, q_writer = await asyncio.open_connection("127.0.0.1", server.port)
    for i in range(5):
        op = {"op": "submit", "n": 16, "seed": 500 + i, "tenant": "metered",
              **_flood_fields(i)}
        q_writer.write(json.dumps(op).encode() + b"\n")
    await q_writer.drain()
    quota_rejects, metered = 0, []
    for _ in range(5):
        resp = json.loads(await asyncio.wait_for(q_reader.readline(), _WAIT_S))
        if resp.get("ok"):
            metered.append(resp["request_id"])
        else:
            assert resp.get("kind") == "quota", resp
            assert resp.get("retry_after_s", 0) > 0, resp
            quota_rejects += 1
    q_writer.close()
    for rid in metered:
        assert (await client.wait(rid, timeout=_WAIT_S))["state"] == "done"
    assert quota_rejects, "the metered tenant was never throttled"
    rid = await client.submit(16, seed=600, timeout=_WAIT_S, retries=8,
                              tenant="metered", **_flood_fields(0))
    row = await client.wait(rid, timeout=_WAIT_S)
    assert row["state"] == "done", row

    await client.shutdown()
    await server.close()
    return {
        "offered": flood,
        "capacity": capacity,
        "admitted": len(admitted),
        "completed": completed,
        "queue_full_rejections": len(rejected),
        "sheds": len(sheds),
        "shed_rate": round(len(sheds) / max(1, len(admitted)), 3),
        "goodput_rps": round(completed / elapsed, 2),
        "admitted_p50_ms": _percentile_ms(lat, 50) if lat else None,
        "admitted_p99_ms": p99 if lat else None,
        "quota_rejections": quota_rejects,
        "retry_with_backoff_succeeded": True,
        "compiles_steady": 0,
    }


def _flood_fields(i: int) -> dict:
    if i % 2:
        return {"mode": "ticks", "ticks": 24, "scenario": "steady"}
    return {"mode": "converge", "ticks": 40, "scenario": "boot"}


def scenario_submit_flood(device=None) -> dict:
    return asyncio.run(_submit_flood_exercise(device))


# -- driver ----------------------------------------------------------------

SCENARIOS = (
    ("spill_latency", scenario_spill_latency),
    ("engine_kill", scenario_engine_kill),
    ("spill_write_failure", scenario_spill_write_failure),
    ("corrupt_restore", scenario_corrupt_restore),
    ("slow_consumer", scenario_slow_consumer),
    ("submit_flood", scenario_submit_flood),
)


def run_chaos_dryrun(device=None) -> int:
    from kaboodle_tpu_torch.analysis.conc import sanitizer
    from kaboodle_tpu_torch.analysis.ir.surface import assert_counter_live

    assert_counter_live()
    report: dict = {"dryrun": "serve-chaos", "seed": CHAOS_SEED,
                    "scenarios": {}}
    # Every scenario runs under the runtime concurrency sanitizer: all
    # SpillManager locks become order-recorded wrappers (an ABBA raises at
    # the acquisition that closes the cycle, no deadlock interleaving
    # needed) and the asyncio scenarios run loop-watchdogged — a chaos
    # pass is also a race regression test. Threshold 1s: toy-scale rounds
    # are sub-ms, warmup/recovery stalls are budgeted, so any trip is a
    # real steady-state stall.
    with sanitizer.enabled(loop_threshold_s=1.0):
        for name, fn in SCENARIOS:
            t0 = time.perf_counter()
            report["scenarios"][name] = fn(device=device)
            report["scenarios"][name]["elapsed_s"] = round(
                time.perf_counter() - t0, 2
            )
        report["sanitizer"] = sanitizer.report()
        sanitizer.assert_clean()
    report["ok"] = True
    print(json.dumps(report))
    return 0
