"""Closed+open-loop load driver for the serve server.

The port of ``kaboodle_tpu/serve/loadgen.py``. Drives a real in-process
:class:`ServeServer` over TCP loopback — the measured path includes the
wire protocol, the engine round loop and every device dispatch, exactly
what a remote client would see minus network flight time. The pool runs on
the card unless ``--device`` names another.

    python -m kaboodle_tpu_torch.serve.loadgen --n 1024 --lanes 16
    python -m kaboodle_tpu_torch.serve.loadgen --overload --device cpu
    python -m kaboodle_tpu_torch.serve.loadgen --slo --device cpu

Two phases, both after a warmup wave that is excluded from measurement and
from the build gate:

- **closed loop**: ``--concurrency`` workers each run submit→wait back to
  back until the request budget is spent — the saturation throughput shape
  (offered load adapts to service rate).
- **open loop**: submissions arrive on a fixed schedule at ``--rate``
  req/s regardless of completions — the latency-under-load shape (queueing
  shows up in the tail instead of throttling the arrivals).

Every completion latency is submit-to-harvest. The steady phase runs under
the compile counter (``analysis/ir/surface.py``: programs built) and the
report pins ``compiles_steady == 0`` — the zero-rebuild-after-warmup
gate, measured on the serving path itself.

``--overload`` swaps the phases for an admission-control study: a
closed-loop calibration measures capacity, then open-loop phases offer
2x / 5x / 10x that rate with mixed tenants and priorities against a
bounded queue. Submits are pipelined raw (a rejection is a response, not
an exception), so the offered schedule really is open-loop; the report
gives goodput, shed rate (aggregate and broken down per tenant and per
priority class) and admitted-latency percentiles per phase — the overload
curves — plus the same ``compiles_steady == 0`` pin across every phase.

``--slo`` is the SLO-attribution campaign: an observability-enabled
server takes open-loop waves at multiples of calibrated capacity, and
every level reports latency percentiles plus *where the time went* —
per-request queue/run span percentiles from the traced manifest and the
round profiler's admit/dispatch/harvest/spill/journal segment deltas from
the ``metrics`` RPC — alongside a Perfetto trace artifact showing lanes,
leaps, spills and journal writes on one timeline.

The report keys are those of the JAX driver's reports.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np


def _mix_fields(i: int) -> dict:
    """The load mix: converge-mode boots and horizon-mode steady runs
    interleaved (the two service shapes; odd = warp-eligible)."""
    if i % 2:
        return {"seed": i, "mode": "ticks", "ticks": 40, "scenario": "steady"}
    return {"seed": i, "mode": "converge", "ticks": 40, "scenario": "boot"}


def _latency_stats(lat_s: list[float]) -> dict:
    # Host-list stats on the harvested latencies, not a device fetch.
    a = np.asarray(lat_s, dtype=np.float64) * 1e3  # noqa: KB501
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
        "max_ms": float(a.max()),
    }


async def _closed_loop(client_factory, n: int, requests: int, concurrency: int):
    lat: list[float] = []
    issued = 0

    async def worker(wid: int) -> None:
        nonlocal issued
        client = await client_factory()
        try:
            while True:
                if issued >= requests:
                    return
                i = issued
                issued += 1
                t0 = time.perf_counter()
                rid = await client.submit(n, **_mix_fields(i))
                await client.wait(rid)
                lat.append(time.perf_counter() - t0)
        finally:
            await client.close()

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(concurrency)))
    elapsed = time.perf_counter() - t0
    return lat, elapsed


async def _open_loop(client_factory, n: int, requests: int, rate: float):
    lat: list[float] = []
    client = await client_factory()
    waiters: list[asyncio.Task] = []

    async def complete(rid: int, t0: float) -> None:
        # One wait op needs its own connection (the shared one is busy
        # submitting on schedule).
        c = await client_factory()
        try:
            await c.wait(rid)
            lat.append(time.perf_counter() - t0)
        finally:
            await c.close()

    start = time.perf_counter()
    try:
        for i in range(requests):
            due = start + i / rate
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            t0 = time.perf_counter()
            rid = await client.submit(n, **_mix_fields(i))
            waiters.append(asyncio.create_task(complete(rid, t0)))
        await asyncio.gather(*waiters)
    finally:
        await client.close()
    elapsed = time.perf_counter() - start
    return lat, elapsed


async def _overload_phase(client_factory, port: int, n: int,
                          rate: float, requests: int) -> dict:
    """One open-loop overload phase: ``requests`` submits offered at
    ``rate`` req/s on a raw pipelined connection (when the schedule is
    behind, lines go out back to back with no response roundtrip — a
    closed-loop client can never outrun the engine), mixed tenants and
    priorities. Rejections arrive as structured error responses; every
    admitted rid gets a waiter, and a shed admission counts against
    goodput just like a rejection."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    submit_t: list[float] = []
    lat: list[float] = []
    waiters: list[asyncio.Task] = []
    counts = {"completed": 0, "shed": 0, "rejected": 0}
    # Per-class fate breakdown: submit i's tenant/priority are functions
    # of i (the offer loop's mix), so every response and waiter outcome
    # attributes deterministically without echoing fields over the wire.
    by_tenant: dict[str, dict] = {}
    by_priority: dict[str, dict] = {}

    def _classes(i: int) -> tuple[dict, dict]:
        zero = {"offered": 0, "rejected": 0, "shed": 0, "completed": 0}
        return (by_tenant.setdefault(f"t{i % 3}", dict(zero)),
                by_priority.setdefault(str(i % 3), dict(zero)))

    def _count(i: int, fate: str) -> None:
        for bucket in _classes(i):
            bucket[fate] += 1

    async def complete(i: int, rid: int, t0: float) -> None:
        c = await client_factory()
        try:
            row = await c.wait(rid)
            if row["state"] == "done":
                counts["completed"] += 1
                _count(i, "completed")
                lat.append(time.perf_counter() - t0)
            else:
                counts["shed"] += 1
                _count(i, "shed")
        finally:
            await c.close()

    async def read_responses() -> None:
        for i in range(requests):
            resp = json.loads(await reader.readline())
            if resp.get("ok"):
                # submit_t[i] exists: the server can only respond to a
                # line written after its timestamp was appended.
                waiters.append(asyncio.create_task(
                    complete(i, resp["request_id"], submit_t[i])))
            else:
                counts["rejected"] += 1
                _count(i, "rejected")

    async def offer() -> None:
        start = time.perf_counter()
        for i in range(requests):
            delay = start + i / rate - time.perf_counter()
            if delay > 0:
                await writer.drain()
                await asyncio.sleep(delay)
            op = {"op": "submit", "n": n, "tenant": f"t{i % 3}",
                  "priority": i % 3, **_mix_fields(i)}
            _count(i, "offered")
            submit_t.append(time.perf_counter())
            writer.write(json.dumps(op).encode() + b"\n")
        await writer.drain()

    t0 = time.perf_counter()
    await asyncio.gather(offer(), read_responses())
    await asyncio.gather(*waiters)
    elapsed = time.perf_counter() - t0
    writer.close()
    admitted = requests - counts["rejected"]

    def _finish(buckets: dict[str, dict]) -> dict:
        for b in buckets.values():
            b["shed_rate"] = round(
                (b["rejected"] + b["shed"]) / max(b["offered"], 1), 3)
        return dict(sorted(buckets.items()))

    return {
        "offered_rps": round(rate, 2),
        "requests": requests,
        "admitted": admitted,
        "rejected": counts["rejected"],
        "shed": counts["shed"],
        "completed": counts["completed"],
        "goodput_rps": round(counts["completed"] / elapsed, 2),
        "shed_rate": round(
            (counts["rejected"] + counts["shed"]) / requests, 3),
        "by_tenant": _finish(by_tenant),
        "by_priority": _finish(by_priority),
        "elapsed_s": round(elapsed, 3),
        "latency": _latency_stats(lat) if lat else None,
    }


async def _slo_level(client_factory, n: int, requests: int, rate: float):
    """One open-loop SLO level: like :func:`_open_loop` but keeps the rid
    of every submit, so the post-run manifest pass can attribute each
    level's queue/run time from its own span records."""
    lat: list[float] = []
    rids: list[int] = []
    client = await client_factory()
    waiters: list[asyncio.Task] = []

    async def complete(rid: int, t0: float) -> None:
        c = await client_factory()
        try:
            await c.wait(rid)
            lat.append(time.perf_counter() - t0)
        finally:
            await c.close()

    start = time.perf_counter()
    try:
        for i in range(requests):
            delay = start + i / rate - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            t0 = time.perf_counter()
            rid = await client.submit(n, **_mix_fields(i))
            rids.append(rid)
            waiters.append(asyncio.create_task(complete(rid, t0)))
        await asyncio.gather(*waiters)
    finally:
        await client.close()
    return lat, time.perf_counter() - start, rids


def _span_stats(spans: list[dict], rids: set[int], phase: str) -> dict | None:
    durs = sorted(
        int(s["dur_us"]) for s in spans
        if int(s["request_id"]) in rids and s["span"] == phase
    )
    if not durs:
        return None
    pick = lambda q: durs[min(int(q * len(durs)), len(durs) - 1)]  # noqa: E731
    return {"count": len(durs), "p50_us": pick(0.50), "p90_us": pick(0.90),
            "p99_us": pick(0.99), "max_us": durs[-1],
            "total_us": sum(durs)}


def _segment_totals(metrics: dict) -> dict[str, int]:
    hists = metrics["histograms"].get("serve_round_segment_us", {})
    return {
        key.split("=", 1)[1]: int(snap["total_us"])
        for key, snap in hists.items()
    }


async def _run_slo(args) -> dict:
    """The SLO-attribution campaign (``--slo``).

    An obs-enabled server (tracing + profiler + metrics + journal +
    spill) takes a closed-loop calibration, then open-loop waves at
    ``--slo-levels`` multiples of measured capacity. Each level banks its
    latency percentiles AND where the time went, from two independent
    instruments: per-request ``queued``/``running`` span percentiles out
    of the manifest, and the round profiler's segment totals (admit /
    dispatch / harvest / spill / journal) deltaed over the level via the
    ``metrics`` RPC. A keep-wave parks lanes so the trace artifact shows
    spill + restore + journal activity on the shared timeline; the whole
    steady phase runs under the compile gate."""
    import os
    import tempfile

    from kaboodle_tpu_torch.analysis.ir.surface import (
        assert_counter_live,
        compile_counter,
    )
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.obsplane import ObsPlane
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer

    assert_counter_live()
    base = args.out[:-5] if args.out.endswith(".json") else args.out
    manifest_path = f"{base}.manifest.jsonl"
    trace_path = f"{base}.trace.json"
    scratch = tempfile.mkdtemp(prefix="kaboodle-slo-")
    os.makedirs(os.path.join(scratch, "spill"), exist_ok=True)
    pool = LanePool(args.n, args.lanes, chunk=args.chunk, device=args.device)
    engine = ServeEngine(
        [pool], warp=not args.no_warp, max_leap=args.max_leap,
        spill_after=2, spill_dir=os.path.join(scratch, "spill"),
        journal_dir=os.path.join(scratch, "journal"),
        obs=ObsPlane(trace=True),
    )
    server = ServeServer(engine, port=0, manifest_path=manifest_path)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    await server.start()

    async def client_factory():
        return await ServeClient.connect(port=server.port)

    warm_client = await client_factory()
    for i in range(2 * args.lanes):
        rid = await warm_client.submit(args.n, **_mix_fields(i))
        await warm_client.wait(rid)
    await warm_client.close()

    levels: dict[str, dict] = {}
    with compile_counter() as box:
        cal_lat, cal_s = await _closed_loop(
            client_factory, args.n, args.requests, args.concurrency
        )
        capacity_rps = len(cal_lat) / cal_s
        # Keep-wave: parked lanes that idle out and spill mid-campaign,
        # putting spill + journal events on the trace timeline.
        keeper = await client_factory()
        kept = []
        for i in range(2):
            rid = await keeper.submit(args.n, seed=100 + i, mode="ticks",
                                      ticks=8, scenario="steady", keep=True)
            kept.append(rid)
            await keeper.wait(rid)
        probe = await client_factory()
        for mult in args.slo_levels:
            before = _segment_totals(await probe.metrics())
            lat, elapsed, rids = await _slo_level(
                client_factory, args.n, args.requests,
                rate=capacity_rps * mult,
            )
            after = _segment_totals(await probe.metrics())
            levels[f"{mult:g}x"] = {
                "offered_rps": round(capacity_rps * mult, 2),
                "requests": len(lat),
                "elapsed_s": round(elapsed, 3),
                "throughput_rps": round(len(lat) / elapsed, 2),
                "latency": _latency_stats(lat),
                "rids": rids,
                "segments_us": {
                    seg: after.get(seg, 0) - before.get(seg, 0)
                    for seg in after
                },
            }
        # Bring one kept lane back through restore->resume so the trace
        # shows the full spilled->parked->running arc.
        for rid in kept:
            row = await keeper.status(rid)
            if row and row["state"] == "spilled":
                await keeper.restore(rid)
                await keeper.resume(rid, mode="ticks", ticks=4)
                await keeper.wait(rid)
                break
        await keeper.close()
    compiles = box.count

    final_metrics = await probe.metrics()
    await probe.shutdown()
    await server.close()

    # Post-run: per-level queue/run attribution from the span records the
    # server streamed to the manifest, then the shared-timeline trace.
    from kaboodle_tpu_torch.serve.journal import read_journal_records
    from kaboodle_tpu_torch.telemetry.manifest import read_manifest
    from kaboodle_tpu_torch.telemetry.trace import (
        journal_trace_events,
        serve_trace_events,
        write_chrome_trace,
    )

    records = list(read_manifest(manifest_path))
    spans = [r for r in records if r["kind"] == "serve_span"]
    for name, lvl in levels.items():
        rids = set(lvl.pop("rids"))
        seg = lvl["segments_us"]
        queued = _span_stats(spans, rids, "queued")
        running = _span_stats(spans, rids, "running")
        lvl["per_request_us"] = {"queued": queued, "running": running}
        # The four-way attribution the SLO table cites: queue time is the
        # requests' own wait, the rest is round-loop wall split by the
        # profiler (compute = dispatch+harvest, spill = poll+pacing).
        lvl["attribution_us"] = {
            "queue": queued["total_us"] if queued else 0,
            "compute": seg.get("dispatch", 0) + seg.get("harvest", 0),
            "spill": seg.get("poll", 0) + seg.get("spill", 0),
            "journal": seg.get("journal", 0),
            "admit": seg.get("admit", 0),
        }
    n_events = write_chrome_trace(
        trace_path, {},
        metadata={"bench": "serve-slo", "manifest": manifest_path},
        extra_events=(serve_trace_events(records)
                      + journal_trace_events(
                          read_journal_records(os.path.join(scratch,
                                                            "journal")))),
    )

    return {
        "bench": "serve-slo",
        "n": args.n,
        "lanes": args.lanes,
        "chunk": args.chunk,
        "warp": not args.no_warp,
        "warmup_s": round(warmup_s, 3),
        "compiles_steady": compiles,
        "compiles_steady_gauge": final_metrics["gauges"]
                                              .get("compiles_steady", {}),
        "capacity_rps": round(capacity_rps, 2),
        "calibration_latency": _latency_stats(cal_lat),
        "levels": levels,
        "round_profile": {
            seg: snap
            for seg, snap in (
                (k.split("=", 1)[1], v) for k, v in final_metrics[
                    "histograms"].get("serve_round_segment_us", {}).items()
            )
        },
        "manifest": manifest_path,
        "trace": trace_path,
        "trace_events": n_events,
    }


async def _run_overload(args) -> dict:
    from kaboodle_tpu_torch.analysis.ir.surface import (
        assert_counter_live,
        compile_counter,
    )
    from kaboodle_tpu_torch.serve.admission import AdmissionController
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer

    assert_counter_live()
    pool = LanePool(args.n, args.lanes, chunk=args.chunk, device=args.device)
    admission = AdmissionController(max_queue=args.max_queue)
    engine = ServeEngine([pool], warp=not args.no_warp,
                         max_leap=args.max_leap, admission=admission)
    server = ServeServer(engine, port=0)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    await server.start()

    async def client_factory():
        return await ServeClient.connect(port=server.port)

    warm_client = await client_factory()
    for i in range(2 * args.lanes):
        rid = await warm_client.submit(args.n, **_mix_fields(i))
        await warm_client.wait(rid)
    await warm_client.close()

    with compile_counter() as box:
        cal_lat, cal_s = await _closed_loop(
            client_factory, args.n, args.requests, args.concurrency
        )
        capacity_rps = len(cal_lat) / cal_s
        phases = {}
        for mult in (2, 5, 10):
            phases[f"{mult}x"] = await _overload_phase(
                client_factory, server.port, args.n,
                rate=capacity_rps * mult, requests=args.requests,
            )
    compiles = box.count

    probe = await client_factory()
    stats = await probe.stats()
    await probe.shutdown()
    await server.close()

    return {
        "bench": "serve-overload",
        "n": args.n,
        "lanes": args.lanes,
        "chunk": args.chunk,
        "warp": not args.no_warp,
        "max_queue": args.max_queue,
        "warmup_s": round(warmup_s, 3),
        "compiles_steady": compiles,
        "capacity_rps": round(capacity_rps, 2),
        "calibration_latency": _latency_stats(cal_lat),
        "phases": phases,
        "engine_rounds": stats["round"],
    }


async def _run(args, rows: list | None = None) -> dict:
    """The default closed+open study. ``rows``, if given, receives every
    request's final status row (its seed and result) before shutdown."""
    from kaboodle_tpu_torch.analysis.ir.surface import (
        assert_counter_live,
        compile_counter,
    )
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer

    assert_counter_live()
    pool = LanePool(args.n, args.lanes, chunk=args.chunk, device=args.device)
    engine = ServeEngine([pool], warp=not args.no_warp, max_leap=args.max_leap)
    server = ServeServer(engine, port=0)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    await server.start()

    async def client_factory():
        return await ServeClient.connect(port=server.port)

    # Warmup wave: one request per lane per mode shape, uncounted.
    warm_client = await client_factory()
    for i in range(2 * args.lanes):
        rid = await warm_client.submit(args.n, **_mix_fields(i))
        await warm_client.wait(rid)
    await warm_client.close()

    with compile_counter() as box:
        closed_lat, closed_s = await _closed_loop(
            client_factory, args.n, args.requests, args.concurrency
        )
        open_lat, open_s = await _open_loop(
            client_factory, args.n, args.requests, args.rate
        )
    compiles = box.count

    probe = await client_factory()
    stats = await probe.stats()
    if rows is not None:
        rows.extend(await probe.status())
    await probe.shutdown()
    await server.close()

    return {
        "bench": "serve",
        "n": args.n,
        "lanes": args.lanes,
        "chunk": args.chunk,
        "warp": not args.no_warp,
        "warmup_s": round(warmup_s, 3),
        "compiles_steady": compiles,
        "closed": {
            "requests": len(closed_lat),
            "concurrency": args.concurrency,
            "elapsed_s": round(closed_s, 3),
            "throughput_rps": round(len(closed_lat) / closed_s, 2),
            "latency": _latency_stats(closed_lat),
        },
        "open": {
            "requests": len(open_lat),
            "offered_rps": args.rate,
            "elapsed_s": round(open_s, 3),
            "throughput_rps": round(len(open_lat) / open_s, 2),
            "latency": _latency_stats(open_lat),
        },
        "engine_rounds": stats["round"],
    }


def parse_args(argv=None):
    """The driver's command line, defaults filled in (``--max-queue``,
    ``--out``, ``--slo-levels`` as floats)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kaboodle_tpu_torch.serve.loadgen",
        description="closed+open-loop load driver over an in-process server",
    )
    parser.add_argument("--n", type=int, default=16, help="request N-class")
    parser.add_argument("--lanes", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--requests", type=int, default=64,
                        help="measured requests per phase")
    parser.add_argument("--concurrency", type=int, default=8,
                        help="closed-loop workers")
    parser.add_argument("--rate", type=float, default=50.0,
                        help="open-loop offered req/s")
    parser.add_argument("--max-leap", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="torch device of the pool (default: the card; "
                             "'cpu' runs the plain path on the host)")
    parser.add_argument("--no-warp", action="store_true")
    parser.add_argument("--overload", action="store_true",
                        help="admission-control study: calibrate capacity, "
                             "then offer 2x/5x/10x against a bounded queue")
    parser.add_argument("--slo", action="store_true",
                        help="SLO-attribution study on an obs-enabled "
                             "server: per-level latency percentiles + "
                             "queue/compute/spill/journal attribution, "
                             "plus a Perfetto trace artifact")
    parser.add_argument("--slo-levels", default="0.5,0.9,1.3",
                        help="comma-separated load multiples of calibrated "
                             "capacity for --slo")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="admission queue bound for --overload "
                             "(default 2*lanes)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.max_queue is None:
        args.max_queue = 2 * args.lanes
    if args.out is None:
        args.out = ("torch_serve_overload.json" if args.overload
                    else "torch_serve_slo.json" if args.slo
                    else "torch_serve.json")
    args.slo_levels = [float(tok) for tok in args.slo_levels.split(",")]
    return args


def run_mode(args):
    """The coroutine of the study ``args`` selects."""
    return (_run_overload(args) if args.overload
            else _run_slo(args) if args.slo
            else _run(args))


def main(argv=None) -> int:
    """``python -m kaboodle_tpu_torch.serve.loadgen`` — load-test the service."""
    args = parse_args(argv)
    report = asyncio.run(run_mode(args))
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
