"""asyncio JSON-over-TCP front end for the serve engine.

The port of ``kaboodle_tpu/serve/server.py``: the same wire protocol and
ops, over the port's engine. Run it with ``python -m
kaboodle_tpu_torch.serve.server`` (on the card unless ``--device`` names
another).

Wire protocol: newline-delimited JSON both ways. A client sends one op
object per line and reads one response object per line:

    {"op": "submit", "n": 16, "seed": 7, "mode": "converge", ...}
    -> {"ok": true, "request_id": 0}

Ops: ``submit`` / ``status`` / ``cancel`` / ``wait`` / ``restore`` /
``resume`` / ``stats`` / ``stream`` / ``shutdown``. ``wait`` parks the
response until the request reaches a terminal state (race-free completion
latency for a load generator — no polling). ``stream`` switches the
connection into live-event mode: every manifest record the engine emits
from then on is written to it as its own JSONL line (the same
``kaboodle-telemetry/1`` records the manifest file gets), until the client
disconnects.

The engine round loop runs as an asyncio task in the server process:
requests wake it, idleness parks it on an event with a short timeout (so
host-side lifecycle like spill countdowns still advances). Engine compute
runs inline on the event loop — a round is one bounded chunk (or one leap)
of device work by construction, which is what keeps the service responsive
without threads; a chunk blocks the loop while it runs.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

from kaboodle_tpu_torch.errors import CheckpointError
from kaboodle_tpu_torch.serve.admission import AdmissionError
from kaboodle_tpu_torch.serve.engine import (
    CANCELLED,
    DONE,
    PARKED,
    SPILLING,
    ServeEngine,
    ServeRequest,
)
from kaboodle_tpu_torch.telemetry.manifest import ManifestWriter, run_record


def _wait_done(row: dict) -> bool:
    """``wait`` resolves when the submitter's answer is in: the run was
    harvested (result present — a kept lane may already be parked or even
    spilled by then), finished outright, or cancelled. A resumed
    continuation clears the old result, so waiting on it blocks until ITS
    harvest."""
    return row["state"] in (DONE, CANCELLED) or row.get("result") is not None

_SUBMIT_FIELDS = frozenset(
    f.name for f in dataclasses.fields(ServeRequest)
)

# How long an idle engine loop sleeps between lifecycle polls (spill
# countdowns advance per poll; submissions interrupt it immediately).
_IDLE_POLL_S = 0.02


class _Subscriber:
    """One stream connection's bounded event queue.

    A consumer that stops reading cannot wedge the server: past
    ``maxsize`` buffered records, new events are counted instead of
    queued, and the count surfaces as one ``stream_gap`` record the
    moment the queue has room again — the subscriber KNOWS it lost
    records, and every other connection is unaffected."""

    def __init__(self, maxsize: int) -> None:
        self.q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.dropped = 0

    def push(self, rec) -> None:  # conc: event-loop
        if self.q.full():
            self.dropped += 1
            return
        if self.dropped:
            self.q.put_nowait(run_record("stream_gap", dropped=self.dropped))
            self.dropped = 0
            if self.q.full():
                self.dropped = 1  # `rec` itself no longer fits
                return
        self.q.put_nowait(rec)

    def push_sentinel(self) -> None:
        if self.q.full():  # make room: the close sentinel must land
            self.q.get_nowait()
        self.q.put_nowait(None)


def _error_response(e: Exception) -> dict:
    """Map an op failure to a structured error a client can act on."""
    resp = {"ok": False, "error": str(e) or type(e).__name__}
    if isinstance(e, AdmissionError):
        resp["kind"] = e.kind  # queue_full | quota
        resp["retry_after_s"] = e.retry_after_s
    elif isinstance(e, CheckpointError):
        resp["kind"] = "checkpoint"
    elif isinstance(e, (ValueError, KeyError, TypeError)):
        resp["kind"] = "bad_request"  # includes malformed JSON lines
    else:
        resp["kind"] = "internal"
    return resp


class ServeServer:
    """One engine + one TCP listener + the live event fan-out."""

    def __init__(
        self,
        engine: ServeEngine,
        host: str = "127.0.0.1",
        port: int = 0,
        manifest_path: str | None = None,
        stream_queue: int = 256,
        metrics_port: int | None = None,
    ) -> None:
        self.engine = engine
        self.host = host
        self.port = port
        self.stream_queue = int(stream_queue)
        # Prometheus-style text endpoint (requires engine.obs). None = off;
        # 0 = ephemeral port, read back after start().
        self.metrics_port = metrics_port
        self.manifest = (
            ManifestWriter(manifest_path, stream=True) if manifest_path else None
        )
        engine.on_event = self._on_event
        self._subscribers: set[_Subscriber] = set()
        self._conn_writers: set = set()  # conc: event-loop
        self._waiters: dict[int, list[asyncio.Future]] = {}
        self._wake = asyncio.Event()
        self._closed = asyncio.Event()
        self._server: asyncio.base_events.Server | None = None
        self._metrics_server: asyncio.base_events.Server | None = None
        self._loop_task: asyncio.Task | None = None

    # -- event fan-out -----------------------------------------------------

    def _on_event(self, rec: dict) -> None:  # conc: event-loop
        if self.manifest is not None:
            self.manifest.write_record(rec)
        for sub in self._subscribers:
            sub.push(rec)

    def _resolve_waiters(self) -> None:  # conc: event-loop
        for rid in list(self._waiters):
            row = self.engine.status(rid)
            if row is not None and _wait_done(row):
                for fut in self._waiters.pop(rid):
                    if not fut.done():
                        fut.set_result(row)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.metrics_port is not None:
            if self.engine.obs is None:
                raise ValueError("metrics_port needs an engine with obs")
            self._metrics_server = await asyncio.start_server(
                self._handle_metrics_http, self.host, self.metrics_port
            )
            self.metrics_port = (
                self._metrics_server.sockets[0].getsockname()[1]
            )
        self._loop_task = asyncio.create_task(self._engine_loop())

    async def serve_forever(self) -> None:
        await self._closed.wait()

    async def close(self) -> None:
        """Stop serving: the listener, the round loop, every stream (after
        it has written what it queued) and every open connection, then the
        engine and the manifest.

        Since Python 3.12.1 ``Server.wait_closed()`` waits for every open
        connection, so the streams and connections are ended before it is
        awaited (the JAX server's order awaits it first, and hangs there
        on a server with an open stream)."""
        self._closed.set()
        self._wake.set()
        for srv in (self._server, self._metrics_server):
            if srv is not None:
                srv.close()
        if self._loop_task is not None:
            await self._loop_task
        for sub in self._subscribers:
            sub.push_sentinel()
        for futs in self._waiters.values():
            for fut in futs:
                if not fut.done():
                    fut.cancel()
        self._waiters.clear()
        # Let each stream write out its queue and hang up (bounded).
        for _ in range(200):
            if not self._subscribers:
                break
            await asyncio.sleep(0.01)
        for writer in list(self._conn_writers):
            writer.close()
        for srv in (self._server, self._metrics_server):
            if srv is not None:
                await srv.wait_closed()
        self.engine.close()  # join spill I/O, release the journal handle
        if self.manifest is not None:
            self.manifest.close()

    async def kill(self) -> None:
        """Die like a crashed process (the federation chaos hook): stop
        the listener, abort every open connection mid-op, cancel the
        round loop — WITHOUT closing the engine, flushing spill I/O, or
        releasing the journal. Whatever the WAL and spill files hold at
        this instant is exactly what a failover replay gets to see."""
        self._closed.set()
        self._wake.set()
        for srv in (self._server, self._metrics_server):
            if srv is not None:
                srv.close()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
        for writer in list(self._conn_writers):
            transport = writer.transport
            if transport is not None:
                transport.abort()  # RST, not FIN: clients see a break
        for sub in self._subscribers:
            sub.push_sentinel()
        for futs in self._waiters.values():
            for fut in futs:
                if not fut.done():
                    fut.cancel()
        self._waiters.clear()

    async def _engine_loop(self) -> None:
        while not self._closed.is_set():
            if self.engine.busy:
                self.engine.step()
                self._resolve_waiters()
                await asyncio.sleep(0)  # let connections progress
                continue
            self._resolve_waiters()
            # Idle: park until a submit wakes us (short timeout so parked-
            # lane spill countdowns keep ticking via engine.step()).
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), _IDLE_POLL_S)
            except asyncio.TimeoutError:
                pass
            if not self.engine.busy and (
                self.engine.spilling  # fold in-flight write completions
                or (
                    self.engine.spill_after is not None
                    and any(
                        row["state"] in (PARKED, SPILLING)
                        for row in self.engine.status()
                    )
                )
            ):
                self.engine.step()
                self._resolve_waiters()

    async def _handle_metrics_http(self, reader, writer) -> None:
        """One-shot Prometheus text scrape: any GET path gets the full
        exposition (stdlib-only HTTP/1.0 — a scraper, not a web server)."""
        try:
            while (await reader.readline()).strip():
                pass  # drain request line + headers; path is irrelevant
            body = self.engine.obs.metrics.to_prometheus().encode()
            writer.write(
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"\r\n" + body
            )
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()

    # -- connections -------------------------------------------------------

    async def _handle(self, reader, writer) -> None:
        self._conn_writers.add(writer)
        try:
            while not self._closed.is_set():
                line = await reader.readline()
                if not line:
                    break
                try:
                    op = json.loads(line)
                    if not isinstance(op, dict):
                        raise ValueError(f"op must be an object, got {op!r}")
                    resp = await self._dispatch(op, writer)
                except Exception as e:  # op errors are responses, not crashes
                    resp = _error_response(e)
                if resp is None:  # stream mode took the connection over
                    return
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        finally:
            self._conn_writers.discard(writer)
            writer.close()

    async def _dispatch(self, op: dict, writer):
        name = op.get("op")
        if name == "submit":
            kw = {k: op[k] for k in _SUBMIT_FIELDS if k in op}
            rid = self.engine.submit(ServeRequest(**kw))
            self._wake.set()
            return {"ok": True, "request_id": rid}
        if name == "adopt":
            # Federation failover handover: take over a dead engine's
            # spilled request (its checkpoint file, its saved run
            # counters, its owner stamp) as a fresh rid on this engine.
            kw = {k: op[k] for k in _SUBMIT_FIELDS if k in op}
            rid = self.engine.adopt(
                ServeRequest(**kw), op["spill_path"],
                op.get("saved_run"), op.get("owner"),
            )
            self._wake.set()
            return {"ok": True, "request_id": rid}
        if name == "status":
            return {"ok": True, "status": self.engine.status(op.get("request_id"))}
        if name == "cancel":
            return {"ok": True, "cancelled": self.engine.cancel(op["request_id"])}
        if name == "wait":
            rid = int(op["request_id"])
            row = self.engine.status(rid)
            if row is None:
                return {"ok": False, "error": f"unknown request {rid}",
                        "kind": "bad_request"}
            if not _wait_done(row):
                fut = asyncio.get_running_loop().create_future()
                self._waiters.setdefault(rid, []).append(fut)
                row = await fut
            return {"ok": True, "status": row}
        if name == "restore":
            ok = self.engine.restore(op["request_id"])
            self._wake.set()
            return {"ok": True, "restored": ok}
        if name == "resume":
            self.engine.resume(
                op["request_id"],
                mode=op.get("mode", "ticks"),
                ticks=op.get("ticks", 16),
            )
            self._wake.set()
            return {"ok": True}
        if name == "stats":
            return {"ok": True, "stats": self.engine.stats()}
        if name == "metrics":
            if self.engine.obs is None:
                return {"ok": False, "kind": "bad_request",
                        "error": "engine has no observability plane "
                                 "(start the server with --obs)"}
            return {"ok": True, "metrics": self.engine.obs.metrics.collect()}
        if name == "stream":
            await self._stream(writer)
            return None
        if name == "shutdown":
            writer.write(json.dumps({"ok": True, "bye": True}).encode() + b"\n")
            await writer.drain()
            self._closed.set()
            self._wake.set()
            return None
        return {"ok": False, "error": f"unknown op {name!r}",
                "kind": "bad_request"}

    async def _stream(self, writer) -> None:
        sub = _Subscriber(self.stream_queue)
        self._subscribers.add(sub)
        # Ack so the subscriber KNOWS it is attached before it triggers the
        # events it wants to see (no submit-vs-subscribe race).
        writer.write(
            json.dumps({"ok": True, "streaming": True}).encode() + b"\n"
        )
        await writer.drain()
        try:
            while True:
                rec = await sub.q.get()
                if rec is None:  # server close sentinel
                    break
                writer.write(json.dumps(rec).encode() + b"\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._subscribers.discard(sub)


def main(argv=None) -> int:
    """``python -m kaboodle_tpu_torch.serve.server`` — run the service.

    The JAX CLI's options plus ``--device``: an engine, the federation
    router in front of member engines (``--federated --members ...``), or
    one of the in-process lanes (``--dryrun``, ``--chaos-dryrun``,
    ``--obs-dryrun``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kaboodle_tpu_torch.serve.server",
        description="gossip-as-a-service: resident lane-pool simulation server",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7447)
    parser.add_argument(
        "--classes", default="16",
        help="comma-separated pow2 N-classes to serve (one pool each)",
    )
    parser.add_argument("--lanes", type=int, default=8, help="lanes per pool")
    parser.add_argument("--chunk", type=int, default=8,
                        help="serve-step dense chunk length")
    parser.add_argument("--max-leap", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device of the pools (default: the card; "
                             "'cpu' runs the plain path on the host)")
    parser.add_argument("--no-warp", action="store_true",
                        help="disable horizon-lane fast-forward")
    parser.add_argument("--no-warp-memo", action="store_true",
                        help="disable span-delta memoization (on by "
                             "default: a lane pool entering a banked state "
                             "replays the delta on the host instead of "
                             "running the leap — bit-identical, "
                             "warp_span_memo_* gauges on --obs)")
    parser.add_argument("--warp-mode", choices=["exact", "distributional"],
                        default="exact",
                        help="leap tier: 'exact' (default) is bit-exact "
                             "with dense ticking; 'distributional' admits "
                             "live-A2 drain spans to the hybrid leap — "
                             "distribution-pinned, NOT bit-exact")
    parser.add_argument("--telemetry", action="store_true",
                        help="per-lane protocol counter totals (disables warp)")
    parser.add_argument("--manifest", default=None,
                        help="stream manifest records to this JSONL path")
    parser.add_argument("--spill-after", type=int, default=None,
                        help="spill parked lanes idle this many rounds")
    parser.add_argument("--spill-dir", default=None)
    parser.add_argument("--sync-spill", action="store_true",
                        help="blocking spill writes on the round loop "
                             "(for A/B only)")
    parser.add_argument("--journal-dir", default=None,
                        help="write-ahead journal directory (crash recovery)")
    parser.add_argument("--engine-id", default=None,
                        help="engine identity: namespaces spill and journal "
                             "paths one level down and stamps every "
                             "checkpoint, so engines can share roots")
    parser.add_argument("--federated", action="store_true",
                        help="run the federation ROUTER instead of an "
                             "engine (needs --members; optional "
                             "--journal-root enables WAL failover)")
    parser.add_argument("--members", default=None,
                        help="federation members as id=host:port,... "
                             "(each id must match that engine's "
                             "--engine-id)")
    parser.add_argument("--journal-root", default=None,
                        help="the members' SHARED --journal-dir root, for "
                             "failover replay")
    parser.add_argument("--spill-root", default=None,
                        help="the members' SHARED --spill-dir root (spill "
                             "files must be reachable for adoption)")
    parser.add_argument("--vnodes", type=int, default=64,
                        help="virtual nodes per member on the placement "
                             "ring")
    parser.add_argument("--recover", action="store_true",
                        help="replay --journal-dir before serving: re-queue "
                             "lost requests, re-attach spilled ones")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="bound the submit queue (enables admission "
                             "control: priorities, shedding, retry-after)")
    parser.add_argument("--obs", action="store_true",
                        help="attach the observability plane: request "
                             "tracing, round profiler, metrics registry")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve Prometheus text metrics on this port "
                             "(0 = ephemeral; implies --obs)")
    parser.add_argument("--dryrun", action="store_true",
                        help="run the in-process CI exercise and exit")
    parser.add_argument("--chaos-dryrun", action="store_true",
                        help="run the seeded fault-injection scenarios and "
                             "exit")
    parser.add_argument("--obs-dryrun", action="store_true",
                        help="run the observability-plane exercise "
                             "(traced lifecycle, metrics, report, trace "
                             "export, overhead A/B) and exit")
    args = parser.parse_args(argv)

    if args.dryrun:
        from kaboodle_tpu_torch.serve.dryrun import run_dryrun

        return run_dryrun(device=args.device)
    if args.chaos_dryrun:
        from kaboodle_tpu_torch.serve.chaos import run_chaos_dryrun

        return run_chaos_dryrun(device=args.device)
    if args.obs_dryrun:
        from kaboodle_tpu_torch.serve.obsdryrun import run_obs_dryrun

        return run_obs_dryrun(device=args.device)

    if args.federated:
        if not args.members:
            parser.error("--federated needs --members id=host:port,...")
        from kaboodle_tpu_torch.serve.federation.router import (
            FedRouter,
            parse_members,
        )

        async def run_router() -> None:
            router = FedRouter(
                parse_members(args.members), host=args.host, port=args.port,
                journal_root=args.journal_root, spill_root=args.spill_root,
                vnodes=args.vnodes, metrics_port=args.metrics_port,
            )
            await router.start()
            print(f"federation router on {router.host}:{router.port} "
                  f"(members {sorted(router.alive)})", flush=True)
            if router.metrics_port is not None:
                print(f"metrics on http://{router.host}:"
                      f"{router.metrics_port}/metrics", flush=True)
            try:
                await router.serve_forever()
            finally:
                await router.close()

        try:
            asyncio.run(run_router())
        except KeyboardInterrupt:
            pass
        return 0

    from kaboodle_tpu_torch.serve.pool import LanePool, lane_n_class

    pools = []
    for tok in args.classes.split(","):
        n = int(tok)
        if n != lane_n_class(n):
            parser.error(f"--classes entry {n} is not a pow2 class >= 8")
        pools.append(
            LanePool(n, args.lanes, chunk=args.chunk,
                     telemetry=args.telemetry, device=args.device)
        )
    admission = None
    if args.max_queue is not None:
        from kaboodle_tpu_torch.serve.admission import AdmissionController

        admission = AdmissionController(max_queue=args.max_queue)
    engine = ServeEngine(
        pools, warp=not args.no_warp, max_leap=args.max_leap,
        warp_memo=not args.no_warp_memo, warp_mode=args.warp_mode,
        spill_after=args.spill_after, spill_dir=args.spill_dir,
        sync_spill=args.sync_spill, journal_dir=args.journal_dir,
        admission=admission, engine_id=args.engine_id,
        obs=args.obs or args.metrics_port is not None,
    )
    if args.recover:
        if args.journal_dir is None:
            parser.error("--recover needs --journal-dir")
        counts = engine.recover()
        print(f"recovered: {counts}", flush=True)

    async def run() -> None:
        server = ServeServer(
            engine, host=args.host, port=args.port,
            manifest_path=args.manifest,
            metrics_port=args.metrics_port,
        )
        print("warming up...", flush=True)
        engine.warmup()
        await server.start()
        print(f"serving on {server.host}:{server.port} "
              f"(classes {sorted(engine.pools)}, device "
              f"{next(iter(engine.pools.values())).device})", flush=True)
        if server.metrics_port is not None:
            print(f"metrics on http://{server.host}:{server.metrics_port}/"
                  f"metrics", flush=True)
        try:
            await server.serve_forever()
        finally:
            await server.close()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
