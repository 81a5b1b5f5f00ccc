"""The federation front door: one NDJSON endpoint over many engines.

The port of ``kaboodle_tpu/serve/federation/router.py``. A
:class:`FedRouter` is wire-compatible with :class:`~kaboodle_tpu_torch.
serve.server.ServeServer` — the same ops, the same structured errors, the same
``ServeClient`` works against either — but behind it every request is
placed onto one of M member engines and tracked under a ROUTER request id
(the member's rid never leaks to clients, so a request can move engines
without its identity changing).

Placement: ``preference(key)`` order on the consistent-hash ring
(key = ``tenant:n_class:seed``, so a tenant's repeats of one shape land
on the same warmed lanes), filtered to members whose pools serve the
request's N-class, tie-broken by router-tracked inflight load — the
ring's choice stands unless it is ``load_slack`` requests busier than
the least-loaded candidate (N-class-aware load scoring).

Failover: every engine namespaces its journal and spill files under its
engine-id in SHARED roots. When any op's connection to a member breaks,
the router declares it dead exactly once and replays its journal
read-only: routes whose last journaled op carries a result (or a
terminal cancel) are served from the fold and NEVER re-run; routes whose
last durable state is a spill file are ``adopt``-ed onto a survivor
(the file keeps the dead engine's owner stamp — the checkpoint guard's
sanctioned handover path); everything else re-submits from its seed with
its cumulative tick budget. Clients parked in ``wait`` ride through: the
wait loop re-resolves the route and re-issues against the survivor, so
the caller sees latency (bounded by ``retry_after_s`` backoff rounds),
never a lost result, and never a second completion for a journaled one.

Concurrency discipline: the router is single-threaded asyncio — every
table below is event-loop confined (``# conc: event-loop``), and the one
shared resource per member (its control connection) is serialized by an
``asyncio.Lock`` so concurrent ops cannot interleave frames on one
socket.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os

from kaboodle_tpu_torch.serve.client import ServeClient, ServeError
from kaboodle_tpu_torch.serve.federation.ring import HashRing
from kaboodle_tpu_torch.serve.journal import replay_journal
from kaboodle_tpu_torch.serve.obsplane import MetricsRegistry

# Request fields forwarded verbatim on submit/adopt (mirrors
# server._SUBMIT_FIELDS without importing the engine and its tensors).
_REQ_FIELDS = ("n", "seed", "mode", "ticks", "drop_rate", "scenario",
               "keep", "tenant", "priority")

# How long a client should back off when an op lands mid-failover.
_RETRY_AFTER_S = 0.25

# Period of the background member-stats poll feeding the lane-occupancy
# gauges (a pull gauge must not RPC inside collect(), which is sync).
_STATS_POLL_S = 0.25


def _lane_n_class(n: int) -> int:
    """pow2 lane class >= 8 (serve.pool.lane_n_class without importing
    the pool — the router must stay importable on a front door with no
    torch device work)."""
    return max(8, 1 << (int(n) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class EngineMember:
    """One member engine's address. ``engine_id`` must match the id the
    engine itself was started with (it names the journal/spill
    namespaces the failover replay reads)."""

    engine_id: str
    host: str
    port: int


def _error_response(e: Exception) -> dict:
    """Server.py's error mapping plus pass-through of a member's
    structured :class:`ServeError` (kind and retry-after survive the
    hop)."""
    resp = {"ok": False, "error": str(e) or type(e).__name__}
    if isinstance(e, ServeError):
        resp["kind"] = e.kind
        if e.retry_after_s:
            resp["retry_after_s"] = e.retry_after_s
    elif isinstance(e, (ValueError, KeyError, TypeError)):
        resp["kind"] = "bad_request"
    else:
        resp["kind"] = "internal"
    return resp


class FedRouter:
    """Consistent-hash request router over member :class:`ServeServer`s.

    ``journal_root`` / ``spill_root`` are the SHARED roots the members
    were started with (each member namespaces itself one level down);
    without a journal root, failover can only re-queue from seeds.
    """

    def __init__(
        self,
        members: list[EngineMember],
        host: str = "127.0.0.1",
        port: int = 0,
        journal_root: str | None = None,
        spill_root: str | None = None,
        vnodes: int = 64,
        load_slack: int = 4,
        metrics_port: int | None = None,
    ) -> None:
        if not members:
            raise ValueError("need at least one member engine")
        self.members = {m.engine_id: m for m in members}
        if len(self.members) != len(members):
            raise ValueError("duplicate engine_id among members")
        self.host = host
        self.port = port
        self.journal_root = journal_root
        self.spill_root = spill_root
        self.load_slack = int(load_slack)
        self.metrics_port = metrics_port
        self.ring = HashRing(vnodes=vnodes)  # members join on attach
        # -- event-loop confined tables (single-threaded asyncio) ----------
        self.alive: set[str] = set()  # conc: event-loop
        self._conns: dict[str, ServeClient] = {}  # conc: event-loop
        # One lock per member control connection: ServeClient is strictly
        # sequential request/response, so every forwarded op holds the
        # member's lock across its whole round trip.
        self._conn_locks: dict[str, asyncio.Lock] = {}
        self._classes: dict[str, set[int]] = {}  # conc: event-loop
        self._routes: dict[int, dict] = {}  # conc: event-loop
        self._next_rid = 0
        self._inflight: dict[str, int] = {}  # conc: event-loop
        self._lane_stats: dict[str, dict] = {}  # conc: event-loop
        self._failing: dict[str, asyncio.Future] = {}  # conc: event-loop
        self._conn_writers: set = set()  # conc: event-loop
        self._closed = asyncio.Event()
        self._server: asyncio.base_events.Server | None = None
        self._metrics_server: asyncio.base_events.Server | None = None
        self._poll_task: asyncio.Task | None = None
        self.metrics = MetricsRegistry()
        self._bind_metrics()

    # -- metrics -----------------------------------------------------------

    def _bind_metrics(self) -> None:
        m = self.metrics
        m.register_gauge("fed_ring_members", lambda: len(self.alive))
        m.register_gauge("fed_ring_size", lambda: self.ring.size)
        m.register_gauge(
            "fed_routes_open",
            lambda: sum(1 for r in self._routes.values() if r["open"]),
        )
        m.register_multi_gauge(
            "fed_engine_inflight",
            lambda: {
                (("engine", mid),): cnt
                for mid, cnt in self._inflight.items()
            },
        )
        for stat in ("lanes_occupied", "lanes_active"):
            m.register_multi_gauge(
                f"fed_engine_{stat}",
                lambda stat=stat: {
                    (("engine", mid),): snap.get(stat, 0)
                    for mid, snap in self._lane_stats.items()
                },
            )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Attach every member (control connection + served-classes
        probe), then open the front-door listener. A member that is down
        at start is declared failed immediately — the federation serves
        with whoever answered."""
        for mid, member in self.members.items():
            try:
                await self._attach(mid, member)
            except (ConnectionError, OSError):
                self.metrics.inc("fed_failovers_total")
                continue
        if not self.alive:
            raise ConnectionError("no member engine reachable")
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.metrics_port is not None:
            self._metrics_server = await asyncio.start_server(
                self._handle_metrics_http, self.host, self.metrics_port
            )
            self.metrics_port = (
                self._metrics_server.sockets[0].getsockname()[1]
            )
        self._poll_task = asyncio.create_task(self._poll_stats())

    async def _attach(self, mid: str, member: EngineMember) -> None:
        conn = await ServeClient.connect(member.host, member.port)
        self._conns[mid] = conn
        self._conn_locks[mid] = asyncio.Lock()
        stats = await conn.stats()
        self._classes[mid] = {int(n) for n in stats["pools"]}
        self._lane_stats[mid] = self._fold_lane_stats(stats)
        self._inflight.setdefault(mid, 0)
        self.alive.add(mid)
        self.ring.add(mid)

    async def serve_forever(self) -> None:
        await self._closed.wait()

    async def close(self) -> None:
        """Stop routing: the listeners, the stats poll, every client
        connection and every member connection, and only then wait for
        the listeners to finish closing.

        Since Python 3.12.1 ``Server.wait_closed()`` waits for every open
        connection, so they are ended before it is awaited (the JAX
        router's order awaits it first, and hangs there while a client
        connection is still open)."""
        self._closed.set()
        for srv in (self._server, self._metrics_server):
            if srv is not None:
                srv.close()
        if self._poll_task is not None:
            self._poll_task.cancel()
            try:
                await self._poll_task
            except asyncio.CancelledError:
                pass
        for writer in list(self._conn_writers):
            writer.close()
        for conn in list(self._conns.values()):
            await conn.close()
        for srv in (self._server, self._metrics_server):
            if srv is not None:
                await srv.wait_closed()

    @staticmethod
    def _fold_lane_stats(stats: dict) -> dict:
        occ = act = 0
        for snap in stats.get("pools", {}).values():
            occ += int(snap.get("occupied", 0))
            act += int(snap.get("active", 0))
        return {"lanes_occupied": occ, "lanes_active": act}

    async def _poll_stats(self) -> None:
        """Background refresh of the per-engine lane gauges (collect()
        is synchronous, so gauges read this cache, never the wire)."""
        while not self._closed.is_set():
            for mid in list(self.alive):
                try:
                    async with self._conn_locks[mid]:
                        stats = await self._conns[mid].stats()
                    self._lane_stats[mid] = self._fold_lane_stats(stats)
                except (ConnectionError, OSError, ServeError):
                    await self._fail_member(mid)
            await asyncio.sleep(_STATS_POLL_S)

    # -- placement ---------------------------------------------------------

    def _placement_key(self, fields: dict) -> str:
        return (f"{fields.get('tenant', 'default')}:"
                f"{_lane_n_class(fields.get('n', 0))}:"
                f"{fields.get('seed', 0)}")

    def _place(self, key: str, n_class: int) -> str:
        """Ring preference walk filtered by N-class, load-scored: the
        ring's pick keeps the key unless it is ``load_slack`` inflight
        requests busier than the least-loaded serving candidate."""
        prefs = [
            mid for mid in self.ring.preference(key)
            if n_class in self._classes.get(mid, ())
        ]
        if not prefs:
            raise ValueError(
                f"no live engine serves N-class {n_class}"
            )
        least = min(prefs, key=lambda m: (self._inflight[m], m))
        if self._inflight[prefs[0]] - self._inflight[least] >= self.load_slack:
            return least
        return prefs[0]

    # -- forwarded ops -----------------------------------------------------

    async def _member_rpc(self, mid: str, **op) -> dict:
        """One op on a member's control connection (serialized); a broken
        pipe fails the member over and re-raises for the caller's retry
        loop."""
        conn = self._conns.get(mid)
        if conn is None:  # lost a race with an in-progress failover
            await self._await_failover(mid)
            raise ConnectionError(f"engine {mid} is down")
        try:
            async with self._conn_locks[mid]:
                return await conn._rpc(**op)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            await self._fail_member(mid)
            raise ConnectionError(f"engine {mid} died mid-op") from None

    async def _submit(self, op: dict) -> dict:
        fields = {k: op[k] for k in _REQ_FIELDS if k in op}
        if "n" not in fields:
            raise ValueError("submit needs n")
        n_class = _lane_n_class(fields["n"])
        key = self._placement_key(fields)
        while True:
            if not self.alive:
                raise ConnectionError("no live engine")
            mid = self._place(key, n_class)
            try:
                resp = await self._member_rpc(mid, op="submit", **fields)
            except ConnectionError:
                continue  # re-place on the survivors
            rid = self._next_rid
            self._next_rid += 1
            self._routes[rid] = {
                "member": mid, "member_rid": int(resp["request_id"]),
                "fields": fields, "key": key, "n_class": n_class,
                "cached": None, "open": True,
            }
            self._inflight[mid] += 1
            self.metrics.inc("fed_submits_total", engine=mid)
            return {"ok": True, "request_id": rid}

    def _route(self, op: dict) -> tuple[int, dict]:
        rid = int(op["request_id"])
        route = self._routes.get(rid)
        if route is None:
            raise KeyError(f"unknown request {rid}")
        return rid, route

    def _translate(self, rid: int, route: dict, row: dict | None) -> dict | None:
        """A member status row under the router's rid. Only TERMINAL rows
        are cached: a kept request's harvested-but-parked row still
        changes state (park -> spill -> restore), so caching it would
        serve stale rows — and would hide it from failover adoption."""
        if row is None:
            return None
        row = dict(row)
        row["request_id"] = rid
        row["engine"] = route["member"]
        if row["state"] in ("done", "cancelled"):
            route["cached"] = row
            self._settle(route)
        return row

    def _settle(self, route: dict) -> None:
        if route["open"]:
            route["open"] = False
            mid = route["member"]
            if mid in self._inflight and self._inflight[mid] > 0:
                self._inflight[mid] -= 1

    async def _wait(self, op: dict) -> dict:
        rid, route = self._route(op)
        while True:
            if route["cached"] is not None:
                return {"ok": True, "status": route["cached"]}
            mid = route["member"]
            if mid not in self.alive:
                await self._await_failover(mid)
                continue
            member = self.members[mid]
            try:
                # A wait parks for the request's whole service time: it
                # gets its own connection so the member's control channel
                # stays free for short ops (loadgen's pattern).
                c = await ServeClient.connect(member.host, member.port)
                try:
                    row = await c.wait(route["member_rid"])
                finally:
                    await c.close()
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                await self._fail_member(mid)
                continue
            if route["member"] != mid:
                continue  # moved while we waited; re-issue on the survivor
            return {"ok": True, "status": self._translate(rid, route, row)}

    async def _status(self, op: dict) -> dict:
        if op.get("request_id") is None:
            rows = []
            for rid, route in self._routes.items():
                rows.append(route["cached"] or {
                    "request_id": rid, "state": "remote",
                    "engine": route["member"],
                })
            return {"ok": True, "status": rows}
        rid, route = self._route(op)
        if route["cached"] is not None:
            return {"ok": True, "status": route["cached"]}
        mid = route["member"]
        if mid not in self.alive:
            await self._await_failover(mid)
            return await self._status(op)
        try:
            resp = await self._member_rpc(
                mid, op="status", request_id=route["member_rid"]
            )
        except ConnectionError:
            return await self._status(op)
        return {"ok": True,
                "status": self._translate(rid, route, resp["status"])}

    async def _forward_simple(self, name: str, op: dict) -> dict:
        """cancel/restore/resume: forward under the member rid; a dead
        member triggers failover and the op retries on the new route."""
        rid, route = self._route(op)
        while True:
            mid = route["member"]
            if mid not in self.alive:
                await self._await_failover(mid)
                if route["member"] not in self.alive:
                    # Failover resolved this route from the journal (or
                    # had no survivor): there is no live lane to act on.
                    if name == "cancel":
                        return {"ok": True, "cancelled": False}
                    raise ValueError(
                        f"request {rid} resolved from a dead engine's "
                        f"journal; nothing to {name}"
                    )
                continue
            kw = {k: op[k] for k in ("mode", "ticks") if k in op}
            try:
                resp = await self._member_rpc(
                    mid, op=name, request_id=route["member_rid"], **kw
                )
            except ConnectionError:
                continue
            if name == "cancel" and resp.get("cancelled"):
                route["cached"] = {
                    "request_id": rid, "state": "cancelled",
                    "engine": mid,
                }
                self._settle(route)
            if name == "resume":
                # The continuation's harvest replaces any cached result.
                route["cached"] = None
                if not route["open"]:
                    route["open"] = True
                    self._inflight[mid] += 1
            resp.pop("request_id", None)
            return resp

    async def _stats(self) -> dict:
        per_member = {}
        for mid in list(self.alive):
            try:
                resp = await self._member_rpc(mid, op="stats")
                per_member[mid] = resp["stats"]
            except ConnectionError:
                continue
        return {"ok": True, "stats": {
            "router": True,
            "members": sorted(self.members),
            "alive": sorted(self.alive),
            "routes": len(self._routes),
            "inflight": dict(self._inflight),
            "per_member": per_member,
        }}

    # -- failover ----------------------------------------------------------

    async def _await_failover(self, mid: str) -> None:
        fut = self._failing.get(mid)
        if fut is not None:
            await fut

    async def _fail_member(self, mid: str) -> None:
        """Declare ``mid`` dead exactly once and re-home its routes.

        Concurrent callers (every op that hit the broken socket) await
        the one in-progress failover future instead of racing the
        replay."""
        if mid not in self.alive:
            await self._await_failover(mid)
            return
        fut = asyncio.get_running_loop().create_future()
        self._failing[mid] = fut
        try:
            self.alive.discard(mid)
            self.ring.remove(mid)
            self._lane_stats.pop(mid, None)
            self.metrics.inc("fed_failovers_total")
            conn = self._conns.pop(mid, None)
            if conn is not None:
                await conn.close()
            table: dict[int, dict] = {}
            if self.journal_root is not None:
                try:
                    table, _ = replay_journal(
                        os.path.join(self.journal_root, mid)
                    )
                except (OSError, ValueError):
                    table = {}
            for rid, route in list(self._routes.items()):
                if route["member"] != mid or route["cached"] is not None:
                    continue
                await self._rehome(rid, route, table.get(route["member_rid"]))
        finally:
            fut.set_result(None)
            del self._failing[mid]

    async def _rehome(self, rid: int, route: dict, jrow: dict | None) -> None:
        """One dead route's disposition, from the dead engine's journal:
        journaled results are final (replayed-never), durable spills are
        adopted, the rest re-runs from seed with cumulative ticks."""
        dead = route["member"]
        jrow = jrow or {}
        result = jrow.get("result")
        # 1. Terminal cancel in the journal: final, never re-run.
        if jrow.get("op") in ("cancelled", "shed"):
            route["cached"] = {"request_id": rid, "state": "cancelled",
                              "engine": dead}
            self._settle(route)
            return
        self._settle(route)  # the dead engine's inflight slot is gone
        # 2. Durable spill: adopt the file onto a survivor. A kept
        # request may carry BOTH a harvested result and a spill file —
        # the result answers the outstanding wait, the adoption keeps
        # restore/resume live on the survivor, so both are applied.
        req = jrow.get("req") or dict(route["fields"])
        spill_path = jrow.get("spill_path")
        if spill_path and os.path.exists(spill_path):
            owner = jrow.get("spill_owner") or dead
            try:
                mid = self._place(route["key"], route["n_class"])
                resp = await self._member_rpc(
                    mid, op="adopt", spill_path=spill_path,
                    saved_run=jrow.get("saved_run"), owner=owner,
                    **{k: v for k, v in req.items() if k in _REQ_FIELDS},
                )
                route.update(member=mid, member_rid=int(resp["request_id"]),
                             open=False)
                self.metrics.inc("fed_rebalance_moves_total")
                if result is not None:
                    route["cached"] = {
                        "request_id": rid, "state": "done", "engine": mid,
                        "n": route["fields"].get("n"),
                        "n_class": route["n_class"], "result": result,
                    }
                return
            except (ConnectionError, ServeError, ValueError):
                pass  # fall through: the result (if any) is still final
        # 3. Harvested result without an adoptable file: the answer is in
        # the journal — serve it forever, never recompute it.
        if result is not None:
            route["cached"] = {
                "request_id": rid, "state": "done", "engine": dead,
                "n": route["fields"].get("n"),
                "n_class": route["n_class"], "result": result,
            }
            return
        # 4. Lost with the process: re-run from the seed, cumulative budget.
        fields = {k: v for k, v in req.items() if k in _REQ_FIELDS}
        extra = int(jrow.get("extra_ticks", 0))
        if extra:
            fields["ticks"] = int(fields.get("ticks", 64)) + extra
        while self.alive:
            try:
                mid = self._place(route["key"], route["n_class"])
                resp = await self._member_rpc(mid, op="submit", **fields)
            except ConnectionError:
                continue
            except ValueError:
                break  # no survivor serves this class
            route.update(member=mid, member_rid=int(resp["request_id"]),
                         open=True)
            self._inflight[mid] += 1
            self.metrics.inc("fed_rebalance_moves_total")
            self.metrics.inc("fed_submits_total", engine=mid)
            return
        route["cached"] = {"request_id": rid, "state": "cancelled",
                           "engine": dead, "error": "no survivor"}

    # -- wire front door ---------------------------------------------------

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
                    resp = await self._dispatch(op)
                except ConnectionError as e:
                    # Mid-failover: tell the client when to come back
                    # rather than holding its whole line behind a replay.
                    resp = {"ok": False, "error": str(e),
                            "kind": "failover",
                            "retry_after_s": _RETRY_AFTER_S}
                except Exception as e:
                    resp = _error_response(e)
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        finally:
            self._conn_writers.discard(writer)
            writer.close()

    async def _dispatch(self, op: dict) -> dict:
        name = op.get("op")
        if name == "submit":
            return await self._submit(op)
        if name == "wait":
            return await self._wait(op)
        if name == "status":
            return await self._status(op)
        if name in ("cancel", "restore", "resume"):
            return await self._forward_simple(name, op)
        if name == "stats":
            return await self._stats()
        if name == "metrics":
            return {"ok": True, "metrics": self.metrics.collect()}
        if name == "shutdown":
            self._closed.set()
            return {"ok": True, "bye": True}
        return {"ok": False, "error": f"unknown op {name!r}",
                "kind": "bad_request"}

    async def _handle_metrics_http(self, reader, writer) -> None:
        """Prometheus text scrape, server.py's stdlib-only shape."""
        try:
            while (await reader.readline()).strip():
                pass
            body = self.metrics.to_prometheus().encode()
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


def parse_members(spec: str) -> list[EngineMember]:
    """``e0=127.0.0.1:7501,e1=127.0.0.1:7502`` -> members (the
    ``serve --federated`` flag grammar)."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        eid, _, addr = tok.partition("=")
        host, _, port = addr.rpartition(":")
        if not eid or not host or not port:
            raise ValueError(
                f"bad member {tok!r} (want id=host:port)"
            )
        out.append(EngineMember(eid, host, int(port)))
    return out
