"""asyncio client for the serve server (plus a one-shot sync helper).

The port's copy of ``kaboodle_tpu/serve/client.py`` (stdlib only): the same
wire protocol, so either package's client talks to either package's server.

One :class:`ServeClient` is one TCP connection running sequential
request/response ops; :meth:`ServeClient.open_stream` opens a SECOND
connection switched into live-event mode and yields manifest records as
they arrive (the stream ack is awaited before returning, so records for
work submitted after ``open_stream`` can never be missed).

Failure surface: a server-side op error raises :class:`ServeError`
carrying the structured ``kind`` (``queue_full`` / ``quota`` /
``bad_request`` / ``checkpoint`` / ``failover`` / ``internal``) and
``retry_after_s`` when the server supplied one. Every op takes
``timeout=`` seconds (None = unbounded) and raises a clean
:class:`TimeoutError` — after which THIS connection is desynchronized (a
late response may still be in flight) and refuses further ops; open a
fresh client. ``submit`` can retry ``queue_full``/``quota`` rejections
with backoff honoring the server's retry-after.

Reconnect (``reconnect=True``): when the transport breaks mid-op — the
server restarted, a federation router failed an engine over, a proxy
dropped the connection — the client re-dials with exponential backoff
and transparently re-sends the op, but ONLY for ops that are safe to
repeat (``_IDEMPOTENT``: a re-sent ``wait`` just waits again, a re-sent
``cancel`` reports already-cancelled). ``submit`` is never auto-resent:
the break may have landed after the server admitted the request, and a
blind re-send would run it twice. Request ids survive the reconnect
(server-side state), so a ``wait`` parked across a restart resumes by
rid on the fresh connection.
"""

from __future__ import annotations

import asyncio
import json

# Ops safe to re-send on a fresh connection after a transport break:
# re-executing any of these cannot double-run a simulation.
_IDEMPOTENT = frozenset(
    {"status", "wait", "stats", "metrics", "cancel", "restore", "resume"}
)


class ServeError(RuntimeError):
    """A structured op failure from the server."""

    def __init__(self, message: str, kind: str = "internal",
                 retry_after_s: float = 0.0) -> None:
        super().__init__(message)
        self.kind = kind
        self.retry_after_s = float(retry_after_s)


class ServeStream:
    """A live-event connection: async-iterate manifest records."""

    def __init__(self, reader, writer) -> None:
        self._reader = reader
        self._writer = writer

    def __aiter__(self) -> "ServeStream":
        return self

    async def __anext__(self) -> dict:
        line = await self._reader.readline()
        if not line:
            raise StopAsyncIteration
        return json.loads(line)

    async def close(self) -> None:
        self._writer.close()


class ServeClient:
    """Sequential JSON-over-TCP ops against a :class:`ServeServer`."""

    def __init__(self, host: str, port: int, reader, writer,
                 reconnect: bool = False, redial_max: int = 8,
                 redial_backoff: float = 0.05) -> None:
        self.host = host
        self.port = port
        self._reader = reader
        self._writer = writer
        self._desynced = False
        self.reconnect = bool(reconnect)
        self.redial_max = int(redial_max)
        self.redial_backoff = float(redial_backoff)

    @classmethod
    async def connect(cls, host: str = "127.0.0.1", port: int = 7447,
                      reconnect: bool = False, redial_max: int = 8,
                      redial_backoff: float = 0.05):
        reader, writer = await asyncio.open_connection(host, port)
        return cls(host, port, reader, writer, reconnect=reconnect,
                   redial_max=redial_max, redial_backoff=redial_backoff)

    async def _redial(self) -> None:
        """Re-establish the transport with exponential backoff (the
        server may be mid-restart; each retry doubles the sleep). A
        fresh connection has clean request/response pairing, so an
        earlier timeout's desync is cleared."""
        last: Exception = ConnectionError("redial")
        for attempt in range(self.redial_max):
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port
                )
                self._desynced = False
                return
            except OSError as e:
                last = e
                await asyncio.sleep(self.redial_backoff * (2 ** attempt))
        raise ConnectionError(
            f"could not reconnect to {self.host}:{self.port} after "
            f"{self.redial_max} attempts"
        ) from last

    async def _rpc(self, timeout: float | None = None, **op) -> dict:
        """One request/response op, with transparent reconnect for
        idempotent ops when enabled. A break during a non-idempotent op
        (``submit``) always surfaces — the server may have applied it."""
        retriable = self.reconnect and op.get("op") in _IDEMPOTENT
        while True:
            try:
                return await self._rpc_once(timeout=timeout, **op)
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                if not retriable:
                    raise
                retriable = False  # one transparent repeat per op
                await self._redial()

    async def _rpc_once(self, timeout: float | None = None, **op) -> dict:
        if self._desynced:
            if self.reconnect:
                await self._redial()
            else:
                raise ConnectionError(
                    "connection desynchronized by an earlier timeout; "
                    "reconnect"
                )
        self._writer.write(json.dumps(op).encode() + b"\n")
        await self._writer.drain()
        try:
            if timeout is None:
                line = await self._reader.readline()
            else:
                line = await asyncio.wait_for(
                    self._reader.readline(), timeout
                )
        except asyncio.TimeoutError:
            # The response (if any) is still in flight; this connection's
            # request/response pairing is broken from here on.
            self._desynced = True
            raise TimeoutError(
                f"op {op.get('op')!r} timed out after {timeout}s"
            ) from None
        if not line:
            raise ConnectionError("server closed the connection")
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ServeError(
                resp.get("error", "server error"),
                kind=resp.get("kind", "internal"),
                retry_after_s=resp.get("retry_after_s", 0.0),
            )
        return resp

    async def submit(self, n: int, timeout: float | None = None,
                     retries: int = 0, backoff: float = 0.05,
                     **fields) -> int:
        """Submit a request; returns its request id. Fields mirror
        :class:`~kaboodle_tpu_torch.serve.engine.ServeRequest` (seed, mode,
        ticks, drop_rate, scenario, keep, tenant, priority).

        ``retries`` re-attempts ``queue_full``/``quota`` rejections,
        sleeping the server's ``retry_after_s`` when it gave one (else
        exponential ``backoff`` doublings) — other error kinds re-raise
        immediately; retrying a ``bad_request`` would never succeed."""
        attempt = 0
        while True:
            try:
                resp = await self._rpc(timeout=timeout, op="submit", n=n,
                                       **fields)
                return resp["request_id"]
            except ServeError as e:
                if e.kind not in ("queue_full", "quota") or attempt >= retries:
                    raise
                delay = e.retry_after_s or backoff * (2 ** attempt)
                attempt += 1
                await asyncio.sleep(delay)

    async def status(self, request_id: int | None = None,
                     timeout: float | None = None):
        resp = await self._rpc(timeout=timeout, op="status",
                               request_id=request_id)
        return resp["status"]

    async def wait(self, request_id: int,
                   timeout: float | None = None) -> dict:
        """Block until the request is terminal; returns its status row
        (the harvest result included). ``timeout`` seconds bounds the
        block with a clean :class:`TimeoutError`."""
        resp = await self._rpc(timeout=timeout, op="wait",
                               request_id=request_id)
        return resp["status"]

    async def cancel(self, request_id: int,
                     timeout: float | None = None) -> bool:
        resp = await self._rpc(timeout=timeout, op="cancel",
                               request_id=request_id)
        return resp["cancelled"]

    async def restore(self, request_id: int,
                      timeout: float | None = None) -> bool:
        resp = await self._rpc(timeout=timeout, op="restore",
                               request_id=request_id)
        return resp["restored"]

    async def resume(self, request_id: int, mode: str = "ticks",
                     ticks: int = 16, timeout: float | None = None) -> None:
        await self._rpc(timeout=timeout, op="resume",
                        request_id=request_id, mode=mode, ticks=ticks)

    async def adopt(self, n: int, spill_path: str,
                    saved_run: dict | None = None,
                    owner: str | None = None,
                    timeout: float | None = None, **fields) -> int:
        """Federation failover handover: hand a dead engine's spilled
        request (file + frozen run counters + owner stamp) to this
        engine. Returns the adopting engine's fresh request id."""
        resp = await self._rpc(timeout=timeout, op="adopt", n=n,
                               spill_path=spill_path, saved_run=saved_run,
                               owner=owner, **fields)
        return resp["request_id"]

    async def stats(self, timeout: float | None = None) -> dict:
        resp = await self._rpc(timeout=timeout, op="stats")
        return resp["stats"]

    async def metrics(self, timeout: float | None = None) -> dict:
        """The metrics-plane snapshot (``MetricsRegistry.collect()``):
        counters, pull-gauges and histograms. Requires a server started
        with ``--obs`` — otherwise a ``bad_request`` ServeClientError."""
        resp = await self._rpc(timeout=timeout, op="metrics")
        return resp["metrics"]

    async def shutdown(self) -> None:
        self._writer.write(json.dumps({"op": "shutdown"}).encode() + b"\n")
        await self._writer.drain()
        await self._reader.readline()  # the bye ack

    async def open_stream(self) -> ServeStream:
        """A NEW connection in live-event mode (awaits the ack, so the
        subscription is active before this returns)."""
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.write(json.dumps({"op": "stream"}).encode() + b"\n")
        await writer.drain()
        ack = json.loads(await reader.readline())
        if not ack.get("streaming"):
            raise RuntimeError(f"stream handshake failed: {ack}")
        return ServeStream(reader, writer)

    async def close(self) -> None:
        self._writer.close()


def run_one(n: int, host: str = "127.0.0.1", port: int = 7447,
            **fields) -> dict:
    """Synchronous one-shot: connect, submit, wait, return the status row."""

    async def go() -> dict:
        client = await ServeClient.connect(host, port)
        try:
            rid = await client.submit(n, **fields)
            return await client.wait(rid)
        finally:
            await client.close()

    return asyncio.run(go())
