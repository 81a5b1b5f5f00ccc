"""Real-network ``Kaboodle`` facade over the native C++ engine.

The same consumer surface as :class:`kaboodle_tpu_torch.api.Kaboodle` (which runs on
the simulated mesh), but backed by real UDP sockets: actual wire-format
interop with reference instances on a LAN (lib.rs:78-369). Where the sim
facade's clock is ``SimNetwork.tick()``, here the protocol thread runs on
wall-clock; event streams fill when :meth:`poll_events` drains the engine.
"""

from __future__ import annotations

import collections
import time

from kaboodle_tpu_torch.errors import InvalidOperation
from kaboodle_tpu_torch.transport.native import NativeEngine, best_interface, probe_mesh


class RealKaboodle:
    """One real mesh instance bound to a network interface.

    ``interface_ip``/``broadcast_ip`` default to the reference's interface
    policy (networking.rs:12-23) with IPv4 broadcast; pass a ``ff02::...``
    group + iface index for the IPv6 multicast path. Timing parameters are
    forwarded to the engine (defaults are the reference's wall-clock values).
    """

    def __init__(
        self,
        identity: bytes = b"",
        broadcast_port: int = 7475,
        interface_ip: str | None = None,
        broadcast_ip: str = "255.255.255.255",
        iface_index: int = 0,
        **engine_kwargs,
    ):
        if interface_ip is None:
            interface_ip, iface_index = best_interface()
        self._identity = identity
        self._engine = NativeEngine(
            bind_ip=interface_ip,
            broadcast_ip=broadcast_ip,
            broadcast_port=broadcast_port,
            iface_index=iface_index,
            identity=identity,
            **engine_kwargs,
        )
        self._interface_ip = interface_ip
        self._discover_subs: list[collections.deque] = []
        self._depart_subs: list[collections.deque] = []
        self._fp_subs: list[collections.deque] = []

    # ---- lifecycle (lib.rs:136-183) ---------------------------------------

    def start(self) -> None:
        if self._engine.is_running:
            raise InvalidOperation("already running")
        self._engine.start()

    def stop(self) -> None:
        if not self._engine.is_running:
            raise InvalidOperation("not running")
        self._engine.stop()

    @property
    def is_running(self) -> bool:
        return self._engine.is_running

    def close(self) -> None:
        self._engine.close()

    # ---- addressing --------------------------------------------------------

    def self_addr(self) -> str:
        return self._engine.self_addr()

    def interface(self) -> str:
        return self._interface_ip

    # ---- queries -----------------------------------------------------------

    def peers(self) -> dict[str, bytes]:
        return {a: e["identity"] for a, e in self._engine.peers().items()}

    def peer_states(self) -> dict[str, tuple[str, float | None]]:
        """addr -> (state name, latency EWMA ms) (lib.rs:348-354)."""
        return {
            a: (e["state"], e["latency_ms"]) for a, e in self._engine.peers().items()
        }

    def fingerprint(self) -> int:
        """Reference-exact CRC-32 mesh fingerprint (kaboodle.rs:71-83)."""
        return self._engine.fingerprint()

    # ---- identity / manual pings ------------------------------------------

    def set_identity(self, identity: bytes) -> None:
        self._identity = identity
        self._engine.set_identity(identity)

    def ping_addrs(self, addrs) -> None:
        if not self._engine.is_running:
            raise InvalidOperation("not running")
        for a in addrs:
            self._engine.ping_addr(a)

    # ---- event streams -----------------------------------------------------

    def discover_peers(self):
        q: collections.deque = collections.deque()
        self._discover_subs.append(q)
        return q

    def discover_departures(self):
        q: collections.deque = collections.deque()
        self._depart_subs.append(q)
        return q

    def discover_fingerprint_changes(self):
        q: collections.deque = collections.deque()
        self._fp_subs.append(q)
        return q

    def discover_next_peer(self, timeout_s: float = 64.0):
        """Wait until the next peer discovery; returns (addr, identity) or
        None on timeout (lib.rs:246-260 — wall-clock twin of the sim facade)."""
        if not self._engine.is_running:
            raise InvalidOperation("not running")
        q = self.discover_peers()
        try:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                self.poll_events()
                if q:
                    return q.popleft()
                time.sleep(0.02)
            return None
        finally:
            self._discover_subs.remove(q)

    def poll_events(self) -> int:
        """Drain engine events into the subscriber streams; returns the count.
        (The CLI calls this once per display refresh, main.rs:144-244.)"""
        events = self._engine.drain_events()
        for e in events:
            if e["type"] == "discovered":
                for q in self._discover_subs:
                    q.append((e["addr"], e["identity"]))
            elif e["type"] == "departed":
                for q in self._depart_subs:
                    q.append(e["addr"])
            elif e["type"] == "fingerprint":
                for q in self._fp_subs:
                    q.append(e["value"])
        return len(events)


def discover_mesh_member(
    broadcast_port: int = 7475,
    interface_ip: str | None = None,
    broadcast_ip: str = "255.255.255.255",
    iface_index: int = 0,
    total_timeout_ms: int = 30000,
    **probe_kwargs,
) -> tuple[str, bytes] | None:
    """Probe for any mesh member without joining (lib.rs:359-368).
    ``total_timeout_ms=0`` retries forever like the reference; the default
    deadline is a library-convenience deviation (PARITY.md)."""
    if interface_ip is None:
        interface_ip, iface_index = best_interface()
    return probe_mesh(
        bind_ip=interface_ip,
        broadcast_ip=broadcast_ip,
        broadcast_port=broadcast_port,
        iface_index=iface_index,
        total_timeout_ms=total_timeout_ms,
        **probe_kwargs,
    )
