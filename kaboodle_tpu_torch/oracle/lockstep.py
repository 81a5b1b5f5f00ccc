"""Deterministic lockstep mesh: N oracle engines + in-memory transport.

This harness defines the framework's discrete-time delivery model — the
executable contract that the port's tick (kaboodle_tpu_torch.sim) reproduces
tensor-wise. One tick is the reference protocol period (kaboodle.rs:746-779):
the active half runs first, then request/reply chains resolve *within* the
tick in a fixed number of delivery rounds, mirroring the reference's reactive
half where a ping and its ack complete inside one 1-second period
(kaboodle.rs:762-778). See SEMANTICS.md for the full round model.

Round structure per tick t:
  A  active phase: join/failed broadcasts + Pings + PingRequests queued
  B  broadcast delivery (Join/Failed/Probe) -> join-response KnownPeers queued
  C  delivery: Ping -> Ack queued; PingRequest -> proxy Ping queued
  D  delivery: Ack (direct), proxy Ping -> Ack queued, join-response KnownPeers
  E  delivery: proxy's Ack from target -> forwarded Acks queued
  F  delivery: forwarded Acks
  G  anti-entropy: each peer resolves <= 1 KnownPeersRequest (deviation D2);
     request + filtered reply resolve within the round
Within each round: all sender-marks (Q1) are applied first, then mutating
messages (Ack, KnownPeers), then reply-generating ones (KnownPeersRequest,
Ping, PingRequest), each in sender-address order — the same serialization the
vectorized kernel implements.

Delivery faults (drop masks, partitions, dead peers) gate every delivery via
``delivery_ok``; a dead peer neither acts, receives, nor replies. The
port's own copy of the JAX package's module (it imports nothing of it).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.oracle.engine import (
    Ack,
    Join,
    KnownPeersMsg,
    KnownPeersRequest,
    PeerEngine,
    Ping,
    PingRequest,
    ProbeResponse,
    addr_key,
)

# Dispatch ordering within a round: mutators before repliers (see module doc).
_TYPE_ORDER = {
    Ack: 0,
    KnownPeersMsg: 1,
    KnownPeersRequest: 2,
    Ping: 3,
    PingRequest: 4,
    ProbeResponse: 5,
}


class LockstepMesh:
    """N simulated peers with integer addresses 0..N-1 gossiping in lockstep."""

    def __init__(
        self,
        n: int,
        cfg: Optional[SwimConfig] = None,
        identities: Optional[list[int]] = None,
        delivery_ok: Optional[Callable[[int, int, int], bool]] = None,
        seed: int = 0,
        alive: Optional[list[bool]] = None,
        ring_contacts: int = 0,
    ) -> None:
        self.n = n
        self.cfg = cfg or SwimConfig()
        self.identities = list(identities) if identities else [i + 1 for i in range(n)]
        self.tick_count = 0
        self._seed = seed
        # delivery_ok(sender, receiver, tick) gates unicasts and broadcasts.
        self.delivery_ok = delivery_ok or (lambda s, r, t: True)
        self.alive = list(alive) if alive else [True] * n
        self.engines: list[PeerEngine] = [
            PeerEngine(i, self.identities[i], self.cfg, now=0, seed=seed * 100003 + i)
            for i in range(n)
        ]
        # Gossip-boot seed contacts (init_state(ring_contacts=...) twin): peer
        # i additionally knows peers (i+1..i+c) mod n as Known(0).
        if ring_contacts:
            if ring_contacts >= n:
                raise ValueError("ring_contacts must be < n")
            from kaboodle_tpu_torch.oracle.engine import PeerRecord
            from kaboodle_tpu_torch.spec import KNOWN

            for i, eng in enumerate(self.engines):
                for d in range(1, ring_contacts + 1):
                    j = (i + d) % n
                    eng.known[j] = PeerRecord(self.identities[j], KNOWN, 0)
        # Message log of the current tick, for tests/metrics.
        self.last_tick_messages = 0
        # Telemetry tallies of the current tick: the oracle side of the
        # ProtocolCounters parity contract (kaboodle_tpu_torch/telemetry/counters.py
        # for the definitions; tests/test_torch_oracle.py pins the tick == this).
        self.last_tick_counters: dict[str, int] = {}

    # --- churn ---------------------------------------------------------------

    def kill(self, i: int) -> None:
        """Silent leave (quirk Q8: stop() does not announce departure)."""
        self.alive[i] = False

    def revive(self, i: int, identity: Optional[int] = None) -> None:
        """Rejoin with fresh state: the peer knows only itself and will
        broadcast Join on its next active phase (kaboodle.rs:228-251)."""
        if identity is not None:
            self.identities[i] = identity
        self.alive[i] = True
        # Fresh RNG stream derived from the mesh seed, disjoint from the
        # constructor's streams (seed*100003 + i, i < n) and from earlier
        # revivals of the same peer.
        self.engines[i] = PeerEngine(
            i,
            self.identities[i],
            self.cfg,
            now=self.tick_count,
            seed=self._seed * 100003 + (self.tick_count + 1) * self.n + i,
        )

    # --- delivery plumbing ---------------------------------------------------

    def _deliver_round(self, unicasts: list[tuple[int, int, object]], now: int) -> list:
        """Deliver one round of (sender, dest, msg); returns next round's sends."""
        delivered: list[tuple[int, int, object]] = []
        for sender, dest, msg in unicasts:
            if not (0 <= dest < self.n) or not self.alive[dest] or not self.alive[sender]:
                continue
            if dest == sender:
                # D8: the in-memory transport does not loop back self-sends
                # (reachable only via a manual self-ping; real UDP would).
                continue
            if not self.delivery_ok(sender, dest, now):
                continue
            delivered.append((sender, dest, msg))
        self.last_tick_messages += len(delivered)

        # Pass 1: marks (Q1), any inbound datagram resurrects its sender.
        for sender, dest, _msg in delivered:
            self.engines[dest].mark_sender(sender, self.engines[sender].identity, now)

        # Pass 2: dispatch in (type order, sender order) per receiver.
        delivered.sort(key=lambda x: (x[1], _TYPE_ORDER[type(x[2])], addr_key(x[0])))
        next_round: list[tuple[int, int, object]] = []
        for sender, dest, msg in delivered:
            out = self.engines[dest].dispatch_unicast(sender, msg, now)
            next_round.extend((dest, d, m) for d, m in out.unicasts)
            assert not out.broadcasts
        return next_round

    def _deliver_broadcasts(self, broadcasts: list[tuple[int, object]], now: int) -> list:
        """Deliver broadcasts to every alive peer (including the origin, whose
        engine skips its own Join/Failed, kaboodle.rs:269-273, 285-287)."""
        next_round: list[tuple[int, int, object]] = []
        for origin, msg in broadcasts:
            if not self.alive[origin]:
                continue
            for r in range(self.n):
                if not self.alive[r] or not self.delivery_ok(origin, r, now):
                    continue
                # Real broadcasts arrive from the broadcast socket's address,
                # which is never a member (quirk Q3): origin=None models that.
                out = self.engines[r].on_broadcast(None, msg, now)
                next_round.extend((r, d, m) for d, m in out.unicasts)
                assert not out.broadcasts
        return next_round

    # --- the tick ------------------------------------------------------------

    def tick(self) -> None:
        now = self.tick_count
        self.last_tick_messages = 0
        # Pre-tick snapshot for the pre/post telemetry counters. Callers
        # apply kill/revive *before* tick(), so this is the post-churn state
        # — the same S0 the kernel's counters snapshot.
        pre_state = self.state_matrix()
        gossip_records = 0

        # A: active phase.
        for eng in self.engines:
            eng.last_escalated = 0
            eng.last_removed = 0
        broadcasts: list[tuple[int, object]] = []
        round1: list[tuple[int, int, object]] = []
        for i, eng in enumerate(self.engines):
            if not self.alive[i]:
                continue
            out = eng.active_phase(now)
            broadcasts.extend((i, b) for b in out.broadcasts)
            round1.extend((i, d, m) for d, m in out.unicasts)

        def n_sent(msgs, typ):
            return sum(1 for (_, _, m) in msgs if isinstance(m, typ))

        c = {
            "suspicions_raised": sum(e.last_escalated for e in self.engines),
            "deaths_declared": sum(e.last_removed for e in self.engines),
            # "Sent" counts datagrams entering the transport, post the D8
            # validity filter (self-sends / out-of-range never enter it) —
            # matching the kernel's ``man_tgt`` gate; random and proxy pings
            # are valid by construction.
            "pings_sent": sum(
                1
                for (s, d, m) in round1
                if isinstance(m, Ping) and 0 <= d < self.n and d != s
            ),
            "ping_reqs_sent": n_sent(round1, PingRequest),
        }

        # B: broadcast delivery; join responses land with round 2. Each
        # engine's D5 snapshot (start-of-round membership + joins accepted so
        # far) is what the aligned share-cap trims against.
        for eng in self.engines:
            eng._round_base = {a: r.identity for a, r in eng.known.items()}
            eng._round_joins = []
        join_responses = self._deliver_broadcasts(broadcasts, now)
        # Join dissemination: deliveries of Join datagrams (origin != self;
        # the same gates _deliver_broadcasts applies).
        c["joins_disseminated"] = sum(
            sum(
                1
                for r in range(self.n)
                if r != origin
                and self.alive[r]
                and self.delivery_ok(origin, r, now)
            )
            for origin, msg in broadcasts
            if isinstance(msg, Join) and self.alive[origin]
        )
        gossip_records += sum(
            len(m.peers) for (_, _, m) in join_responses
            if isinstance(m, KnownPeersMsg)
        )

        # C..F: four unicast delivery rounds resolve the ping / ping-req /
        # ack / forwarded-ack chains within the tick.
        round2 = self._deliver_round(round1, now)
        round3 = self._deliver_round(round2 + join_responses, now)
        round4 = self._deliver_round(round3, now)
        leftovers = self._deliver_round(round4, now)
        # The chain is at most 4 deep (ping-req -> proxy ping -> ack ->
        # forwarded ack); anything further would break kernel parity.
        assert not leftovers, f"unexpected round-5 messages: {leftovers}"
        # Proxy pings dispatch on a delivered PingRequest (round 2); acks on
        # any delivered ping, plus call-3 coincidence pops and call-4 relays.
        c["pings_sent"] += n_sent(round2, Ping)
        c["acks_sent"] = (
            n_sent(round2, Ack) + n_sent(round3, Ack) + n_sent(round4, Ack)
        )

        # G: anti-entropy resolution (deviation D2: <= 1 request per peer).
        requests: list[tuple[int, int, KnownPeersRequest]] = []
        for i, eng in enumerate(self.engines):
            if not self.alive[i]:
                eng._sync_candidates = []
                continue
            req = eng.take_sync_request()
            if req is not None:
                partner, msg = req
                requests.append((i, partner, msg))
        replies = self._deliver_round(requests, now)
        final = self._deliver_round(replies, now)
        assert all(isinstance(m, KnownPeersMsg) for (_, _, m) in replies)
        assert not final
        gossip_records += sum(len(m.peers) for (_, _, m) in replies)

        # D3: curious-peer relay entries do not outlive the tick (the kernel
        # resolves the whole indirect-ping chain in-tick and stores nothing).
        for eng in self.engines:
            eng.curious.clear()

        # Pre/post counters + the modeled gossip byte total (RECORD_BYTES
        # per (addr, identity) record, modular uint32 like the kernel's).
        post_state = self.state_matrix()
        from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
        from kaboodle_tpu_torch.telemetry.counters import RECORD_BYTES

        c["suspicions_refuted"] = int(
            (
                (pre_state == WAITING_FOR_INDIRECT_PING) & (post_state == KNOWN)
            ).sum()
        )
        alive_rows = np.asarray(self.alive, dtype=bool)[:, None]
        c["armed_timers"] = int(
            (
                alive_rows
                & (
                    (post_state == WAITING_FOR_PING)
                    | (post_state == WAITING_FOR_INDIRECT_PING)
                )
            ).sum()
        )
        c["gossip_bytes"] = (RECORD_BYTES * gossip_records) % (1 << 32)
        self.last_tick_counters = c

        self.tick_count += 1

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.tick()

    # --- observers -----------------------------------------------------------

    def fingerprints(self) -> list[int]:
        return [e.fingerprint() for e in self.engines]

    def converged(self) -> bool:
        """All alive peers agree on the mesh fingerprint (the reference's
        convergence signal, README.md:19-29)."""
        fps = {e.fingerprint() for e, a in zip(self.engines, self.alive) if a}
        return len(fps) <= 1

    def state_matrix(self) -> np.ndarray:
        """int8 [N, N] of spec state codes: row i = peer i's view."""
        m = np.zeros((self.n, self.n), dtype=np.int8)
        for i, eng in enumerate(self.engines):
            for a, rec in eng.known.items():
                if isinstance(a, int) and 0 <= a < self.n:
                    m[i, a] = rec.state
        return m

    def timer_matrix(self) -> np.ndarray:
        """int32 [N, N] of state timestamps (ticks); 0 where not a member."""
        m = np.zeros((self.n, self.n), dtype=np.int32)
        for i, eng in enumerate(self.engines):
            for a, rec in eng.known.items():
                if isinstance(a, int) and 0 <= a < self.n:
                    m[i, a] = int(rec.since)
        return m
