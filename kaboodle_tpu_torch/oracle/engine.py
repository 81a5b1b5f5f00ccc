"""One SWIM peer's state machine — a faithful re-expression of kaboodle.rs.

Transport-agnostic and clock-agnostic: every entry point takes ``now`` (ticks
in the simulator, seconds against a wall clock in the real transport) and
returns an :class:`Outbox` of messages to deliver. Citations are to the
reference's src/kaboodle.rs unless noted. The port's own copy of the JAX
package's module (it imports nothing of it).

Semantics preserved exactly (SURVEY.md §8 quirk numbers):
- Q1: ANY inbound unicast marks its sender Known(now) before dispatch
  (kaboodle.rs:408-415) — the only mechanism that clears suspicion.
- Q11 (faithful_indirect_ack): a forwarded indirect-ping Ack resurrects the
  *proxy* that forwarded it, not the suspect named inside it.
- Q3 (faithful_failed_broadcast): Failed broadcasts require the broadcast
  source address to be a known member, which never holds for real sockets
  (kaboodle.rs:268-283) — so they are inert by default.
- Q5: join-triggered shares send the whole map (self included, no age filter,
  kaboodle.rs:362-369); KnownPeersRequest replies filter by Known-state,
  10-tick age, and exclude self+requester (kaboodle.rs:483-501).
- Q6: gossip-learned peers are inserted back-dated by MAX_PEER_SHARE_AGE so
  they are never re-shared before direct contact (kaboodle.rs:459-470).
- Q8: stop() does not announce departure (lib.rs:159-183).

Documented deviations from the reference (see PARITY.md):
- D1: at most one WaitingForPing escalation per tick (unreachable under normal
  dynamics, which enter suspicion at <= 1 peer/tick).
- D2: at most one anti-entropy KnownPeersRequest issued per tick, chosen from
  the tick's sync candidates in arrival order.
- D3: curious-peer (indirect-ping relay) entries live for one tick instead of
  lingering until an eventual ack.
- D7: a forwarded Ack never re-forwards (one relay hop per tick), bounding the
  in-tick delivery chain at four calls. The reference's reactive loop would
  relay again if time remained in the period (kaboodle.rs:762-778).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.oracle.fingerprint import mix_fingerprint


# --- wire messages (structs.rs:64-116) --------------------------------------


@dataclasses.dataclass(frozen=True)
class Ping:  # SwimMessage::Ping (structs.rs:97)
    pass


@dataclasses.dataclass(frozen=True)
class PingRequest:  # SwimMessage::PingRequest (structs.rs:101)
    target: object


@dataclasses.dataclass(frozen=True)
class Ack:  # SwimMessage::Ack (structs.rs:103-107)
    peer: object
    mesh_fingerprint: int
    num_peers: int
    # D7: set on curious-peer relays; a forwarded Ack never re-forwards (the
    # reference's real-time loop would relay again if time remained in the
    # period, kaboodle.rs:762-778 — the lockstep model caps the relay at one
    # hop so the chain depth is fixed at four delivery calls).
    forwarded: bool = False


@dataclasses.dataclass(frozen=True)
class KnownPeersMsg:  # SwimMessage::KnownPeers (structs.rs:110)
    peers: tuple  # tuple of (addr, identity) pairs


@dataclasses.dataclass(frozen=True)
class KnownPeersRequest:  # SwimMessage::KnownPeersRequest (structs.rs:112-115)
    mesh_fingerprint: int
    num_peers: int


@dataclasses.dataclass(frozen=True)
class Join:  # SwimBroadcast::Join (structs.rs:67)
    addr: object
    identity: object


@dataclasses.dataclass(frozen=True)
class Failed:  # SwimBroadcast::Failed (structs.rs:69)
    peer: object


@dataclasses.dataclass(frozen=True)
class Probe:  # SwimBroadcast::Probe (structs.rs:72)
    addr: object


@dataclasses.dataclass(frozen=True)
class ProbeResponse:  # structs.rs:88-90
    identity: object


@dataclasses.dataclass
class PeerRecord:
    """PeerInfo (structs.rs:17-22): identity + state code + state timestamp.

    The reference stores the timestamp inside the PeerState variant; ``since``
    is that Instant (last-heard for Known, sent-at for the WaitingFor states).
    """

    identity: object
    state: int
    since: float
    latency: Optional[float] = None


class Outbox:
    """Messages produced by one handler invocation."""

    def __init__(self) -> None:
        self.unicasts: list[tuple[object, object]] = []  # (dest addr, msg)
        self.broadcasts: list[object] = []

    def send(self, dest: object, msg: object) -> None:
        self.unicasts.append((dest, msg))

    def broadcast(self, msg: object) -> None:
        self.broadcasts.append(msg)

    def extend(self, other: "Outbox") -> None:
        self.unicasts.extend(other.unicasts)
        self.broadcasts.extend(other.broadcasts)


def addr_key(addr: object):
    """Total order over peer addresses: numeric for simulated (int) peers —
    matching the kernel's index order — and string form otherwise (the
    reference sorts SocketAddrs, kaboodle.rs:72-73)."""
    return (0, addr, "") if isinstance(addr, int) else (1, 0, str(addr))


def _default_fingerprint(members: dict) -> int:
    return mix_fingerprint(members)


class PeerEngine:
    """KaboodleInner (kaboodle.rs:91-786) minus sockets, tasks, and mutexes."""

    def __init__(
        self,
        addr: object,
        identity: object,
        cfg: SwimConfig,
        now: float = 0,
        fingerprint_fn: Optional[Callable[[dict], int]] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.addr = addr
        self.identity = identity
        self.cfg = cfg
        # Maps addr -> PeerRecord; self inserted as Known(now) (kaboodle.rs:144-152).
        self.known: dict = {addr: PeerRecord(identity, KNOWN, now)}
        # curious_peers: target addr -> list of requester addrs (kaboodle.rs:99-101).
        self.curious: dict = {}
        self.last_broadcast_time: Optional[float] = None  # kaboodle.rs:102-103
        self.pending_manual_pings: list = []  # ping_request_rx (kaboodle.rs:107)
        self._fingerprint_fn = fingerprint_fn or _default_fingerprint
        self._rng = random.Random(seed)
        # D2: sync candidates observed this tick, in arrival order.
        self._sync_candidates: list[tuple[object, int, int]] = []
        # Telemetry tallies (kaboodle_tpu_torch.telemetry counter parity): the
        # lockstep harness zeroes these each tick and reads them after the
        # active phase — standalone (real-transport) use ignores them.
        self.last_escalated = 0
        self.last_removed = 0
        # Lockstep-only bookkeeping: the membership snapshot (addr ->
        # identity) at the start of the current broadcast round and the joins
        # (addr, identity) accepted during it. Under the harness, join-reply
        # shares are built from snapshot + joins-so-far (deviation D9: a
        # same-tick Failed delivery does not retroactively shrink a share —
        # the reference's outcome there depends on UDP arrival order, and
        # this is the ordering the O(N^2) kernel implements). None =>
        # standalone use (real transport): share the live map.
        self._round_base: Optional[dict] = None
        self._round_joins: list = []

    # --- queries (lib.rs:301-354) -------------------------------------------

    def fingerprint(self) -> int:
        return self._fingerprint_fn({a: r.identity for a, r in self.known.items()})

    def num_peers(self) -> int:
        return len(self.known)

    def peers(self) -> list:
        return sorted((a for a in self.known), key=addr_key)

    # --- internal helpers ----------------------------------------------------

    def _mark_known(self, sender: object, identity: object, now: float) -> None:
        """Q1: unconditional insert-as-Known of a datagram's sender
        (kaboodle.rs:408-415), with the latency EWMA of kaboodle.rs:789-817."""
        prev = self.known.get(sender)
        latency = None
        if prev is not None:
            if prev.state in (WAITING_FOR_PING, WAITING_FOR_INDIRECT_PING):
                sample = now - prev.since
                if prev.latency is None:
                    latency = sample
                else:
                    latency = 0.8 * sample + 0.2 * prev.latency  # kaboodle.rs:810-814
            else:
                latency = prev.latency
        self.known[sender] = PeerRecord(identity, KNOWN, now, latency)

    def _remove(self, peer: object) -> None:
        self.known.pop(peer, None)
        self.curious.pop(peer, None)  # kaboodle.rs:643-644

    def _should_respond_to_broadcast(self) -> bool:
        """Reply-dampening curve (kaboodle.rs:333-354)."""
        n_other = len(self.known) - 2
        if n_other <= 0:
            return True
        pct = max(1, 100 - min(n_other, 10) ** 2) / 100.0
        if self.cfg.deterministic:
            return True  # pct is always > 0
        return self._rng.random() < pct

    def _share_snapshot_join(self) -> list[tuple[object, object]]:
        """Q5: join-triggered share — whole map, self included, no age filter
        (kaboodle.rs:362-369), trimmed to max_share_peers (kaboodle.rs:373-383
        trims randomly until the payload fits the 10 KiB buffer)."""
        if self._round_base is None:
            entries = [(a, r.identity) for a, r in self.known.items()]
        else:
            # D9 (lockstep contract, aligned with the kernel's share_base /
            # term2): start-of-round snapshot plus joins accepted so far —
            # NOT the live map, which same-tick Failed deliveries may already
            # have shrunk. Identities refresh from the live record when one
            # exists (D-ID1).
            merged = dict(self._round_base)
            for a, ident in self._round_joins:
                merged[a] = ident
            entries = [
                (a, self.known[a].identity if a in self.known else ident)
                for a, ident in merged.items()
            ]
        cap = self.cfg.max_share_peers
        if cap and len(entries) > cap:
            if self.cfg.deterministic:
                if self._round_base is None:
                    # Standalone use: cap to the lowest-addressed entries.
                    entries.sort(key=lambda e: addr_key(e[0]))
                    entries = entries[:cap]
                else:
                    # D5 (aligned with the kernel): cap to the lowest-index
                    # members of the start-of-round map, plus — uncapped —
                    # every joiner accepted so far this round (the kernel's
                    # term2 adds this round's Join origins outside the cap).
                    base = sorted(
                        (e for e in entries if e[0] in self._round_base),
                        key=lambda e: addr_key(e[0]),
                    )[:cap]
                    base_addrs = {a for a, _ in base}
                    joins = {a for a, _ in self._round_joins}
                    extra = [
                        e for e in entries
                        if e[0] in joins and e[0] not in base_addrs
                    ]
                    entries = base + extra
            else:
                entries = self._rng.sample(entries, cap)
        return entries

    def _share_snapshot_filtered(self, requester: object, now: float) -> list:
        """KnownPeersRequest reply: Known-state peers heard from within
        MAX_PEER_SHARE_AGE, excluding self and the requester
        (kaboodle.rs:483-501). Not trimmed (quirk Q12)."""
        max_age = self.cfg.max_peer_share_age_ticks
        return [
            (a, r.identity)
            for a, r in self.known.items()
            if r.state == KNOWN
            and a != self.addr
            and a != requester
            and (now - r.since) < max_age
        ]

    def _maybe_sync_known_peers(self, peer: object, their_fp: int, their_n: int) -> None:
        """Record an anti-entropy sync candidate (kaboodle.rs:707-740); D2
        resolves at most one per tick via take_sync_request()."""
        self._sync_candidates.append((peer, their_fp, their_n))

    # --- tick active phase (kaboodle.rs:746-757) ------------------------------

    def active_phase(self, now: float) -> Outbox:
        out = Outbox()
        self._maybe_broadcast_join(now, out)
        self._handle_suspected_peers(now, out)
        self._ping_random_peer(now, out)
        self._handle_manual_ping_requests(out)
        return out

    def _maybe_broadcast_join(self, now: float, out: Outbox) -> None:
        """kaboodle.rs:228-251: first call always broadcasts; afterwards only
        while lonely and >= REBROADCAST_INTERVAL since the last broadcast.
        With ``join_broadcast_enabled=False`` (the gossip boot — no broadcast
        medium) the whole mechanism is disabled."""
        if not self.cfg.join_broadcast_enabled:
            return
        if self.last_broadcast_time is not None:
            lonely = len(self.known) <= 1
            waited = (now - self.last_broadcast_time) >= self.cfg.rebroadcast_interval_ticks
            if not (lonely and waited):
                return
        self.last_broadcast_time = now
        out.broadcast(Join(self.addr, self.identity))

    def _handle_suspected_peers(self, now: float, out: Outbox) -> None:
        """kaboodle.rs:558-653. D1: escalate at most one WaitingForPing."""
        timeout = self.cfg.ping_timeout_ticks
        removed: list = []
        # Stable iteration order for deterministic parity with the kernel.
        items = sorted(self.known.items(), key=lambda kv: addr_key(kv[0]))

        waiting_timed_out = [
            (a, r) for a, r in items if r.state == WAITING_FOR_PING and (now - r.since) >= timeout
        ]
        # D1: oldest first (ties toward lower addr via the stable sort above).
        waiting_timed_out.sort(key=lambda kv: kv[1].since)
        for peer, _rec in waiting_timed_out[:1]:
            candidates = [
                a for a, r in items if a != self.addr and r.state == KNOWN
            ]
            if not candidates:
                # No one to ask — give up immediately (kaboodle.rs:599-605).
                removed.append(peer)
                continue
            k = self.cfg.num_indirect_ping_peers
            if self.cfg.deterministic:
                proxies = candidates[: k]
            else:
                proxies = self._rng.sample(candidates, min(k, len(candidates)))
            self.known[peer] = dataclasses.replace(
                self.known[peer], state=WAITING_FOR_INDIRECT_PING, since=now
            )  # kaboodle.rs:631-639
            self.last_escalated += 1
            for proxy in proxies:
                out.send(proxy, PingRequest(peer))

        for peer, rec in items:
            if rec.state == WAITING_FOR_INDIRECT_PING and (now - rec.since) >= timeout:
                removed.append(peer)  # kaboodle.rs:617-627

        self.last_removed += len(removed)
        for peer in removed:
            self._remove(peer)
            out.broadcast(Failed(peer))  # kaboodle.rs:641-652

    def _ping_random_peer(self, now: float, out: Outbox) -> None:
        """kaboodle.rs:655-703: uniform choice among the oldest
        NUM_CANDIDATE_TARGET_PEERS Known peers."""
        candidates = [
            (r.since, addr_key(a), a)
            for a, r in self.known.items()
            if a != self.addr and r.state == KNOWN
        ]
        if not candidates:
            return
        candidates.sort(key=lambda t: (t[0], t[1]))
        pool = candidates[: self.cfg.num_candidate_target_peers]
        if self.cfg.deterministic:
            target = pool[0][2]
        else:
            target = self._rng.choice(pool)[2]
        self.known[target] = dataclasses.replace(
            self.known[target], state=WAITING_FOR_PING, since=now
        )
        out.send(target, Ping())

    def _handle_manual_ping_requests(self, out: Outbox) -> None:
        """kaboodle.rs:550-556: drain the manual ping queue; no state change."""
        for target in self.pending_manual_pings:
            out.send(target, Ping())
        self.pending_manual_pings = []

    # --- inbound unicast (kaboodle.rs:394-548) --------------------------------

    def on_unicast(self, sender: object, sender_identity: object, msg: object, now: float) -> Outbox:
        """Real-transport entry point: mark the sender (Q1) then dispatch."""
        self.mark_sender(sender, sender_identity, now)
        return self.dispatch_unicast(sender, msg, now)

    def mark_sender(self, sender: object, sender_identity: object, now: float) -> None:
        """Q1 half of message handling (kaboodle.rs:408-415). The lockstep
        harness applies all of a round's marks before any dispatch, so that
        Ack payloads (fingerprint/num_peers) see the round's full insert set —
        the kernel computes a round's effects as one tensor op."""
        self._mark_known(sender, sender_identity, now)

    def dispatch_unicast(self, sender: object, msg: object, now: float) -> Outbox:
        out = Outbox()
        if isinstance(msg, Ack):
            # D7: only first-generation Acks pop-and-forward the curious list.
            observers = [] if msg.forwarded else self.curious.pop(msg.peer, [])
            for observer in observers:  # forward to curious peers (kaboodle.rs:423-443)
                out.send(observer, Ack(msg.peer, msg.mesh_fingerprint, msg.num_peers, forwarded=True))
            if not self.cfg.faithful_indirect_ack and msg.peer in self.known:
                # Intended-SWIM mode: a forwarded ack clears the suspect too.
                rec = self.known[msg.peer]
                if rec.state in (WAITING_FOR_PING, WAITING_FOR_INDIRECT_PING):
                    self.known[msg.peer] = dataclasses.replace(rec, state=KNOWN, since=now)
            self._maybe_sync_known_peers(msg.peer, msg.mesh_fingerprint, msg.num_peers)

        elif isinstance(msg, KnownPeersMsg):
            # Q6: insert unknown peers back-dated (kaboodle.rs:448-472).
            # With backdate_gossip_inserts=False (epidemic boot extension),
            # learned peers get fresh stamps and re-share immediately.
            stamp = now - (
                self.cfg.max_peer_share_age_ticks
                if self.cfg.backdate_gossip_inserts
                else 0
            )
            for addr, identity in msg.peers:
                if addr not in self.known:
                    self.known[addr] = PeerRecord(identity, KNOWN, stamp)

        elif isinstance(msg, KnownPeersRequest):
            share = self._share_snapshot_filtered(sender, now)
            out.send(sender, KnownPeersMsg(tuple(share)))  # kaboodle.rs:503-508
            self._maybe_sync_known_peers(sender, msg.mesh_fingerprint, msg.num_peers)

        elif isinstance(msg, Ping):
            out.send(
                sender,
                Ack(self.addr, self.fingerprint(), self.num_peers()),
            )  # kaboodle.rs:513-532

        elif isinstance(msg, PingRequest):
            observers = self.curious.setdefault(msg.target, [])
            if sender not in observers:
                observers.append(sender)  # kaboodle.rs:533-540
            out.send(msg.target, Ping())  # kaboodle.rs:542-544

        return out

    # --- inbound broadcast (kaboodle.rs:256-311) ------------------------------

    def on_broadcast(self, origin: object, msg: object, now: float) -> Outbox:
        """``origin`` is the broadcast datagram's source address. For real
        sockets this is never a member address (quirk Q3)."""
        out = Outbox()
        if isinstance(msg, Failed):
            if msg.peer == self.addr:
                return out  # kaboodle.rs:269-273
            if self.cfg.faithful_failed_broadcast:
                # Source-membership check that never passes with real sockets
                # (kaboodle.rs:276-281): inert unless origin happens to be known.
                if origin in self.known and origin != msg.peer:
                    self._remove(msg.peer)
            else:
                self._remove(msg.peer)
        elif isinstance(msg, Join):
            if msg.addr == self.addr:
                return out  # kaboodle.rs:285-287
            prev = self.known.get(msg.addr)
            is_new = prev is None
            latency = prev.latency if prev else None  # kaboodle.rs:291-297
            self.known[msg.addr] = PeerRecord(msg.identity, KNOWN, now, latency)
            if self._round_base is not None:
                # D5 bookkeeping only under the lockstep harness (which resets
                # both fields every round); a standalone engine must not
                # accumulate join addresses forever.
                self._round_joins.append((msg.addr, msg.identity))
            if is_new and self._should_respond_to_broadcast():
                share = self._share_snapshot_join()
                if share:
                    out.send(msg.addr, KnownPeersMsg(tuple(share)))  # kaboodle.rs:356-392
        elif isinstance(msg, Probe):
            if self._should_respond_to_broadcast():
                out.send(msg.addr, ProbeResponse(self.identity))  # kaboodle.rs:313-331
        return out

    # --- end-of-tick anti-entropy (D2) ---------------------------------------

    def take_sync_request(self) -> Optional[tuple[object, KnownPeersRequest]]:
        """Resolve this tick's sync candidates into at most one
        KnownPeersRequest (kaboodle.rs:707-740): fire for the first candidate
        whose fingerprint differs from ours and whose num_peers >= ours."""
        candidates, self._sync_candidates = self._sync_candidates, []
        our_fp = self.fingerprint()
        our_n = self.num_peers()
        for peer, their_fp, their_n in candidates:
            if their_fp == our_fp:
                continue
            if our_n > their_n:
                continue  # they'll ask us instead (kaboodle.rs:722-726)
            return peer, KnownPeersRequest(our_fp, our_n)
        return None
