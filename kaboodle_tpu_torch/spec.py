"""The SWIM state machine as data: the peer-state codes of the ``[N, N]`` plane
and the wire's message kinds.

``state[i, j]`` is what peer i believes about peer j (reference
src/structs.rs:27-41). NOT_MEMBER encodes absence from the membership map.
``UnicastKind`` / ``BroadcastKind`` are the wire codec's enum variants.
"""

from __future__ import annotations

import enum

NOT_MEMBER = 0
KNOWN = 1  # PeerState::Known(last_heard)           structs.rs:31
WAITING_FOR_PING = 2  # PeerState::WaitingForPing(sent_at)   structs.rs:35
WAITING_FOR_INDIRECT_PING = 3  # PeerState::WaitingForIndirectPing    structs.rs:40

STATE_NAMES = {
    NOT_MEMBER: "NotMember",
    KNOWN: "Known",
    WAITING_FOR_PING: "WaitingForPing",
    WAITING_FOR_INDIRECT_PING: "WaitingForIndirectPing",
}


class UnicastKind(enum.IntEnum):
    """SwimMessage variants, in declaration order (structs.rs:94-115).

    The enum ordinal doubles as the bincode variant index for the wire codec.
    """

    PING = 0
    PING_REQUEST = 1
    ACK = 2
    KNOWN_PEERS = 3
    KNOWN_PEERS_REQUEST = 4


class BroadcastKind(enum.IntEnum):
    """SwimBroadcast variants, in declaration order (structs.rs:65-73)."""

    JOIN = 0
    FAILED = 1
    PROBE = 2
