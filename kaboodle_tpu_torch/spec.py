"""The SWIM state machine as data: the peer-state codes of the ``[N, N]`` plane.

``state[i, j]`` is what peer i believes about peer j (reference
src/structs.rs:27-41). NOT_MEMBER encodes absence from the membership map.
"""

from __future__ import annotations

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
