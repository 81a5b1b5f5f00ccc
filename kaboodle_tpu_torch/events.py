"""Event derivation: membership diffs -> discovered / departed / fingerprint events.

The reference implements this with a channel pipeline: every mutation of the
shared ``ObservableHashMap`` emits Added/Updated/Removed to an observer task
(observable_hashmap.rs:84-142) which batches bursts, derives semantic events,
and fans them out to consumer channels (events.rs:18-125). In the simulator
membership is a tensor and a tick is the natural batch, so the whole pipeline
collapses to a pure diff between consecutive snapshots — no channels, no
locks, no observer registry. The facade (kaboodle_tpu_torch.api) owns
delivery. This module works on host numpy arrays, as in the JAX package.

Semantics preserved from events.rs:

- *Batching*: all changes within one feed are one batch; a peer removed and
  re-added inside the batch produces no event (events.rs:88-99) — with tensor
  diffs this holds by construction, since only the net change is visible.
- *Updated is ignored unless the identity changed* (events.rs:80-87); an
  identity change re-announces the peer on the discovery stream with its new
  identity.
- *Fingerprint dedup* (events.rs:103-122): a FingerprintChanged event fires
  only when the recomputed fingerprint differs from the last announced one.
- *Quirk Q10*: the fingerprint of an empty map is 0 and is deliberately never
  announced (events.rs:110-117).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kaboodle_tpu_torch.oracle.fingerprint import mix_fingerprint


@dataclasses.dataclass(frozen=True)
class PeerDiscovered:
    """A peer entered the map, or re-announced with a new identity
    (events.rs:59-87)."""

    peer: int
    identity: int


@dataclasses.dataclass(frozen=True)
class PeerDeparted:
    """A peer left the map (events.rs:88-99)."""

    peer: int


@dataclasses.dataclass(frozen=True)
class FingerprintChanged:
    """The observer's mesh fingerprint changed (events.rs:103-122)."""

    fingerprint: int


Event = PeerDiscovered | PeerDeparted | FingerprintChanged


class EventTap:
    """Derives the reference's three event streams for one observer's row.

    Feed consecutive membership snapshots (one per tick, or coarser — any
    cadence is a valid batch boundary); get the semantic events of each batch.
    """

    def __init__(self) -> None:
        self._member: np.ndarray | None = None  # bool [N]
        self._identity: np.ndarray | None = None  # uint32 [N]
        self._announced_fp: int = 0  # Q10: empty-map fp 0 counts as announced

    def feed(self, member, identities, fingerprint: int | None = None) -> list[Event]:
        """Diff against the previous snapshot; return this batch's events.

        Args:
          member: bool [N] — the observer's current membership row.
          identities: uint32 [N] — identity words (only entries where
            ``member`` is True are read).
          fingerprint: precomputed row fingerprint (must equal
            ``mix_fingerprint`` of the row — the kernel/ops value qualifies);
            computed host-side when omitted.
        """
        member = np.asarray(member, dtype=bool)
        identities = np.asarray(identities, dtype=np.uint32)
        events: list[Event] = []

        if self._member is None:
            added = np.flatnonzero(member)
            changed = np.empty(0, dtype=np.int64)
            removed = np.empty(0, dtype=np.int64)
        else:
            added = np.flatnonzero(member & ~self._member)
            removed = np.flatnonzero(self._member & ~member)
            stayed = member & self._member
            changed = np.flatnonzero(stayed & (identities != self._identity))

        for p in added:
            events.append(PeerDiscovered(int(p), int(identities[p])))
        for p in changed:
            events.append(PeerDiscovered(int(p), int(identities[p])))
        for p in removed:
            events.append(PeerDeparted(int(p)))

        if fingerprint is None:
            fingerprint = mix_fingerprint(
                {int(p): int(identities[p]) for p in np.flatnonzero(member)}
            )
        fp = fingerprint
        if fp != self._announced_fp and member.any():
            events.append(FingerprintChanged(fp))
            self._announced_fp = fp

        self._member = member.copy()
        self._identity = identities.copy()
        return events


def membership_diff(prev_member, member):
    """Vectorized whole-mesh diff: (added, removed) bool [N, N] masks.

    ``added[i, j]``: peer i discovered peer j this step; ``removed[i, j]``:
    peer i dropped peer j. The tensor form of the per-observer streams — used
    for mesh-wide observability (SURVEY.md §5 structured metrics).
    """
    prev_member = np.asarray(prev_member, dtype=bool)
    member = np.asarray(member, dtype=bool)
    return member & ~prev_member, prev_member & ~member
