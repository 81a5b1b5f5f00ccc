"""Consistent-hash placement ring (the federation's request->engine map).

Classic Karger ring with virtual nodes: each member owns ``vnodes``
points on a 64-bit circle, a key is placed on the first point at or past
its own hash. The port's copy of ``kaboodle_tpu/serve/federation/ring.py``
(tests/test_torch_fedserve.py holds the two equal). Properties the
federation leans on:

- **stability**: adding or removing one of M members moves only ~1/M of
  the key space — a failover re-places the dead engine's keys and
  nothing else, so the survivors' warmed lanes keep their traffic.
- **determinism**: hashes come from ``hashlib.blake2b``, never the
  builtin ``hash`` (salted per process) — two router processes, or one
  router across restarts, place every key identically. Placement state
  never needs journaling.
- **spread**: vnodes smooth per-member load to within a few percent at
  the federation's key cardinalities.

Pure host-side stdlib.
"""

from __future__ import annotations

import bisect
import hashlib


def stable_hash(key: str) -> int:
    """64-bit process-independent hash (blake2b prefix)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over member ids, ``vnodes`` points each."""

    def __init__(self, members=(), vnodes: int = 64) -> None:
        if vnodes < 1:
            raise ValueError("need vnodes >= 1")
        self.vnodes = int(vnodes)
        self._points: list[int] = []  # sorted vnode hashes
        self._owner: dict[int, str] = {}  # vnode hash -> member id
        self._members: set[str] = set()
        for m in members:
            self.add(m)

    # -- membership --------------------------------------------------------

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for i in range(self.vnodes):
            h = stable_hash(f"{member}#{i}")
            # A 64-bit collision across members is ~impossible at these
            # cardinalities; refuse loudly rather than silently re-own.
            if h in self._owner:
                raise ValueError(
                    f"vnode hash collision: {member!r} vs "
                    f"{self._owner[h]!r}"
                )
            self._owner[h] = member
            bisect.insort(self._points, h)

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        dead = [h for h, m in self._owner.items() if m == member]
        for h in dead:
            del self._owner[h]
            self._points.pop(bisect.bisect_left(self._points, h))

    @property
    def members(self) -> frozenset:
        return frozenset(self._members)

    @property
    def size(self) -> int:
        """Live vnode count (the placement-ring-size gauge)."""
        return len(self._points)

    # -- placement ---------------------------------------------------------

    def place(self, key: str) -> str:
        """The member owning ``key`` (first vnode clockwise of its hash)."""
        if not self._points:
            raise ValueError("ring has no members")
        i = bisect.bisect_left(self._points, stable_hash(key))
        if i == len(self._points):
            i = 0  # wrap past the top of the circle
        return self._owner[self._points[i]]

    def preference(self, key: str, limit: int | None = None) -> list[str]:
        """Distinct members in ring order from ``key``'s placement point —
        the failover/filter walk order (index 0 is :meth:`place`)."""
        if not self._points:
            return []
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_left(self._points, stable_hash(key))
        n = len(self._points)
        want = len(self._members) if limit is None else min(
            limit, len(self._members)
        )
        for step in range(n):
            m = self._owner[self._points[(start + step) % n]]
            if m not in seen:
                seen.add(m)
                out.append(m)
                if len(out) >= want:
                    break
        return out
