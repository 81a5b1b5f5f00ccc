"""Async spill/restore: checkpoint I/O off the engine round loop.

The port of ``kaboodle_tpu/serve/spill.py``. A synchronous
``checkpoint.save`` inside the round loop would stall every active lane
for one full npz write. The :class:`SpillManager` moves the disk work onto
a background writer thread:

- **device->host copies off the loop**: the engine hands the manager a
  zero-arg thunk (:meth:`LanePool.member_snapshot`) over a private device
  copy of the lane, cloned on the loop thread when the snapshot is taken.
  The pool writes lanes in place (an admission overwrites ``leaf[lane]``),
  so the thunk must never read the live pool; the clone is queued on the
  default stream before any later write to that lane, and the worker's
  device->host copy waits for it there. The bounded submit queue (default
  depth 4) is the double buffer: at most ``depth`` spills are in flight
  before ``submit_write`` reports backpressure and the engine retries next
  round (``spill_deferred``).
- **durability**: writes go through ``checkpoint.save(..., atomic=True)``
  -- same-directory temp file, fsync, rename -- so a crash mid-spill leaves
  either the previous complete file or the new complete file, never a
  truncated archive for recovery to trip over.
- **the host tree IS the request until the write is durable**: the cache
  entry is dropped only when the writer reports success. A failed write
  (disk full, an injected fault) leaves the cache intact, so an evicted
  lane's state is never lost -- the engine retries or degrades, loudly.
- **restore prefetch**: ``prefetch`` reads a spill file back on the same
  worker thread into the cache (onto the manager's ``device``), so a
  planned restore's ``checkpoint.load`` cost is off the round loop too.

Everything here is host-side stdlib threading.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

from kaboodle_tpu_torch.analysis.conc.sanitizer import make_lock


@dataclasses.dataclass(frozen=True)
class SpillResult:
    """One finished background I/O: ``op`` is ``"write"`` or ``"read"``."""

    rid: int
    path: str
    op: str
    ok: bool
    error: str | None = None


class SpillManager:
    """Bounded-queue background writer/reader for lane spills.

    ``depth`` bounds the number of in-flight host trees (the double
    buffer); completions are polled by the engine at round start — the
    worker thread never touches engine state directly, so the round loop
    stays single-threaded from the device's point of view.
    """

    def __init__(self, depth: int = 4, owner: str | None = None, device=None) -> None:
        # Writer identity stamped into every spill archive (federation
        # engine-id): restores can then refuse alien engines' files.
        self.owner = owner
        # Where a prefetched spill file lands (the pools' device; None is
        # the card, as for checkpoint.load).
        self.device = device
        self._work: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        # KB506 waiver: fed only by the bounded _work queue (one completion
        # per submitted item) and drained to empty by the engine's
        # _poll_spills at EVERY round start, so occupancy is bounded by
        # depth + one round's completions.
        self._done: queue.Queue = queue.Queue()  # noqa: KB506
        self._cache: dict[int, object] = {}  # guarded_by: _lock
        # Sanitized under the chaos/test harnesses (dynamic lock-order
        # graph), a plain threading.Lock in production — see make_lock.
        self._lock = make_lock("SpillManager._lock")
        self._fail_next = 0  # guarded_by: _lock
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="kaboodle-spill-writer", daemon=True
        )
        self._thread.start()

    # -- engine-facing API (round-loop thread) -----------------------------

    def submit_write(self, rid: int, path: str, member) -> bool:  # conc: event-loop
        """Queue a durable write of ``member`` to ``path``. ``member`` is
        a state tree OR a zero-arg thunk producing one (the worker
        materializes it off the round loop). Returns False — try again
        next round — when the bounded queue is full. The tree (or thunk)
        is cached until the write succeeds."""
        with self._lock:
            self._cache[rid] = member
        try:
            self._work.put_nowait(("write", rid, path, member))
        except queue.Full:
            return False
        return True

    def prefetch(self, rid: int, path: str) -> bool:
        """Queue a background read of ``path`` into the cache (restore
        warm-up). Returns False when the queue is full."""
        try:
            self._work.put_nowait(("read", rid, path, None))
        except queue.Full:
            return False
        return True

    def poll(self) -> list[SpillResult]:  # conc: event-loop
        """Drain completed background I/Os (non-blocking)."""
        out: list[SpillResult] = []
        while True:
            try:
                out.append(self._done.get_nowait())
            except queue.Empty:
                return out

    def cached(self, rid: int):
        """The state tree for ``rid`` if still resident (write not yet
        durable, or a completed prefetch), else None. A still-deferred
        thunk is materialized here (both threads may race to do so; the
        results are identical by construction)."""
        with self._lock:
            member = self._cache.get(rid)
        if callable(member):
            member = member()
            with self._lock:
                if rid in self._cache:
                    self._cache[rid] = member
        return member

    def drop_cache(self, rid: int) -> None:
        with self._lock:
            self._cache.pop(rid, None)

    def pending(self) -> int:
        """Writes/reads still queued or in flight (approximate)."""
        return self._work.qsize()

    def fail_next(self, k: int = 1) -> None:
        """Fault hook: the next ``k`` writes fail deterministically
        (before touching disk), as if the target volume were full."""
        with self._lock:
            self._fail_next += int(k)

    def flush(self) -> None:
        """Block until every queued I/O has completed. Completions stay in
        the done queue — the engine's ``_poll_spills`` must still fold
        them (draining here would swallow the lane-state transitions)."""
        self._work.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._work.put(None)
        self._thread.join(timeout=10.0)

    # -- worker thread -----------------------------------------------------

    def _run(self) -> None:
        from kaboodle_tpu_torch import checkpoint

        while True:
            item = self._work.get()
            if item is None:
                self._work.task_done()
                return
            op, rid, path, member = item
            try:
                if op == "write":
                    with self._lock:
                        inject = self._fail_next > 0
                        if inject:
                            self._fail_next -= 1
                    if inject:
                        raise OSError("injected spill-write failure")
                    if callable(member):
                        member = member()
                        with self._lock:
                            if rid in self._cache:
                                self._cache[rid] = member
                    checkpoint.save(path, member, atomic=True,
                                    owner=self.owner)
                    # Durable: the file supersedes the host copy.
                    with self._lock:
                        self._cache.pop(rid, None)
                else:
                    loaded = checkpoint.load(path, device=self.device)
                    with self._lock:
                        self._cache[rid] = loaded
                self._done.put(SpillResult(rid, path, op, ok=True))
            except Exception as e:  # surfaces as a poll()ed failure record
                self._done.put(
                    SpillResult(rid, path, op, ok=False, error=str(e))
                )
            finally:
                self._work.task_done()
