"""Runtime concurrency sanitizer: dynamic lock-order graph + loop watchdog.

A copy of ``kaboodle_tpu/analysis/conc/sanitizer.py`` (stdlib only): the
port's serve engine and spill writer take their locks from
:func:`make_lock` and budget their startup stalls with :func:`budgeted`.

The static KB5xx rules (rules.py) prove properties of the code the AST can
see; this module asserts the same two invariants on the EXECUTION the
chaos harness and the serve test suites actually drive:

- **Lock order**: :func:`make_lock` hands out :class:`SanitizedLock`
  wrappers (plain ``threading.Lock`` when the sanitizer is disabled —
  zero overhead in production). Every acquisition records edges
  ``held -> acquired`` into one process-wide order graph, and the edge
  that would close a cycle raises :class:`LockOrderError` *immediately*,
  on whichever thread adds it — a deterministic report of the ABBA that
  deadlocks only under the lost interleaving. The pre-acquire check means
  a single thread exercising both orders is enough to trip it: no race
  required, so the chaos scenarios double as deadlock regression tests.
- **Event loop**: while enabled, ``asyncio.events.Handle._run`` is timed.
  A callback's synchronous segment exceeding the slow-callback threshold
  is recorded as a violation (the serve plane's p99 is exactly the longest
  such segment). Known-budgeted stalls — warmup compiles, recovery replay
  — wrap themselves in :func:`budgeted` and are excused, mirroring the
  compiles_steady contract (budgeted at warmup, gated at steady state).

stdlib only (threading/asyncio/contextlib): importable from the serve
engine itself without dragging the analysis plane's rule registry in.

Env hook: ``KABOODLE_CONC_SANITIZE=1`` enables at import (threshold from
``KABOODLE_CONC_LOOP_THRESHOLD_MS``, default 500), so any dryrun can run
sanitized for overhead measurement without code changes (PERF.md banks
the serve-obs number).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

__all__ = [
    "LockOrderError", "SanitizedLock", "make_lock", "enable", "disable",
    "enabled", "is_enabled", "budgeted", "budget_current_callback",
    "lock_graph", "loop_violations",
    "reset", "report", "assert_clean",
]


class LockOrderError(RuntimeError):
    """Acquiring this lock here closes a cycle in the lock-order graph."""


_state = threading.Lock()  # guards _edges/_violations; never wrapped itself
_enabled = False
_edges: dict[str, set[str]] = {}
_violations: list[tuple[str, float]] = []
_threshold_s = 0.5
_tls = threading.local()
_orig_handle_run = None
_budget_flag = False  # set by budgeted(), cleared at each callback entry


def _held() -> list[str]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _path(src: str, dst: str) -> list[str] | None:
    """A path src ~> dst in the recorded graph, else None (caller holds
    ``_state``)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class SanitizedLock:
    """A ``threading.Lock`` that records acquisition-order edges.

    Non-reentrant, like the lock it wraps; re-acquiring on the same
    thread raises :class:`LockOrderError` instead of deadlocking.
    """

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if self.name in held:
            raise LockOrderError(
                f"re-acquiring non-reentrant lock {self.name!r} on the same "
                f"thread (held: {held})"
            )
        # Record BEFORE blocking: the ordering violation is the bug even
        # when the actual deadlock interleaving doesn't happen this run.
        with _state:
            for h in held:
                back = _path(self.name, h)
                if back is not None:
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {self.name!r} while "
                        f"holding {h!r}, but the recorded order already has "
                        f"{'->'.join(back)}->{h!r} — ABBA deadlock"
                    )
                _edges.setdefault(h, set()).add(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        held = _held()
        if self.name in held:
            # remove the most recent acquisition of this name
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str):
    """A lock for ``name`` (e.g. ``"SpillManager._lock"``): sanitized when
    the sanitizer is enabled, a plain ``threading.Lock`` otherwise."""
    return SanitizedLock(name) if _enabled else threading.Lock()


# ---------------------------------------------------------------------------
# event-loop watchdog


def _install_loop_monitor() -> None:
    global _orig_handle_run
    if _orig_handle_run is not None:
        return
    import asyncio.events

    _orig_handle_run = asyncio.events.Handle._run

    def _timed_run(handle):
        global _budget_flag
        _budget_flag = False
        t0 = time.perf_counter()
        try:
            return _orig_handle_run(handle)
        finally:
            dt = time.perf_counter() - t0
            if dt > _threshold_s and not _budget_flag:
                cb = repr(getattr(handle, "_callback", handle))[:120]
                with _state:
                    _violations.append((cb, dt))

    asyncio.events.Handle._run = _timed_run


def _uninstall_loop_monitor() -> None:
    global _orig_handle_run
    if _orig_handle_run is None:
        return
    import asyncio.events

    asyncio.events.Handle._run = _orig_handle_run
    _orig_handle_run = None


def budget_current_callback() -> None:
    """Excuse the CURRENT event-loop callback from the slow-callback gate
    (warmup compiles, recovery replay: blocking that is part of the
    budgeted startup contract, not a steady-state stall). The flag is
    cleared at the next callback's entry, so the excuse never outlives
    the callback that earned it."""
    global _budget_flag
    _budget_flag = True


@contextlib.contextmanager
def budgeted():
    """Context-manager spelling of :func:`budget_current_callback`."""
    try:
        yield
    finally:
        budget_current_callback()


# ---------------------------------------------------------------------------
# lifecycle


def enable(loop_threshold_s: float = 0.5) -> None:
    global _enabled, _threshold_s
    _threshold_s = float(loop_threshold_s)
    _enabled = True
    _install_loop_monitor()


def disable() -> None:
    global _enabled
    _enabled = False
    _uninstall_loop_monitor()


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled(loop_threshold_s: float = 0.5, fresh: bool = True):
    """Enable for a scope (chaos harness, a test module), disabling on
    exit. ``fresh`` resets the recorded graph/violations on entry so the
    scope asserts ITS execution, not history."""
    if fresh:
        reset()
    enable(loop_threshold_s)
    try:
        yield
    finally:
        disable()


def reset() -> None:
    with _state:
        _edges.clear()
        _violations.clear()


def lock_graph() -> dict[str, list[str]]:
    with _state:
        return {a: sorted(bs) for a, bs in _edges.items()}


def loop_violations() -> list[tuple[str, float]]:
    with _state:
        return list(_violations)


def report() -> dict:
    """JSON-able summary for dryrun reports."""
    g = lock_graph()
    return {
        "locks": sorted({a for a in g} | {b for bs in g.values() for b in bs}),
        "order_edges": sum(len(bs) for bs in g.values()),
        "loop_violations": [
            {"callback": cb, "blocked_s": round(dt, 4)}
            for cb, dt in loop_violations()
        ],
    }


def assert_clean() -> None:
    """Raise if the watched execution blocked the loop. (Lock-order cycles
    raise at the acquisition itself; this is the end-of-run gate for the
    watchdog half.)"""
    v = loop_violations()
    if v:
        lines = ", ".join(f"{cb} blocked {dt * 1e3:.0f}ms" for cb, dt in v[:5])
        raise AssertionError(
            f"event loop blocked past {_threshold_s * 1e3:.0f}ms slow-callback "
            f"threshold {len(v)}x: {lines}"
        )


if os.environ.get("KABOODLE_CONC_SANITIZE") == "1":
    enable(float(os.environ.get("KABOODLE_CONC_LOOP_THRESHOLD_MS", "500")) / 1e3)
