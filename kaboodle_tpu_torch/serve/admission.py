"""Admission control: quotas, priorities, backpressure, load shedding.

The port's copy of ``kaboodle_tpu/serve/admission.py`` (host-only): the
same classes, decisions and ``retry_after_s`` under an injectable clock.

Without admission control any client could queue unbounded work and the
engine would FIFO it. This module is the policy layer
the engine (and through it ``server.py``) consults at submit time:

- **per-tenant token buckets**: each tenant refills at ``rate`` requests/s
  up to ``burst``; an empty bucket rejects with :class:`QuotaError`
  carrying ``retry_after_s`` (when one token will exist). The clock is
  injectable, so tests and the chaos harness drive it deterministically.
- **bounded submit queue**: more than ``max_queue`` queued requests
  rejects with :class:`QueueFullError` + retry-after — unless the
  newcomer strictly outranks the lowest-priority queued request, in which
  case the engine sheds that victim instead (lowest priority first,
  oldest within a class), emitted as a ``shed`` event.
- **priority classes**: higher ``ServeRequest.priority`` admits first
  (FIFO within a class), and under lane pressure a strictly
  lower-priority PARKED lane may be preempted — spill-evicted to make
  room. Running lanes are never preempted: a dispatched round is paid
  for, and eviction mid-run would forfeit it.

Policy decisions live here; mechanism (who owns which lane, spill I/O)
stays in the engine. Everything host-side, nothing traced.
"""

from __future__ import annotations

import time

from kaboodle_tpu_torch.errors import KaboodleError


class AdmissionError(KaboodleError):
    """Base for structured submit rejections (carries ``retry_after_s``)."""

    kind = "rejected"

    def __init__(self, msg: str, retry_after_s: float = 0.0) -> None:
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class QueueFullError(AdmissionError):
    """Submit queue at capacity and nobody shed — back off and retry."""

    kind = "queue_full"


class QuotaError(AdmissionError):
    """The tenant's token bucket is empty — back off and retry."""

    kind = "quota"


class TokenBucket:
    """Monotonic-clock token bucket: ``rate`` tokens/s, cap ``burst``."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("need rate > 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will exist (0 when they already do)."""
        self._refill()
        if self._tokens >= n:
            return 0.0
        return (n - self._tokens) / self.rate


class AdmissionController:
    """The submit-time policy gate the engine consults.

    ``quotas`` maps tenant -> ``(rate, burst)``; ``default_quota`` covers
    unlisted tenants (None = unmetered). ``max_queue`` bounds QUEUED
    requests engine-wide. Stateless about lanes — the engine owns those.
    """

    def __init__(
        self,
        max_queue: int = 64,
        quotas: dict[str, tuple[float, float]] | None = None,
        default_quota: tuple[float, float] | None = None,
        clock=time.monotonic,
    ) -> None:
        if max_queue < 1:
            raise ValueError("need max_queue >= 1")
        self.max_queue = int(max_queue)
        self._clock = clock
        self._quota_spec = dict(quotas or {})
        self._default_quota = default_quota
        self._buckets: dict[str, TokenBucket] = {}

    def _bucket(self, tenant: str) -> TokenBucket | None:
        b = self._buckets.get(tenant)
        if b is not None:
            return b
        spec = self._quota_spec.get(tenant, self._default_quota)
        if spec is None:
            return None
        b = TokenBucket(spec[0], spec[1], clock=self._clock)
        self._buckets[tenant] = b
        return b

    def check_quota(self, tenant: str) -> None:  # conc: event-loop
        """Take one token for ``tenant`` or raise :class:`QuotaError`."""
        b = self._bucket(tenant)
        if b is None or b.try_take():
            return
        raise QuotaError(
            f"tenant {tenant!r} over quota", retry_after_s=b.retry_after()
        )

    def snapshot(self) -> dict:  # conc: event-loop
        """Point-in-time view for the metrics plane: queue bound plus the
        live token balance per tenant (refilled first, so the gauge reads
        what ``try_take`` would see). Only tenants that have actually
        submitted appear — buckets are lazily materialized."""
        tenants = {}
        for tenant, b in self._buckets.items():
            b._refill()
            tenants[tenant] = {
                "tokens": b._tokens,
                "rate": b.rate,
                "burst": b.burst,
            }
        return {"max_queue": self.max_queue, "tenants": tenants}

    def check_queue(self, queued: int) -> None:  # conc: event-loop
        """Raise :class:`QueueFullError` when the queue is at capacity.

        The engine calls this AFTER trying to shed a lower-priority queued
        victim; retry-after is a queue-drain heuristic (half the queue at
        one admission per idle poll), honest about being an estimate."""
        if queued < self.max_queue:
            return
        raise QueueFullError(
            f"submit queue full ({queued}/{self.max_queue})",
            retry_after_s=0.05 * max(1, queued // 2),
        )
