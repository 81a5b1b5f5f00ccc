"""The resident step loop: requests in, convergence events out.

The port of ``kaboodle_tpu/serve/engine.py``: the same lifecycle states,
request surface, round loop, records and journal, on the port's lane pools
(``serve/pool.py``). Given the same pools, requests and call sequence, the
JAX engine and this one emit the same records and results and leave the
same pools, bit for bit (``tests/test_torch_serve.py``). The pools'
device is the engine's: the card unless the pools were built elsewhere.

One :class:`ServeEngine` owns a set of lane pools (one per pow2 N-class)
and advances them all with a continuous-batching round loop:

1. **admit** — queued requests drop into free lanes of their class pool
   (one reseed call each; the retired occupant is overwritten in place on
   the device). With an :class:`~kaboodle_tpu_torch.serve.admission.
   AdmissionController` attached, admission runs in priority order and a
   strictly lower-priority PARKED lane may be spill-evicted to make room
   (running lanes are never preempted).
2. **advance** — each pool with active lanes runs either ONE masked
   fleet-leap call (per-member horizons: every horizon-mode lane leaps
   exactly its own ``k_m``, converge-mode and hot lanes freeze at
   ``k_m == 0``) or one serve-step chunk (masked dense ticks, per-lane
   convergence tests inside the step's loop). The leap path is the
   per-member round of ``run_fleet_warped``: the same signature fetch,
   the same classifier, the same bucketed ProgramCache.
3. **harvest** — lanes whose run finished (converged under a converge-mode
   budget, or horizon exhausted) are read out with one vmapped agreement
   fetch, emitted as ``serve_event`` records, then parked or released.
   Released lanes are immediately re-seedable: retire/re-seed never leaves
   the program set built at warmup.
4. **spill** — parked lanes idle past ``spill_after`` rounds clone their
   lane on the device (``LanePool.member_snapshot``: the pool writes lanes
   in place, so the copy must be taken now) and hand it to the background
   :class:`~kaboodle_tpu_torch.serve.spill.SpillManager`, whose writer
   thread blocks on the device->host transfer and the disk write; the
   round loop NEVER blocks on either. Initiation is paced
   (``spills_per_round``, default 1) so a burst of idle lanes costs one
   lane copy per round, not a stall. The lane stays held (state
   ``spilling``) until the write is durable, then frees; a failed write
   degrades the lane back to parked with a loud ``spill_failed`` event.
   ``sync_spill=True`` keeps the blocking write (an A/B baseline).

Crash safety: with ``journal_dir`` set, every lifecycle transition is
appended to a write-ahead :class:`~kaboodle_tpu_torch.serve.journal.
ServeJournal` before the engine acts on it, and a restarted engine's
:meth:`ServeEngine.recover` folds the journal back into a live request
table — completed requests keep their results (nothing replays twice),
spilled requests re-attach to their durable files, and requests whose
lane state died with the process re-queue from their seeds with
cumulative tick budgets.

Correctness rules the loop enforces:

- converge-mode lanes NEVER leap — a hybrid leap may jump past the first
  fp-agreement tick, and the service contract is bit-exactness with a
  standalone ``run_until_converged`` of the same (seed, knobs, scenario).
  Only horizon-mode lanes (exact tick budgets) take the fast-forward.
- leaps only in fault-free, non-telemetry pools (the span programs'
  precondition; exact counter totals require dense ticks).
- every per-round ``k_m`` is clamped to ``max_leap``, so only the leap
  buckets built by :meth:`ServeEngine.warmup` are ever requested — leap
  composition is exact, so the clamp costs calls, not correctness.

The device work of a round runs inline on the caller's thread (the
server's event loop), as in the JAX engine; the spill worker thread does
only device->host copies and disk writes, on the default stream.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict

import numpy as np

from kaboodle_tpu_torch.analysis.conc import sanitizer as _conc_sanitizer
from kaboodle_tpu_torch.errors import CheckpointError
from kaboodle_tpu_torch.serve.admission import AdmissionError
from kaboodle_tpu_torch.serve.obsplane import (
    SEG_ADMIT,
    SEG_DISPATCH,
    SEG_HARVEST,
    SEG_JOURNAL,
    SEG_POLL,
    SEG_ROUND,
    SEG_SPILL,
    ObsPlane,
)
from kaboodle_tpu_torch.serve.pool import LanePool, lane_n_class
from kaboodle_tpu_torch.telemetry.manifest import run_record
from kaboodle_tpu_torch.warp.horizon import decode_signature
from kaboodle_tpu_torch.warp.runner import (
    MIN_LEAP,
    SpanMemo,
    WarpLedger,
    _check_warp_mode,
    _classify,
    _leap_budget,
)

# Request lifecycle states (the engine's host-side view of a lane).
QUEUED = "queued"
RUNNING = "running"
PARKED = "parked"
SPILLING = "spilling"  # lane held; background write not yet durable
SPILLED = "spilled"
DONE = "done"
CANCELLED = "cancelled"


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One simulation request: scenario + knobs + N-class.

    ``mode="converge"`` runs until fp-agreement (or ``ticks`` as the
    budget cap) — the served twin of ``run_until_converged``, bit-exact
    per the admission parity pin. ``mode="ticks"`` runs exactly ``ticks``
    ticks (horizon mode) — the lane the warp fast-forward applies to.
    ``keep=True`` parks the finished lane (spillable, resumable) instead
    of releasing it. ``tenant`` names the quota bucket and ``priority``
    the admission class (higher admits first; both inert without an
    :class:`~kaboodle_tpu_torch.serve.admission.AdmissionController`)."""

    n: int
    seed: int = 0
    mode: str = "converge"
    ticks: int = 64
    drop_rate: float = 0.0
    scenario: str = "boot"
    keep: bool = False
    tenant: str = "default"
    priority: int = 1

    def __post_init__(self):
        if self.mode not in ("converge", "ticks"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.ticks < 1:
            raise ValueError("need ticks >= 1")
        if self.priority < 0:
            raise ValueError("need priority >= 0")

    @property
    def n_class(self) -> int:
        return lane_n_class(self.n)

    @property
    def until_conv(self) -> bool:
        return self.mode == "converge"


def _fresh_row(req: ServeRequest) -> dict:
    return {
        "req": req,
        "state": QUEUED,
        "lane": None,
        "pool": req.n_class,
        "generation": None,
        "result": None,
        "idle_rounds": 0,
        "spill_path": None,
        "saved_run": None,
        "spill_owner": None,  # engine-id stamped in the spill file
        "retry_spill": False,
    }


class ServeEngine:
    """Continuous-batching round loop over a dict of lane pools.

    ``pools`` maps pow2 N-class -> :class:`LanePool`; requests are routed
    by :func:`lane_n_class`. ``on_event`` (optional) is called with every
    emitted manifest record as it happens — the server's live stream tap.
    ``admission`` (optional) gates submits; ``journal_dir`` (optional)
    write-ahead-logs every transition for :meth:`recover`.
    """

    def __init__(
        self,
        pools,
        warp: bool = True,
        max_leap: int = 256,
        spill_after: int | None = None,
        spill_dir: str | None = None,
        on_event=None,
        admission=None,
        journal_dir: str | None = None,
        sync_spill: bool = False,
        spill_depth: int = 4,
        spills_per_round: int = 1,
        obs=None,
        engine_id: str | None = None,
        warp_memo: SpanMemo | bool | None = None,
        warp_mode: str = "exact",
    ) -> None:
        self.pools: dict[int, LanePool] = {}
        for pool in pools:
            if pool.n in self.pools:
                raise ValueError(f"duplicate pool class n={pool.n}")
            self.pools[pool.n] = pool
        if not self.pools:
            raise ValueError("need at least one pool")
        self.warp = bool(warp)
        self.max_leap = int(max_leap)
        if self.max_leap < MIN_LEAP:
            raise ValueError(f"need max_leap >= MIN_LEAP ({MIN_LEAP})")
        # Warp 3.0: signature-keyed span memo for the leap rounds.
        # ``True`` adopts the process-shared ``span_memo`` (serve lanes,
        # fleet drains, and sim runs then trade deltas); a ``SpanMemo``
        # instance scopes the cache to this engine; ``None`` turns
        # memoization off (every leap round dispatches, as before).
        _check_warp_mode(warp_mode)
        self.warp_mode = warp_mode
        if warp_memo is True:
            from kaboodle_tpu_torch.warp.runner import span_memo

            self.warp_memo: SpanMemo | None = span_memo
        elif warp_memo is False:
            self.warp_memo = None
        else:
            self.warp_memo = warp_memo
        self.spill_after = spill_after
        self.spill_dir = spill_dir
        # Federation identity: namespaces this engine's spill files under
        # ``<spill_dir>/<engine_id>/`` and stamps every spill archive +
        # journal directory, so engines sharing one spill root can never
        # collide on paths or silently cross-restore a lane snapshot.
        self.engine_id = engine_id
        if engine_id is not None and spill_dir is not None:
            self.spill_dir = os.path.join(spill_dir, engine_id)
            os.makedirs(self.spill_dir, exist_ok=True)
        self.on_event = on_event
        self.admission = admission
        self.sync_spill = bool(sync_spill)
        self.spill_depth = int(spill_depth)
        # Idle spills initiated per round: even the HOST side of a spill
        # (the lane copy + device->host copy) costs a round-loop
        # slice, so initiation is paced — one copy per round keeps round
        # latency within the no-spill envelope however many lanes idle out
        # together. Evictions (preemption) bypass the pacing: admission
        # needs the lane this round.
        self.spills_per_round = int(spills_per_round)
        self.journal = None
        if journal_dir is not None:
            from kaboodle_tpu_torch.serve.journal import ServeJournal

            if engine_id is not None:
                journal_dir = os.path.join(journal_dir, engine_id)
            self.journal = ServeJournal(journal_dir, owner=engine_id)
        self.round = 0
        self._next_rid = 0
        self._events: list[dict] = []
        self._spiller = None  # lazy: engines that never spill get no thread
        # rid -> bookkeeping row; insertion order is admission FIFO order.
        self._requests: OrderedDict[int, dict] = OrderedDict()
        # (n_class, lane) -> rid for lanes currently occupied by a request.
        self._lane_owner: dict[tuple[int, int], int] = {}
        # Why-dense ledger: when a round falls back from leap to
        # chunk, the blocking signature terms are recorded per horizon lane
        # — host-side bookkeeping only, engine state stays bit-identical.
        # Surfaced by the obs plane's warp_blocked_* gauges.
        self.warp_ledger = WarpLedger()
        # Observability plane: obs=True gets the defaults,
        # obs=ObsPlane(...) a configured one. The plane is a pure observer
        # — engine state is bit-identical with it on or off — and its
        # epoch is shared with the journal so WAL ts_us and span t0_us
        # live on one monotonic timeline.
        self.obs: ObsPlane | None = None
        if obs:
            self.obs = obs if isinstance(obs, ObsPlane) else ObsPlane()
            self.obs.bind(self)
            if self.journal is not None:
                self.journal.epoch_ns = self.obs.epoch_ns

    @property
    def spiller(self):
        if self._spiller is None:
            from kaboodle_tpu_torch.serve.spill import SpillManager

            self._spiller = SpillManager(
                depth=self.spill_depth, owner=self.engine_id,
                device=next(iter(self.pools.values())).device,
            )
        return self._spiller

    def close(self) -> None:  # conc: event-loop
        """Join outstanding spill I/O, release the journal handle and close
        the pools (a sharded pool's followers stop here)."""
        if self._spiller is not None:
            self._spiller.flush()
            self._poll_spills()
            self._spiller.close()
        if self.obs is not None:
            for rec in self.obs.flush_spans():
                if self.on_event is not None:
                    self.on_event(rec)
            self.obs.close()
        if self.journal is not None:
            self.journal.close()
        for pool in self.pools.values():
            pool.close()

    def _log(self, op: str, rid: int, **fields) -> None:
        if self.journal is None:
            return
        if self.obs is not None:
            t0 = time.perf_counter_ns()
            self.journal.append(op, rid, **fields)
            self.obs.profiler.add_ns(
                SEG_JOURNAL, time.perf_counter_ns() - t0
            )
        else:
            self.journal.append(op, rid, **fields)

    def _span(self, rid: int, span: str | None, pool_n: int = -1,
              lane: int = -1, **extra) -> None:
        """One lifecycle edge on the tracer: closes the request's open
        span (fanning the ``serve_span`` record out to the stream and
        manifest) and opens the next (None = terminal). No-op without an
        observability plane."""
        if self.obs is None:
            return
        rec = self.obs.transition(rid, span, pool_n=pool_n, lane=lane,
                                  **extra)
        if rec is not None and self.on_event is not None:
            self.on_event(rec)

    # -- request surface ---------------------------------------------------

    def submit(self, req: ServeRequest) -> int:  # conc: event-loop
        """Queue a request; returns its request id. Raises on an unserved
        N-class or a faulty knob no pool can honor — rejection is loud,
        not an event. With admission control attached, quota and
        queue-capacity rejections raise structured
        :class:`~kaboodle_tpu_torch.serve.admission.AdmissionError` subclasses
        carrying ``retry_after_s`` (emitted as ``rejected`` events)."""
        n_class = req.n_class
        pool = self.pools.get(n_class)
        if pool is None:
            raise ValueError(
                f"no pool serves N-class {n_class} (request n={req.n})"
            )
        if req.scenario not in ("boot", "steady"):
            raise ValueError(f"unknown scenario {req.scenario!r}")
        if req.drop_rate and not pool.faulty:
            raise ValueError(
                f"pool n={n_class} is fault-free; drop_rate must be 0"
            )
        if self.admission is not None:
            try:
                self._admission_gate(req)
            except AdmissionError as e:
                self._emit_standalone(
                    "serve_event", event="rejected", request_id=-1,
                    pool_n=n_class, lane=-1, tenant=req.tenant,
                    priority=req.priority, reason=e.kind,
                    retry_after_s=e.retry_after_s,
                )
                raise
        rid = self._next_rid
        self._next_rid += 1
        self._requests[rid] = _fresh_row(req)
        self._log("submitted", rid, req=dataclasses.asdict(req))
        self._emit_standalone(
            "serve_event", event="submitted", request_id=rid, pool_n=n_class,
            lane=-1, tenant=req.tenant, priority=req.priority,
        )
        self._span(rid, "queued", pool_n=n_class)
        return rid

    def _admission_gate(self, req: ServeRequest) -> None:
        """Quota first (one token per accepted OR shed-displacing submit),
        then queue capacity — shedding the lowest-priority queued request
        when the newcomer strictly outranks it, else raising queue_full."""
        self.admission.check_quota(req.tenant)
        queued = [
            (rid, row)
            for rid, row in self._requests.items()
            if row["state"] == QUEUED
        ]
        if len(queued) < self.admission.max_queue:
            return
        victim = min(queued, key=lambda kv: (kv[1]["req"].priority, kv[0]))
        if victim[1]["req"].priority < req.priority:
            self._shed(victim[0], victim[1])
            return
        self.admission.check_queue(len(queued))

    def _shed(self, rid: int, row: dict) -> None:
        row["state"] = CANCELLED
        self._log("shed", rid)
        self._emit_standalone(
            "serve_event", event="shed", request_id=rid, pool_n=row["pool"],
            lane=-1, tenant=row["req"].tenant, priority=row["req"].priority,
        )
        self._span(rid, None, fate="shed")

    def cancel(self, rid: int) -> bool:  # conc: event-loop
        """Cancel a request in any non-terminal state; frees its lane."""
        row = self._requests.get(rid)
        if row is None or row["state"] in (DONE, CANCELLED):
            return False
        if row["state"] in (RUNNING, PARKED, SPILLING):
            pool = self.pools[row["pool"]]
            pool.release(row["lane"])
            del self._lane_owner[(row["pool"], row["lane"])]
            row["lane"] = None
        if self._spiller is not None:
            self._spiller.drop_cache(rid)
        row["state"] = CANCELLED
        row["retry_spill"] = False
        self._log("cancelled", rid)
        self._emit("serve_event", event="cancelled", request_id=rid,
                   pool_n=row["pool"], lane=-1)
        self._span(rid, None, fate="cancelled")
        return True

    def status(self, rid: int | None = None):  # conc: event-loop
        """One request's public row, or all of them (rid=None)."""
        if rid is not None:
            row = self._requests.get(rid)
            return None if row is None else self._public_row(rid, row)
        return [self._public_row(r, row) for r, row in self._requests.items()]

    def _public_row(self, rid: int, row: dict) -> dict:
        req = row["req"]
        out = {
            "request_id": rid,
            "state": row["state"],
            "n": req.n,
            "n_class": row["pool"],
            "seed": req.seed,
            "mode": req.mode,
            "tenant": req.tenant,
            "priority": req.priority,
            "lane": row["lane"],
            "generation": row["generation"],
        }
        if row["result"] is not None:
            out["result"] = dict(row["result"])
        if row["spill_path"] is not None:
            out["spill_path"] = row["spill_path"]
        return out

    # -- spill / restore ---------------------------------------------------

    def _spill_path(self, rid: int, row: dict) -> str:
        return os.path.join(
            self.spill_dir, f"lane-n{row['pool']}-req{rid}.npz"
        )

    def _begin_spill(self, rid: int, row: dict, evict: bool = False) -> bool:
        """Start spilling a parked lane. Async path: host-copy now, hand
        to the background writer, hold the lane (``spilling``) until the
        write is durable — unless ``evict``, where the lane frees
        immediately and the host copy is the request until durable.
        Returns False (and emits ``spill_deferred``) when the bounded
        write queue is full — the caller retries next round."""
        pool = self.pools[row["pool"]]
        lane = row["lane"]
        path = self._spill_path(rid, row)
        saved_run = pool.run_counters(lane)
        if self.sync_spill:
            from kaboodle_tpu_torch import checkpoint

            checkpoint.save(path, pool.member(lane), atomic=True,
                            owner=self.engine_id)
            pool.release(lane)
            del self._lane_owner[(row["pool"], lane)]
            row.update(state=SPILLED, lane=None, spill_path=path,
                       saved_run=saved_run, spill_owner=self.engine_id)
            self._log("spilled", rid, path=path, saved_run=saved_run)
            self._emit("serve_event",
                       event="preempted" if evict else "spilled",
                       request_id=rid, pool_n=row["pool"], lane=lane,
                       path=path)
            self._span(rid, "spilled", pool_n=row["pool"])
            return True
        # A thunk over a device copy of the lane taken NOW (the pool writes
        # lanes in place): the writer thread does the device->host transfer
        # and the disk write, so the round loop pays a lane copy and a put.
        member = pool.member_snapshot(lane)
        if not self.spiller.submit_write(rid, path, member):
            self.spiller.drop_cache(rid)
            self._emit("serve_event", event="spill_deferred", request_id=rid,
                       pool_n=row["pool"], lane=lane)
            return False
        self._log("spill_begin", rid, path=path)
        row.update(spill_path=path, saved_run=saved_run,
                   spill_owner=self.engine_id)
        if evict:
            pool.release(lane)
            del self._lane_owner[(row["pool"], lane)]
            row.update(state=SPILLED, lane=None)
            self._emit("serve_event", event="preempted", request_id=rid,
                       pool_n=row["pool"], lane=lane, path=path)
            self._span(rid, "spilling", pool_n=row["pool"])
        else:
            row["state"] = SPILLING
            self._span(rid, "spilling", pool_n=row["pool"], lane=lane)
        return True

    def _poll_spills(self) -> None:
        """Fold completed background I/O into request state (round start).

        A durable write frees a ``spilling`` lane (or just journals an
        evicted one); a failed write degrades a held lane back to parked
        — loudly — or, for an evicted lane whose host copy is the only
        remaining state, marks the write for retry."""
        if self._spiller is None:
            return
        for res in self._spiller.poll():
            row = self._requests.get(res.rid)
            if row is None or res.op == "read":
                continue  # prefetch results live in the cache
            if res.ok:
                if row["state"] == SPILLING:
                    pool = self.pools[row["pool"]]
                    lane = row["lane"]
                    pool.release(lane)
                    del self._lane_owner[(row["pool"], lane)]
                    row.update(state=SPILLED, lane=None)
                    self._log("spilled", res.rid, path=res.path,
                              saved_run=row["saved_run"])
                    self._emit("serve_event", event="spilled",
                               request_id=res.rid, pool_n=row["pool"],
                               lane=lane, path=res.path)
                    self._span(res.rid, "spilled", pool_n=row["pool"])
                elif row["state"] == SPILLED:
                    self._log("spilled", res.rid, path=res.path,
                              saved_run=row["saved_run"])
                    self._emit("serve_event", event="spilled",
                               request_id=res.rid, pool_n=row["pool"],
                               lane=-1, path=res.path)
                    self._span(res.rid, "spilled", pool_n=row["pool"])
                # restored/cancelled while in flight: the file is a
                # harmless stale snapshot; nothing to transition.
            elif row["state"] == SPILLING:
                self.spiller.drop_cache(res.rid)
                row.update(state=PARKED, idle_rounds=0, spill_path=None,
                           saved_run=None)
                self._log("spill_failed", res.rid, path=res.path,
                          error=res.error)
                self._emit("serve_event", event="spill_failed",
                           request_id=res.rid, pool_n=row["pool"],
                           lane=row["lane"], error=res.error)
                self._span(res.rid, "parked", pool_n=row["pool"],
                           lane=row["lane"], fate="spill_failed")
            elif row["state"] == SPILLED:
                row["retry_spill"] = True
                self._log("spill_failed", res.rid, path=res.path,
                          error=res.error)
                self._emit("serve_event", event="spill_failed",
                           request_id=res.rid, pool_n=row["pool"], lane=-1,
                           error=res.error, retrying=True)

    def _retry_spills(self) -> None:
        for rid, row in self._requests.items():
            if not row["retry_spill"]:
                continue
            member = self.spiller.cached(rid)
            if member is None:  # a racing write actually landed
                row["retry_spill"] = False
                continue
            if self.spiller.submit_write(rid, row["spill_path"], member):
                row["retry_spill"] = False

    def settle_spills(self, max_rounds: int = 100) -> None:
        """Block until no spill write is in flight or pending retry (test
        and shutdown helper — the round loop itself never blocks)."""
        if self._spiller is None:
            return
        for _ in range(max_rounds):
            self._spiller.flush()
            self.step()
            if not any(
                row["state"] == SPILLING or row["retry_spill"]
                for row in self._requests.values()
            ):
                return
        raise RuntimeError("spill writes still failing after retries")

    def restore(self, rid: int) -> bool:  # conc: event-loop
        """Bring a spilled request back into a free lane (parked). Returns
        False when its class pool has no free lane right now. Prefers the
        spill manager's host cache (an evicted lane whose write has not
        landed yet restores from memory); a missing/corrupt spill file
        raises :class:`CheckpointError` after a ``restore_failed`` event —
        the request stays spilled, the engine keeps serving."""
        from kaboodle_tpu_torch import checkpoint

        row = self._requests.get(rid)
        if row is None or row["state"] != SPILLED:
            raise ValueError(f"request {rid} is not spilled")
        pool = self.pools[row["pool"]]
        lane = pool.free_lane()
        if lane is None:
            return False
        member = (
            self._spiller.cached(rid) if self._spiller is not None else None
        )
        if member is None:
            # The stamp check: this engine's own files carry its id; an
            # adopted request's file carries the DEAD engine's id, which
            # rode in through adopt(). Anything else is an alien snapshot.
            expect = row["spill_owner"] if self.engine_id is not None else None
            try:
                member = checkpoint.load(
                    row["spill_path"], expect_owner=expect, device=pool.device
                )
            except CheckpointError as e:
                self._emit_standalone(
                    "serve_event", event="restore_failed", request_id=rid,
                    pool_n=row["pool"], lane=-1, error=str(e),
                )
                raise
        row["generation"] = pool.insert(lane, member)
        if row["saved_run"] is not None:
            pool.set_run_counters(lane, row["saved_run"])
        if self._spiller is not None:
            self._spiller.drop_cache(rid)
        row["retry_spill"] = False
        self._lane_owner[(row["pool"], lane)] = rid
        row.update(state=PARKED, lane=lane, idle_rounds=0)
        self._log("restored", rid)
        self._emit("serve_event", event="restored", request_id=rid,
                   pool_n=row["pool"], lane=lane,
                   generation=row["generation"])
        self._span(rid, "parked", pool_n=row["pool"], lane=lane,
                   fate="restored")
        return True

    def resume(self, rid: int, mode: str = "ticks", ticks: int = 16) -> None:  # conc: event-loop
        """Re-activate a parked request with a fresh budget (continuation
        runs across the park/spill boundary keep their tick counters)."""
        row = self._requests.get(rid)
        if row is None or row["state"] != PARKED:
            raise ValueError(f"request {rid} is not parked")
        if mode not in ("converge", "ticks"):
            raise ValueError(f"unknown mode {mode!r}")
        pool = self.pools[row["pool"]]
        pool.resume(row["lane"], until_conv=(mode == "converge"),
                    budget=int(ticks))
        row["state"] = RUNNING
        row["idle_rounds"] = 0
        row["result"] = None  # the continuation's harvest replaces it
        self._log("resumed", rid, mode=mode, ticks=int(ticks))
        self._emit("serve_event", event="resumed", request_id=rid,
                   pool_n=row["pool"], lane=row["lane"], mode=mode,
                   ticks=int(ticks))
        self._span(rid, "running", pool_n=row["pool"], lane=row["lane"])

    def adopt(
        self,
        req: ServeRequest,
        spill_path: str,
        saved_run: dict | None,
        owner: str | None,
    ) -> int:  # conc: event-loop
        """Take over a dead engine's SPILLED request (federation failover).

        The router replays the dead engine's journal, finds a non-terminal
        request whose last durable state is a spill file in the shared
        root, and hands (request, file, frozen run counters, dead engine's
        id) to a survivor here. The request lands ``spilled`` under a
        fresh local rid; a later :meth:`restore` loads the file expecting
        the DEAD engine's owner stamp — the explicit handover is exactly
        the intentional cross-engine restore the stamp guard exists to
        separate from accidental ones. Journaled as one ``adopted`` record
        (submitted + spilled folded), so the survivor's own recovery
        re-attaches it like any native spill."""
        if req.n_class not in self.pools:
            raise ValueError(
                f"no pool serves N-class {req.n_class} (adopt n={req.n})"
            )
        if not os.path.exists(spill_path):
            raise CheckpointError(f"adopt: spill file missing: {spill_path}")
        rid = self._next_rid
        self._next_rid += 1
        row = _fresh_row(req)
        row.update(state=SPILLED, spill_path=spill_path, saved_run=saved_run,
                   spill_owner=owner)
        self._requests[rid] = row
        self._log("adopted", rid, req=dataclasses.asdict(req),
                  path=spill_path, saved_run=saved_run, owner=owner)
        self._emit_standalone(
            "serve_event", event="adopted", request_id=rid,
            pool_n=row["pool"], lane=-1, path=spill_path,
            prior_owner=owner if owner is not None else "",
        )
        self._span(rid, "spilled", pool_n=row["pool"])
        return rid

    # -- crash recovery ----------------------------------------------------

    def recover(self) -> dict:
        """Rebuild the request table from this engine's journal.

        Call on a FRESH engine (warmed pools, empty table) constructed
        with the crashed engine's ``journal_dir``. Folding rules: terminal
        rows keep their results and are never re-run; rows whose last
        durable state is a spill file re-attach as ``spilled`` (their
        host run counters ride along, so a later restore+resume is a true
        continuation); everything else — queued, running, parked-but-not-
        spilled, mid-spill — lost its device state with the process and
        re-queues from its seed with a cumulative tick budget (original
        budget plus every journaled ticks-mode resume). Returns per-
        disposition counts, emits ``recovered`` (+ per-row ``requeued``),
        and compacts the journal."""
        if self.journal is None:
            raise ValueError("recover() needs an engine with journal_dir")
        if self._requests:
            raise ValueError("recover() needs an empty engine")
        # Startup phase: replay + cold restores are budgeted stalls for
        # the conc sanitizer's loop watchdog, like warmup's builds.
        _conc_sanitizer.budget_current_callback()
        table, next_rid = self.journal.replay()
        counts = {"done": 0, "spilled": 0, "requeued": 0, "cancelled": 0,
                  "dropped": 0}
        requeued: list[int] = []
        for rid in sorted(table):
            jrow = table[rid]
            if jrow.get("req") is None:
                counts["dropped"] += 1  # torn submit: client never acked
                continue
            req = ServeRequest(**jrow["req"])
            if req.n_class not in self.pools:
                counts["dropped"] += 1
                continue
            row = _fresh_row(req)
            op = jrow.get("op")
            spill_ok = bool(jrow.get("spill_path")) and os.path.exists(
                jrow["spill_path"]
            )
            if op in ("cancelled", "shed"):
                row["state"] = CANCELLED
                counts["cancelled"] += 1
            elif spill_ok and op in ("spilled", "restored", "adopted"):
                # Native spills restore under this engine's stamp; adopted
                # ones keep the dead engine's (the journal remembers it).
                owner = (jrow.get("spill_owner") if op == "adopted"
                         else self.engine_id)
                row.update(state=SPILLED, spill_path=jrow["spill_path"],
                           saved_run=jrow.get("saved_run"),
                           result=jrow.get("result"), spill_owner=owner)
                counts["spilled"] += 1
            elif op == "harvested":
                row.update(state=DONE, result=jrow.get("result"))
                counts["done"] += 1
            else:
                extra = int(jrow.get("extra_ticks", 0))
                if extra:
                    req = dataclasses.replace(req, ticks=req.ticks + extra)
                    row["req"] = req
                counts["requeued"] += 1
                requeued.append(rid)
            self._requests[rid] = row
        self._next_rid = max(self._next_rid, next_rid)
        self.journal.compact(table, self._next_rid)
        # Re-queue in journal order (the WAL's sequence numbers; rid as
        # the pre-seq fallback), so recovery admission replays the order
        # the crashed engine actually witnessed.
        requeued.sort(key=lambda rid: (table[rid].get("seq", rid), rid))
        for rid in requeued:
            self._log("requeued", rid)
            self._emit_standalone(
                "serve_event", event="requeued", request_id=rid,
                pool_n=self._requests[rid]["pool"], lane=-1,
            )
            self._span(rid, "queued", pool_n=self._requests[rid]["pool"])
        for rid, row in self._requests.items():
            if row["state"] == SPILLED:
                self._span(rid, "spilled", pool_n=row["pool"])
        self._emit_standalone(
            "serve_event", event="recovered", request_id=-1, lane=-1,
            pool_n=min(self.pools), **counts,
        )
        return counts

    # -- the round loop ----------------------------------------------------

    @property
    def busy(self) -> bool:
        if any(row["state"] == QUEUED for row in self._requests.values()):
            return True
        return any(pool.active.any() for pool in self.pools.values())

    @property
    def spilling(self) -> bool:
        """Spill I/O in flight or pending retry (the server's idle loop
        keeps stepping while this holds, so completions get folded)."""
        return any(
            row["state"] == SPILLING or row["retry_spill"]
            for row in self._requests.values()
        )

    def step(self) -> list[dict]:  # conc: event-loop
        """One engine round: fold spill completions, admit, advance every
        pool, harvest, spill. Never blocks on disk.

        Returns the manifest records emitted this round (also fanned out
        through ``on_event`` as they happen). With an observability plane
        attached the loop sections are bracketed by monotonic-clock laps
        (preallocated accumulators — no allocation per round) and, when
        tracing, the finished round is emitted as one ``round`` span
        carrying the segment split."""
        obs = self.obs
        prof = obs.profiler if obs is not None else None
        self._events = []
        if prof is not None:
            t = prof.round_begin()
            t0_us = obs.now_us()
        self._poll_spills()
        self._retry_spills()
        if prof is not None:
            t = prof.lap(SEG_POLL, t)
        self._admit_queued()
        if prof is not None:
            t = prof.lap(SEG_ADMIT, t)
        for pool in self.pools.values():
            if not pool.active.any():
                continue
            if not self._try_leap_round(pool):
                self._chunk_round(pool)
            if prof is not None:
                t = prof.lap(SEG_DISPATCH, t)
            self._harvest(pool)
            if prof is not None:
                t = prof.lap(SEG_HARVEST, t)
        self._spill_idle()
        if prof is not None:
            t = prof.lap(SEG_SPILL, t)
        rnd = self.round
        self.round += 1
        if self.journal is not None and self.journal.should_compact():
            table, next_rid = self.journal.replay()
            self.journal.compact(table, max(next_rid, self._next_rid))
        if prof is not None:
            prof.lap(SEG_JOURNAL, t)
            prof.round_end()
            if obs.trace:
                self._emit(
                    "serve_span", span="round", request_id=-1, pool_n=-1,
                    lane=-1, round=rnd, t0_us=t0_us,
                    dur_us=int(prof.last_us[SEG_ROUND]),
                    segments=prof.last_segments(),
                )
        return self._events

    def drain(self, max_rounds: int = 10_000) -> list[dict]:
        """Round until nothing is queued or active; returns all events."""
        events: list[dict] = []
        for _ in range(max_rounds):
            if not self.busy:
                return events
            events.extend(self.step())
        raise RuntimeError(f"engine still busy after {max_rounds} rounds")

    def _admit_queued(self) -> None:
        queued = [
            (rid, row)
            for rid, row in self._requests.items()
            if row["state"] == QUEUED
        ]
        if self.admission is not None:
            # Priority classes admit first; FIFO (rid order) within one.
            queued.sort(key=lambda kv: (-kv[1]["req"].priority, kv[0]))
        for rid, row in queued:
            pool = self.pools[row["pool"]]
            lane = pool.free_lane()
            if lane is None and self.admission is not None:
                if self._preempt_for(row):
                    lane = pool.free_lane()
            if lane is None:
                continue  # class full this round; stays queued
            req: ServeRequest = row["req"]
            row["generation"] = pool.admit(
                lane, seed=req.seed, drop_rate=req.drop_rate,
                until_conv=req.until_conv, budget=req.ticks,
                scenario=req.scenario,
            )
            self._lane_owner[(row["pool"], lane)] = rid
            row.update(state=RUNNING, lane=lane)
            self._log("admitted", rid, lane=lane,
                      generation=row["generation"])
            self._emit("serve_event", event="admitted", request_id=rid,
                       pool_n=row["pool"], lane=lane,
                       generation=row["generation"], seed=req.seed,
                       mode=req.mode, scenario=req.scenario)
            self._span(rid, "running", pool_n=row["pool"], lane=lane)

    def _preempt_for(self, row: dict) -> bool:
        """Spill-evict one strictly lower-priority PARKED lane of this
        class (lowest priority, then oldest-parked) to admit ``row``.
        Running lanes are never preempted. Needs a spill_dir."""
        if self.spill_dir is None:
            return False
        pri = row["req"].priority
        victims = [
            (rid, r)
            for rid, r in self._requests.items()
            if r["state"] == PARKED and r["pool"] == row["pool"]
            and r["req"].priority < pri
        ]
        if not victims:
            return False
        vrid, vrow = min(
            victims,
            key=lambda kv: (kv[1]["req"].priority, -kv[1]["idle_rounds"],
                            kv[0]),
        )
        return self._begin_spill(vrid, vrow, evict=True)

    def _try_leap_round(self, pool: LanePool) -> bool:
        """One masked fleet-leap dispatch if any horizon lane can cover
        MIN_LEAP ticks; returns False when this round must run dense."""
        if not self.warp or pool.faulty or pool.telemetry:
            return False
        horizon = pool.active & ~pool.until_conv & (pool.remaining > 0)
        if not horizon.any():
            return False
        rows = pool.signature().cpu().numpy()  # noqa: KB501 — bounded [E]-row fetch; the round loop dispatches inline by design (server.py docstring)
        k_m = np.zeros((pool.lanes,), dtype=np.int32)
        tracing = self.obs is not None and self.obs.trace
        classes: list[dict] = []
        decoded: list[tuple] = []  # (cls, mode) per horizon lane
        for e in np.flatnonzero(horizon):
            cls = decode_signature(rows[e])
            mode = _classify(cls, hybrid=True, warp_mode=self.warp_mode)
            if mode != "dense":
                k_m[e] = min(
                    _leap_budget(cls, mode, int(pool.remaining[e])),
                    self.max_leap,
                )
            decoded.append((cls, mode))
            if tracing:
                classes.append({
                    "lane": int(e), "k": int(k_m[e]), "mode": mode,
                    "class_key": cls.key, "terms": cls.describe()["terms"],
                })
        if k_m.max() < MIN_LEAP:
            # Round falls back to the chunk engine: attribute the dense
            # ticks each horizon lane is about to pay (pool.chunk) to the
            # signature terms that blocked its leap — host-side only.
            for cls, mode in decoded:
                self.warp_ledger.record_blocked(
                    cls, pool.chunk, "serve", mode=mode
                )
            return False
        K = 1 << int(k_m.max() - 1).bit_length()
        K = max(K, MIN_LEAP)
        if tracing:
            t0_us = self.obs.now_us()
        memo_hits, dispatched = pool.leap(K, k_m, memo=self.warp_memo)
        pool.advance_leaped(k_m)
        self._emit(
            "serve_round", round=self.round, pool_n=pool.n,
            engine="leap" if dispatched else "leap+memo",
            lanes=int((k_m > 0).sum()), ticks=int(k_m.sum()), bucket=K,
            memo_hits=memo_hits,
        )
        if tracing:
            # One advance span per pool round, each leaping lane annotated
            # with its signature class. dur_us is the round loop's wall time
            # of the call (device work may still be queued).
            self._emit(
                "serve_span", span="advance", request_id=-1, pool_n=pool.n,
                lane=-1, t0_us=t0_us, dur_us=self.obs.now_us() - t0_us,
                round=self.round, engine="leap", bucket=K, classes=classes,
            )
        return True

    def _chunk_round(self, pool: LanePool) -> None:
        prev = pool.ticks_run.copy()
        tracing = self.obs is not None and self.obs.trace
        if tracing:
            t0_us = self.obs.now_us()
            active = [int(e) for e in np.flatnonzero(pool.active)]
        pool.step()
        self._emit(
            "serve_round", round=self.round, pool_n=pool.n, engine="chunk",
            lanes=int(pool.active.sum()),
            ticks=int((pool.ticks_run - prev).sum()),
        )
        if tracing:
            self._emit(
                "serve_span", span="advance", request_id=-1, pool_n=pool.n,
                lane=-1, t0_us=t0_us, dur_us=self.obs.now_us() - t0_us,
                round=self.round, engine="chunk",
                classes=[
                    {"lane": e, "k": int(pool.ticks_run[e] - prev[e])}
                    for e in active
                ],
            )

    def _harvest(self, pool: LanePool) -> None:
        finished = pool.active & (
            (pool.until_conv & (pool.conv_tick >= 0))
            | (pool.remaining <= 0)
        )
        if not finished.any():
            return
        converged, fp_min, fp_max, n_alive = pool.agreement()
        for lane in np.flatnonzero(finished):
            lane = int(lane)
            rid = self._lane_owner[(pool.n, lane)]
            row = self._requests[rid]
            req: ServeRequest = row["req"]
            result = {
                "ticks_run": int(pool.ticks_run[lane]),
                "conv_tick": int(pool.conv_tick[lane]),
                "converged": bool(converged[lane]),
                "fp_min": int(fp_min[lane]),
                "fp_max": int(fp_max[lane]),
                "n_alive": int(n_alive[lane]),
                "messages": int(pool.messages[lane]),
            }
            counters = pool.counters_row(lane)
            if counters is not None:
                result["counters"] = counters
            row["result"] = result
            if not pool.until_conv[lane]:
                event = "completed"  # horizon run: ran its exact ticks
            elif pool.conv_tick[lane] >= 0:
                event = "converged"
            else:
                event = "exhausted"  # converge run: budget up, no agreement
            self._log("harvested", rid, event=event, result=result)
            self._emit(
                "serve_event", event=event, request_id=rid, pool_n=pool.n,
                lane=lane, generation=row["generation"], **result,
            )
            if req.keep:
                pool.park(lane)
                row["state"] = PARKED
                row["idle_rounds"] = 0
                self._span(rid, "parked", pool_n=pool.n, lane=lane,
                           fate=event, ticks_run=result["ticks_run"])
            else:
                pool.release(lane)
                del self._lane_owner[(pool.n, lane)]
                row.update(state=DONE, lane=None)
                self._span(rid, None, fate=event,
                           ticks_run=result["ticks_run"])

    def _spill_idle(self) -> None:
        if self.spill_after is None or self.spill_dir is None:
            return
        begun = 0
        for rid, row in self._requests.items():
            if row["state"] != PARKED:
                continue
            row["idle_rounds"] += 1
            if (row["idle_rounds"] > self.spill_after
                    and begun < self.spills_per_round):
                # deferred (queue full) => retried next round
                begun += int(self._begin_spill(rid, row))

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> None:
        """Build the whole serving surface with state-preserving calls:
        each pool's program set (pool.warmup), then — for pools the warp
        applies to — the signature fetch and every leap bucket
        8..max_leap at ``k_m = 0`` (the masked span program freezes
        everyone bit-exactly at zero). After this the round loop's admit/
        leap/chunk/harvest/spill path builds nothing (``compiles_steady``
        stays 0)."""
        # Budgeted for the conc sanitizer's loop watchdog, like the
        # compiles_steady gauge: warmup stalls are the contract, steady-
        # state stalls are the bug.
        with _conc_sanitizer.budgeted():
            for pool in self.pools.values():
                pool.warmup()
                if not self.warp or pool.faulty or pool.telemetry:
                    continue
                pool.signature().cpu()
                zeros = np.zeros((pool.lanes,), dtype=np.int32)
                K = MIN_LEAP
                while K <= self.max_leap:
                    pool.leap(K, zeros)
                    K <<= 1
        self._emit_standalone(
            "serve_event", event="warm", request_id=-1, lane=-1,
            pool_n=min(self.pools), pools=sorted(self.pools),
        )
        if self.obs is not None:
            # Warmup builds are the budgeted ones; from here on the
            # ``compiles_steady`` gauge counts contract violations.
            self.obs.reset_compiles()

    # -- events ------------------------------------------------------------

    def _emit(self, kind: str, **fields) -> dict:
        rec = self._emit_standalone(kind, **fields)
        self._events.append(rec)
        return rec

    def _emit_standalone(self, kind: str, **fields) -> dict:
        if self.obs is not None:
            if self.obs.trace and "t_us" not in fields:
                # Wall-clock stamp (plane-epoch us) so lifecycle events
                # land on the same trace timeline as the spans.
                fields["t_us"] = self.obs.now_us()
            rec = run_record(kind, **fields)
            self.obs.on_record(rec)
        else:
            rec = run_record(kind, **fields)
        if self.on_event is not None:
            self.on_event(rec)
        return rec

    def stats(self) -> dict:  # conc: event-loop
        states: dict[str, int] = {}
        for row in self._requests.values():
            states[row["state"]] = states.get(row["state"], 0) + 1
        return {
            "round": self.round,
            "requests": len(self._requests),
            "states": states,
            "pools": {n: p.stats() for n, p in self.pools.items()},
        }
