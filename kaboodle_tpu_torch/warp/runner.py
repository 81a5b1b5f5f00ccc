"""Warp runners: signature-classed fast-forward between dense ticks.

The port of ``kaboodle_tpu/warp/runner.py``. The dense runners (``sim/runner.py``, ``fleet/core.py``) run one
full tick per simulated tick. These runners cut a run into *spans* bounded
by the event horizon (``warp/horizon.py``) and pick each span's program by
the entry state's **activity signature**:

- class ``leap`` (every signature bit clear): the strict span program
  (``phasegraph/span.py``) replays the whole event-free span in bucketed
  power-of-two calls, bit-exact with dense ticking;
- class ``hybrid`` (only armed-but-unexpired timers, disagreeing
  fingerprints or a live anti-entropy ledger): the hybrid program leaps to
  ``min(next scheduled event, earliest timer expiry)``; the expiry tick and
  what follows re-classify;
- class ``dense`` (any other bit): dense ticks, re-checking the signature
  every ``recheck_every`` ticks.

One signature fetch (an int32[4] row) decides each span. The runners work
on the device of the state they are given: leaps, dense ticks and memo
replays all leave the state there.

**Bounded program cache**: built leap closures are kept in
:class:`ProgramCache` keyed by (config family, strict/hybrid, chunk
length), where chunk lengths are powers of two at least ``MIN_LEAP``: a
span of any length costs at most ``log2(span)`` leap calls plus up to
``MIN_LEAP - 1`` dense ticks, and the cache holds at most
``len(CHUNK_BUCKETS)`` programs per family by construction. (Torch builds
no compiled program; the bound keeps the vocabulary of span lengths the
JAX package compiles, and the cache's ``stats()``.)

**Span memo** (:class:`SpanMemo`): every span's effect is a pure function
of its entry state under the counter-keyed draws, so a span's state delta
(byte XOR of entry and exit leaves) is banked on the host under the span's
identity and entry-state digest, and a recurring span is replayed from it
with no tick or leap run.

**Sharded warp** (``mesh=`` on :func:`simulate_warped` and
:func:`run_warped`): the state is the rank's rows of a ``parallel`` mesh;
the dense stretches run the row-sharded tick, the leaps the row-sharded
span program, the signature and the schedule's event mask are reduced
over the ranks, so every rank takes the same spans; a memo replay happens
only when every rank hits, and the memo key carries the mesh.

**Per-member fleet warp**: :func:`run_fleet_warped` fetches the ``[E, 4]``
signature rows once a round; every leapable member leaps to its own
horizon inside ONE masked leap call over the ``[E, ...]`` leaves, and
only dense-class members ride dense ticks, the others frozen by
``fleet/core.py::freeze_members``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, freeze_members, make_fleet_tick_fn
from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick, make_warp_leap
from kaboodle_tpu_torch.sim.runner import _stack, state_agreement, state_converged
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics, idle_inputs
from kaboodle_tpu_torch.telemetry.counters import (
    ProtocolCounters,
    TickTelemetry,
    counters_totals,
    leap_counters,
)
from kaboodle_tpu_torch.telemetry.trace import host_span
from kaboodle_tpu_torch.warp.horizon import (
    HYBRID_BITS,
    SIG_ANY_A2,
    SIG_WAIT_ALIVE,
    ActivityClass,
    decode_signature,
    make_quiescence_fn,
    make_signature_fn,
    next_static_event,
    static_event_ticks,
)

# The chunk vocabulary: powers of two >= MIN_LEAP. A span's sub-MIN_LEAP
# remainder runs dense instead, so a family holds at most
# len(CHUNK_BUCKETS) programs; the ProgramCache refuses any other length.
MIN_LEAP = 8
CHUNK_BUCKETS = tuple(1 << j for j in range(3, 32))  # 8 .. 2^31


class ProgramCache:
    """Explicit bounded cache of built span programs.

    Keys are ``(family, kind, k)``: ``family`` identifies the build (the
    config, fleet-ness), ``kind`` is ``"strict"`` or ``"hybrid"`` and ``k``
    MUST be one of :data:`CHUNK_BUCKETS`, so per (family, kind) the cache
    never holds more than ``len(CHUNK_BUCKETS)`` programs, whatever span
    lengths the schedule produces. ``stats()`` reports the bound."""

    def __init__(self) -> None:
        self._programs: dict = {}
        self.hits = 0
        self.misses = 0
        self._kind_stats: dict[str, list[int]] = {}  # kind -> [hits, misses]

    def get(self, family, kind: str, k: int, build):
        if k not in CHUNK_BUCKETS:
            raise ValueError(
                f"leap chunk {k} is not a power-of-two bucket >= {MIN_LEAP} "
                "-- the program cache only admits bucketed span lengths"
            )
        key = (family, kind, k)
        kind_stats = self._kind_stats.setdefault(kind, [0, 0])
        prog = self._programs.get(key)
        if prog is not None:
            self.hits += 1
            kind_stats[0] += 1
            return prog
        self.misses += 1
        kind_stats[1] += 1
        prog = build()
        self._programs[key] = prog
        return prog

    def clear(self) -> None:
        """Drop every program (the hit and miss counts keep counting, so
        ``serve.pool.program_builds`` only grows)."""
        self._programs.clear()

    def stats(self) -> dict:
        families = collections.Counter(repr((family, kind)) for family, kind, _ in self._programs)
        per_kind = {
            kind: {"hits": h, "misses": m, "hit_rate": round(h / (h + m), 4) if h + m else 0.0}
            for kind, (h, m) in sorted(self._kind_stats.items())
        }
        return {
            "programs": len(self._programs),
            "per_family_bound": len(CHUNK_BUCKETS),
            "max_family_programs": max(families.values(), default=0),
            "hits": self.hits,
            "misses": self.misses,
            "per_kind": per_kind,
        }


leap_cache = ProgramCache()


# ---------------------------------------------------------------------------
# Span memo: signature-keyed state deltas on the host
#
# Two spans entering the same state at the same tick compute the same exit
# state (the carried key is constant and every draw derives from (key,
# tick, stream)). SpanMemo caches a span's per-leaf XOR delta keyed by the
# span's identity plus a blake2b digest of the entry leaves (and, for a
# dense span, of the schedule slice it consumed), and replays it when the
# span recurs: host XOR plus one copy per leaf back to the state's device,
# no tick and no leap, the exact exit bytes.


def _host_leaves(obj) -> list[np.ndarray]:
    """A state's (or inputs') tensors on the host, in field order, ``None``
    fields skipped: the raw bits (uint32 words stay int32, bools bool)."""
    return [getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None]


def _from_host_leaves(like, leaves):
    """``like`` with its non-None fields rebuilt from ``leaves`` on its device."""
    it = iter(leaves)
    dev = like.state.device
    return dataclasses.replace(like, **{
        f.name: torch.as_tensor(next(it), device=dev)
        for f in dataclasses.fields(like) if getattr(like, f.name) is not None
    })


def _digest_leaves(leaves) -> bytes:
    """blake2b-128 over the raw bytes of every leaf, in order."""
    h = hashlib.blake2b(digest_size=16)
    for a in leaves:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _xor_delta(entry: np.ndarray, exit_: np.ndarray) -> np.ndarray:
    """uint8 XOR of two same-shape arrays' raw bytes (exact, dtype-blind)."""
    return _bytes(entry) ^ _bytes(exit_)


def _apply_xor(entry: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """The exit array: ``entry``'s bytes XOR ``delta``, in ``entry``'s dtype and shape."""
    entry = np.asarray(entry)
    return (_bytes(entry) ^ delta).view(entry.dtype).reshape(entry.shape)


class SpanMemo:
    """Bounded LRU cache of span state-deltas, keyed by span signature.

    Entries: ``key -> (deltas, metrics)`` with ``deltas`` the per-leaf
    uint8 XOR of entry and exit bytes and ``metrics`` the per-tick metrics
    (host copies) a dense span re-emits on replay, or ``None``. Both bounds
    are hard: an insert past ``max_bytes`` or ``max_entries`` evicts the
    least recently used entries first. Host-side only: a hit replays the
    exact exit bytes, so memo-on and memo-off runs are bit-identical."""

    def __init__(self, max_bytes: int = 256 << 20, max_entries: int = 4096) -> None:
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._kind_stats: dict[str, list[int]] = {}  # kind -> [hits, misses]

    def get(self, key, kind: str = "span"):
        stats = self._kind_stats.setdefault(kind, [0, 0])
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            stats[1] += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        stats[0] += 1
        return hit[0]

    def put(self, key, value, nbytes: int) -> None:
        if key in self._entries or nbytes > self.max_bytes:
            return
        self._entries[key] = (value, int(nbytes))
        self.bytes += int(nbytes)
        while self._entries and (
            self.bytes > self.max_bytes or len(self._entries) > self.max_entries
        ):
            _, (_, old) = self._entries.popitem(last=False)
            self.bytes -= old
            self.evictions += 1

    def stats(self) -> dict:
        total = self.hits + self.misses
        per_kind = {
            kind: {"hits": h, "misses": m, "hit_rate": round(h / (h + m), 4) if h + m else 0.0}
            for kind, (h, m) in sorted(self._kind_stats.items())
        }
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "per_kind": per_kind,
        }

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0
        self.hits = self.misses = self.evictions = 0
        self._kind_stats.clear()


# The process-shared memo: serve lanes, fleet drains and one-mesh runs that
# pass it trade deltas (``ServeEngine(warp_memo=True)`` adopts it).
span_memo = SpanMemo()


def _metrics_nbytes(metrics) -> int:
    return sum(getattr(m, f.name).numel() * getattr(m, f.name).element_size()
               for m in metrics for f in dataclasses.fields(m))


def _metrics_to(m: TickMetrics, device) -> TickMetrics:
    return dataclasses.replace(m, **{f.name: getattr(m, f.name).to(device)
                                     for f in dataclasses.fields(m)})


def _memo_store(memo: SpanMemo, key, entry_leaves, exit_state, metrics=None) -> None:
    """Bank one span: per-leaf XOR deltas (+ the dense span's host metrics)."""
    deltas = [_xor_delta(a, b) for a, b in zip(entry_leaves, _host_leaves(exit_state))]
    nbytes = sum(d.nbytes for d in deltas)
    if metrics is not None:
        nbytes += _metrics_nbytes(metrics)
    memo.put(key, (deltas, metrics), nbytes)


def _memo_replay(state: MeshState, entry_leaves, deltas) -> MeshState:
    """The exit state, rebuilt from the entry leaves + banked deltas on the
    state's device, every leaf in its own dtype."""
    assert len(entry_leaves) == len(deltas)
    return _from_host_leaves(state, [_apply_xor(a, d) for a, d in zip(entry_leaves, deltas)])


def _span_chunks(k: int) -> tuple[list[int], int]:
    """``(chunks, dense_remainder)``: the binary decomposition of a span
    into powers of two >= ``MIN_LEAP``, and the sub-``MIN_LEAP`` remainder
    the caller runs dense. Leaps compose exactly (leap(a) then leap(b) is
    leap(a + b)), so the split never changes the result."""
    chunks: list[int] = []
    rem = int(k)
    while rem >= MIN_LEAP:
        p = 1 << (rem.bit_length() - 1)
        chunks.append(p)
        rem -= p
    return chunks, rem


def _get_leap(cfg: SwimConfig, k: int, hybrid: bool, mesh=None):
    """One bucketed span program through the bounded cache (the sharded
    program, under its own family, with a mesh)."""
    kind = "hybrid" if hybrid else "strict"
    if mesh is None:
        return leap_cache.get(cfg, kind, k, lambda: make_warp_leap(cfg, k, hybrid=hybrid))
    from kaboodle_tpu_torch.parallel.mesh import constrain_state, peer_group

    def build():
        leap = make_warp_leap(cfg, k, hybrid=hybrid, group=peer_group(mesh))
        return lambda st: constrain_state(leap(st), mesh)

    return leap_cache.get((cfg, mesh), kind, k, build)


def _dense_tick(cfg: SwimConfig, faulty: bool, mesh=None, telemetry: bool = False):
    """The dense tick of the runners: the row-sharded one with a mesh."""
    if mesh is None:
        return make_dense_tick(cfg, faulty=faulty, telemetry=telemetry)
    from kaboodle_tpu_torch.parallel.mesh import make_sharded_tick

    return make_sharded_tick(cfg, mesh, faulty=faulty, telemetry=telemetry)


def _group(mesh):
    from kaboodle_tpu_torch.parallel.mesh import peer_group

    return None if mesh is None else peer_group(mesh)


def _memo_hit(memo, key, kind: str, mesh):
    """The memo's entry for ``key``, or None. With a mesh each rank holds
    its own rows' deltas: a replay happens only when every rank hits."""
    hit = memo.get(key, kind=kind)
    if mesh is None:
        return hit
    from kaboodle_tpu_torch.parallel import collectives as C

    flag = torch.tensor([0 if hit is None else 1], dtype=torch.int32,
                        device=_mesh_device(mesh))
    return hit if int(C.reduce_min(flag, _group(mesh))[0]) else None


def _mesh_device(mesh):
    from kaboodle_tpu_torch.parallel.mesh import mesh_device

    return mesh_device(mesh)


@dataclasses.dataclass
class WarpLedger:
    """Host-side span ledger: what leaped, under which signature class.

    ``spans`` rows: dict(engine, class_key, class, ticks, dispatches).
    ``blocked`` rows attribute every dense span to the terms that forced it
    (the blocking term combination, or the pseudo-terms
    ``scheduled_event``, recorded without a signature fetch, and
    ``short_span``, a leapable class whose budget was under ``MIN_LEAP``);
    summed ``ticks`` equal the dense ticks run. Recording never changes
    what runs, so ledger on and off give the same bits."""

    spans: list = dataclasses.field(default_factory=list)
    blocked: list = dataclasses.field(default_factory=list)

    def record(self, cls: ActivityClass, engine: str, ticks: int, dispatches: int) -> None:
        self.spans.append({
            "engine": engine,
            "class_key": cls.key,
            "class": cls.describe(),
            "ticks": int(ticks),
            "dispatches": int(dispatches),
        })

    def record_blocked(
        self,
        cls: ActivityClass | None,
        ticks: int,
        engine: str,
        mode: str = "dense",
        members: int = 1,
    ) -> None:
        """One dense span: which term kept it off the leap path.

        ``cls=None`` marks an eventful tick (no signature was fetched); a
        leapable ``mode`` marks a budget under ``MIN_LEAP``."""
        if cls is None:
            term, key = "scheduled_event", -1
        elif mode != "dense":
            term, key = "short_span", cls.key
        else:
            term, key = "+".join(cls.describe()["terms"]), cls.key
        self.blocked.append({
            "engine": engine,
            "term": term,
            "class_key": key,
            "ticks": int(ticks),
            "spans": 1,
            "members": int(members),
        })

    def blocked_histogram(self) -> dict:
        """``{term: {spans, ticks, members}}``: the why-dense histogram."""
        out: dict = {}
        for row in self.blocked:
            agg = out.setdefault(row["term"], {"spans": 0, "ticks": 0, "members": 0})
            agg["spans"] += row["spans"]
            agg["ticks"] += row["ticks"]
            agg["members"] += row["members"]
        return out

    def per_class(self) -> dict:
        """``{class_key: {engine, terms, active_row_bucket, spans, ticks, dispatches}}``."""
        out: dict = {}
        for row in self.spans:
            agg = out.setdefault(
                row["class_key"],
                {
                    "engine": row["engine"],
                    "terms": row["class"]["terms"],
                    "active_row_bucket": row["class"]["active_row_bucket"],
                    "spans": 0,
                    "ticks": 0,
                    "dispatches": 0,
                },
            )
            agg["spans"] += 1
            agg["ticks"] += row["ticks"]
            agg["dispatches"] += row["dispatches"]
        return out


# ``exact`` is the default and bit-exact with dense ticking.
# ``distributional`` also admits classes whose only extra activity is A2
# escalation / wait-alive traffic to the hybrid program: their in-span
# escalation side effects are approximated (pings delivered and acked),
# while every timer-expiry tick still runs dense. Pinned on statistics,
# never on bits.
WARP_MODES = ("exact", "distributional")
_DISTRIBUTIONAL_BITS = HYBRID_BITS | SIG_ANY_A2 | SIG_WAIT_ALIVE


def _check_warp_mode(warp_mode: str) -> None:
    if warp_mode not in WARP_MODES:
        raise ValueError(f"warp_mode {warp_mode!r} not in {WARP_MODES}")


def _classify(cls: ActivityClass, hybrid: bool, telemetry: bool = False,
              warp_mode: str = "exact") -> str:
    """The engine a span entry state maps to, under the runner's knobs.

    ``hybrid=False`` demotes hybrid-class states to dense, and so does
    telemetry (hybrid spans carry anti-entropy gossip bytes with no closed
    form; strictly quiescent spans keep ``leap_counters``'s).
    ``warp_mode="distributional"`` promotes dense classes whose only extra
    bits are A2 escalation / wait-alive to hybrid; joins, known-dead or
    missing-alive cells, identity staleness and too-few rows stay dense in
    every mode."""
    mode = cls.mode
    if (
        warp_mode == "distributional"
        and mode == "dense"
        and cls.bits
        and not (cls.bits & ~_DISTRIBUTIONAL_BITS)
    ):
        mode = "hybrid"
    if mode == "hybrid" and (not hybrid or telemetry):
        return "dense"
    return mode


def _leap_budget(cls: ActivityClass, mode: str, span: int) -> int:
    """How many of the next ``span`` ticks the class's program may cover."""
    if mode == "leap":
        return span
    return max(0, min(span, cls.expiry - cls.tick))


def _stack_dense(rows, telemetry: bool):
    """The dense ticks' per-tick outputs stacked on ``[M]`` (``None`` if none)."""
    if not rows:
        return None
    if not telemetry:
        return _stack(TickMetrics, rows)
    return TickTelemetry(
        metrics=_stack(TickMetrics, [r.metrics for r in rows]),
        counters=_stack(ProtocolCounters, [r.counters for r in rows]),
        fp=torch.stack([r.fp for r in rows]),
    )


def simulate_warped(
    state: MeshState,
    inputs: TickInputs,
    cfg: SwimConfig,
    faulty: bool = True,
    recheck_every: int = 16,
    on_boundary=None,
    telemetry: bool = False,
    hybrid: bool = True,
    ledger: WarpLedger | None = None,
    memo: SpanMemo | None = None,
    warp_mode: str = "exact",
    mesh=None,
):
    """Run a stacked ``[T]`` schedule, fast-forwarding (near-)quiescent spans.

    The twin of ``sim.runner.simulate``: the same final state, bit for bit,
    with event-free spans whose entry signature classes ``leap`` or
    ``hybrid`` advanced by the span programs; everything else runs dense,
    re-checking the signature every ``recheck_every`` ticks. ``hybrid=False``
    leaps strictly quiescent spans only.

    Returns ``(final_state, dense_ticks, dense_metrics)``: the int32 ``[M]``
    indices of the ticks that ran dense and their stacked ``TickMetrics``
    (``None`` when every tick leaped). ``on_boundary(t, state)`` is called
    at each leap's entry and exit with the tick index about to run / just
    reached. ``ledger`` collects per-span class records.

    ``telemetry=True`` runs the telemetry build of the dense tick and
    returns ``(final_state, dense_ticks, dense_telemetry, totals)``:
    ``totals`` sums the dense ticks' counters and each strictly quiescent
    leap's closed form (``leap_counters``: ``k * n_alive`` pings and acks);
    hybrid spans run dense under telemetry, so the totals stay exact.

    ``memo`` banks every span's state delta and replays recurring spans
    (leaped and dense) from it. ``warp_mode="distributional"`` widens the
    hybrid class (see :func:`_classify`). ``mesh`` runs the sharded twins
    (module docstring): ``state`` and ``inputs`` are the rank's rows, and
    every rank must call this with the same arguments."""
    _check_warp_mode(warp_mode)
    n_ticks = int(inputs.kill.shape[0])
    group = _group(mesh)
    eventful = static_event_ticks(inputs, group)
    tick = _dense_tick(cfg, faulty, mesh, telemetry)
    signature = make_signature_fn(cfg, group)
    recheck_every = max(1, int(recheck_every))
    family = repr((cfg, mesh, faulty, telemetry, warp_mode))
    host_inputs = _host_leaves(inputs) if memo is not None else None
    dense_ticks: list[int] = []
    rows = []
    leap_spans: list[tuple[int, int]] = []  # (span length, n_alive)
    t = 0
    while t < n_ticks:
        if not eventful[t]:
            span_end = next_static_event(eventful, t)
            cls = decode_signature(signature(state))
            mode = _classify(cls, hybrid, telemetry, warp_mode)
            k = _leap_budget(cls, mode, span_end - t) if mode != "dense" else 0
            chunks, rem = _span_chunks(k)
            if chunks:
                k -= rem  # the sub-MIN_LEAP tail re-enters the loop densely
                if on_boundary is not None:
                    on_boundary(t, state)
                if telemetry:
                    leap_spans.append((k, cls.n_alive))
                entry_leaves = memo_key = None
                if memo is not None:
                    entry_leaves = _host_leaves(state)
                    memo_key = ("leap", family, mode, k, cls.key, _digest_leaves(entry_leaves))
                    hit = _memo_hit(memo, memo_key, mode, mesh)
                    if hit is not None:
                        state = _memo_replay(state, entry_leaves, hit[0])
                        if ledger is not None:
                            ledger.record(cls, mode + "+memo", k, 0)
                        t += k
                        if on_boundary is not None:
                            on_boundary(t, state)
                        continue
                with host_span(f"leap_span:{mode}:{k}"):
                    for chunk in chunks:
                        state = _get_leap(cfg, chunk, mode == "hybrid", mesh)(state)
                if memo is not None:
                    _memo_store(memo, memo_key, entry_leaves, state)
                if ledger is not None:
                    ledger.record(cls, mode, k, len(chunks))
                t += k
                if on_boundary is not None:
                    on_boundary(t, state)
                continue
            stop = min(span_end, t + recheck_every)
            blocked_cls = cls
        else:
            stop = t + 1
            cls, mode, blocked_cls = None, "dense", None
        entry_leaves = memo_key = None
        if memo is not None and not telemetry:
            # Dense spans memoize too: the key folds in the consumed
            # schedule slice, so eventful ticks and differing drop/churn
            # planes never collide.
            entry_leaves = _host_leaves(state)
            memo_key = (
                "dense", family, stop - t, cls.key if cls is not None else -1,
                _digest_leaves(entry_leaves),
                _digest_leaves([x[t:stop] for x in host_inputs]),
            )
            hit = _memo_hit(memo, memo_key, "dense", mesh)
            if hit is not None:
                state = _memo_replay(state, entry_leaves, hit[0])
                dense_ticks.extend(range(t, stop))
                rows.extend(_metrics_to(m, state.device) for m in hit[1])
                if ledger is not None:
                    # A replayed dense span ran no dense tick: it is not blocked.
                    if blocked_cls is not None:
                        ledger.record(blocked_cls, "dense+memo", stop - t, 0)
                    else:
                        ledger.spans.append({
                            "engine": "dense+memo",
                            "class_key": -1,
                            "class": {"terms": ["scheduled_event"], "active_row_bucket": -1},
                            "ticks": stop - t,
                            "dispatches": 0,
                        })
                t = stop
                continue
        if ledger is not None:
            if blocked_cls is not None:
                ledger.record_blocked(blocked_cls, stop - t, "sim", mode=mode)
            else:
                # Eventful tick: the schedule forced it dense, no signature fetched.
                ledger.record_blocked(None, 1, "sim")
        span_rows = []
        with host_span("dense_span"):
            while t < stop:
                state, m = tick(state, inputs.at(t))
                dense_ticks.append(t)
                span_rows.append(m)
                t += 1
        rows.extend(span_rows)
        if memo_key is not None:
            _memo_store(memo, memo_key, entry_leaves, state,
                        [_metrics_to(m, "cpu") for m in span_rows])
    stacked = _stack_dense(rows, telemetry)
    dense_ticks = np.asarray(dense_ticks, dtype=np.int32)
    if not telemetry:
        return state, dense_ticks, stacked
    totals = counters_totals(
        stacked.counters if stacked is not None
        else leap_counters(0, 0, device=state.device)
    )
    for k, n_alive in leap_spans:
        leap = counters_totals(leap_counters(n_alive, k, device=state.device))
        totals = {name: totals[name] + leap[name] for name in totals}
    return state, dense_ticks, stacked, totals


def run_warped(
    state: MeshState,
    cfg: SwimConfig,
    ticks: int,
    recheck_every: int = 16,
    hybrid: bool = True,
    ledger: WarpLedger | None = None,
    memo: SpanMemo | None = None,
    warp_mode: str = "exact",
    mesh=None,
) -> tuple[MeshState, int, bool]:
    """Advance a fault-free mesh exactly ``ticks`` ticks, leaping spans.

    A converged idle mesh leaps the whole budget in bucketed calls; a
    near-quiescent one (armed timers draining, fingerprints settling) leaps
    to each timer-expiry horizon through the hybrid program and runs the
    expiry ticks dense; anything else runs dense, re-checking the signature
    every ``recheck_every`` ticks. Returns ``(state, ticks_run, converged)``
    as ``sim.runner.run_until_converged`` does, with ``ticks_run == ticks``
    always and ``converged`` evaluated on the final state. ``mesh`` runs the
    sharded twins on the rank's rows of the state, as in
    :func:`simulate_warped`; ``converged`` is then the whole mesh's."""
    _check_warp_mode(warp_mode)
    group = _group(mesh)
    tick = _dense_tick(cfg, False, mesh)
    signature = make_signature_fn(cfg, group)
    idle = idle_inputs(state.state.shape[-2], device=state.device)
    recheck_every = max(1, int(recheck_every))
    family = repr((cfg, mesh, "steady", warp_mode))
    t = 0
    while t < ticks:
        cls = decode_signature(signature(state))
        mode = _classify(cls, hybrid, warp_mode=warp_mode)
        k = _leap_budget(cls, mode, ticks - t) if mode != "dense" else 0
        chunks, rem = _span_chunks(k)
        if chunks:
            k -= rem
            entry_leaves = memo_key = None
            if memo is not None:
                entry_leaves = _host_leaves(state)
                memo_key = ("leap", family, mode, k, cls.key, _digest_leaves(entry_leaves))
                hit = _memo_hit(memo, memo_key, mode, mesh)
                if hit is not None:
                    state = _memo_replay(state, entry_leaves, hit[0])
                    if ledger is not None:
                        ledger.record(cls, mode + "+memo", k, 0)
                    t += k
                    continue
            for chunk in chunks:
                state = _get_leap(cfg, chunk, mode == "hybrid", mesh)(state)
            if memo is not None:
                _memo_store(memo, memo_key, entry_leaves, state)
            if ledger is not None:
                ledger.record(cls, mode, k, len(chunks))
            t += k
            continue
        stop = min(ticks, t + recheck_every)
        entry_leaves = memo_key = None
        if memo is not None:
            # Idle inputs: the entry state alone keys the span.
            entry_leaves = _host_leaves(state)
            memo_key = ("dense", family, stop - t, cls.key, _digest_leaves(entry_leaves))
            hit = _memo_hit(memo, memo_key, "dense", mesh)
            if hit is not None:
                state = _memo_replay(state, entry_leaves, hit[0])
                if ledger is not None:
                    ledger.record(cls, "dense+memo", stop - t, 0)
                t = stop
                continue
        if ledger is not None:
            ledger.record_blocked(cls, stop - t, "steady", mode=mode)
        while t < stop:
            state, _ = tick(state, idle)
            t += 1
        if memo is not None:
            _memo_store(memo, memo_key, entry_leaves, state)
    return state, t, state_converged(state, group)


# ---------------------------------------------------------------------------
# fleet integration: per-member horizons


@functools.lru_cache(maxsize=None)
def _masked_fleet_tick(cfg: SwimConfig):
    """The fault-free fleet tick with members outside ``active`` frozen."""
    vtick = make_fleet_tick_fn(cfg, faulty=False)

    def step(mesh: MeshState, idle: TickInputs, active: torch.Tensor) -> MeshState:
        new, _ = vtick(mesh, idle)
        return freeze_members(active, mesh, new)

    return step


def _get_fleet_leap(cfg: SwimConfig, K: int):
    """The masked hybrid span program over ``[E, ...]`` leaves, through the
    bounded cache: one program covers every per-member length ``k_m <= K``,
    and the hybrid program is bit-exactly the strict one on strictly
    quiescent members, so one (cfg, K) entry serves a round's class mix."""
    return leap_cache.get((cfg, "fleet"), "hybrid", K,
                          lambda: make_warp_leap(cfg, K, hybrid=True, masked=True))


def memo_fleet_leap(family: str, mesh_state: MeshState, k_m: np.ndarray, memo: SpanMemo,
                    dispatch) -> tuple:
    """One masked fleet leap round through the span memo.

    Deltas are banked PER MEMBER, keyed by the member's own ``k_m`` and
    entry-row digest, so a span one member computed is a hit for every
    other member (and later round) entering the same state. The masked
    call is all-or-nothing, so it is skipped only when every active member
    hits; on a partial hit the round still calls ``dispatch(mesh_state,
    k_m)`` once and banks the fresh members' deltas. Members at ``k_m == 0``
    are untouched and never keyed.

    Only the members with ``k_m > 0`` cross to the host: their entry rows
    are fetched and digested, the missed members' exit rows fetched after
    the call, and on the all-hit path only their replayed rows are written
    back (into a device copy of each leaf; the caller's tensors are never
    written). Returns ``(new_mesh_state, hit_members, dispatched)``."""
    k_m = np.asarray(k_m)
    dev = mesh_state.device
    active = [int(e) for e in np.flatnonzero(k_m > 0)]
    k_dev = torch.as_tensor(k_m, dtype=torch.int32, device=dev)
    if not active:
        return dispatch(mesh_state, k_dev), 0, True
    names = [f.name for f in dataclasses.fields(mesh_state)
             if getattr(mesh_state, f.name) is not None]
    rows = torch.as_tensor(active, dtype=torch.long, device=dev)
    host = [getattr(mesh_state, name).index_select(0, rows).cpu().numpy() for name in names]
    keys: dict[int, tuple] = {}
    hits: dict[int, tuple] = {}
    for i, e in enumerate(active):
        key = ("fleet", family, int(k_m[e]), _digest_leaves([h[i] for h in host]))
        keys[e] = key
        hit = memo.get(key, kind="fleet")
        if hit is not None:
            hits[e] = hit
    if len(hits) == len(active):
        new_state = {}
        for j, name in enumerate(names):
            rows_out = np.stack([_apply_xor(host[j][i], hits[e][0][j])
                                 for i, e in enumerate(active)])
            new_state[name] = getattr(mesh_state, name).index_copy(
                0, rows, torch.as_tensor(rows_out, device=dev))
        return dataclasses.replace(mesh_state, **new_state), len(hits), False
    out = dispatch(mesh_state, k_dev)
    fresh = [(i, e) for i, e in enumerate(active) if e not in hits]
    fresh_rows = torch.as_tensor([e for _, e in fresh], dtype=torch.long, device=dev)
    out_host = [getattr(out, name).index_select(0, fresh_rows).cpu().numpy() for name in names]
    for r, (i, e) in enumerate(fresh):
        deltas = [_xor_delta(a[i], b[r]) for a, b in zip(host, out_host)]
        memo.put(keys[e], (deltas, None), sum(d.nbytes for d in deltas))
    return out, len(hits), True


def fleet_quiescence_mask(fleet, cfg: SwimConfig) -> torch.Tensor:
    """bool ``[E]``: per-member strict event horizon, on the device."""
    return make_quiescence_fn(cfg)(fleet.mesh)


def fleet_signature(fleet, cfg: SwimConfig) -> torch.Tensor:
    """int32 ``[E, 4]``: per-member activity signature rows
    ``[class_key, earliest_expiry, n_alive, tick]``, on the device."""
    return make_signature_fn(cfg)(fleet.mesh)


def run_fleet_warped(
    fleet,
    cfg: SwimConfig,
    ticks: int,
    recheck_every: int = 16,
    hybrid: bool = True,
    ledger: WarpLedger | None = None,
    memo: SpanMemo | None = None,
    warp_mode: str = "exact",
):
    """Advance every fleet member exactly ``ticks`` fault-free ticks.

    Each round fetches the ``[E, 4]`` signature rows once and computes per
    member how far it may leap: its remaining budget if strictly
    quiescent, its own timer-expiry horizon if hybrid, zero if dense or
    finished. If any member can cover ``MIN_LEAP`` ticks, the ensemble
    takes ONE masked leap in which every member leaps exactly its own
    ``k_m`` (members at 0 freeze bit-exactly); otherwise the unfinished
    members take dense ticks with the others frozen. Fault-free only
    (``fleet.drop_rate`` is inert). Returns ``(fleet, ticks, converged)``
    with ``converged`` an ``[E]`` bool tensor of the final states; member
    trajectories are bit-exact with standalone :func:`run_warped` runs. The
    fleet tick takes no kernel flag (``ValueError``, as in the JAX fleet)."""
    _check_warp_mode(warp_mode)
    mesh_state = fleet.mesh
    dev = mesh_state.device
    ensemble = fleet.ensemble
    idle = fleet_idle_inputs(fleet.n, ensemble, device=dev)
    signature = make_signature_fn(cfg)
    recheck_every = max(1, int(recheck_every))
    family = repr((cfg, "fleet", warp_mode))
    target = None
    while True:
        rows = signature(mesh_state).cpu().numpy()  # one [E, 4] fetch a round
        t_m = rows[:, 3].astype(np.int64)
        if target is None:
            target = t_m + int(ticks)
        remaining = target - t_m
        if (remaining <= 0).all():
            break
        k_m = np.zeros((ensemble,), dtype=np.int64)
        classes = [decode_signature(rows[e]) for e in range(ensemble)]
        for e, cls in enumerate(classes):
            if remaining[e] <= 0:
                continue
            mode = _classify(cls, hybrid, warp_mode=warp_mode)
            if mode != "dense":
                k_m[e] = _leap_budget(cls, mode, int(remaining[e]))
        if k_m.max() >= MIN_LEAP:
            # One masked call: everyone leaps its own horizon (sub-MIN_LEAP
            # free riders included: they share the program).
            K = max(1 << int(k_m.max() - 1).bit_length(), MIN_LEAP)
            leap = _get_fleet_leap(cfg, K)
            if memo is not None:
                mesh_state, _, dispatched = memo_fleet_leap(family, mesh_state, k_m, memo, leap)
            else:
                mesh_state = leap(mesh_state, torch.as_tensor(k_m, dtype=torch.int32, device=dev))
                dispatched = True
            if ledger is not None:
                # One row per signature class among the leapers (ticks
                # summed over its members), each carrying the round's single
                # call, never one call per member.
                per_round: dict[int, list] = {}
                for e, cls in enumerate(classes):
                    if k_m[e] > 0:
                        row = per_round.setdefault(cls.key, [cls, 0, 0])
                        row[1] += int(k_m[e])
                        row[2] += 1
                for cls, ticks_sum, members in per_round.values():
                    engine = "fleet-" + _classify(cls, hybrid, warp_mode=warp_mode)
                    ledger.spans.append({
                        "engine": engine if dispatched else engine + "+memo",
                        "class_key": cls.key,
                        "class": cls.describe(),
                        "ticks": ticks_sum,
                        "dispatches": 1 if dispatched else 0,
                        "members": members,
                    })
            continue
        # Nobody can leap a full chunk: dense ticks for unfinished members
        # (leapable-but-short members ride along: dense is bit-identical
        # for them), everyone else frozen.
        steps = int(min(recheck_every, remaining[remaining > 0].min()))
        active = torch.as_tensor(remaining > 0, device=dev)
        if ledger is not None:
            per_round: dict = {}
            for e, cls in enumerate(classes):
                if remaining[e] <= 0:
                    continue
                mode = _classify(cls, hybrid, warp_mode=warp_mode)
                row = per_round.setdefault((cls.key, mode), [cls, mode, 0])
                row[2] += 1
            for cls, mode, members in per_round.values():
                ledger.record_blocked(cls, steps * members, "fleet", mode=mode, members=members)
        step = _masked_fleet_tick(cfg)
        for _ in range(steps):
            mesh_state = step(mesh_state, idle, active)
    converged = state_agreement(mesh_state)[0]
    return dataclasses.replace(fleet, mesh=mesh_state), int(ticks), converged
