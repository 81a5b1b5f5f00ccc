"""servescope — the serve stack's observability plane.

The port of ``kaboodle_tpu/serve/obsplane.py``: the same three instruments,
record shapes, metric names and Prometheus text.

- **Per-request lifecycle tracing** — the engine drives
  :meth:`ObsPlane.transition` at every lifecycle edge the journal already
  witnesses, and each closing phase yields one ``serve_span`` record
  (``kaboodle-telemetry/1``) carrying ``request_id``, the phase name
  (``queued`` / ``running`` / ``parked`` / ``spilling`` / ``spilled``),
  monotonic ``t0_us`` / ``dur_us`` relative to the plane's epoch, and the
  terminal ``fate``. The engine adds pool-level ``advance`` spans (leap
  rounds annotated per lane with the signature class) and ``round`` spans
  (the profiler's segment split), all on the SAME monotonic timeline.
- **Round-loop profiler** — :class:`RoundProfiler` accumulates
  ``perf_counter_ns`` laps into a fixed set of segments (spill poll,
  admission, dispatch, harvest, spill pacing, journal append) and folds
  each finished round into preallocated log2-microsecond
  :class:`Histogram` buckets. Nothing is allocated per round — the
  accumulators are numpy vectors written in place.
- **Metrics registry + exposition** — :class:`MetricsRegistry` holds
  counters (event totals, per-tenant sheds, spill failures), pull-model
  gauges (queue depth, lane occupancy by N-class, spill-writer queue
  depth, journal lag, warp leap cache and span memo, the
  ``compiles_steady`` gauge) and the profiler histograms; ``collect()``
  feeds the server's ``metrics`` RPC and ``to_prometheus()`` the text
  endpoint.

``compiles_steady`` keeps the JAX name, so manifests and scrapes keep the
JAX schema, but the port compiles nothing: it counts the programs the port
BUILDS (:func:`~kaboodle_tpu_torch.serve.pool.program_builds`: misses of
the pool's program caches and of the warp ``leap_cache``, and CUDA kernel
libraries built or loaded) since the engine's warmup ended.

The plane is an OBSERVER: it never touches pool or mesh state, so an
engine with tracing on is bit-identical to one with it off. Everything
here is host-side stdlib + numpy; evaluating a gauge touches no device.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from kaboodle_tpu_torch.telemetry.manifest import run_record

# Histogram buckets are log2 microseconds: bucket b holds durations whose
# bit_length is b, i.e. [2^(b-1), 2^b - 1] us (bucket 0 holds 0 us). 28
# buckets cap at ~134 s — far past any round segment worth resolving.
N_BUCKETS = 28

# Round-loop segments, in execution order. ``round`` is the whole-loop
# envelope the others subdivide (journal includes per-append WAL writes
# plus compaction).
SEGMENTS = ("poll", "admit", "dispatch", "harvest", "spill", "journal",
            "round")
(SEG_POLL, SEG_ADMIT, SEG_DISPATCH, SEG_HARVEST, SEG_SPILL, SEG_JOURNAL,
 SEG_ROUND) = range(len(SEGMENTS))


class Histogram:
    """Fixed log2-us buckets; in-place increments, no per-observe allocation."""

    __slots__ = ("buckets", "count", "total_us", "max_us")

    def __init__(self) -> None:
        self.buckets = np.zeros((N_BUCKETS,), dtype=np.int64)
        self.count = 0
        self.total_us = 0
        self.max_us = 0

    def observe(self, us: int) -> None:
        us = int(us)
        self.buckets[min(us.bit_length(), N_BUCKETS - 1)] += 1
        self.count += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us

    def quantile(self, q: float) -> int:
        """Upper bound (us) of the bucket holding the q-quantile sample.

        Bucket resolution is a factor of 2 — the right precision for "did
        p99 move a decade", which is what SLO curves ask."""
        if self.count == 0:
            return 0
        target = q * self.count
        cum = 0
        for b in range(N_BUCKETS):
            cum += int(self.buckets[b])
            if cum >= target:
                return (1 << b) - 1 if b else 0
        return self.max_us

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "total_us": self.total_us,
            "max_us": self.max_us,
            "p50_us": self.quantile(0.50),
            "p90_us": self.quantile(0.90),
            "p99_us": self.quantile(0.99),
        }
        if self.count:
            out["mean_us"] = round(self.total_us / self.count, 1)
        return out


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Counters, gauges and histograms with flat ``name{label=value}`` keys.

    Counters are push-model (the plane bumps them as events fan out);
    gauges are PULL-model — registered once as zero-arg callables and
    evaluated only at :meth:`collect` / :meth:`to_prometheus` time, so a
    gauge costs the round loop nothing. ``register_multi_gauge`` covers
    dynamic label sets (per-tenant quota levels) with one callable
    returning ``{label_dict: value}``.
    """

    def __init__(self) -> None:
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, object]] = {}
        self._multi: dict[str, object] = {}
        self._hists: dict[str, dict[tuple, Histogram]] = {}

    # -- write side --------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        series = self._counters.setdefault(name, {})
        key = _label_key(labels)
        series[key] = series.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def register_gauge(self, name: str, fn, **labels) -> None:
        """A zero-arg callable evaluated at collection time."""
        self._gauges.setdefault(name, {})[_label_key(labels)] = fn

    def register_multi_gauge(self, name: str, fn) -> None:
        """``fn() -> {label_dict: value}`` — dynamic label sets."""
        self._multi[name] = fn

    def histogram(self, name: str, **labels) -> Histogram:
        series = self._hists.setdefault(name, {})
        key = _label_key(labels)
        h = series.get(key)
        if h is None:
            h = series[key] = Histogram()
        return h

    def attach_histogram(self, name: str, hist: Histogram, **labels) -> None:
        """Expose an externally-owned :class:`Histogram` (the round
        profiler's segment histograms) under this registry's namespace —
        shared object, no copying, so collection always sees live totals."""
        self._hists.setdefault(name, {})[_label_key(labels)] = hist

    # -- read side ---------------------------------------------------------

    def _gauge_items(self):
        for name, series in self._gauges.items():
            for key, v in series.items():
                yield name, key, float(v() if callable(v) else v)
        for name, fn in self._multi.items():
            for labels, v in fn().items():
                yield name, _label_key(dict(labels)), float(v)

    def collect(self) -> dict:  # conc: event-loop
        """JSON-able snapshot (the ``metrics`` RPC payload)."""
        return {
            "counters": {
                name: {_label_str(k): v for k, v in series.items()}
                for name, series in self._counters.items()
            },
            "gauges": self._collected_gauges(),
            "histograms": {
                name: {_label_str(k): h.snapshot() for k, h in series.items()}
                for name, series in self._hists.items()
            },
        }

    def _collected_gauges(self) -> dict:
        out: dict[str, dict] = {}
        for name, key, v in self._gauge_items():
            out.setdefault(name, {})[_label_str(key)] = v
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, summary quantiles)."""
        lines: list[str] = []
        for name in sorted(self._counters):
            lines.append(f"# TYPE {name} counter")
            for key, v in sorted(self._counters[name].items()):
                lines.append(f"{name}{_prom_labels(key)} {v:g}")
        gauges: dict[str, list] = {}
        for name, key, v in self._gauge_items():
            gauges.setdefault(name, []).append((key, v))
        for name in sorted(gauges):
            lines.append(f"# TYPE {name} gauge")
            for key, v in sorted(gauges[name]):
                lines.append(f"{name}{_prom_labels(key)} {v:g}")
        for name in sorted(self._hists):
            lines.append(f"# TYPE {name} summary")
            for key, h in sorted(self._hists[name].items()):
                for q in (0.5, 0.9, 0.99):
                    qkey = key + (("quantile", f"{q:g}"),)
                    lines.append(
                        f"{name}{_prom_labels(qkey)} {h.quantile(q)}"
                    )
                lines.append(f"{name}_sum{_prom_labels(key)} {h.total_us}")
                lines.append(f"{name}_count{_prom_labels(key)} {h.count}")
        return "\n".join(lines) + "\n"


class RoundProfiler:
    """Per-round segment timing: preallocated accumulators, log2 histograms.

    The engine brackets each round-loop section with :meth:`mark` /
    :meth:`lap`; :meth:`round_end` folds the round's accumulated
    nanoseconds into one :class:`Histogram` per segment. All per-round
    state is two preallocated int64 vectors written in place.
    """

    def __init__(self) -> None:
        self.hist = tuple(Histogram() for _ in SEGMENTS)
        self._acc = np.zeros((len(SEGMENTS),), dtype=np.int64)  # ns
        self.last_us = np.zeros((len(SEGMENTS),), dtype=np.int64)
        self._t_round = 0
        self.rounds = 0

    @staticmethod
    def mark() -> int:
        return time.perf_counter_ns()

    def lap(self, seg: int, t0: int) -> int:
        """Charge now - t0 ns to ``seg``; returns now (the next mark)."""
        now = time.perf_counter_ns()
        self._acc[seg] += now - t0
        return now

    def add_ns(self, seg: int, dns: int) -> None:
        self._acc[seg] += dns

    def round_begin(self) -> int:
        self._acc[:] = 0
        self._t_round = time.perf_counter_ns()
        return self._t_round

    def round_end(self) -> None:  # conc: event-loop
        self._acc[SEG_ROUND] = time.perf_counter_ns() - self._t_round
        np.floor_divide(self._acc, 1000, out=self.last_us)
        for i, h in enumerate(self.hist):
            h.observe(int(self.last_us[i]))
        self.rounds += 1

    def last_segments(self) -> dict[str, int]:
        """This round's per-segment microseconds (the ``round`` span args)."""
        return {
            SEGMENTS[i]: int(self.last_us[i]) for i in range(SEG_ROUND)
        }

    def snapshot(self) -> dict:
        return {SEGMENTS[i]: h.snapshot() for i, h in enumerate(self.hist)}

    def totals_us(self) -> dict[str, int]:
        return {SEGMENTS[i]: h.total_us for i, h in enumerate(self.hist)}


class BuildCounter:
    """Programs built since construction or the last ``count = 0``.

    The port's stand-in for the JAX package's compile-event counter box:
    ``count`` reads :func:`~kaboodle_tpu_torch.serve.pool.program_builds`
    against a base, and setting it to 0 moves the base to now. Usable as a
    context manager (``with BuildCounter() as box: ...; box.count``)."""

    def __init__(self) -> None:
        self._base = self._total()

    @staticmethod
    def _total() -> int:
        from kaboodle_tpu_torch.serve.pool import program_builds

        return program_builds()

    @property
    def count(self) -> int:
        return self._total() - self._base

    @count.setter
    def count(self, value: int) -> None:
        self._base = self._total() - int(value)

    def __enter__(self) -> "BuildCounter":
        return self

    def __exit__(self, *exc) -> None:
        pass


class ObsPlane:
    """The engine-side observability plane: tracer + profiler + registry.

    Construct one per engine and pass it as ``ServeEngine(obs=...)`` (or
    ``obs=True`` for the defaults). ``trace=False`` keeps the profiler and
    metrics but emits no span records. ``clock_ns`` is injectable for
    deterministic tests; all span timestamps are microseconds relative to
    ``epoch_ns`` (the engine shares this epoch with its journal, so WAL
    ``ts_us`` and span ``t0_us`` live on one timeline).
    """

    def __init__(self, trace: bool = True, clock_ns=time.monotonic_ns) -> None:
        self.trace = bool(trace)
        self.metrics = MetricsRegistry()
        self.profiler = RoundProfiler()
        self._clock_ns = clock_ns
        self.epoch_ns = clock_ns()
        # rid -> (phase, t0_us, pool_n, lane): the one open span per request.
        self._open: dict[int, tuple] = {}
        self._stack = contextlib.ExitStack()
        self._compiles = None
        self.engine = None

    def now_us(self) -> int:
        return (self._clock_ns() - self.epoch_ns) // 1000

    # -- lifecycle tracing -------------------------------------------------

    def transition(self, rid: int, span: str | None, pool_n: int = -1,
                   lane: int = -1, **extra):
        """Close ``rid``'s open span and open ``span`` (None = terminal).

        Returns the closing ``serve_span`` record (or None when nothing
        was open / tracing is off); ``extra`` fields (``fate``,
        ``ticks_run``) land on the closing record. The caller fans the
        record out — the plane never writes manifests itself."""
        if not self.trace:
            return None
        now = self.now_us()
        prev = self._open.pop(rid, None)
        rec = None
        if prev is not None:
            pspan, pt0, ppool, plane = prev
            rec = run_record(
                "serve_span", span=pspan, request_id=rid, pool_n=ppool,
                lane=plane, t0_us=pt0, dur_us=now - pt0, **extra,
            )
        if span is not None:
            self._open[rid] = (span, now, pool_n, lane)
        return rec

    def flush_spans(self) -> list[dict]:
        """Close every still-open span (engine shutdown): the trace shows
        requests that were parked/spilled when the service stopped."""
        if not self.trace:
            return []
        now = self.now_us()
        out = [
            run_record("serve_span", span=pspan, request_id=rid,
                       pool_n=ppool, lane=plane, t0_us=pt0,
                       dur_us=now - pt0, open=True)
            for rid, (pspan, pt0, ppool, plane) in sorted(self._open.items())
        ]
        self._open.clear()
        return out

    # -- event-driven counters ---------------------------------------------

    def on_record(self, rec: dict) -> None:
        """Fold one engine-emitted manifest record into the counters."""
        kind = rec.get("kind")
        m = self.metrics
        if kind == "serve_event":
            ev = rec.get("event", "?")
            m.inc("serve_events_total", event=ev)
            if ev == "shed":
                m.inc("serve_shed_total", tenant=rec.get("tenant", "?"),
                      priority=rec.get("priority", "?"))
            elif ev == "rejected":
                m.inc("serve_rejected_total", tenant=rec.get("tenant", "?"),
                      reason=rec.get("reason", "?"))
            elif ev in ("spill_failed", "spill_deferred", "restore_failed"):
                m.inc("serve_spill_incidents_total", kind=ev)
        elif kind == "serve_round":
            eng = rec.get("engine", "?")
            m.inc("serve_rounds_total", engine=eng)
            m.inc("serve_ticks_total", value=rec.get("ticks", 0), engine=eng)

    # -- engine binding ----------------------------------------------------

    def bind(self, engine) -> None:
        """Attach to an engine: register the pull gauges over its live
        state and arm the program-build gauge (:class:`BuildCounter`).

        The gauges close over host bookkeeping only — evaluating them
        never touches the device, so a metrics scrape costs no device
        work."""
        self.engine = engine
        self._compiles = self._stack.enter_context(BuildCounter())
        m = self.metrics

        def _state_count(state):
            return lambda: sum(
                1 for row in engine._requests.values()
                if row["state"] == state
            )

        for state in ("queued", "running", "parked", "spilling", "spilled",
                      "done", "cancelled"):
            m.register_gauge("serve_requests", _state_count(state),
                             state=state)
        m.register_gauge(
            "serve_queue_depth", _state_count("queued"))
        for n, pool in engine.pools.items():
            m.register_gauge("serve_lanes_occupied",
                             (lambda p: lambda: p.occupancy()[0])(pool),
                             pool=n)
            m.register_gauge("serve_lanes_active",
                             (lambda p: lambda: p.occupancy()[1])(pool),
                             pool=n)
        m.register_gauge(
            "serve_spill_queue_depth",
            lambda: engine._spiller.pending() if engine._spiller else 0,
        )
        m.register_gauge(
            "serve_journal_lag_appends",
            lambda: (engine.journal._appends_since_compact
                     if engine.journal is not None else 0),
        )
        m.register_gauge("serve_engine_round", lambda: engine.round)

        def _leap_cache(field):
            def read():
                from kaboodle_tpu_torch.warp.runner import leap_cache

                return leap_cache.stats()[field]

            return read

        m.register_gauge("warp_leap_cache_hits", _leap_cache("hits"))
        m.register_gauge("warp_leap_cache_misses", _leap_cache("misses"))
        m.register_gauge("warp_leap_cache_programs", _leap_cache("programs"))

        # The span memo (signature-keyed state deltas). Reads the
        # engine's bound memo — engines without one report zeros, so the
        # gauge set is stable across configurations.
        def _span_memo(field):
            def read():
                memo = getattr(engine, "warp_memo", None)
                return memo.stats()[field] if memo is not None else 0

            return read

        m.register_gauge("warp_span_memo_hits", _span_memo("hits"))
        m.register_gauge("warp_span_memo_misses", _span_memo("misses"))
        m.register_gauge("warp_span_memo_entries", _span_memo("entries"))
        m.register_gauge("warp_span_memo_bytes", _span_memo("bytes"))
        m.register_gauge("warp_span_memo_evictions", _span_memo("evictions"))

        def _cache_kind_hit_rates():
            from kaboodle_tpu_torch.warp.runner import leap_cache

            return {
                (("kind", kind),): st["hit_rate"]
                for kind, st in leap_cache.stats()["per_kind"].items()
            }

        # Per-class cache hit rates (strict / hybrid / fleet programs) and
        # the why-dense histogram: which signature terms forced
        # leap->chunk fallbacks, labeled by blocking term combo.
        m.register_multi_gauge(
            "warp_leap_cache_hit_rate", _cache_kind_hit_rates)

        def _blocked(field):
            def read():
                return {
                    (("term", term),): agg[field]
                    for term, agg in
                    engine.warp_ledger.blocked_histogram().items()
                }

            return read

        m.register_multi_gauge("warp_blocked_ticks", _blocked("ticks"))
        m.register_multi_gauge("warp_blocked_spans", _blocked("spans"))
        m.register_gauge("compiles_steady", lambda: self._compiles.count)
        for i, seg in enumerate(SEGMENTS):
            m.attach_histogram("serve_round_segment_us",
                               self.profiler.hist[i], segment=seg)
        if engine.admission is not None:
            m.register_multi_gauge(
                "admission_tokens",
                lambda: {
                    (("tenant", t),): v["tokens"]
                    for t, v in engine.admission.snapshot()["tenants"].items()
                },
            )

    def reset_compiles(self) -> None:
        """Zero the program-build gauge — the engine calls this when
        warmup finishes, so ``compiles_steady`` means what it says."""
        if self._compiles is not None:
            self._compiles.count = 0

    def close(self) -> None:
        """Detach the build counter (idempotent)."""
        self._stack.close()
        self._compiles = None
