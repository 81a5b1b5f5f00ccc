"""Profiler labels and Chrome-trace writers of the port.

The port of ``kaboodle_tpu/telemetry/trace.py``, in two halves:

- **Annotations** -- :func:`op_scope` and :func:`host_span` open a
  ``torch.profiler.record_function`` range named ``kaboodle:<name>``, which
  a ``torch.profiler`` capture shows on the host timeline with the kernels
  launched inside it; outside a capture a range costs a few microseconds
  and changes nothing the program computes.
- **Export** -- :func:`chrome_trace_events` renders per-tick telemetry rows
  (manifest ``tick`` records, or anything shaped like them) into Chrome
  trace events: one ``X`` slice per tick on a "protocol" track (leaped gaps
  become ``leap`` slices), one ``C`` counter series per ProtocolCounters
  field. :func:`phase_slice_events` adds a thread of per-pass slices from a
  phase program's ``describe()`` dict (the tables in ``summary.py``);
  :func:`serve_trace_events` and :func:`journal_trace_events` render the
  serve manifest and the journal on the wall clock; :func:`write_chrome_trace`
  wraps everything in the JSON object format that chrome://tracing and
  https://ui.perfetto.dev load directly. These are host JSON writers: for
  the same records their output is byte-equal to the JAX package's. The
  tick timeline's unit is simulated ticks (1 tick == 1 ms display time),
  not wall clock; for device wall time use a ``torch.profiler`` capture.
"""

from __future__ import annotations

import contextlib
import json

import torch

from kaboodle_tpu_torch.telemetry.counters import FIELDS

_TICK_US = 1000  # 1 simulated tick rendered as 1 ms of trace time


def op_scope(name: str):
    """A ``kaboodle:<name>`` profiler range, usable as a context manager or
    a decorator (the JAX package's ``jax.named_scope`` label)."""
    return torch.profiler.record_function(f"kaboodle:{name}")


@contextlib.contextmanager
def host_span(name: str):
    """Host-side profiler span around a stretch of the runner's loop."""
    with torch.profiler.record_function(f"kaboodle:{name}"):
        yield


def chrome_trace_events(tick_rows, pid: int = 1, label: str | None = None) -> list[dict]:
    """Per-tick telemetry rows FROM ONE RUN -> Chrome trace events.

    ``tick_rows``: iterable of dicts carrying ``tick`` plus any subset of
    the counter/metric fields (manifest ``tick`` records qualify). Rows
    need not be contiguous — a gap between consecutive ticks is rendered as
    one ``leap`` slice spanning it (the warp runner's leaped spans) — but
    they MUST come from a single run: the gap inference and the one-slice-
    per-tick layout are meaningless over pooled runs. Multiple runs get one
    call each with distinct ``pid``s (``write_chrome_trace`` with a mapping
    does exactly that), so each renders as its own Perfetto process track.
    """
    rows = sorted(tick_rows, key=lambda r: r["tick"])
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": label or "kaboodle protocol timeline"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
         "args": {"name": "ticks"}},
    ]
    prev_tick = None
    for row in rows:
        t = int(row["tick"])
        if prev_tick is not None and t > prev_tick + 1:
            events.append({
                "name": "leap", "ph": "X", "pid": pid, "tid": 1,
                "ts": (prev_tick + 1) * _TICK_US,
                "dur": (t - prev_tick - 1) * _TICK_US,
                "args": {"leaped_ticks": t - prev_tick - 1},
            })
        args = {
            k: row[k]
            for k in row
            if k not in ("tick", "schema", "kind") and isinstance(row[k], (int, float, bool))
        }
        events.append({
            "name": "tick", "ph": "X", "pid": pid, "tid": 1,
            "ts": t * _TICK_US, "dur": _TICK_US, "args": args,
        })
        for name in FIELDS:
            if name in row:
                events.append({
                    "name": name, "ph": "C", "pid": pid,
                    "ts": t * _TICK_US, "args": {name: row[name]},
                })
        prev_tick = t
    return events


def phase_slice_events(program, tick_rows, pid: int = 1) -> list[dict]:
    """Per-tick **pass** slices derived from a planned phase-graph program.

    ``program`` is a phase program's ``describe()`` dict (or an object with
    a ``describe()`` method) — the one source of truth for which fused pass
    each phase op landed in. Each tick present in ``tick_rows`` gets its
    1 ms subdivided equally among the program's executable passes (prologue
    then tail, in execution order) on a second thread of the same process
    track; a pass slice's args carry its op names. Pruned ops (the
    rare-phase work the dispatch predicate excludes from the fused program)
    are rendered once as an instant event at the first tick, with the
    predicate terms that guard their absence.

    Equal subdivision is deliberate: this is the *protocol* timeline (pass
    structure and op membership), not a wall-clock profile — per-pass wall
    time lives in a ``torch.profiler`` capture, where the ``kaboodle:``
    ranges bracket the same work.
    """
    desc = program.describe() if hasattr(program, "describe") else program
    passes = desc["passes"]
    events: list[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 2,
         "args": {"name": f"phase passes ({desc['mode']})"}},
    ]
    ticks = sorted(int(r["tick"]) for r in tick_rows)
    if ticks and desc.get("pruned"):
        events.append({
            "name": "pruned", "ph": "i", "s": "t", "pid": pid, "tid": 2,
            "ts": ticks[0] * _TICK_US,
            "args": {
                "ops": {p["op"]: p["reason"] for p in desc["pruned"]},
                "pred_terms": list(desc.get("pred_terms", ())),
            },
        })
    width = _TICK_US // max(len(passes), 1)
    for t in ticks:
        for j, p in enumerate(passes):
            events.append({
                "name": f"{p['stage']}:{p['name']}", "ph": "X",
                "pid": pid, "tid": 2,
                "ts": t * _TICK_US + j * width, "dur": width,
                "args": {"ops": list(p["ops"])},
            })
    return events


def serve_trace_events(records, pid_base: int = 10) -> list[dict]:
    """Serve manifest records -> Chrome trace events on the wall timeline.

    Renders the serve observability plane's record kinds into one shared-clock
    view — all timestamps are the engine/journal monotonic microseconds
    (``t0_us`` / ``t_us``), NOT the simulated-tick axis of
    :func:`chrome_trace_events`, so the two families should go in separate
    trace files.

    Layout: one **engine process** (``pid_base``) with the round envelope
    on thread 1 and the profiler's segment split laid out sequentially
    under each round on thread 2 (segments are sub-totals, not contiguous
    wall intervals — the layout shows proportion, the args carry truth);
    one **process per N-class pool** with a thread per lane: request
    phase spans (``queued`` / ``running`` / ``parked`` / ``spilling`` /
    ``spilled``) land on their lane's track (off-lane phases on the
    pool's "queue/off-lane" thread 1), and each ``advance`` span fans
    onto the lanes it moved — leap rounds named with the Warp signature
    class and leap length, chunk rounds with ticks run. ``serve_event``
    records that carry a ``t_us`` stamp (spill lifecycle, shed,
    recovery) become instant markers on the same tracks.
    """
    records = list(records)
    pools = sorted({
        int(r["pool_n"]) for r in records
        if r.get("kind") in ("serve_span", "serve_event")
        and int(r.get("pool_n", -1)) >= 0
    })
    pool_pid = {n: pid_base + 1 + i for i, n in enumerate(pools)}
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid_base,
         "args": {"name": "serve engine"}},
        {"name": "thread_name", "ph": "M", "pid": pid_base, "tid": 1,
         "args": {"name": "rounds"}},
        {"name": "thread_name", "ph": "M", "pid": pid_base, "tid": 2,
         "args": {"name": "round segments"}},
    ]
    lanes_seen: set[tuple[int, int]] = set()
    for n, pid in pool_pid.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"lane pool N={n}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": "queue/off-lane"}})

    def lane_tid(pid: int, lane: int) -> int:
        tid = lane + 2
        if (pid, lane) not in lanes_seen:
            lanes_seen.add((pid, lane))
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": f"lane {lane}"}})
        return tid

    for rec in records:
        kind = rec.get("kind")
        if kind == "serve_span":
            span = rec["span"]
            t0, dur = int(rec["t0_us"]), max(int(rec["dur_us"]), 1)
            if span == "round":
                args = {"round": rec.get("round")}
                args.update(rec.get("segments") or {})
                events.append({
                    "name": f"round {rec.get('round')}", "ph": "X",
                    "pid": pid_base, "tid": 1, "ts": t0, "dur": dur,
                    "args": args,
                })
                off = t0
                for seg, us in (rec.get("segments") or {}).items():
                    if us <= 0:
                        continue
                    events.append({
                        "name": seg, "ph": "X", "pid": pid_base, "tid": 2,
                        "ts": off, "dur": int(us), "args": {"us": int(us)},
                    })
                    off += int(us)
            elif span == "advance":
                pid = pool_pid.get(int(rec.get("pool_n", -1)), pid_base)
                eng = rec.get("engine", "?")
                for c in rec.get("classes") or []:
                    k = int(c.get("k", 0))
                    if eng == "leap":
                        name = f"leap x{k} [{c.get('class_key', '?')}]"
                    else:
                        name = f"run x{k}"
                    events.append({
                        "name": name, "ph": "X", "pid": pid,
                        "tid": lane_tid(pid, int(c["lane"])),
                        "ts": t0, "dur": dur,
                        "args": {**c, "engine": eng,
                                 "round": rec.get("round")},
                    })
            else:
                rid = int(rec["request_id"])
                pool_n = int(rec.get("pool_n", -1))
                lane = int(rec.get("lane", -1))
                pid = pool_pid.get(pool_n, pid_base)
                tid = lane_tid(pid, lane) if lane >= 0 else (
                    1 if pool_n >= 0 else 3)
                args = {k: v for k, v in rec.items()
                        if k not in ("schema", "kind", "span", "t0_us",
                                     "dur_us")}
                events.append({
                    "name": f"r{rid}:{span}", "ph": "X", "pid": pid,
                    "tid": tid, "ts": t0, "dur": dur, "args": args,
                })
        elif kind == "serve_event" and isinstance(rec.get("t_us"), int):
            pool_n = int(rec.get("pool_n", -1))
            lane = int(rec.get("lane", -1))
            pid = pool_pid.get(pool_n, pid_base)
            tid = lane_tid(pid, lane) if lane >= 0 and pid != pid_base else 1
            args = {k: v for k, v in rec.items()
                    if k not in ("schema", "kind", "t_us")}
            events.append({
                "name": rec.get("event", "?"), "ph": "i", "s": "t",
                "pid": pid, "tid": tid, "ts": int(rec["t_us"]),
                "args": args,
            })
    return events


def journal_trace_events(records, pid: int = 9) -> list[dict]:
    """WAL records (``journal.read_journal_records``) -> instant markers.

    Records carry ``ts_us`` on the engine's shared monotonic
    epoch, so journal writes line up under the serve spans; ``seq`` orders
    them (crash-recovery order). Records without a timestamp are
    skipped — there is nowhere honest to put them on a wall timeline.
    """
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "serve journal (WAL)"}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
         "args": {"name": "appends"}},
    ]
    for rec in sorted(records, key=lambda r: int(r.get("seq", -1))):
        if not isinstance(rec.get("ts_us"), int):
            continue
        events.append({
            "name": f"{rec.get('op', '?')} r{rec.get('rid')}", "ph": "i",
            "s": "t", "pid": pid, "tid": 1, "ts": int(rec["ts_us"]),
            "args": {"op": rec.get("op"), "rid": rec.get("rid"),
                     "seq": rec.get("seq", None)},
        })
    return events


def write_chrome_trace(
    path: str, tick_rows, metadata: dict | None = None, program=None,
    extra_events: list[dict] | None = None,
) -> int:
    """Write rows as a Chrome-trace JSON file; returns the event count.

    ``tick_rows`` is either one run's rows, or a ``{label: rows}`` mapping
    of several runs — each mapping entry gets its own pid (Perfetto process
    track), so independent runs' ticks never interleave into each other's
    leap-gap inference. ``program`` (optional) is a planned phase-graph
    program (or its ``describe()`` dict): each run track then gets a second
    thread of per-pass slices (:func:`phase_slice_events`) showing which
    pass each phase op landed in; the program structure is also embedded in
    ``otherData.phase_program``. ``extra_events`` (optional) are appended
    verbatim — the summarizer uses this for the serve/journal tracks
    (:func:`serve_trace_events` / :func:`journal_trace_events`), which live
    on their own pids."""
    if isinstance(tick_rows, dict):
        events = []
        for i, (label, rows) in enumerate(tick_rows.items(), start=1):
            rows = list(rows)
            events.extend(chrome_trace_events(rows, pid=i, label=str(label)))
            if program is not None:
                events.extend(phase_slice_events(program, rows, pid=i))
    else:
        tick_rows = list(tick_rows)
        events = chrome_trace_events(tick_rows)
        if program is not None:
            events.extend(phase_slice_events(program, tick_rows))
    if extra_events:
        events.extend(extra_events)
    if program is not None:
        desc = program.describe() if hasattr(program, "describe") else program
        metadata = {**(metadata or {}), "phase_program": desc}
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": "kaboodle-telemetry/1", **(metadata or {})},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)
