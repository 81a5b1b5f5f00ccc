"""JSONL run manifests: ONE schema for every lane's machine output.

The port of ``kaboodle_tpu/telemetry/manifest.py``: the same schema tag,
record kinds and validation, so a manifest written by either package reads
back in the other. Values coerce to JSON types from numpy scalars and
arrays and from torch tensors (fetched to the host).

Before this module, three tools each formatted their own JSON: bench.py
(``BENCHDOC`` lines + BENCH_last_full.json), the fleet sweep CLI (a compact
tail line), and the warp A/B (a third shape). A manifest is the superset
they all need — a stream of schema-tagged records:

    {"schema": "kaboodle-telemetry/1", "kind": "run",  ...lane fields...}
    {"schema": "kaboodle-telemetry/1", "kind": "tick", "tick": 0, ...}
    {"schema": "kaboodle-telemetry/1", "kind": "recorder", ...}

``kind`` values are open (lanes add their own), but every record carries
the schema tag and every ``tick`` record carries a ``tick`` index, so the
summarizer (``python -m kaboodle_tpu_torch.telemetry.summary``) and the
Chrome-trace exporter can consume any lane's manifest. Writers are
stdlib-only and host-side.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

import numpy as np
import torch

MANIFEST_SCHEMA = "kaboodle-telemetry/1"


def _jsonable(v):
    """NumPy scalars and arrays, torch tensors -> plain Python (json.dumps-safe)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def run_record(kind: str = "run", **fields) -> dict:
    """A schema-tagged manifest record (host values coerced to JSON types)."""
    rec = {"schema": MANIFEST_SCHEMA, "kind": kind}
    rec.update({k: _jsonable(v) for k, v in fields.items()})
    return rec


def validate_record(rec) -> dict:
    """Raise ``ValueError`` unless ``rec`` is a well-formed manifest record."""
    if not isinstance(rec, dict):
        raise ValueError(f"manifest record must be an object, got {type(rec).__name__}")
    if rec.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"manifest record schema {rec.get('schema')!r} != {MANIFEST_SCHEMA!r}"
        )
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        raise ValueError("manifest record needs a non-empty string 'kind'")
    if kind == "tick" and not isinstance(rec.get("tick"), int):
        raise ValueError("'tick' records need an integer 'tick' index")
    if kind == "serve_event":
        if not isinstance(rec.get("event"), str) or not rec.get("event"):
            raise ValueError(
                "'serve_event' records need a non-empty string 'event'"
            )
        if not isinstance(rec.get("lane"), int):
            raise ValueError("'serve_event' records need an integer 'lane'")
    if kind == "serve_round" and not isinstance(rec.get("round"), int):
        raise ValueError("'serve_round' records need an integer 'round'")
    if kind == "serve_span":
        if not isinstance(rec.get("span"), str) or not rec.get("span"):
            raise ValueError(
                "'serve_span' records need a non-empty string 'span'"
            )
        for field in ("t0_us", "dur_us", "request_id"):
            if not isinstance(rec.get(field), int):
                raise ValueError(
                    f"'serve_span' records need an integer {field!r}"
                )
    if kind == "warp_blocked":
        # Why-dense attribution rows (warp/runner.py WarpLedger): one per
        # blocking term combo, summed over the run's dense spans.
        if not isinstance(rec.get("term"), str) or not rec.get("term"):
            raise ValueError(
                "'warp_blocked' records need a non-empty string 'term'"
            )
        for field in ("ticks", "spans"):
            if not isinstance(rec.get(field), int):
                raise ValueError(
                    f"'warp_blocked' records need an integer {field!r}"
                )
    if kind == "costscope":
        # Static compiler-plane records (costscope/cli.py --manifest).
        if not isinstance(rec.get("entry"), str) or not rec.get("entry"):
            raise ValueError(
                "'costscope' records need a non-empty string 'entry'"
            )
    return rec


class ManifestWriter:
    """JSONL manifest writer (context manager).

    One record per line; every record is validated before it is written, so
    a manifest can never contain a line the summarizer would reject.

    Default mode TRUNCATES: a manifest names one run, and re-running a CLI
    lane with the same path must replace the old run, not silently merge
    two runs into doubled counter totals and duplicate tick records.
    ``append=True`` opts into accumulation for writers that deliberately
    build a multi-record stream across processes (bench.py ``--manifest``
    appends one ``run`` record per lane invocation).

    ``stream=True`` opts into line-buffered live mode: every record is
    flushed to the file the moment it is written, so a client tailing the
    manifest (the serve server's ``stream`` op, ``tail -f``) sees records
    at event time rather than at close. Batch writers keep the default
    block buffering — a bench run has no live readers.
    """

    def __init__(
        self, path: str, append: bool = False, stream: bool = False
    ) -> None:
        self.path = path
        self.stream = bool(stream)
        self._f = open(path, "a" if append else "w")
        self.records_written = 0

    def write(self, kind: str = "run", **fields) -> dict:
        return self.write_record(run_record(kind, **fields))

    def write_record(self, rec: dict) -> dict:  # conc: event-loop
        """Validate and write an ALREADY-BUILT record (the serve engine
        emits records through ``on_event`` fan-out; the server writes the
        same dict it hands to stream subscribers — i.e. this runs ON the
        event loop, which is why this file is in graftconc's CONC_SCOPE:
        the write/flush here must stay a buffered line append, never an
        fsync or a device fetch)."""
        rec = validate_record(rec)
        self._f.write(json.dumps(rec) + "\n")
        self.records_written += 1
        if self.stream:
            self._f.flush()
        return rec

    def flush(self) -> None:
        """Push buffered records to the file now (no-op cost in stream
        mode, where every write already flushed)."""
        self._f.flush()

    def write_tick_metrics(self, metrics, counters=None, ticks=None) -> int:
        """Stream stacked per-tick ``TickMetrics`` (and optionally stacked
        ``ProtocolCounters``) as ``tick`` records.

        ``ticks`` overrides the tick column (warped runs: the densely
        executed tick indices); default 0..T-1. Returns rows written.
        Zero-tick runs (already converged at entry) write nothing — the
        empty table is valid, not an error.
        """
        from kaboodle_tpu_torch.profiling import tick_stats

        table = tick_stats(metrics)
        ctable = None
        if counters is not None:
            from kaboodle_tpu_torch.telemetry.counters import counters_table

            ctable = counters_table(counters)
        for i, row in enumerate(table):
            fields = {name: row[name] for name in table.dtype.names}
            if ticks is not None:
                fields["tick"] = int(np.asarray(ticks)[i])
            if ctable is not None:
                fields.update(
                    {n: ctable[n][i] for n in ctable.dtype.names if n != "tick"}
                )
            fields["tick"] = int(fields["tick"])
            self.write("tick", **fields)
        return len(table)

    def write_recorder(self, rec) -> dict:
        """Dump a :class:`FlightRecorder` ring as one ``recorder`` record
        (table rows inline; the per-member fp plane as min/max/row digests,
        not the full [K, N] matrix — manifests stay O(K))."""
        from kaboodle_tpu_torch.telemetry.recorder import recorder_rows

        rows = recorder_rows(rec)
        table = rows["table"]
        return self.write(
            "recorder",
            rows=[
                {name: _jsonable(r[name]) for name in table.dtype.names}
                for r in table
            ],
            fp_unique=[int(len(np.unique(f))) for f in rows["fp"]],
        )

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "ManifestWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_manifest(path: str, validate: bool = True) -> Iterator[dict]:
    """Yield manifest records from a JSONL file (optionally validated)."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
            if validate:
                try:
                    validate_record(rec)
                except ValueError as e:
                    raise ValueError(f"{path}:{lineno}: {e}") from None
            yield rec


def dataclass_fields(obj) -> dict:
    """Flatten a (host-fetched) dataclass pytree into manifest fields."""
    return {
        f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)
    }
