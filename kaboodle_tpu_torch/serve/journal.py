"""Write-ahead journal of request lifecycle transitions (crash recovery).

The port's copy of ``kaboodle_tpu/serve/journal.py`` (host-only): the same
record shape, ``JOURNAL_VERSION`` and folding rules, so a journal written by
either package's engine replays in the other.

Without a journal a crashed engine forgets every in-flight request: the host-side
``_requests`` table is the only record. The journal makes the table
reconstructible: every lifecycle transition is appended to
``<dir>/wal.jsonl`` (one JSON object per line, flushed per append) BEFORE
the engine acts on it, and a periodic compaction snapshots the folded
table into ``<dir>/manifest.json`` (atomic fsync-then-rename) and
truncates the WAL — replay cost stays O(live transitions), not O(service
lifetime).

Record shape: ``{"op": <transition>, "rid": <id>, ...fields}``. The ops
the engine writes: ``submitted`` (full request fields), ``admitted``,
``harvested`` (terminal event + result), ``resumed``,
``spill_begin``, ``spilled`` (path + the host run counters frozen at
spill time), ``spill_failed``, ``restored``, ``cancelled``, ``shed``,
``requeued``.

:meth:`ServeJournal.replay` folds manifest + WAL into a per-rid table of
last-known states; ``ServeEngine.recover`` turns that into a live request
table — terminal rows keep their results (nothing replays twice), spilled
rows re-attach to their files, everything whose lane state died with the
process re-queues from its seed. A half-written last WAL line (the crash
landed mid-append) is ignored, not fatal.
"""

from __future__ import annotations

import json
import os
import time

JOURNAL_VERSION = 1


def _write_json_atomic(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ServeJournal:
    """Append-ahead request-lifecycle log + compacted manifest snapshot.

    ``fsync=True`` fsyncs every append (true write-ahead durability);
    default flushes to the OS per append — a process crash loses nothing,
    a power cut may lose the tail, which recovery treats as re-queueable.
    """

    def __init__(
        self,
        journal_dir: str,
        fsync: bool = False,
        compact_every: int = 256,
        owner: str | None = None,
    ) -> None:
        self.dir = os.fspath(journal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.wal_path = os.path.join(self.dir, "wal.jsonl")
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        self.owner = owner
        if owner is not None:
            # Claim (or re-claim) the directory: a federation engine that
            # opens another engine's journal for WRITING is a deployment
            # bug — refused loudly here, before any append could interleave
            # two engines' transitions. Read-side failover replay goes
            # through :func:`replay_journal`, which claims nothing.
            owner_path = os.path.join(self.dir, "owner.json")
            existing = journal_owner(self.dir)
            if existing is not None and existing != owner:
                raise ValueError(
                    f"journal {self.dir} is owned by alien engine "
                    f"{existing!r} (this engine: {owner!r})"
                )
            _write_json_atomic(owner_path, {"owner": owner})
        self.fsync = bool(fsync)
        self.compact_every = int(compact_every)
        self._appends_since_compact = 0
        # Timeline origin for ``ts_us`` stamps. The engine overwrites this
        # with the observability plane's epoch after construction so journal
        # timestamps and trace spans share one monotonic axis.
        self.epoch_ns = time.monotonic_ns()
        self._seq = self._restore_seq()
        self._f = open(self.wal_path, "a")

    def _restore_seq(self) -> int:
        """Resume the sequence counter past everything already on disk, so
        seq stays strictly increasing across process restarts (pre-seq
        records simply don't participate in the max)."""
        seq = 0
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    seq = int(json.load(f).get("next_seq", 0))
            except (json.JSONDecodeError, ValueError, OSError):
                seq = 0
        if os.path.exists(self.wal_path):
            with open(self.wal_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail: same tolerance as replay()
                    if "seq" in rec:
                        seq = max(seq, int(rec["seq"]) + 1)
        return seq

    # -- write side --------------------------------------------------------

    def append(self, op: str, rid: int, **fields) -> None:  # conc: event-loop
        rec = {
            "op": op,
            "rid": int(rid),
            "seq": self._seq,
            "ts_us": (time.monotonic_ns() - self.epoch_ns) // 1000,
        }
        self._seq += 1
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._appends_since_compact += 1

    def should_compact(self) -> bool:
        return self._appends_since_compact >= self.compact_every

    def compact(self, table: dict[int, dict], next_rid: int) -> None:  # conc: event-loop
        """Snapshot the folded table to ``manifest.json`` and truncate the
        WAL. The snapshot lands atomically BEFORE the WAL is cut, so a
        crash between the two replays some transitions twice into the same
        folded rows — idempotent by construction."""
        snap = {
            "version": JOURNAL_VERSION,
            "next_rid": int(next_rid),
            "next_seq": self._seq,
            "requests": {str(rid): row for rid, row in table.items()},
        }
        if self.owner is not None:
            snap["owner"] = self.owner
        _write_json_atomic(self.manifest_path, snap)
        self._f.close()
        self._f = open(self.wal_path, "w")
        if self.fsync:
            os.fsync(self._f.fileno())
        self._appends_since_compact = 0

    def close(self) -> None:
        self._f.close()

    # -- read side ---------------------------------------------------------

    def replay(self) -> tuple[dict[int, dict], int]:
        """Fold manifest snapshot + WAL into ``(table, next_rid)``.

        ``table`` maps rid -> a journal-row dict: ``{"op": <last
        transition>, "req": {...}, "result": ..., "spill_path": ...,
        "saved_run": ..., "extra_ticks": <sum of ticks-mode resume
        budgets>}`` — everything recover needs, nothing engine-internal."""
        return _replay_paths(self.manifest_path, self.wal_path)

    @staticmethod
    def _fold(table: dict[int, dict], rec: dict) -> None:
        rid = int(rec["rid"])
        row = table.setdefault(
            rid,
            {
                "op": None,
                "req": None,
                "result": None,
                "spill_path": None,
                "saved_run": None,
                "extra_ticks": 0,
            },
        )
        op = rec["op"]
        row["op"] = op
        # Ordering metadata (absent from pre-seq journals; recover() falls
        # back to rid order when missing).
        if "seq" in rec:
            row["seq"] = int(rec["seq"])
        if "ts_us" in rec:
            row["ts_us"] = int(rec["ts_us"])
        if op == "submitted":
            row["req"] = rec.get("req")
        elif op == "adopted":
            # A failover handover: submitted + spilled in one record, the
            # spill file still owned (stamped) by the dead engine.
            row["req"] = rec.get("req")
            row["spill_path"] = rec.get("path")
            row["saved_run"] = rec.get("saved_run")
            row["spill_owner"] = rec.get("owner")
        elif op == "harvested":
            row["result"] = rec.get("result")
            row["event"] = rec.get("event")
        elif op == "resumed":
            # Cumulative continuation budget: a re-queued request re-runs
            # its whole trajectory, original budget plus every resume.
            if rec.get("mode") == "ticks":
                row["extra_ticks"] += int(rec.get("ticks", 0))
        elif op == "spilled":
            row["spill_path"] = rec.get("path")
            row["saved_run"] = rec.get("saved_run")
        elif op == "spill_failed":
            pass  # lane still held (or cache retried); last op stands


def _replay_paths(
    manifest_path: str, wal_path: str
) -> tuple[dict[int, dict], int]:
    table: dict[int, dict] = {}
    next_rid = 0
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            snap = json.load(f)
        if snap.get("version") != JOURNAL_VERSION:
            raise ValueError(
                f"journal manifest version {snap.get('version')!r} != "
                f"{JOURNAL_VERSION}"
            )
        table = {int(rid): row for rid, row in snap["requests"].items()}
        next_rid = int(snap["next_rid"])
    if os.path.exists(wal_path):
        with open(wal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail write: the crash point
                ServeJournal._fold(table, rec)
                next_rid = max(next_rid, int(rec["rid"]) + 1)
    return table, next_rid


def replay_journal(journal_dir: str) -> tuple[dict[int, dict], int]:
    """Read-only fold of an engine's journal — no append handle, no owner
    claim, no compaction. The router's failover path replays a DEAD
    engine's directory through here; constructing a :class:`ServeJournal`
    instead would steal the directory (owner claim) and truncate evidence
    a post-mortem might want."""
    d = os.fspath(journal_dir)
    return _replay_paths(
        os.path.join(d, "manifest.json"), os.path.join(d, "wal.jsonl")
    )


def journal_owner(journal_dir: str) -> str | None:
    """The engine-id that owns ``journal_dir`` (``None`` when unclaimed or
    unreadable — a single-engine era journal)."""
    path = os.path.join(os.fspath(journal_dir), "owner.json")
    try:
        with open(path) as f:
            return json.load(f).get("owner")
    except (OSError, json.JSONDecodeError, ValueError, AttributeError):
        return None


def read_journal_records(journal_dir: str) -> list[dict]:
    """Raw WAL records in replay order, for the trace exporter.

    Records carrying ``seq`` (every journal written with sequence numbers) are ordered by it —
    that is the crash-recovery order even when compaction interleaved
    writes.  Pre-seq records keep file order (stable sort, missing seq
    sorts first in encounter order).  Torn tails are skipped exactly like
    :meth:`ServeJournal.replay`.
    """
    path = os.path.join(os.fspath(journal_dir), "wal.jsonl")
    records: list[dict] = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    break
    records.sort(key=lambda r: int(r.get("seq", -1)))
    return records
