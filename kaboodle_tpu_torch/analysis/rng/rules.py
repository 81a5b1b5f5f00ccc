"""KB602's registry half: the pinned stream table vs the live ``STREAM_*`` ids.

The port of the trace-free part of ``kaboodle_tpu/analysis/rng/rules.py``.
The JAX lane's other checks (KB601, KB603-KB605 and KB602's in-trace half)
walk jaxprs and have no counterpart in the port. This one compares the
port's own pinned table, :data:`KEYSCOPE_STREAMS`, with the live constants
of ``phasegraph/rng.py`` (``stream_table``) -- double-entry bookkeeping,
so a renumbering or a swap of two ids trips the lane before every banked
run's draws silently renumber.
"""

from __future__ import annotations

from kaboodle_tpu_torch.analysis.core import Finding

# The port's own copy of phasegraph/rng.py's STREAM_* registry. The two are
# compared verbatim on every rng run: ids must be dense from 0, in
# append-only order, and value-identical. A new randomized phase appends to
# BOTH (this tuple and rng.py) -- that dual edit is the mechanical form of
# rng.py's "new phases append, renumbering changes every banked run". Ids
# 0-5 are the sparse tick's (seed, cursor) streams; 6-9 are the dense
# tick's (key, tick) streams.
KEYSCOPE_STREAMS = (
    ("STREAM_PROXY", 0),
    ("STREAM_CHAIN", 1),
    ("STREAM_DRAW", 2),
    ("STREAM_PING", 3),
    ("STREAM_ACK", 4),
    ("STREAM_GOSSIP", 5),
    ("STREAM_TICK_PROXY", 6),
    ("STREAM_TICK_PING", 7),
    ("STREAM_TICK_BERN", 8),
    ("STREAM_TICK_DROP", 9),
)

_STREAMS_PATH = "rng://sparseplane.streams"


def check_kb602_stream_registry() -> list[Finding]:
    """The pinned table vs the live phasegraph.rng constants (trace-free).

    Ids must be dense from 0 in append-only order and value-identical to
    ``KEYSCOPE_STREAMS`` -- a swap keeps the draws collision-free and the
    id set unchanged, so only this double-entry comparison catches it."""
    from kaboodle_tpu_torch.phasegraph.rng import stream_table

    out: list[Finding] = []
    live = stream_table()
    pinned = dict(KEYSCOPE_STREAMS)
    for name, want in KEYSCOPE_STREAMS:
        got = live.get(name)
        if got != want:
            out.append(Finding(
                _STREAMS_PATH, "KB602", 0,
                f"{name} is {got!r} live but pinned {want} in KEYSCOPE_STREAMS "
                "-- stream ids renumber banked draws; ids append, they never move",
                f"drift:{name}",
            ))
    for name in sorted(set(live) - set(pinned)):
        out.append(Finding(
            _STREAMS_PATH, "KB602", 0,
            f"live stream {name}={live[name]} is not in the KEYSCOPE_STREAMS "
            "table -- append it (new phases append to both ledgers)",
            f"unpinned:{name}",
        ))
    ids = sorted(live.values())
    if ids != list(range(len(ids))):
        out.append(Finding(
            _STREAMS_PATH, "KB602", 0,
            f"live STREAM_* ids {ids} are not dense from 0 -- gaps or "
            "duplicates mean a collision or a renumbering hazard",
            "not-dense",
        ))
    return out
