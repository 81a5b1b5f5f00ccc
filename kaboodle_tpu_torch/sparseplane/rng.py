"""Counter-based threefry streams for the blocked-sparse tick (re-export).

The port of ``kaboodle_tpu/sparseplane/rng.py``: the stream table and key
derivations live in :mod:`kaboodle_tpu_torch.phasegraph.rng`; this module
re-exports the sparse-facing names under their JAX import path.
"""

from __future__ import annotations

from kaboodle_tpu_torch.phasegraph.rng import (  # noqa: F401
    STREAM_ACK,
    STREAM_CHAIN,
    STREAM_DRAW,
    STREAM_GOSSIP,
    STREAM_PING,
    STREAM_PROXY,
    STREAM_TICK_BERN,
    STREAM_TICK_DROP,
    STREAM_TICK_PING,
    STREAM_TICK_PROXY,
    stream_key,
    stream_keys,
    stream_table,
    stream_uniform,
)

__all__ = [
    "STREAM_PROXY",
    "STREAM_CHAIN",
    "STREAM_DRAW",
    "STREAM_PING",
    "STREAM_ACK",
    "STREAM_GOSSIP",
    "STREAM_TICK_PROXY",
    "STREAM_TICK_PING",
    "STREAM_TICK_BERN",
    "STREAM_TICK_DROP",
    "stream_key",
    "stream_keys",
    "stream_table",
    "stream_uniform",
]
