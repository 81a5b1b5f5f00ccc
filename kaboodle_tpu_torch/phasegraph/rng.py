"""Counter-keyed threefry streams of the tick, bit-exact with the JAX package.

Every draw of a tick is keyed by a pure function of ``(key, tick, stream)``:

    tick_key(stream) = fold_in(fold_in(PRNGKey(key[0] ^ key[1]), tick), stream)

so the carried key is a constant of the run and any tick's randomness can
be recomputed from the state alone. The ``STREAM_*`` ids are those of the
JAX package; renumbering one changes every draw of every run.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.ops import threefry

STREAM_PROXY = 0  # proxy slot picks for ping-req fan-out
STREAM_CHAIN = 1  # the four delivery legs of each indirect-ping chain
STREAM_DRAW = 2  # ping target pick among the oldest-k Known slots
STREAM_PING = 3  # direct ping delivery bernoulli
STREAM_ACK = 4  # ack delivery bernoulli
STREAM_GOSSIP = 5  # piggyback share slot picks
STREAM_TICK_PROXY = 6  # dense tick: proxy member choose-k for escalation
STREAM_TICK_PING = 7  # dense tick: ping target pick / candidate choice
STREAM_TICK_BERN = 8  # dense tick: join-reply bernoulli matrix
STREAM_TICK_DROP = 9  # dense tick: datagram drop uniform matrix


def stream_key(seed: int, cursor: int, stream: int) -> threefry.Key:
    """Threefry key for one phase of one tick -- a pure function of the counters."""
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), cursor), stream)


def stream_uniform(
    seed: int, cursor: int, stream: int, shape: tuple[int, ...], device
) -> torch.Tensor:
    """Shaped float32 uniform in [0, 1) for one phase (position = row/slot)."""
    return threefry.uniform(stream_key(seed, cursor, stream), shape, device)


def tick_stream_key(key: threefry.Key, tick: int, stream: int) -> threefry.Key:
    """Dense-tick key for ``(key, tick, stream)``; ``key`` is the carried word pair."""
    seed = (key[0] ^ key[1]) & threefry.M32
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), tick), stream)


def tick_draw_keys(key: threefry.Key, tick: int):
    """The dense tick's four draw keys ``(proxy, ping, bern, drop)``."""
    return (
        tick_stream_key(key, tick, STREAM_TICK_PROXY),
        tick_stream_key(key, tick, STREAM_TICK_PING),
        tick_stream_key(key, tick, STREAM_TICK_BERN),
        tick_stream_key(key, tick, STREAM_TICK_DROP),
    )
