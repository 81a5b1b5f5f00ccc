"""Counter-keyed threefry streams of the tick, bit-exact with the JAX package.

Every draw of a tick is keyed by a pure function of ``(key, tick, stream)``:

    tick_key(stream) = fold_in(fold_in(PRNGKey(key[0] ^ key[1]), tick), stream)

so the carried key is a constant of the run and any tick's randomness can
be recomputed from the state alone. The ``STREAM_*`` ids are those of the
JAX package; renumbering one changes every draw of every run.

The dense tick derives its keys on the device from the state's ``key`` and
``tick`` tensors (:func:`state_draw_keys`; ``[E]`` words for an ensemble),
the sparse tick from its ``seed`` and ``cursor`` tensors
(:func:`stream_keys`), the blocked tick on the host from Python ints: every
form gives the same words.
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


def stream_table() -> dict[str, int]:
    """Live ``{name: id}`` view of every ``STREAM_*`` constant, in id order.

    Read off the module's attributes at call time, not a frozen copy, so a
    renumbering shows up here as it would in the draws."""
    import sys

    mod = sys.modules[__name__]
    table = {
        name: getattr(mod, name)
        for name in dir(mod)
        if name.startswith("STREAM_") and isinstance(getattr(mod, name), int)
    }
    return dict(sorted(table.items(), key=lambda kv: (kv[1], kv[0])))


def stream_key(seed: int, cursor: int, stream: int) -> threefry.Key:
    """Threefry key for one phase of one tick -- a pure function of the counters."""
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), cursor), stream)


def stream_uniform(
    seed: int, cursor: int, stream: int, shape: tuple[int, ...], device
) -> torch.Tensor:
    """Shaped float32 uniform in [0, 1) for one phase (position = row/slot)."""
    return threefry.uniform(stream_key(seed, cursor, stream), shape, device)


def stream_keys(seed: torch.Tensor, cursor: torch.Tensor, streams) -> tuple:
    """:func:`stream_key` of each stream in ``streams``, for ``seed`` and
    ``cursor`` given as 0-d tensors of 32-bit words (int32 bits): the
    streams are folded in one batched call and every key word stays on
    their device, with no host fetch."""
    k0, k1 = threefry.fold_in(threefry.prng_key(seed), cursor)
    ids = torch.tensor(streams, dtype=torch.int64, device=cursor.device)
    w0, w1 = threefry.fold_in((k0[..., None], k1[..., None]), ids)
    return tuple((w0[..., i], w1[..., i]) for i in range(len(streams)))


def tick_stream_key(key: threefry.Key, tick: int, stream: int) -> threefry.Key:
    """Dense-tick key for ``(key, tick, stream)``; ``key`` is the carried word pair."""
    seed = (key[0] ^ key[1]) & threefry.M32
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), tick), stream)


_TICK_STREAMS = (STREAM_TICK_PROXY, STREAM_TICK_PING, STREAM_TICK_BERN, STREAM_TICK_DROP)


def tick_draw_keys(key: threefry.Key, tick):
    """The dense tick's four draw keys ``(proxy, ping, bern, drop)``.

    With int words and an int ``tick``, four host keys; with tensor words
    (shape ``[]`` or ``[E]``) and a tick tensor of the same shape, four
    tensor keys of that shape, the four streams folded in one batched call."""
    if not isinstance(tick, torch.Tensor):
        return tuple(tick_stream_key(key, tick, s) for s in _TICK_STREAMS)
    seed = (key[0] ^ key[1]) & threefry.M32
    k0, k1 = threefry.fold_in(threefry.prng_key(seed), tick)
    streams = torch.tensor(_TICK_STREAMS, dtype=torch.int64, device=tick.device)
    w0, w1 = threefry.fold_in((k0[..., None], k1[..., None]), streams)
    return tuple((w0[..., i], w1[..., i]) for i in range(len(_TICK_STREAMS)))


def state_draw_keys(key: torch.Tensor, tick: torch.Tensor):
    """:func:`tick_draw_keys` of a state's carried ``key`` (int32 bits,
    ``[..., 2]``) and ``tick`` (``[...]``), on their device: no host fetch."""
    words = threefry._u32(key)
    return tick_draw_keys((words[..., 0], words[..., 1]), tick)
