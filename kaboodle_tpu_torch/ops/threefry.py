"""Threefry-2x32 counter RNG, bit-exact with ``jax.random`` (threefry, partitionable).

What the JAX tick draws, reproduced bit for bit (jax 0.9.0 with
``jax_threefry_partitionable=True``):

- ``PRNGKey(seed)`` is the word pair ``(0, seed)`` (``prng.threefry_seed``);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))`` (``_threefry_fold_in``),
  and row i of ``split(key, num)`` is ``threefry2x32(key, (0, i))``
  (``_threefry_split_foldlike``);
- 32 random bits at flat position ``c`` of a shape are ``b1 ^ b2`` with
  ``(b1, b2) = threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``
  (``_threefry_random_bits_partitionable`` over ``iota_2x32_shape``);
- a float32 uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1``
  (``random._uniform``), and the Gumbel draw (``random._gumbel``, mode
  "low") is ``-log(-log(max(u, tiny)))``: strictly increasing in ``u``, so
  an ORDER of Gumbel draws is the order of the 23 bits ``bits >> 9``.

A key is a pair of words: two Python ints (derived on the host), or two
int64 tensors holding unsigned 32-bit values, of shape ``[]`` (one mesh)
or ``[E]`` (an ensemble, one key per member). A draw under ``[E]`` keys
has a leading ``[E]`` axis, and member e's slice is the draw of its own
key over counters ``0 .. cells - 1``: the batch ``jax.vmap`` gives.
Shaped draws run on the tensor's device in int64 holding unsigned 32-bit
values, chunk by chunk (rows of a member, or whole members), so an
``[N, N]`` or ``[E, N, N]`` draw never needs more than a few chunk-sized
temporaries: the counter of a cell is its flat index within its member,
so chunking changes no bit.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Cells per row chunk of a shaped draw (and of init_state's plane and the
# membership fingerprint): 2^22 cells keep each int64 temporary at 32 MiB.
CHUNK_CELLS = 1 << 22

Key = tuple  # (k0, k1): two ints, or two int64 tensors of one shape ([] or [E])


def _rotl(x, r: int, scalar: bool):
    if scalar:
        return ((x << r) | (x >> (32 - r))) & M32
    return ((x << r) & M32) | (x >> (32 - r))


def _u32(x):
    """A word as its unsigned value: ``x & M32`` (int64 for a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return x & M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)`` under ``key``.

    Key and counter words are Python ints or int64 tensors of unsigned
    32-bit values, broadcast together; the result is ints when all are
    ints, else tensors."""
    scalar = not any(isinstance(v, torch.Tensor) for v in (x0, x1, *key))
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r, scalar) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (an int or a tensor)."""
    seed = _u32(seed)
    return (torch.zeros_like(seed) if isinstance(seed, torch.Tensor) else 0, seed)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` an int or a tensor that
    broadcasts against the key words."""
    return threefry2x32(key, 0, _u32(data))


def split(key: Key, num: int = 2) -> tuple[Key, ...]:
    """The ``num`` rows of ``jax.random.split(key, num)``, as word pairs.

    Under ``jax_threefry_partitionable=True`` (``_threefry_split_foldlike``)
    row ``i`` is ``threefry2x32(key, (0, i))``: the counter words of
    ``iota_2x32_shape((num,))``, which is ``fold_in(key, i)``."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def batch_shape(key: Key) -> tuple[int, ...]:
    """The ensemble shape of a key: ``()`` for one mesh, ``(E,)`` for ``[E]`` words."""
    return tuple(key[0].shape) if isinstance(key[0], torch.Tensor) else ()


def _key_slice(key: Key, e0: int, e1: int) -> Key:
    """Members ``e0:e1`` of an ensemble key."""
    return key[0][e0:e1], key[1][e0:e1]


def _bits_flat(key: Key, start: int, count: int, device) -> torch.Tensor:
    c = torch.arange(start, start + count, dtype=torch.int64, device=device)
    if batch_shape(key):
        key = (key[0][..., None], key[1][..., None])  # [E, 1] against [count]
    b0, b1 = threefry2x32(key, c >> 32, c & M32)
    return b0 ^ b1


def random_bits(key: Key, shape: tuple[int, ...], device, rows=None) -> torch.Tensor:
    """32 random bits per cell (int64, unsigned value) of a draw of ``shape``,
    with the key's ensemble axis in front.

    ``rows=(r0, r1)`` returns only rows ``r0:r1`` of the draw (the cells
    ``r0:r1`` of a 1-D one) -- the same bits as slicing the whole draw."""
    if len(shape) == 1:
        r0, r1 = rows if rows is not None else (0, shape[0])
        return _bits_flat(key, r0, r1 - r0, device)
    n_rows, n_cols = shape
    r0, r1 = rows if rows is not None else (0, n_rows)
    flat = _bits_flat(key, r0 * n_cols, (r1 - r0) * n_cols, device)
    return flat.view(*flat.shape[:-1], r1 - r0, n_cols)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from 32 random bits (``random._uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def row_chunks(n_rows: int, n_cols: int):
    """``(r0, r1)`` row ranges of at most ``CHUNK_CELLS`` cells each."""
    step = max(1, CHUNK_CELLS // max(n_cols, 1))
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


def draw_chunks(key: Key, n_rows: int, n_cols: int, row0: int = 0):
    """Blocks of a 2-D draw of at most ``CHUNK_CELLS`` cells (one row chunk
    when the draw has more), as ``(key part, out index, (r0, r1))``: the
    block's draw is ``random_bits(key part, (n_rows, n_cols), dev, (r0,
    r1))`` and it lands at ``out[out index]`` of the ``batch + shape`` result.
    One mesh: row chunks. An ensemble: whole members while they fit, else
    row chunks of one member at a time.

    ``row0`` places the ``n_rows`` rows at rows ``row0 ..`` of a taller
    draw (a rank's rows of the dense draw): the yielded ``(r0, r1)`` are
    the rows of that draw, the out index stays local."""
    batch = batch_shape(key)
    if not batch:
        for r0, r1 in row_chunks(n_rows, n_cols):
            yield key, (slice(r0, r1),), (row0 + r0, row0 + r1)
        return
    (members,) = batch
    per_member = n_rows * n_cols
    if per_member >= CHUNK_CELLS:
        for e in range(members):
            for r0, r1 in row_chunks(n_rows, n_cols):
                yield (_key_slice(key, e, e + 1), (slice(e, e + 1), slice(r0, r1)),
                       (row0 + r0, row0 + r1))
        return
    step = CHUNK_CELLS // max(per_member, 1)
    for e0 in range(0, members, step):
        e1 = min(members, e0 + step)
        yield _key_slice(key, e0, e1), (slice(e0, e1),), (row0, row0 + n_rows)


def uniform(key: Key, shape: tuple[int, ...], device, row0: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float32)`` (under ``[E]`` keys,
    ``[E, *shape]``: each member's own draw), for a shape of any rank.

    A cell's counter is its flat (row-major) index, so a draw of rank 3 or
    more is the 2-D draw ``(shape[0], prod(shape[1:]))`` reshaped. ``row0``
    draws ``shape``'s rows as rows ``row0 ..`` of a taller draw (cells
    ``row0 ..`` of a 1-D one): a rank's slice of the dense draw."""
    if len(shape) > 2:
        flat = uniform(key, (shape[0], math.prod(shape[1:])), device, row0)
        return flat.view(*batch_shape(key), *shape)
    if len(shape) == 1:
        return bits_to_uniform(random_bits(key, shape, device, (row0, row0 + shape[0])))
    out = torch.empty(batch_shape(key) + tuple(shape), dtype=torch.float32, device=device)
    for part, at, rows in draw_chunks(key, *shape, row0=row0):
        out[at] = bits_to_uniform(random_bits(part, shape, device, rows))
    return out


def gumbel_order_bits(key: Key, shape: tuple[int, ...], device, rows=None) -> torch.Tensor:
    """The 23-bit integers that order ``jax.random.gumbel(key, shape)``.

    Equal integers are equal Gumbel draws (``lax.top_k`` then breaks the
    tie toward the lower index); a larger integer is a larger draw."""
    return random_bits(key, shape, device, rows) >> 9
