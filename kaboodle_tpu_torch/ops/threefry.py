"""Threefry-2x32 counter RNG, bit-exact with ``jax.random`` (threefry, partitionable).

What the JAX tick draws, reproduced bit for bit (jax 0.9.0 with
``jax_threefry_partitionable=True``):

- ``PRNGKey(seed)`` is the word pair ``(0, seed)`` (``prng.threefry_seed``);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))`` (``_threefry_fold_in``);
- 32 random bits at flat position ``c`` of a shape are ``b1 ^ b2`` with
  ``(b1, b2) = threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``
  (``_threefry_random_bits_partitionable`` over ``iota_2x32_shape``);
- a float32 uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1``
  (``random._uniform``), and the Gumbel draw (``random._gumbel``, mode
  "low") is ``-log(-log(max(u, tiny)))``: strictly increasing in ``u``, so
  an ORDER of Gumbel draws is the order of the 23 bits ``bits >> 9``.

Keys are pairs of Python ints (derived on the host: a key is two words).
Shaped draws run on the tensor's device in int64 holding unsigned 32-bit
values, row chunk by row chunk, so an ``[N, N]`` draw never needs more
than a few chunk-sized temporaries: the counter of a cell is its flat
index, so chunking changes no bit.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Cells per row chunk of a shaped draw (and of init_state's plane and the
# membership fingerprint): 2^22 cells keep each int64 temporary at 32 MiB.
CHUNK_CELLS = 1 << 22

Key = tuple[int, int]


def _rotl(x, r: int, scalar: bool):
    if scalar:
        return ((x << r) | (x >> (32 - r))) & M32
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words ``(x0, x1)`` under ``key``.

    ``x0``/``x1`` are Python ints or int64 tensors of unsigned 32-bit
    values; the result has the same kind."""
    scalar = isinstance(x0, int)
    k0, k1 = key[0] & M32, key[1] & M32
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


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return (0, seed & M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & M32)


def _bits_flat(key: Key, start: int, count: int, device) -> torch.Tensor:
    c = torch.arange(start, start + count, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, c >> 32, c & M32)
    return b0 ^ b1


def random_bits(key: Key, shape: tuple[int, ...], device, rows=None) -> torch.Tensor:
    """32 random bits per cell (int64, unsigned value) of a draw of ``shape``.

    ``rows=(r0, r1)`` returns only rows ``r0:r1`` of a 2-D draw -- the same
    bits as slicing the whole draw."""
    if len(shape) == 1:
        return _bits_flat(key, 0, shape[0], device)
    n_rows, n_cols = shape
    r0, r1 = rows if rows is not None else (0, n_rows)
    return _bits_flat(key, r0 * n_cols, (r1 - r0) * n_cols, device).view(r1 - r0, n_cols)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from 32 random bits (``random._uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def row_chunks(n_rows: int, n_cols: int):
    """``(r0, r1)`` row ranges of at most ``CHUNK_CELLS`` cells each."""
    step = max(1, CHUNK_CELLS // max(n_cols, 1))
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


def uniform(key: Key, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float32)``."""
    if len(shape) == 1:
        return bits_to_uniform(random_bits(key, shape, device))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    for r0, r1 in row_chunks(*shape):
        out[r0:r1] = bits_to_uniform(random_bits(key, shape, device, (r0, r1)))
    return out


def gumbel_order_bits(key: Key, shape: tuple[int, ...], device, rows=None) -> torch.Tensor:
    """The 23-bit integers that order ``jax.random.gumbel(key, shape)``.

    Equal integers are equal Gumbel draws (``lax.top_k`` then breaks the
    tie toward the lower index); a larger integer is a larger draw."""
    return random_bits(key, shape, device, rows) >> 9
