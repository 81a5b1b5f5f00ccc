"""Threefry-2x32 counter draws of the SWIM tick, in plain PyTorch.

A frozen, independent statement of the draws the simulated protocol makes
(``jax.random`` threefry, partitionable layout), so the benchmark's
reference does not move when the program's RNG is rewritten:

- ``prng_key(seed)`` is the word pair ``(0, seed)``; ``fold_in(key, d)`` is
  ``threefry2x32(key, (0, d))``;
- the 32 random bits at flat position ``c`` of a draw are ``b1 ^ b2`` with
  ``(b1, b2) = threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``;
- a uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1`` in float32, and a
  Gumbel order is the order of ``bits >> 9``.

Keys are pairs of Python ints here (the reference reads the carried key and
the tick on the host). Shaped draws run in int64 holding unsigned 32-bit
values, in row chunks of at most ``CHUNK_CELLS`` cells. ``fdt`` is the float
type a uniform is handed on in: float32 as the configuration states, or a
lower precision for the benchmark's control.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK_CELLS = 1 << 22

# Stream ids of the dense tick's four draws.
STREAM_TICK_PROXY = 6
STREAM_TICK_PING = 7
STREAM_TICK_BERN = 8
STREAM_TICK_DROP = 9


def _rotl(x, r: int, scalar: bool):
    if scalar:
        return ((x << r) | (x >> (32 - r))) & M32
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds, of counter words ``(x0, x1)`` under ``key``
    (ints, or int64 tensors of unsigned 32-bit values)."""
    scalar = not any(isinstance(v, torch.Tensor) for v in (x0, x1))
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


def prng_key(seed: int):
    return (0, seed & M32)


def fold_in(key, data: int):
    return threefry2x32(key, 0, data & M32)


def tick_draw_keys(key, tick: int):
    """The dense tick's ``(proxy, ping, bern, drop)`` keys for the carried
    word pair ``key`` at ``tick``."""
    base = fold_in(prng_key(key[0] ^ key[1]), tick)
    return tuple(fold_in(base, s) for s in
                 (STREAM_TICK_PROXY, STREAM_TICK_PING, STREAM_TICK_BERN, STREAM_TICK_DROP))


def random_bits(key, shape, device, rows=None) -> torch.Tensor:
    """32 random bits (int64) per cell of a 1-D or 2-D draw; ``rows=(r0, r1)``
    gives only those rows (cells of a 1-D draw)."""
    n_cols = 1 if len(shape) == 1 else shape[1]
    r0, r1 = rows if rows is not None else (0, shape[0])
    c = torch.arange(r0 * n_cols, r1 * n_cols, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, c >> 32, c & M32)
    bits = b0 ^ b1
    return bits if len(shape) == 1 else bits.view(r1 - r0, n_cols)


def bits_to_uniform(bits: torch.Tensor, fdt=torch.float32) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(fdt)


def row_chunks(n_rows: int, n_cols: int):
    step = max(1, CHUNK_CELLS // max(n_cols, 1))
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


def uniform(key, shape, device, fdt=torch.float32) -> torch.Tensor:
    """A uniform draw of a 1-D or 2-D ``shape``, handed on in ``fdt``."""
    if len(shape) == 1:
        return bits_to_uniform(random_bits(key, shape, device), fdt)
    out = torch.empty(tuple(shape), dtype=fdt, device=device)
    for r0, r1 in row_chunks(*shape):
        out[r0:r1] = bits_to_uniform(random_bits(key, shape, device, (r0, r1)), fdt)
    return out


def gumbel_order_bits(key, shape, device, rows=None) -> torch.Tensor:
    return random_bits(key, shape, device, rows) >> 9
