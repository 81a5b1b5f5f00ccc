"""The membership fingerprint on 32-bit words, in plain PyTorch.

    fingerprint[i] = sum_{j : member[i, j]} mix32(mix32(j ^ 0x9E3779B9) ^ id[j])  (mod 2^32)

uint32 words (identities, views, fingerprints, keys) are int32 tensors that
hold the same bits; arithmetic on them runs in int64 on the unsigned value
and is folded back by ``wrap32``.
"""

from __future__ import annotations

import torch

from portbench.reference.rng import row_chunks

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def as_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    y = x & MASK32
    return (y - ((y >> 31) << 32)).to(torch.int32)


def u32_to_i32(v: int) -> int:
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32_u(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def peer_record_hash(peer_ids: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    h = _mix32_u(as_u32(peer_ids) ^ GOLDEN)
    return wrap32(_mix32_u(h ^ as_u32(identities)))


def wrap_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return wrap32(x.sum(dim=dim, dtype=torch.int64))


def row_fingerprints(member: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    """Fingerprint of each row of the bool ``[N, N]`` membership, against the
    ``[N]`` identities or the ``[N, N]`` identity views; in row chunks."""
    n_rows, n = member.shape
    pid = torch.arange(n, dtype=torch.int64, device=member.device)
    zero = torch.zeros((), dtype=torch.int32, device=member.device)
    views = identities.shape == member.shape
    h_all = None if views else peer_record_hash(pid, identities)
    out = torch.empty((n_rows,), dtype=torch.int32, device=member.device)
    for r0, r1 in row_chunks(n_rows, n):
        h = peer_record_hash(pid[None, :], identities[r0:r1]) if views else h_all
        out[r0:r1] = wrap_sum(torch.where(member[r0:r1], h, zero))
    return out


def fingerprint_agreement(alive: torch.Tensor, fp: torch.Tensor):
    """``(converged, fp_min, fp_max, n_alive)`` over the alive rows, the
    minimum and maximum taken on the unsigned values."""
    u = as_u32(fp)
    fp_min = torch.where(alive, u, MASK32).amin(dim=-1)
    fp_max = torch.where(alive, u, 0).amax(dim=-1)
    n_alive = alive.sum(dim=-1, dtype=torch.int32)
    converged = (fp_min == fp_max) & (n_alive > 0)
    return converged, wrap32(fp_min), wrap32(fp_max), n_alive
