"""Commutative membership fingerprint: the convergence hash, on 32-bit words.

    fingerprint[i] = sum_{j : member[i,j]} mix32(mix32(j ^ 0x9E3779B9) ^ id[j])  (mod 2^32)

PyTorch has no usable unsigned 32-bit arithmetic (``torch.uint32`` lacks
``add``, ``>>`` and ``sum`` on the CPU), so every uint32 quantity of the
port -- identities, identity views, fingerprints, PRNG keys -- is carried
as an ``int32`` tensor holding the same 32 bits. Arithmetic on them runs
here in ``int64`` on the unsigned value (``as_u32``) and is folded back to
the int32 bit pattern by ``wrap32``. Sums mod 2^32 do not depend on the
order of the terms, so any reduction tree gives the same bits.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.ops.threefry import row_chunks

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value (int64, 0..2^32-1) of a 32-bit word tensor."""
    return x.to(torch.int64) & MASK32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 tensor holding ``x mod 2^32`` as a bit pattern."""
    y = x & MASK32
    return (y - ((y >> 31) << 32)).to(torch.int32)


def u32_to_i32(v: int) -> int:
    """A Python uint32 value as the int32 with the same bits."""
    v &= MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for unsigned int64 ``x``, with no int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32_u(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer; bijective on 32-bit words. Returns int32 bits."""
    return wrap32(_mix32_u(as_u32(x)))


def peer_record_hash(peer_ids: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    """32-bit hash of (peer id, identity) records, broadcasting. int32 bits."""
    h = _mix32_u(as_u32(peer_ids) ^ GOLDEN)
    return wrap32(_mix32_u(h ^ as_u32(identities)))


def wrap_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of 32-bit words mod 2^32 along ``dim``. int32 bits."""
    return wrap32(x.sum(dim=dim, dtype=torch.int64))


def membership_fingerprint(member: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    """Commutative fingerprint of each row of the bool ``[..., N, N]`` membership.

    ``identities`` is the global ``[..., N]`` identity word per peer (one
    vector per mesh) or the ``[..., N, N]`` per-row identity views. Returns
    int32 bits ``[..., N]``.
    """
    *batch, n_rows, n = member.shape
    pid = torch.arange(n, dtype=torch.int64, device=member.device)
    zero = torch.zeros((), dtype=torch.int32, device=member.device)
    rows = member.reshape(-1, n)
    views = identities.shape == member.shape
    if views:
        ids = identities.reshape(-1, n)
    else:  # one hash vector per mesh, [meshes, N]
        h_mesh = peer_record_hash(pid, identities).reshape(-1, n)
    # In row chunks (of all meshes' rows): the hashes and their int64 sums
    # never take [N, N].
    out = torch.empty((rows.shape[0],), dtype=torch.int32, device=member.device)
    for r0, r1 in row_chunks(rows.shape[0], n):
        if views:
            h = peer_record_hash(pid[None, :], ids[r0:r1])
        elif h_mesh.shape[0] == 1:
            h = h_mesh
        else:
            mesh = torch.arange(r0, r1, device=member.device, dtype=torch.int64) // n_rows
            h = h_mesh[mesh]
        out[r0:r1] = wrap_sum(torch.where(rows[r0:r1], h, zero))
    return out.view(*batch, n_rows)


def fingerprint_agreement(alive: torch.Tensor, fp: torch.Tensor):
    """Fingerprint agreement over the alive rows of each mesh (``[..., N]``).

    The minimum and maximum are taken over the UNSIGNED values, as the
    reference does on uint32. Returns ``(converged bool, fp_min int32 bits,
    fp_max int32 bits, n_alive int32)``, each of the leading shape (``[]``
    for one mesh, ``[E]`` for an ensemble).
    """
    u = as_u32(fp)
    fp_min = torch.where(alive, u, MASK32).amin(dim=-1)
    fp_max = torch.where(alive, u, 0).amax(dim=-1)
    n_alive = alive.sum(dim=-1, dtype=torch.int32)
    converged = (fp_min == fp_max) & (n_alive > 0)
    return converged, wrap32(fp_min), wrap32(fp_max), n_alive
