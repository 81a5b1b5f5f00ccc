"""Vectorized CRC-32 (IEEE, reflected poly 0xEDB88320) over byte rows.

The reference fingerprints its membership map with ``crc32fast``
(kaboodle.rs:71-83): peers sorted by address, then for each peer the CRC is
updated with the address bytes and the identity bytes. ``crc32fast``
computes standard CRC-32 (Python's ``zlib.crc32``), so ``zlib`` is the
test oracle here.

The byte-wise update ``s' = (s >> 8) ^ LUT[(s ^ byte) & 0xFF]`` is
sequential along the byte axis and parallel across rows: data lies as
``[rows, bytes]`` and a Python loop walks the bytes, one table gather per
step. CRC registers are int64 tensors holding the unsigned 32-bit value
(0..2^32-1), so results compare with ``zlib`` directly.
:func:`membership_crc32` folds a masked, variable-length record sequence
and walks the peer axis: O(N) steps, a parity and wire-interop function,
not on the tick's path (the tick's convergence hash is the commutative
mix-hash of ``ops/hashing.py``). Plain PyTorch; no kernel.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.ops.hashing import as_u32

_POLY = 0xEDB88320


def _make_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table.append(c)
    return table


# The 256 table words as Python ints; a tensor is made on the data's device.
CRC_TABLE = _make_table()


def crc32_update_bytes(state: torch.Tensor, data: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Fold ``data`` bytes into running CRC registers, vectorized across rows.

    ``state`` int64 ``[...]``: the raw (pre-inverted) register values.
    ``data`` ``[..., K]`` bytes (uint8 or any integer dtype holding 0..255),
    row-aligned with ``state``. ``mask`` optional bool ``[..., K]``: False
    bytes are skipped. Returns the int64 ``[...]`` updated registers."""
    table = torch.tensor(CRC_TABLE, dtype=torch.int64, device=data.device)
    data = data.to(torch.int64)
    s = state.to(torch.int64)
    for b in range(data.shape[-1]):
        new = (s >> 8) ^ table[(s ^ data[..., b]) & 0xFF]
        s = new if mask is None else torch.where(mask[..., b], new, s)
    return s


def crc32(data: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32 of each row of ``data`` (``[..., K]`` bytes) -> int64 ``[...]``.

    Equals ``zlib.crc32`` of each row's unmasked bytes."""
    init = torch.full(data.shape[:-1], 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    return crc32_update_bytes(init, data, mask) ^ 0xFFFFFFFF


def record_bytes(peer_ids: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    """The simulator's fixed-width CRC record for each peer: uint8 ``[N, 8]``.

    Big-endian uint32 peer index, then big-endian uint32 identity word (the
    reference hashes the address string + identity bytes, kaboodle.rs:77-79;
    simulated peers are dense indices). ``identities`` may be the port's
    int32-bit words or unsigned values in a wider dtype."""
    pid = as_u32(peer_ids)
    idn = as_u32(identities)

    def be_bytes(x):
        return torch.stack([(x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF],
                           dim=-1)

    return torch.cat([be_bytes(pid), be_bytes(idn)], dim=-1).to(torch.uint8)


def membership_crc32(member: torch.Tensor, identities: torch.Tensor) -> torch.Tensor:
    """Order-sensitive CRC-32 fingerprint of each row of the bool ``[N, N]``
    membership: ``crc32`` of the concatenated ``record_bytes(j, identities[j])``
    over the members j of the row, ascending (the sim-canonical analogue of
    ``generate_fingerprint``, kaboodle.rs:71-83). Walks the peer axis, so
    O(N) steps; returns int64 ``[N]`` unsigned values."""
    n = member.shape[-1]
    recs = record_bytes(torch.arange(n, device=member.device, dtype=torch.int64), identities)  # [N, 8]
    s = torch.full((member.shape[0],), 0xFFFFFFFF, dtype=torch.int64, device=member.device)
    for j in range(n):
        mask = member[:, j, None].expand(-1, 8)
        s = crc32_update_bytes(s, recs[j].expand(member.shape[0], 8), mask)
    return s ^ 0xFFFFFFFF
