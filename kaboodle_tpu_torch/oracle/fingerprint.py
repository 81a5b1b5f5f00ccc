"""Host-side fingerprint functions matching the two on-device variants.

- :func:`mix_fingerprint` — the production commutative hash; bit-exact with
  ``kaboodle_tpu_torch.ops.hashing.membership_fingerprint`` (tested in
  tests/test_torch_api.py).
- :func:`crc_fingerprint` — the reference's exact CRC-32 semantics
  (kaboodle.rs:71-83): peers sorted, CRC over address-string bytes + identity
  bytes, for wire interop with actual kaboodle instances; ``addr_bytes``
  controls the address encoding (string form for real sockets, fixed-width
  records for the simulator's index space).

The port's own copy of the JAX package's module (it imports nothing of it).
"""

from __future__ import annotations

import zlib
from typing import Callable, Mapping

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF


def mix32_py(x: int) -> int:
    """splitmix32 finalizer; bit-exact with ops.hashing.mix32."""
    x &= _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 15
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


def peer_record_hash_py(peer_id: int, identity: int) -> int:
    """Bit-exact with ops.hashing.peer_record_hash."""
    return mix32_py(mix32_py((peer_id ^ 0x9E3779B9) & _MASK) ^ (identity & _MASK))


def mix_fingerprint(members: Mapping[int, int]) -> int:
    """Commutative fingerprint over {peer_id: identity_word} (mod 2^32)."""
    total = 0
    for pid, idn in members.items():
        total = (total + peer_record_hash_py(pid, idn)) & _MASK
    return total


def default_addr_bytes(addr) -> bytes:
    """Address encoding for CRC fingerprints.

    Integers (simulated peers) use the sim-canonical 4-byte big-endian record
    prefix (see ops.crc32.record_bytes); anything else is stringified like the
    reference's ``peer.to_string()`` (kaboodle.rs:78).
    """
    if isinstance(addr, int):
        return addr.to_bytes(4, "big")
    return str(addr).encode()


def socket_addr_sort_key(addr: object):
    """Rust ``SocketAddr`` ``Ord`` order (the sort of kaboodle.rs:72-73):
    V4 variants before V6, then IP numerically (big-endian octets), then port.
    Integers (simulated peers) sort first, numerically; unparseable addresses
    fall back to their string form, after all real sockets."""
    if isinstance(addr, int):
        return (0, 0, b"", addr)
    s = str(addr)
    try:
        import ipaddress

        if s.startswith("["):  # "[v6]:port"
            host, port = s[1:].rsplit("]:", 1)
        else:
            host, port = s.rsplit(":", 1)
        ip = ipaddress.ip_address(host)
        return (1, ip.version, ip.packed, int(port))
    except ValueError:
        return (2, 0, s.encode(), 0)


def crc_fingerprint(
    members: Mapping[object, bytes],
    addr_bytes: Callable[[object], bytes] = default_addr_bytes,
) -> int:
    """Reference-exact fingerprint: CRC-32 over sorted (addr, identity) records.

    ``members`` maps address -> identity bytes. Sorting matches Rust's
    ``SocketAddr`` ordering (the reference sorts SocketAddrs, kaboodle.rs:72-73)
    — numeric IP order, not lexicographic strings.
    """
    crc = 0
    for addr in sorted(members.keys(), key=socket_addr_sort_key):
        crc = zlib.crc32(addr_bytes(addr), crc)
        ident = members[addr]
        if isinstance(ident, int):
            ident = ident.to_bytes(4, "big")
        crc = zlib.crc32(ident, crc)
    return crc
