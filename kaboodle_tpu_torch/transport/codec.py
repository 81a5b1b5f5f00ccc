"""Pure-Python bincode-compatible codec for the kaboodle wire format.

Byte-compatible with the reference's ``bincode::serialize`` of the structs in
src/structs.rs (bincode 1.3 legacy config: little-endian fixed-width ints,
u64 sequence/byte lengths, u32 enum variant tags; serde's binary SocketAddr
encoding: enum{V4=0,V6=1} tag + raw octets + u16 port) — and with the C++
codec in native/src/wire.cc, which tests cross-check byte-for-byte.

Addresses are strings in Rust ``SocketAddr`` Display form ("1.2.3.4:56",
"[::1]:56"). Messages are plain dicts with a "kind" field naming the
:class:`kaboodle_tpu_torch.spec.UnicastKind` / ``BroadcastKind`` variant.

Decoders parse a *prefix* and tolerate trailing bytes (quirk Q2 — the
reference deserializes the whole zero-padded receive buffer, and probe
replies rely on it, Q4).
"""

from __future__ import annotations

import ipaddress
import struct

from kaboodle_tpu_torch.spec import BroadcastKind, UnicastKind


class CodecError(ValueError):
    pass


# --- address <-> bytes ----------------------------------------------------


def _encode_addr(addr: str) -> bytes:
    try:
        if addr.startswith("["):
            host, sep, port = addr[1:].rpartition("]:")
            if not sep:
                raise ValueError("missing ]:port")
            ip6 = ipaddress.IPv6Address(host)
            return struct.pack("<I", 1) + ip6.packed + struct.pack("<H", int(port))
        host, sep, port = addr.rpartition(":")
        if not sep:
            raise ValueError("missing :port")
        ip4 = ipaddress.IPv4Address(host)
        return struct.pack("<I", 0) + ip4.packed + struct.pack("<H", int(port))
    except (ValueError, struct.error) as e:
        # Module contract: all malformed input surfaces as CodecError.
        raise CodecError(f"bad address {addr!r}: {e}") from None


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise CodecError("truncated")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def bytes_(self) -> bytes:
        return self.take(self.u64())

    def addr(self) -> str:
        tag = self.u32()
        if tag == 0:
            ip = ipaddress.IPv4Address(self.take(4))
            return f"{ip}:{self.u16()}"
        if tag == 1:
            ip = ipaddress.IPv6Address(self.take(16))
            return f"[{ip}]:{self.u16()}"
        raise CodecError(f"bad SocketAddr variant {tag}")


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _bytes(b: bytes) -> bytes:
    return _u64(len(b)) + b


# --- unicast envelope -----------------------------------------------------


def encode_message(msg: dict) -> bytes:
    kind = UnicastKind[msg["kind"]] if isinstance(msg["kind"], str) else msg["kind"]
    out = _u32(int(kind))
    if kind == UnicastKind.PING:
        pass
    elif kind == UnicastKind.PING_REQUEST:
        out += _encode_addr(msg["peer"])
    elif kind == UnicastKind.ACK:
        out += _encode_addr(msg["peer"]) + _u32(msg["fingerprint"]) + _u32(msg["num_peers"])
    elif kind == UnicastKind.KNOWN_PEERS:
        peers: dict[str, bytes] = msg["peers"]
        out += _u64(len(peers))
        for addr, ident in peers.items():
            out += _encode_addr(addr) + _bytes(ident)
    elif kind == UnicastKind.KNOWN_PEERS_REQUEST:
        out += _u32(msg["fingerprint"]) + _u32(msg["num_peers"])
    else:
        raise CodecError(f"bad kind {kind}")
    return out


def encode_envelope(identity: bytes, msg: dict) -> bytes:
    return _bytes(identity) + encode_message(msg)


def decode_envelope(data: bytes) -> tuple[bytes, dict]:
    r = _Reader(data)
    identity = r.bytes_()
    tag = r.u32()
    if tag > 4:
        raise CodecError(f"bad SwimMessage variant {tag}")
    kind = UnicastKind(tag)
    msg: dict = {"kind": kind.name}
    if kind == UnicastKind.PING_REQUEST:
        msg["peer"] = r.addr()
    elif kind == UnicastKind.ACK:
        msg["peer"] = r.addr()
        msg["fingerprint"] = r.u32()
        msg["num_peers"] = r.u32()
    elif kind == UnicastKind.KNOWN_PEERS:
        msg["peers"] = {r.addr(): r.bytes_() for _ in range(r.u64())}
    elif kind == UnicastKind.KNOWN_PEERS_REQUEST:
        msg["fingerprint"] = r.u32()
        msg["num_peers"] = r.u32()
    return identity, msg


# --- broadcasts -----------------------------------------------------------


def encode_broadcast(msg: dict) -> bytes:
    kind = BroadcastKind[msg["kind"]] if isinstance(msg["kind"], str) else msg["kind"]
    out = _u32(int(kind)) + _encode_addr(msg["addr"])
    if kind == BroadcastKind.JOIN:
        out += _bytes(msg["identity"])
    return out


def decode_broadcast(data: bytes) -> dict:
    r = _Reader(data)
    tag = r.u32()
    if tag > 2:
        raise CodecError(f"bad SwimBroadcast variant {tag}")
    kind = BroadcastKind(tag)
    msg = {"kind": kind.name, "addr": r.addr()}
    if kind == BroadcastKind.JOIN:
        msg["identity"] = r.bytes_()
    return msg


def encode_probe_response(identity: bytes) -> bytes:
    return _bytes(identity)
