"""ctypes bindings for the native C++ engine (native/src, libkaboodle_native.so).

The shared library is built on demand with ``make`` on first use (g++ is part
of the environment; no Python build deps). All strings cross the boundary as
UTF-8; peer/event snapshots cross as JSON with hex-encoded identities.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess

from kaboodle_tpu_torch.errors import IoError, NoAvailableInterfaces

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libkaboodle_native.so"

_lib = None


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    # Always invoke make: its dependency rules make this a no-op when the
    # library is current, and pick up native/src edits when it is not. A
    # build failure is fatal unless the existing library is newer than every
    # source (i.e. the failure cannot mean "stale code would load").
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        out = getattr(e, "stderr", b"") or b""
        stale = not _LIB_PATH.exists() or any(
            src.stat().st_mtime > _LIB_PATH.stat().st_mtime
            for src in (_NATIVE_DIR / "src").glob("*")
        )
        if stale:
            raise IoError(f"native build failed: {out.decode(errors='replace')}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))

    lib.kb_create.restype = ctypes.c_void_p
    lib.kb_create.argtypes = [
        ctypes.c_char_p,  # bind_ip
        ctypes.c_char_p,  # broadcast_ip
        ctypes.c_uint16,  # broadcast_port
        ctypes.c_uint,  # iface_index
        ctypes.c_char_p,  # identity
        ctypes.c_size_t,
        ctypes.c_uint32,  # period_ms
        ctypes.c_uint32,  # ping_timeout_ms
        ctypes.c_uint32,  # share_age_ms
        ctypes.c_uint32,  # rebroadcast_ms
        ctypes.c_uint64,  # rng_seed
    ]
    for name in ("kb_start", "kb_stop", "kb_is_running"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.kb_destroy.restype = None
    lib.kb_destroy.argtypes = [ctypes.c_void_p]
    for name in ("kb_self_addr", "kb_peers_json", "kb_events_json"):
        getattr(lib, name).restype = ctypes.c_void_p  # manual free
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.kb_fingerprint.restype = ctypes.c_uint32
    lib.kb_fingerprint.argtypes = [ctypes.c_void_p]
    lib.kb_ping_addr.restype = ctypes.c_int
    lib.kb_ping_addr.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.kb_set_identity.restype = ctypes.c_int
    lib.kb_set_identity.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.kb_probe.restype = ctypes.c_void_p
    lib.kb_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint16,
        ctypes.c_uint,
        ctypes.c_uint32,
        ctypes.c_double,
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.kb_best_interface.restype = ctypes.c_void_p
    lib.kb_best_interface.argtypes = []
    lib.kb_list_interfaces.restype = ctypes.c_void_p
    lib.kb_list_interfaces.argtypes = []
    lib.kb_free.restype = None
    lib.kb_free.argtypes = [ctypes.c_void_p]
    lib.kb_codec_roundtrip_envelope.restype = ctypes.c_long
    lib.kb_codec_roundtrip_envelope.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    lib.kb_codec_roundtrip_broadcast.restype = ctypes.c_long
    lib.kb_codec_roundtrip_broadcast.argtypes = lib.kb_codec_roundtrip_envelope.argtypes
    lib.kb_crc32.restype = ctypes.c_uint32
    lib.kb_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    _lib = lib
    return lib


def _take_string(lib, ptr) -> str:
    if not ptr:
        return ""
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        lib.kb_free(ptr)


def best_interface() -> tuple[str, int]:
    """Reference policy (networking.rs:12-23): first non-loopback IPv6
    interface, else IPv4. Returns (ip, ifindex)."""
    lib = load_library()
    s = _take_string(lib, lib.kb_best_interface())
    if not s:
        raise NoAvailableInterfaces("no non-loopback interface")
    ip, idx = s.rsplit(",", 1)
    return ip, int(idx)


def list_interfaces() -> list[dict]:
    """All non-loopback addresses: {family: 4|6, ip, ifindex, broadcast, name}.

    ``name`` is the OS device name (``eth0``), so ``--interface`` can resolve
    by name like the reference (main.rs:18-36)."""
    lib = load_library()
    out = []
    for line in _take_string(lib, lib.kb_list_interfaces()).splitlines():
        fam, ip, idx, bcast, name = (line.split(",") + [""])[:5]
        out.append(
            {"family": int(fam), "ip": ip, "ifindex": int(idx),
             "broadcast": bcast, "name": name}
        )
    return out


class NativeEngine:
    """Thin OO wrapper over the C API. Timing is injectable so tests can run
    the full protocol at millisecond scale (defaults match the reference)."""

    def __init__(
        self,
        bind_ip: str,
        broadcast_ip: str,
        broadcast_port: int = 7475,
        iface_index: int = 0,
        identity: bytes = b"",
        period_ms: int = 1000,
        ping_timeout_ms: int = 2000,
        share_age_ms: int = 10000,
        rebroadcast_ms: int = 10000,
        rng_seed: int = 0,
    ):
        self._lib = load_library()
        self._h = self._lib.kb_create(
            bind_ip.encode(),
            broadcast_ip.encode(),
            broadcast_port,
            iface_index,
            identity,
            len(identity),
            period_ms,
            ping_timeout_ms,
            share_age_ms,
            rebroadcast_ms,
            rng_seed,
        )
        if not self._h:
            raise IoError(f"kb_create failed for {bind_ip} / {broadcast_ip}")

    def start(self) -> None:
        if self._lib.kb_start(self._h) != 0:
            raise IoError("engine start failed (bind/socket error)")

    def stop(self) -> None:
        self._lib.kb_stop(self._h)

    @property
    def is_running(self) -> bool:
        return bool(self._lib.kb_is_running(self._h))

    def self_addr(self) -> str:
        return _take_string(self._lib, self._lib.kb_self_addr(self._h))

    def fingerprint(self) -> int:
        return int(self._lib.kb_fingerprint(self._h))

    def peers(self) -> dict[str, dict]:
        raw = json.loads(_take_string(self._lib, self._lib.kb_peers_json(self._h)))
        return {
            e["addr"]: {
                "identity": bytes.fromhex(e["identity_hex"]),
                "state": e["state"],
                "latency_ms": e["latency_ms"] if e["latency_ms"] >= 0 else None,
            }
            for e in raw
        }

    def drain_events(self) -> list[dict]:
        events = json.loads(_take_string(self._lib, self._lib.kb_events_json(self._h)))
        for e in events:
            if "identity_hex" in e:
                e["identity"] = bytes.fromhex(e.pop("identity_hex"))
        return events

    def ping_addr(self, addr: str) -> None:
        if self._lib.kb_ping_addr(self._h, addr.encode()) != 0:
            raise IoError(f"bad address {addr!r}")

    def set_identity(self, identity: bytes) -> None:
        self._lib.kb_set_identity(self._h, identity, len(identity))

    def close(self) -> None:
        if self._h:
            self._lib.kb_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def probe_mesh(
    bind_ip: str,
    broadcast_ip: str,
    broadcast_port: int = 7475,
    iface_index: int = 0,
    start_ms: int = 1000,
    multiplier: float = 1.25,
    cap_ms: int = 10000,
    total_timeout_ms: int = 30000,
) -> tuple[str, bytes] | None:
    """discover_mesh_member (discovery.rs:30-89): find one mesh member without
    joining. Returns (addr, identity) or None on timeout.
    ``total_timeout_ms=0`` retries forever with the 1 s x1.25 (cap 10 s)
    backoff, like the reference (discovery.rs:51-72)."""
    lib = load_library()
    s = _take_string(
        lib,
        lib.kb_probe(
            bind_ip.encode(),
            broadcast_ip.encode(),
            broadcast_port,
            iface_index,
            start_ms,
            multiplier,
            cap_ms,
            total_timeout_ms,
        ),
    )
    if not s:
        return None
    addr, _, ident_hex = s.partition("|")
    return addr, bytes.fromhex(ident_hex)


def codec_roundtrip_envelope(data: bytes) -> bytes | None:
    """Decode+re-encode through the C++ codec (cross-language golden tests)."""
    lib = load_library()
    out = ctypes.create_string_buffer(len(data) + 64)
    n = lib.kb_codec_roundtrip_envelope(data, len(data), out, len(out))
    return out.raw[:n] if n >= 0 else None


def codec_roundtrip_broadcast(data: bytes) -> bytes | None:
    lib = load_library()
    out = ctypes.create_string_buffer(len(data) + 64)
    n = lib.kb_codec_roundtrip_broadcast(data, len(data), out, len(out))
    return out.raw[:n] if n >= 0 else None


def native_crc32(data: bytes) -> int:
    lib = load_library()
    return int(lib.kb_crc32(data, len(data)))
