"""The port's real-network transport, through the cases of tests/test_transport.py.

The port's codec, ctypes bindings and engine wrapper (``kaboodle_tpu_torch.
transport``) over the same native library (``native/``, built by ``make``
on first use): the golden wire vectors, the Python round trip, prefix
tolerance, the C++ codec's cross-language round trip, the native CRC-32,
the port's codec against the JAX package's, and the live interface cases,
which skip where the JAX package's skip (the same ``iface4`` fixture).
"""

import itertools
import socket
import time
import zlib

import pytest

from kaboodle_tpu.transport import codec as jax_codec
from kaboodle_tpu_torch.oracle.fingerprint import crc_fingerprint
from kaboodle_tpu_torch.transport import codec
from kaboodle_tpu_torch.transport.native import (
    NativeEngine,
    codec_roundtrip_broadcast,
    codec_roundtrip_envelope,
    list_interfaces,
    native_crc32,
    probe_mesh,
)

# A port range of its own: the JAX transport tests may run at the same time.
_PORTS = itertools.count(17700)
_FAST = dict(period_ms=50, ping_timeout_ms=100, share_age_ms=500, rebroadcast_ms=500)


@pytest.fixture(scope="module")
def iface4():
    for i in list_interfaces():
        if i["family"] == 4 and i["broadcast"]:
            return i
    pytest.skip("no broadcast-capable IPv4 interface")


def _mesh(iface4, n, port, **overrides):
    kw = {**_FAST, **overrides}
    engines = [
        NativeEngine(
            iface4["ip"],
            iface4["broadcast"],
            port,
            identity=f"pane-{i}".encode(),
            rng_seed=i + 1,
            **kw,
        )
        for i in range(n)
    ]
    for e in engines:
        e.start()
    return engines


def _wait(pred, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --- golden wire vectors ---------------------------------------------------


def test_codec_golden_vectors():
    # SwimEnvelope{identity: b"ab", msg: Ping}
    assert codec.encode_envelope(b"ab", {"kind": "PING"}).hex() == (
        "0200000000000000" + "6162" + "00000000"
    )
    # Ack{peer: 1.2.3.4:5, fp: 0xDEADBEEF, n: 7} in envelope with empty identity
    assert codec.encode_envelope(
        b"", {"kind": "ACK", "peer": "1.2.3.4:5", "fingerprint": 0xDEADBEEF, "num_peers": 7}
    ).hex() == (
        "0000000000000000"  # identity len 0
        + "02000000"  # variant Ack
        + "00000000" + "01020304" + "0500"  # SocketAddr::V4(1.2.3.4:5)
        + "efbeadde" + "07000000"
    )
    # SwimBroadcast::Join{addr: [::1]:9, identity: b"x"}
    assert codec.encode_broadcast(
        {"kind": "JOIN", "addr": "[::1]:9", "identity": b"x"}
    ).hex() == (
        "00000000" + "01000000" + "00" * 15 + "01" + "0900" + "0100000000000000" + "78"
    )
    # SwimBroadcast::Probe(192.0.2.2:17475)
    assert codec.encode_broadcast({"kind": "PROBE", "addr": "192.0.2.2:17475"}).hex() == (
        "02000000" + "00000000" + "c0000202" + "43" + "44"
    )


def test_codec_python_roundtrip():
    msgs = [
        {"kind": "PING"},
        {"kind": "PING_REQUEST", "peer": "10.0.0.1:9999"},
        {"kind": "ACK", "peer": "[fe80::1]:2", "fingerprint": 1, "num_peers": 2},
        {"kind": "KNOWN_PEERS", "peers": {"1.1.1.1:1": b"a", "[::2]:3": b"bb"}},
        {"kind": "KNOWN_PEERS_REQUEST", "fingerprint": 42, "num_peers": 3},
    ]
    for m in msgs:
        ident, back = codec.decode_envelope(codec.encode_envelope(b"idy", m))
        assert ident == b"idy" and back == m
    for b in [
        {"kind": "JOIN", "addr": "4.3.2.1:8", "identity": b"q"},
        {"kind": "FAILED", "addr": "4.3.2.1:8"},
        {"kind": "PROBE", "addr": "[fd00::2]:1"},
    ]:
        assert codec.decode_broadcast(codec.encode_broadcast(b)) == b


def test_codec_prefix_tolerance_q2_q4():
    """Q2: decoders read a prefix of the zero-padded buffer; Q4: a raw
    ProbeResponse + zero tail parses as an envelope carrying Ping."""
    wire = codec.encode_envelope(b"id", {"kind": "PING"}) + b"\x00" * 100
    assert codec.decode_envelope(wire) == (b"id", {"kind": "PING"})
    probe_reply = codec.encode_probe_response(b"who-am-i") + b"\x00" * 64
    ident, msg = codec.decode_envelope(probe_reply)
    assert ident == b"who-am-i" and msg == {"kind": "PING"}


def test_codec_cross_language():
    """The C++ codec decodes and re-encodes Python-encoded bytes unchanged."""
    env = codec.encode_envelope(
        b"xyz",
        {"kind": "KNOWN_PEERS", "peers": {"1.2.3.4:5": b"a", "[::1]:2": b"bb"}},
    )
    # NB: C++ re-encodes maps in address-sorted order; v4 sorts before v6 and
    # the Python dict above is already in that order.
    assert codec_roundtrip_envelope(env) == env
    bc = codec.encode_broadcast(
        {"kind": "JOIN", "addr": "[fd00::2]:777", "identity": b"node"}
    )
    assert codec_roundtrip_broadcast(bc) == bc
    assert codec_roundtrip_broadcast(b"\xff\xff\xff\xff") is None


def test_codec_matches_the_jax_codec():
    """Both packages' codecs give the same bytes and decode each other's."""
    from kaboodle_tpu.spec import BroadcastKind as JaxBroadcastKind
    from kaboodle_tpu.spec import UnicastKind as JaxUnicastKind
    from kaboodle_tpu_torch.spec import BroadcastKind, UnicastKind

    assert [(k.name, int(k)) for k in UnicastKind] == [(k.name, int(k)) for k in JaxUnicastKind]
    assert ([(k.name, int(k)) for k in BroadcastKind]
            == [(k.name, int(k)) for k in JaxBroadcastKind])
    msgs = [
        {"kind": "PING"},
        {"kind": "PING_REQUEST", "peer": "10.0.0.1:9999"},
        {"kind": "ACK", "peer": "[fe80::1]:2", "fingerprint": 0xFFFFFFFF, "num_peers": 2},
        {"kind": "KNOWN_PEERS", "peers": {"1.1.1.1:1": b"a", "[::2]:3": b"bb"}},
        {"kind": "KNOWN_PEERS_REQUEST", "fingerprint": 42, "num_peers": 3},
    ]
    for m in msgs:
        wire = codec.encode_envelope(b"idy", m)
        assert wire == jax_codec.encode_envelope(b"idy", m)
        assert jax_codec.decode_envelope(wire) == codec.decode_envelope(wire)
    for b in [
        {"kind": "JOIN", "addr": "4.3.2.1:8", "identity": b"q"},
        {"kind": "FAILED", "addr": "4.3.2.1:8"},
        {"kind": "PROBE", "addr": "[fd00::2]:1"},
    ]:
        wire = codec.encode_broadcast(b)
        assert wire == jax_codec.encode_broadcast(b)
        assert jax_codec.decode_broadcast(wire) == codec.decode_broadcast(wire)
    for bad in (b"", b"\x05\x00\x00\x00", b"\x00" * 8 + b"\x09\x00\x00\x00"):
        with pytest.raises(codec.CodecError):
            codec.decode_envelope(bad)
    with pytest.raises(codec.CodecError):
        codec.encode_envelope(b"", {"kind": "PING_REQUEST", "peer": "no-port"})


def test_native_library_is_the_shared_one():
    """The port loads the library ``native/`` builds, at the JAX package's path."""
    from kaboodle_tpu.transport import native as jax_native
    from kaboodle_tpu_torch.transport import native

    assert native._LIB_PATH == jax_native._LIB_PATH
    assert native._LIB_PATH.parent.parent.name == "native"
    assert native.load_library() is native.load_library()


def test_native_crc32_matches_zlib():
    for data in [b"", b"a", b"hello kaboodle", bytes(range(256))]:
        assert native_crc32(data) == zlib.crc32(data)


# --- live network tests ----------------------------------------------------


def test_4peer_demo_converges(iface4):
    """BASELINE config 1: the 2x2 demo — join, converge, matching CRC-32
    fingerprints, full peer maps with identities."""
    engines = _mesh(iface4, 4, next(_PORTS))
    try:
        assert _wait(
            lambda: len({e.fingerprint() for e in engines}) == 1
            and all(len(e.peers()) == 4 for e in engines)
        )
        # The fingerprint is reference-exact: recompute host-side from the
        # snapshot with the CRC/sort semantics of kaboodle.rs:71-83.
        snap = engines[0].peers()
        want = crc_fingerprint({a: e["identity"] for a, e in snap.items()})
        assert engines[0].fingerprint() == want
        idents = {e["identity"] for e in snap.values()}
        assert idents == {b"pane-0", b"pane-1", b"pane-2", b"pane-3"}
    finally:
        for e in engines:
            e.stop()
            e.close()


def test_departure_detection_and_events(iface4):
    engines = _mesh(iface4, 3, next(_PORTS))
    try:
        assert _wait(lambda: all(len(e.peers()) == 3 for e in engines))
        victim_addr = engines[2].self_addr()
        engines[2].stop()
        assert _wait(
            lambda: all(victim_addr not in e.peers() for e in engines[:2]), 15.0
        )
        evs = engines[0].drain_events()
        assert any(
            e["type"] == "departed" and e["addr"] == victim_addr for e in evs
        )
        assert len({e.fingerprint() for e in engines[:2]}) == 1
    finally:
        for e in engines:
            e.stop()
            e.close()


def test_probe_discovers_member_without_joining(iface4):
    port = next(_PORTS)
    engines = _mesh(iface4, 2, port)
    try:
        assert _wait(lambda: all(len(e.peers()) == 2 for e in engines))
        res = probe_mesh(
            iface4["ip"], iface4["broadcast"], port, start_ms=100, total_timeout_ms=8000
        )
        assert res is not None
        addr, ident = res
        assert addr in {e.self_addr() for e in engines}
        assert ident in {b"pane-0", b"pane-1"}
        # The prober did not join: peer counts unchanged.
        assert all(len(e.peers()) == 2 for e in engines)
        # total_timeout_ms=0 = the reference's retry-forever mode
        # (discovery.rs:51-72); with a member up it returns on the first
        # backoff round, so this exercises the no-deadline path hang-free.
        res = probe_mesh(
            iface4["ip"], iface4["broadcast"], port, start_ms=100,
            total_timeout_ms=0,
        )
        assert res is not None
    finally:
        for e in engines:
            e.stop()
            e.close()


def test_wire_interop_with_independent_python_socket(iface4):
    """A plain Python socket speaking the Python codec is a valid mesh peer:
    send Ping, get a well-formed Ack back (kaboodle.rs:513-532)."""
    engines = _mesh(iface4, 1, next(_PORTS))
    try:
        target = engines[0].self_addr()
        host, _, port = target.rpartition(":")
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind((iface4["ip"], 0))
            s.settimeout(5.0)
            s.sendto(codec.encode_envelope(b"py-peer", {"kind": "PING"}), (host, int(port)))
            data, _ = s.recvfrom(10240)
            my_port = s.getsockname()[1]
        ident, msg = codec.decode_envelope(data + b"\x00" * 16)
        assert ident == b"pane-0"
        assert msg["kind"] == "ACK"
        assert msg["peer"] == target  # the engine acks with its own address
        assert msg["num_peers"] == 2  # self + the python peer (Q1 marked us)
        # Q1: our datagram made us a member; the fingerprint must now cover us.
        me = f"{iface4['ip']}:{my_port}"
        assert me in engines[0].peers()
        assert engines[0].peers()[me]["identity"] == b"py-peer"
    finally:
        for e in engines:
            e.stop()
            e.close()


def test_ipv6_multicast_path():
    v6 = [i for i in list_interfaces() if i["family"] == 6 and not i["ip"].startswith("fe80")]
    if not v6:
        pytest.skip("no global IPv6 interface")
    port = next(_PORTS)
    engines = [
        NativeEngine(
            v6[0]["ip"],
            "ff02::1213:1989",  # the reference group (networking.rs:86)
            port,
            iface_index=v6[0]["ifindex"],
            identity=f"v6-{i}".encode(),
            rng_seed=i + 1,
            **_FAST,
        )
        for i in range(2)
    ]
    for e in engines:
        e.start()
    try:
        assert _wait(
            lambda: len({e.fingerprint() for e in engines}) == 1
            and all(len(e.peers()) == 2 for e in engines)
        )
    finally:
        for e in engines:
            e.stop()
            e.close()
