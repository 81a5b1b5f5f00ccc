"""ProtocolCounters: per-tick protocol event reductions of the telemetry tick.

Every counter is a pure derived value of one tick's delivery masks and
pre/post states: no tick mutates state to count, so a telemetry-on tick is
bit-identical to a telemetry-off tick in everything but its outputs. The
definitions are the JAX package's (``kaboodle_tpu/telemetry/counters.py``),
bit for bit; "sent" means the datagram entered the transport (post the D8
validity filter -- delivery may still drop it):

- ``pings_sent``      random A3 pings + valid manual pings + proxy pings
                      dispatched on a delivered PingRequest.
- ``acks_sent``       acks dispatched on a delivered ping (direct, manual,
                      proxy->suspect) + forwarded acks (call-3 coincidence
                      pops and call-4 relays).
- ``ping_reqs_sent``  PingRequests dispatched by escalating suspectors.
- ``suspicions_raised``   rows escalating WaitingForPing ->
                      WaitingForIndirectPing this tick (D1: <= 1 per row).
- ``suspicions_refuted``  cells WaitingForIndirectPing at tick start and
                      Known at tick end.
- ``deaths_declared`` cells removed by phase A2 (WaitingForIndirectPing
                      timeouts + no-proxy insta-removals).
- ``joins_disseminated``  Join broadcast deliveries (origin != receiver).
- ``gossip_bytes``    ``RECORD_BYTES`` x (records in KnownPeersRequest
                      replies sent + records in join-response shares sent,
                      the D5-capped share model), modulo 2^32.
- ``armed_timers``    waiting-state cells in alive rows at tick end.

Leaves are 0-d device tensors (stacked ``[T]`` by the runner, ``[K]`` in
the flight recorder). Every field is int32 except ``gossip_bytes``, a
uint32 quantity carried, like the port's other uint32 words, as an int32
tensor holding its 32 bits: its arithmetic runs in int64 on the unsigned
value and wraps back with ``ops/hashing.wrap32``. ``counters_table`` and
``counters_totals`` give the JAX package's host layout back (uint32
``gossip_bytes``, its total modulo 2^32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.ops.hashing import MASK32, as_u32, wrap32
from kaboodle_tpu_torch.sim.state import TickMetrics, resolve_device

# Modeled wire size of one gossiped membership record: u32 address word +
# u32 identity word (the simulator's (addr, identity) pair).
RECORD_BYTES = 8


@dataclasses.dataclass
class ProtocolCounters:
    """One tick's protocol event counts (module docstring for definitions)."""

    pings_sent: torch.Tensor  # int32 []
    acks_sent: torch.Tensor  # int32 []
    ping_reqs_sent: torch.Tensor  # int32 []
    suspicions_raised: torch.Tensor  # int32 []
    suspicions_refuted: torch.Tensor  # int32 []
    deaths_declared: torch.Tensor  # int32 []
    joins_disseminated: torch.Tensor  # int32 []
    gossip_bytes: torch.Tensor  # int32 bits of uint32 [] (modular)
    armed_timers: torch.Tensor  # int32 []


FIELDS = tuple(f.name for f in dataclasses.fields(ProtocolCounters))


@dataclasses.dataclass
class TickTelemetry:
    """Telemetry-build tick output: metrics + counters + per-member digests.

    ``fp`` is the end-of-tick per-member membership fingerprint vector
    (int32 bits of uint32 ``[N]``), the flight recorder's digest plane."""

    metrics: TickMetrics
    counters: ProtocolCounters
    fp: torch.Tensor


def _map(fn, *cs: ProtocolCounters) -> ProtocolCounters:
    return ProtocolCounters(**{f: fn(f, *(getattr(c, f) for c in cs)) for f in FIELDS})


def zero_counters(device=None) -> ProtocolCounters:
    """All-zero counters (the accumulator seed), on the card unless ``device``
    names another."""
    dev = resolve_device(device)
    return _map(lambda f: torch.zeros((), dtype=torch.int32, device=dev))


def add_counters(a: ProtocolCounters, b: ProtocolCounters) -> ProtocolCounters:
    """Leafwise sum; int32 leaves wrap like JAX's, ``gossip_bytes`` mod 2^32."""
    def add(f, x, y):
        return wrap32(x.to(torch.int64) + y.to(torch.int64)) if f == "gossip_bytes" else x + y

    return _map(add, a, b)


def _mul_u32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x * k mod 2^32`` of unsigned int64 values, with no int64 overflow."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def scale_counters(c: ProtocolCounters, k) -> ProtocolCounters:
    """``k`` identical ticks' worth of ``c`` (per-leaf multiply in its dtype)."""
    def scale(f, x):
        kt = torch.as_tensor(k, device=x.device)
        if f == "gossip_bytes":
            return wrap32(_mul_u32(as_u32(x), as_u32(kt)))
        return x * kt.to(torch.int32)

    return _map(scale, c)


def leap_counters(n_alive, k, device=None) -> ProtocolCounters:
    """Counters of ``k`` quiescent ticks in closed form: per tick every alive
    row pings and is acked (``pings_sent == acks_sent == n_alive``), and
    every other counter is zero. On ``n_alive``'s device when it is a
    tensor, else on the card unless ``device`` names another."""
    if not (device is None and isinstance(n_alive, torch.Tensor)):
        device = resolve_device(device)
    n = torch.as_tensor(n_alive, dtype=torch.int32, device=device)
    per_tick = dataclasses.replace(zero_counters(n.device), pings_sent=n, acks_sent=n)
    return scale_counters(per_tick, k)


def _host(x) -> np.ndarray:
    return np.atleast_1d(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x))


def _host_field(counters: ProtocolCounters, name: str) -> np.ndarray:
    a = _host(getattr(counters, name))
    return a.astype(np.int32).view(np.uint32) if name == "gossip_bytes" else a


def counters_table(counters: ProtocolCounters) -> np.ndarray:
    """Stacked ``[T]`` counters -> structured NumPy table, one row per tick
    (the JAX package's layout: ``gossip_bytes`` uint32)."""
    rows = _host(counters.pings_sent).shape[0]
    out = np.zeros(
        rows,
        dtype=[("tick", np.int32)]
        + [(name, np.uint32 if name == "gossip_bytes" else np.int32) for name in FIELDS],
    )
    out["tick"] = np.arange(rows)
    for name in FIELDS:
        out[name] = _host_field(counters, name)
    return out


def counters_totals(counters: ProtocolCounters) -> dict:
    """Run totals of stacked counters, as Python ints.

    ``armed_timers`` is a gauge, so its total is the tick-integrated value;
    ``gossip_bytes`` wraps modulo 2^32 like the on-device accumulator
    (``add_counters``), so the two totals can never disagree."""
    out = {name: int(_host_field(counters, name).astype(np.int64).sum()) for name in FIELDS}
    out["gossip_bytes"] = int(
        _host_field(counters, "gossip_bytes").astype(np.uint64).sum() % (1 << 32)
    )
    return out
