"""Protocol configuration: the reference's tunable surface as one frozen config.

Every duration is in ticks with ``PROTOCOL_PERIOD == 1 tick``
(reference kaboodle.rs:38). The fields, defaults and checks are those of the
JAX package's ``SwimConfig``, so one config means the same protocol in both
engines. The three ``use_pallas_*`` flags keep their names: here a flag that
is on routes the op through the hand-written CUDA kernel (a CUDA tensor) or
its plain PyTorch version (a CPU tensor), for any N.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SwimConfig:
    """All SWIM protocol constants plus parity flags for the reference's quirks."""

    # PING_TIMEOUT = 2000 ms (kaboodle.rs:62).
    ping_timeout_ticks: int = 2
    # MAX_PEER_SHARE_AGE = 10000 ms (kaboodle.rs:49); also the Q6 back-date.
    max_peer_share_age_ticks: int = 10
    # REBROADCAST_INTERVAL = 10000 ms (kaboodle.rs:65).
    rebroadcast_interval_ticks: int = 10
    # NUM_INDIRECT_PING_PEERS (kaboodle.rs:52).
    num_indirect_ping_peers: int = 3
    # NUM_CANDIDATE_TARGET_PEERS (kaboodle.rs:57).
    num_candidate_target_peers: int = 5
    # Join-response share cap (kaboodle.rs:373-383, deviation D5); 0 = none.
    max_share_peers: int = 300
    # Join broadcasts (kaboodle.rs:228-251); False = the gossip boot.
    join_broadcast_enabled: bool = True
    # Q6 back-dating of gossip-learned peers; False = the epidemic boot.
    backdate_gossip_inserts: bool = True
    # Q1/Q11: a forwarded indirect Ack marks the proxy, not the suspect.
    faithful_indirect_ack: bool = True
    # Q3: Failed broadcasts are inert in the reference.
    faithful_failed_broadcast: bool = True
    # Lowest-index / always-respond picks instead of random draws.
    deterministic: bool = False
    # Fingerprint + count through ops/fused_fp.py.
    use_pallas_fp: bool = False
    # Oldest-k formulation of the fused program's draw: "topk" or "iter".
    oldest_k_method: str = "iter"
    # Oldest-k candidates of the full program through ops/fused_oldest_k.py.
    use_pallas_oldest_k: bool = False
    # Phase-A row statistics through ops/fused_suspicion.py.
    use_pallas_suspicion: bool = False
    # Per-tick dispatch between the full and the fused program.
    fast_path: bool = True

    def __post_init__(self) -> None:
        if self.oldest_k_method not in ("topk", "iter"):
            raise ValueError("oldest_k_method must be 'topk' or 'iter'")
        if self.ping_timeout_ticks < 1:
            raise ValueError("ping_timeout_ticks must be >= 1")
        if self.num_indirect_ping_peers < 1:
            raise ValueError("num_indirect_ping_peers must be >= 1")
        if self.num_candidate_target_peers < 1:
            raise ValueError("num_candidate_target_peers must be >= 1")


# Reference wire/transport constants, kept for the interop edge (see
# kaboodle_tpu_torch.transport). Values cited from the reference sources.
INCOMING_BUFFER_SIZE = 10240  # kaboodle.rs:43
DISCOVERY_BUFFER_SIZE = 1024  # discovery.rs:16
DEFAULT_BROADCAST_PORT = 7475  # justfile run2x2 demo port
IPV6_MULTICAST_GROUP = "ff02::1213:1989"  # networking.rs:86
PROBE_BACKOFF_START_MS = 1000  # discovery.rs:19
PROBE_BACKOFF_MULTIPLIER = 1.25  # discovery.rs:22
PROBE_BACKOFF_CAP_MS = 10000  # discovery.rs:25
LATENCY_EWMA_MOST_RECENT_WEIGHT = 0.8  # kaboodle.rs:810
