"""Reference-faithful per-peer SWIM engine (pure Python, transport-agnostic).

The port's executable spec: a direct, readable implementation of the
reference protocol engine (src/kaboodle.rs), independent of both tensor
engines. ``lockstep.py`` runs N of them in the deterministic delivery model
that the port's tick (``kaboodle_tpu_torch.sim``) is held to, tick by tick.
The port's own copy of the JAX package's modules (it imports nothing of it).
"""

from kaboodle_tpu_torch.oracle.engine import PeerEngine, PeerRecord, Outbox
from kaboodle_tpu_torch.oracle.engine import (
    Ping,
    PingRequest,
    Ack,
    KnownPeersMsg,
    KnownPeersRequest,
    Join,
    Failed,
    Probe,
    ProbeResponse,
)
from kaboodle_tpu_torch.oracle.fingerprint import mix_fingerprint, crc_fingerprint
from kaboodle_tpu_torch.oracle.lockstep import LockstepMesh

__all__ = [
    "PeerEngine",
    "PeerRecord",
    "Outbox",
    "Ping",
    "PingRequest",
    "Ack",
    "KnownPeersMsg",
    "KnownPeersRequest",
    "Join",
    "Failed",
    "Probe",
    "ProbeResponse",
    "mix_fingerprint",
    "crc_fingerprint",
    "LockstepMesh",
]
