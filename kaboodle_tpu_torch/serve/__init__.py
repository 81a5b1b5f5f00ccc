"""serve — gossip-as-a-service: continuous-batching simulation serving.

The port of ``kaboodle_tpu/serve``. The package keeps one resident
fixed-shape ``[E]`` fleet per power-of-two N-class and admits concurrent
simulation requests into its free lanes mid-flight: a converged lane is
frozen, harvested and re-seeded with the next request's seed and knobs
without leaving the program set built at warmup, and harvests are
bit-exact with standalone runs.

Layers:

- pool.py      — the lane pool: the ``[E]`` fleet + per-lane generation
                 counters, in-place admit/retire/re-seed, pow2 N-classes.
- engine.py    — the resident step loop: the serve step (masked converge
                 chunks) composed with the per-member fleet warp (quiescent
                 horizon-mode lanes fast-forward, hot lanes tick dense),
                 request bookkeeping, lane spill, journal, admission.
- server.py    — asyncio JSON-over-TCP front end (submit/status/cancel/
                 stream) streaming ``kaboodle-telemetry/1`` records live.
- client.py    — the asyncio client + a one-shot synchronous helper.
- dryrun.py    — the CI lane: in-process server, toy requests,
                 schema-checked manifest, no program built after warmup.
- admission.py, journal.py, spill.py, obsplane.py — policy, write-ahead
                 log, background spill I/O, observability.
- loadgen.py   — the closed+open-loop load driver (``--overload``,
                 ``--slo``) over an in-process server.
- federation/  — the consistent-hash ring, the router in front of many
                 engines (journal failover, spill adoption) and the
                 two-engine load driver with its kill-one-engine chaos.
- chaos.py, obsdryrun.py — the fault-injection and observability lanes.
- shardpool.py — the sharded lane pool: one pool's lanes (and, on a 2-D
                 mesh, each lane's rows) over the ranks of a device mesh;
                 rank 0 serves and the other ranks follow its pool calls.
"""

from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
from kaboodle_tpu_torch.serve.pool import LanePool, lane_n_class
from kaboodle_tpu_torch.serve.shardpool import ShardedLanePool

__all__ = [
    "LanePool",
    "ServeEngine",
    "ServeRequest",
    "ShardedLanePool",
    "lane_n_class",
]
