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

The JAX package's ``shardpool.py`` (the sharded lane pool) is not ported
yet: it stands on ``parallel/``'s row-sharded tick, but ``torch.distributed``
is multi-controller, so it needs rank 0 to serve and the other ranks to
follow its steps (ROADMAP.md).
"""

from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
from kaboodle_tpu_torch.serve.pool import LanePool, lane_n_class

__all__ = [
    "LanePool",
    "ServeEngine",
    "ServeRequest",
    "lane_n_class",
]
