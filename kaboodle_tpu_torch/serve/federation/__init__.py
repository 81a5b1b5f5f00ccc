"""Federated serving: many engines behind one consistent-hash front door.

The port of ``kaboodle_tpu/serve/federation``. One
:class:`~kaboodle_tpu_torch.serve.federation.router.FedRouter` speaks the
same NDJSON wire protocol as ``server.py`` and places requests onto member
:class:`~kaboodle_tpu_torch.serve.server.ServeServer` engines:

- **placement** (ring.py): a consistent-hash ring over the live members
  (stable hashes — ``hashlib``, never the per-process-salted builtin —
  so placement is deterministic across router restarts), preference-order
  walk filtered to members that serve the request's N-class, tie-broken
  by router-tracked inflight load.
- **failover** (router.py): engines share one spill root and one journal
  root, each namespaced per engine-id (engine.py). When a member dies
  mid-round the router replays its journal READ-ONLY
  (:func:`~kaboodle_tpu_torch.serve.journal.replay_journal`): journaled
  results are served from the fold and never re-run, spilled requests are
  ``adopt``-ed onto survivors (the spill file still carries the dead
  engine's owner stamp — the checkpoint guard's sanctioned handover),
  and everything else re-queues from its seed with its cumulative tick
  budget. A client parked in ``wait`` rides through transparently.
- **proof** (fedload.py): the federation load driver and its ``--dryrun``
  lane — two engines + router on loopback, mixed N-classes, park/resume
  churn, a kill-one-engine chaos scenario, zero lost terminals, zero
  duplicate completions, zero programs built in the steady phase.
"""

from kaboodle_tpu_torch.serve.federation.ring import HashRing
from kaboodle_tpu_torch.serve.federation.router import EngineMember, FedRouter

__all__ = ["EngineMember", "FedRouter", "HashRing"]
