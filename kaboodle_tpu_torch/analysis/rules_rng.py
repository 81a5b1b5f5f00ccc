"""KB6xx -- keyscope: PRNG key-provenance rules, the documentation.

The port of ``kaboodle_tpu/analysis/rules_rng.py``: the rule documentation
for ``--explain KB6nn`` and ``--list-rules``, with no-op checks (no lane
runs them over source files). One check runs in the port:
KB602's registry half (``analysis/rng/rules.py``), under ``python -m
kaboodle_tpu_torch.analysis --rng``. KB601, KB603, KB604, KB605 and
KB602's in-trace half walk jaxprs, which the port does not have.
"""

from __future__ import annotations

from kaboodle_tpu_torch.analysis.core import rule

_NO_COUNTERPART = """

In the port: no counterpart. The JAX lane finds these in traced programs
(jaxprs); the port's programs are not traced, so the rule is documented
here and never run."""


def _rng_only(mod):
    """KB6xx rules do not run on source files."""
    return []


rule(
    "KB601",
    "key reuse: two reachable draws on one unforked key",
    """
Two `random_bits` sinks in one traced program whose key provenance reaches
the same canonical key node without an intervening `split`/`fold_in`.
Identical threefry keys produce identical streams: the two "independent"
draws are bit-equal, which skews every statistic built on them.
""" + _NO_COUNTERPART,
)(_rng_only)


rule(
    "KB602",
    "stream-id collision / STREAM_* registry drift",
    """
Two ledgers, compared mechanically on every rng run:

1. *In-trace* (JAX lane only): two `fold_in` constants colliding on the
   same canonical parent key, or a literal fold on a counter-seed chain
   using an id absent from the registered STREAM_* set.
2. *Registry* (runs in the port, `--rng`): the live `phasegraph/rng.py`
   STREAM_* constants vs the pinned KEYSCOPE_STREAMS table
   (`analysis/rng/rules.py`). Ids must be value-identical, dense from 0,
   and append-only-ordered. A *swap* of two ids keeps the draws
   collision-free and the id set unchanged -- only this double-entry
   comparison catches it before every banked run's draws silently
   renumber.

"New phases append" is rng.py's stated contract; this rule is its
mechanical form: appending edits both ledgers, renumbering trips the lane.
""",
)(_rng_only)


rule(
    "KB603",
    "resume-impure draw: provenance outside the checkpointable state",
    """
A draw whose key provenance does not bottom out in the entry point's
arguments -- a constant seed or key baked into the program. Such a draw
replays identically on every resume and every process, regardless of the
checkpoint, so restarts stop being bit-exact continuations.
""" + _NO_COUNTERPART,
)(_rng_only)


rule(
    "KB604",
    "cross-engine key-chain divergence",
    """
Engines derived from the same op table, with bit-exactness pinned, must
fork keys identically: their provenance fingerprints must be equal. A
divergence is the trace-time shadow of a numeric diff. (In the port the
numeric diff itself is held by the tests, engine against engine.)
""" + _NO_COUNTERPART,
)(_rng_only)


rule(
    "KB605",
    "leapability: chain-coupled vs counter-keyed draw sites",
    """
A classification of every draw site of every traced engine as
counter-keyed (a pure function of checkpointable counters) or
chain-coupled (a carried split-chain key feeds it), banked as a leap
report whose freshness the JAX lane checks.
""" + _NO_COUNTERPART,
)(_rng_only)
