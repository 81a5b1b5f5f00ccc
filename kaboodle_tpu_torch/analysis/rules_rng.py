"""KB6xx -- keyscope: counter-RNG key-provenance rules, the documentation.

The port of ``kaboodle_tpu/analysis/rules_rng.py``: the rule documentation
for ``--explain KB6nn`` and ``--list-rules``, with no-op source checks.
The checks run under ``python -m kaboodle_tpu_torch.analysis --rng``
(``analysis/rng/``) over the key provenance recorded at the port's
counter-RNG calls (``ops/threefry.py``, ``phasegraph/rng.py``) while each
registry entry runs, plus KB602's trace-free register.
"""

from __future__ import annotations

from kaboodle_tpu_torch.analysis.core import rule

_IN_THE_PORT = """

In the port: run by the rng lane over the provenance recorded at the
counter-RNG calls of each registry entry (analysis/rng/provenance.py),
each entry run as it is and with every device gate forced each way, so
both arms of every gate are seen as a jaxpr shows both branches."""


def _rng_only(mod):
    """KB6xx rules do not run on source files."""
    return []


rule(
    "KB601",
    "key reuse: two reachable draws on one unforked key",
    """
Two draws (`threefry.random_bits`/`uniform`/`gumbel_order_bits`) in one
call of an entry whose key provenance reaches the same key without an
intervening `split`/`fold_in`, or one draw site looped on an unchanged key.
Identical threefry keys produce identical streams: the two "independent"
draws are bit-equal, which skews every statistic built on them.
""" + _IN_THE_PORT,
)(_rng_only)


rule(
    "KB602",
    "stream-id collision / STREAM_* registry drift",
    """
Two ledgers, compared mechanically on every rng run:

1. *In-trace*: two `fold_in` constants colliding on the same canonical
   parent key at two call sites, or a constant fold on a counter-seed
   chain using an id absent from the registered STREAM_* set.
2. *Registry*: the live `phasegraph/rng.py`
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
arguments -- a constant seed or key made inside the call (`prng_key(0)`). Such a draw
replays identically on every resume and every process, regardless of the
checkpoint, so restarts stop being bit-exact continuations.
""" + _IN_THE_PORT,
)(_rng_only)


rule(
    "KB604",
    "cross-engine key-chain divergence",
    """
Engines derived from the same op table, with bit-exactness pinned, must
fork keys identically: their provenance fingerprints must be equal. A
divergence is the shadow of a numeric diff (which the tests hold too,
engine against engine).
""" + _IN_THE_PORT,
)(_rng_only)


rule(
    "KB605",
    "leapability: chain-coupled vs counter-keyed draw sites",
    """
A classification of every draw site of every traced engine as
counter-keyed (a pure function of checkpointable counters) or
chain-coupled (a carried split-chain key feeds it), banked as the leap
report `kaboodle_tpu_torch/analysis/rng/leap.json` (the JAX schema;
`--check-leap` gates its freshness, `--write-leap` regenerates it). A
stale report is never baselineable, and the chain-coupled total only
shrinks.
""" + _IN_THE_PORT,
)(_rng_only)
