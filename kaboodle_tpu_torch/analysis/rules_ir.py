"""KB4xx -- graftscan: rules over the dispatch trace of the registry's entries.

The port of ``kaboodle_tpu/analysis/rules_ir.py``. The KB1xx-KB3xx
families read *source*; this family reads what a call *does*: every aten
op one call of each entry of ``analysis/ir/registry.py`` dispatches
(``analysis/ir/walk.py``, the port's counterpart of the jaxpr). This
module registers only the rule documentation (``--explain KB4nn``,
``--list-rules``) with no-op source checks, so the AST lane stays
torch-free; the passes live in ``analysis/ir/`` and run under ``python -m
kaboodle_tpu_torch.analysis --ir``.

IR findings have no source line to ``# noqa``; suppression is the
justified baseline ``kaboodle_tpu_torch/analysis/ir/baseline.json`` (the
AST lane's format and shrink-only contract), and the KB405 program counts
are pinned by ``analysis/ir/surface.json``.
"""

from __future__ import annotations

from kaboodle_tpu_torch.analysis.core import rule


def _ir_only(mod):
    """KB4xx rules run over the dispatch trace (analysis/ir/), never on source files."""
    return []


rule(
    "KB401",
    "dtype widening in a traced entry",
    """
Two detectors over each registry entry's dispatch trace:

1. Any non-scalar float64/complex128 tensor an op takes or returns. A
   dtype-less constructor or a Python-float promotion lands on f64 only
   where a double sneaks in (`torch.tensor(0.5)` is f32, an f64 numpy
   array made into a tensor is not); an f64 [N, N] resident doubles the
   card memory of exactly the tensors the memory plan is spent on.
2. In the lean programs (int16 timers), an op that takes an int16 tensor
   and returns a wider one, outside the allowlisted accumulation set: age
   arithmetic (`t - T` computes in int32 by design) and comparisons. Torch
   promotes inside an op, so each op's output dtype is held against its
   inputs'; a conversion (`.to(torch.int32)`) is judged by where its value
   ends up (followed through views). A widened value reaching anything
   else -- a `where`, a scatter, the call's output -- silently doubles the
   timer resident the lean mode exists to halve. The port's uint32 words
   are int64 on purpose (ops/hashing.py): the detector reads int16 only.

Fix by spelling the dtype; baseline with a justification only for
widenings that are provably local to the call.
""",
)(_ir_only)


rule(
    "KB402",
    "host sync inside an entry's call",
    """
What makes the host wait for the card inside one call of a registered
entry: every `aten._local_scalar_dense` (each `.item()`, `bool()`, `int()`
or Python `if` on a tensor), every op whose output size depends on the data
(`nonzero`, `masked_select`, a boolean-mask index), and every host copy
(`.cpu()`, `.numpy()`, `.tolist()`, `.to("cpu")`). Each is a stall of the
stream; inside a tick the port rolls thousands of times it is paid per
tick. The lane prints how many each entry makes per call.

The AST twins (KB201/KB202/KB301) catch what they can see in source; this
rule catches what reached the call, through helper layers the per-module
reachability cannot follow. The port's gates (a Python `if` on a device
predicate that skips a phase) are such syncs by design: each is baselined
with the gate it serves until the tick is captured whole.
""",
)(_ir_only)


rule(
    "KB403",
    "host data made into a tensor inside the call",
    """
A tensor made from host data inside one call -- `torch.tensor(...)` of a
Python sequence or a host array (`lift_fresh`), or a host-to-card copy --
above the entry's byte budget (`const_budget_bytes`: 4,096, 2,048 for
`ops.crc32`). A table rebuilt per call is uploaded per call, and copied
again on every call of a tick the port rolls thousands of times; build it
once (module level, or a cache keyed on the device) or thread it through
the arguments. The registry traces at toy N, so the budget is sized to
catch state-shaped uploads at trace scale.
""",
)(_ir_only)


rule(
    "KB404",
    "row block off the sharding spec",
    """
In the sharded entries (the row-sharded tick and leap, the sharded serve
step, the E x peers fleet tick), every tensor handed to
`parallel/collectives.py` must carry the row split that
`parallel.state_specs`/`inputs_specs` give: the peer axis `Shard(0)`, so a
rank holds N / R rows of every [N, N] plane and [N] vector. A block of any
other length on the axis a helper gathers, transposes or rings (a gather
along the columns, a block cut off the split) is a hand-rolled layout: the
ranks exchange the wrong rows, or all of them. A sharded entry that makes
NO collective at all has lost its exchange entirely (a tick built without
`group=`). `state_specs` is the single source of truth; derive from it.
""",
)(_ir_only)


rule(
    "KB405",
    "compile-surface budget exceeded (rebuild debt gate)",
    """
Memoization-based simulators get their speed from a small, stable set of
built programs: warp spans leap through O(log max_span) power-of-two
programs, a lane pool serves every admission mix with one program set. This
rule runs the scripted dense+warp+fleet+serve+sparse exercise
(analysis/ir/surface.py) in a fresh process, counts the programs each
entry-point family builds (misses of the program caches that
`serve.pool.program_builds` counts), and compares them with the committed
`kaboodle_tpu_torch/analysis/ir/surface.json`.

A count above the committed budget is a rebuild regression -- a spurious
cache key, a span-chunking policy that degraded to one program per span
length -- and fails the gate. Raising a committed count requires editing
the budget file WITH a justification; under `--no-baseline-growth` a count
*below* the budget also fails until the smaller number is committed, so
the file is a shrink-only record of how many programs the hot paths may
cost.
""",
)(_ir_only)
