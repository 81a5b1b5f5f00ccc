"""KB401-KB404: the graftscan passes over the dispatch trace.

The port of ``kaboodle_tpu/analysis/ir/passes.py``. Each pass is
``check(entry, traces) -> [Finding]`` over one entry's recorded runs
(``walk.py::trace_entry``: the call as it is, then every gate forced true
and false). Findings reuse the AST lane's :class:`Finding`, so the
baseline and CLI plumbing is shared:

- ``path`` is the pseudo-path ``ir://<entry name>``;
- ``line`` is the source line of the nearest user frame (0 if unknown);
- ``symbol`` -- the baseline key component -- is line-free and built from
  (source file and function, op, dtype/shape), so one justified entry
  covers a finding class and survives unrelated edits.
"""

from __future__ import annotations

import collections

from kaboodle_tpu_torch.analysis.core import Finding
from kaboodle_tpu_torch.analysis.ir.walk import DATA_DEPENDENT, nbytes, terminal_consumers

# -- KB401 ------------------------------------------------------------------

# 64-bit float dtypes only: the rule is "any f64 anywhere". int64 is NOT
# swept: the port's uint32 words are int64 on purpose (ops/hashing.py),
# and the int16 discipline has its own detector below.
_WIDE_FLOATS = frozenset({"float64", "complex128"})

# The lean int16 allowlist (JAX's): a widened timer may feed age arithmetic
# (`t - T` computes in int32 by design) and comparisons, and nothing else.
# A widened value reaching a write (`where`), a scatter, a reduction or the
# call's output is a resident-doubling leak.
_ALLOWED_WIDEN_CONSUMERS = frozenset({"sub", "add", "lt", "le", "gt", "ge", "eq", "ne"})
_INT16_WIDENED = frozenset({"int32", "int64", "float32", "float64"})
# Ops that only convert a value's dtype: their consumers decide.
_CONVERTS = frozenset({"aten._to_copy", "aten.to", "aten._to_dtype", "aten.copy_"})


def _ops(traces):
    for tr in traces:
        for op in tr.ops:
            yield tr, op


def check_kb401_wide_floats(entry, traces) -> list[Finding]:
    """Non-scalar f64/c128 tensors anywhere in the call -> findings.

    Scalars are exempt: a 0-d float64 from a Python float is a host value,
    an f64 tensor is a doubled resident."""
    out: dict[str, Finding] = {}
    for _, op in _ops(traces):
        for ref in (*op.ins, *op.outs):
            if ref.dtype not in _WIDE_FLOATS or not ref.shape:
                continue
            symbol = f"{op.src.where}:{op.name.replace('aten.', '')}:{ref.dtype}"
            if symbol not in out:
                out[symbol] = Finding(
                    f"ir://{entry.name}", "KB401", op.src.line,
                    f"{ref.dtype} {list(ref.shape)} reaches '{op.name}' ({op.src.render()}) "
                    "-- spell the dtype (float32 constants, dtype= on constructors)",
                    symbol,
                )
    return list(out.values())


def check_kb401_lean_widening(entry, traces) -> list[Finding]:
    """int16 -> wider in a lean program, outside the allowlist.

    Torch promotes inside an op, with no conversion op to spot, so each
    op's output dtype is compared with its inputs': an op that takes an
    int16 tensor and returns a wider one widens. An allowlisted op
    (age arithmetic, a comparison) may widen itself; a conversion
    (``.to(int32)``) is judged by the terminal consumers of its output,
    followed through views; anything else that widens is a finding."""
    if not entry.lean:
        return []
    out: dict[str, Finding] = {}
    for tr in traces:
        for i, op in enumerate(tr.ops):
            # A kernel unit takes int16 timers natively; its int32 outputs
            # are counts and indices, not the timers widened.
            if op.name.startswith("unit:") or not any(r.dtype == "int16" for r in op.ins):
                continue
            for ref in op.outs:
                if ref.dtype not in _INT16_WIDENED:
                    continue
                name = op.name.replace("aten.", "")
                if name in _ALLOWED_WIDEN_CONSUMERS:
                    continue
                if op.name in _CONVERTS:
                    bad = terminal_consumers(tr.ops, i, ref.tid) - _ALLOWED_WIDEN_CONSUMERS
                else:
                    bad = {name}
                if not bad:
                    continue
                symbol = f"{op.src.where}:int16->{ref.dtype}:{'|'.join(sorted(bad))}"
                if symbol not in out:
                    out[symbol] = Finding(
                        f"ir://{entry.name}", "KB401", op.src.line,
                        f"int16 state widened to {ref.dtype} ({op.src.render()}) flows into "
                        f"{sorted(bad)} -- outside the age-arithmetic allowlist; the "
                        "lean-mode timer resident must stay int16",
                        symbol,
                    )
    return list(out.values())


# -- KB402 ------------------------------------------------------------------


def host_syncs(trace) -> collections.Counter:
    """``{(where, kind): count}`` of one run's host syncs: every
    ``_local_scalar_dense`` (``.item()``/``bool()``/``int()`` of a tensor),
    every op whose output size depends on the data, every host copy."""
    c: collections.Counter = collections.Counter()
    for op in trace.ops:
        if op.scalar:
            c[(op.src.where, "_local_scalar_dense")] += 1
        elif op.name in DATA_DEPENDENT:
            c[(op.src.where, op.name.replace("aten.", ""))] += 1
        elif op.name in ("aten.index", "aten.index_put", "aten.index_put_") and any(
                r.dtype == "bool" for r in op.ins[1:]):
            c[(op.src.where, op.name.replace("aten.", "") + "[bool mask]")] += 1
    for kind, src in trace.host:
        c[(src.where, kind)] += 1
    return c


def check_kb402_host_boundary(entry, traces) -> list[Finding]:
    """Host syncs in the call, one finding per (site, kind), with the
    as-is run's count per call (0 where only a forced arm reaches it)."""
    natural = host_syncs(traces[0])
    out: dict[str, Finding] = {}
    lines: dict[str, int] = {}
    for tr in traces:
        for op in tr.ops:
            lines.setdefault(op.src.where, op.src.line)
        for (where, kind), _ in sorted(host_syncs(tr).items()):
            symbol = f"{where}:{kind}"
            if symbol in out:
                continue
            n = natural.get((where, kind), 0)
            out[symbol] = Finding(
                f"ir://{entry.name}", "KB402", lines.get(where, 0),
                f"host sync '{kind}' in {where}: {n} per call"
                + ("" if n else " (reached on a forced gate arm)")
                + " -- the host waits for the card's stream each time",
                symbol,
            )
    return list(out.values())


def sync_count(traces) -> int:
    """The as-is run's host syncs per call."""
    return sum(host_syncs(traces[0]).values())


def sync_counts(entry, traces) -> dict[str, tuple[int, ...]]:
    """Each KB402 finding's key -> its syncs per call in each run (as it
    is, gates forced true, forced false): the counts the baseline records
    beside the key, so a new sync at a baselined site still shows."""
    runs = [host_syncs(tr) for tr in traces]
    return {f"ir://{entry.name}::KB402::{where}:{kind}": tuple(r.get((where, kind), 0)
                                                               for r in runs)
            for where, kind in set().union(*runs)}


# -- KB403 ------------------------------------------------------------------

_HOST_DATA = frozenset({"aten.lift_fresh", "aten.scalar_tensor"})


def check_kb403_captured_consts(entry, traces) -> list[Finding]:
    """Tensors made from host data inside the call above the entry's budget:
    ``torch.tensor(...)`` of a Python sequence or a host array
    (``lift_fresh``), or a host-to-card copy. A table built per call is
    uploaded per call; build it once, or pass it in."""
    out: dict[str, Finding] = {}
    for _, op in _ops(traces):
        if op.name in _HOST_DATA:
            refs = op.outs
        elif op.h2d:
            refs = op.outs
        else:
            continue
        for ref in refs:
            size = nbytes(ref)
            if size <= entry.const_budget_bytes:
                continue
            symbol = f"const:{ref.dtype}{list(ref.shape)}"
            if symbol not in out:
                out[symbol] = Finding(
                    f"ir://{entry.name}", "KB403", op.src.line,
                    f"host data {ref.dtype}{list(ref.shape)} ({size} bytes > budget "
                    f"{entry.const_budget_bytes}) made into a tensor inside the call "
                    f"({op.src.render()}) -- build it once, or pass it as an argument",
                    symbol,
                )
    return list(out.values())


# -- KB404 ------------------------------------------------------------------


def check_kb404_sharding_specs(entry, traces) -> list[Finding]:
    """A sharded entry's collectives must carry the row split the specs give.

    ``parallel/mesh.py::state_specs``/``inputs_specs`` shard the peer axis
    (``Shard(0)`` of ``[N, N]`` planes and ``[N]`` vectors): a rank holds
    ``N / R`` rows; ``fleet/sharding.py``'s specs shard the member axis too
    (a rank holds its ``E_local`` members). Every row block handed to
    ``parallel/collectives.py`` must be one of those splits on the axis the
    helper treats as rows (a gather along the columns, or a block cut off
    the split, is a hand-rolled layout); and a sharded entry that makes no
    collective at all is a finding, as in the JAX package (its rows never
    meet) -- unless its mesh is one rank, where the ``E x peers`` fleet
    layout degenerates to whole members on the rank (no peer axis, nothing
    to exchange), so the card's one rank and a gloo job give the same keys.
    An entry run with no process group at all is never exempt."""
    if not entry.sharded:
        return []
    out: dict[str, Finding] = {}
    calls = 0
    for tr in traces:
        n, members = tr.n_peers, tr.n_members
        for c in tr.collectives:
            calls += 1
            bad = []
            for length, dim, dtype, shape in c.blocks:
                if n is not None and length * c.group_size != n and length != members:
                    bad.append((length, dim, dtype, shape))
            if c.n is not None and n is not None and c.n != n:
                bad.append((c.n, None, "n", ()))
            for length, dim, dtype, shape in bad:
                symbol = f"{c.src.where}:{c.helper}:{dtype}:dim{dim}"
                if symbol not in out:
                    out[symbol] = Finding(
                        f"ir://{entry.name}", "KB404", c.src.line,
                        f"{c.helper} gets a {dtype}{list(shape)} block whose axis {dim} has "
                        f"{length} rows on a group of {c.group_size} ({c.src.render()}); the "
                        f"spec's split of N = {n} is {n // c.group_size if n else '?'} a rank "
                        "-- a layout not derived from parallel.state_specs",
                        symbol,
                    )
    if calls == 0 and traces[0].world != 1:
        out["<missing>"] = Finding(
            f"ir://{entry.name}", "KB404", 0,
            "sharded entry point makes NO collective -- its ranks never exchange rows "
            "(a tick built without group=?)",
            "missing-collectives",
        )
    return list(out.values())


PASSES = (
    check_kb401_wide_floats,
    check_kb401_lean_widening,
    check_kb402_host_boundary,
    check_kb403_captured_consts,
    check_kb404_sharding_specs,
)
