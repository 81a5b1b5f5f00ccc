"""Percent of the traced device time spent in elementwise kernels over 64-bit
integers: the counter RNG of ``ops/threefry.py``, ``mix32`` of
``ops/hashing.py`` and the draws of ``ops/sampling.py`` (``.ticks``,
``.rest``, ``.blocked`` over traced ticks, ``.boot`` over traced boots).

PyTorch names an elementwise kernel ``...elementwise_kernel<...>`` with
the functor's C++ types in its template arguments; a pass over int64
tensors carries ``long`` there."""

import re

_LONG = re.compile(r"\blong\b")


def is_int64_elementwise(name: str) -> bool:
    return "elementwise_kernel" in name and bool(_LONG.search(name))


def read(ctx):
    total = ctx.trace.device_total_s()
    if total <= 0:
        return None
    ew = sum(op.dur for op in ctx.trace.device_ops if is_int64_elementwise(op.name)) * 1e-9
    return 100.0 * ew / total
