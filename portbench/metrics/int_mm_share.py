"""Percent of the traced device time in the library's int8 product
(``torch._int_mm`` under ``phasegraph/exec.py::_bool_matmul``, the gossip
and Failed unions): device operations launched inside an ``aten::_int_mm``
host op, over all device time. None where no traced unit ran one."""


def read(ctx):
    total = ctx.trace.device_total_s()
    under = ctx.trace.time_under("aten::_int_mm")
    if total <= 0 or under <= 0:
        return None
    return 100.0 * under / total
