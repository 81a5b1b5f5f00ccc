"""Share of their roofline the hand kernels reach (``csrc/fused_fp.cu``,
``fused_suspicion.cu``, ``fused_oldest_k.cu``): the sum over their traced
launches of the least time the card could take (``yardstick.bound_s`` at
the launch's shape: whole planes at the cell's N, the alive rows of the
launch's tick) over the sum of their measured device times. ``.rest`` is
the same reading in ticks at rest.

The launches found in the trace, by kernel, have to equal the program's
own launch counter over the traced stretch (``ops/_cuda.py::launches``):
where they differ, a kernel name was missed or matched another kernel, so
the reading is left out and the counts go to standard error. None too
where no hand kernel ran."""

import sys

import torch

from portbench import yardstick


def _kind(name: str, config: dict):
    for kind, sym in yardstick.KERNEL_SYMBOLS.items():
        if sym in name:
            if kind == "fused_fp":
                return "fused_fp_hash" if config["state"]["instant_identity"] else "fused_fp_idv"
            return kind
    return None


def read(ctx):
    cfg = ctx.config
    n = cfg["n"]
    tb = torch.empty((), dtype=getattr(torch, cfg["state"]["timer_dtype"])).element_size()
    k = cfg["protocol"]["num_candidate_target_peers"]
    bound = measured = 0.0
    found = {}
    for op in ctx.trace.device_ops:
        kind = _kind(op.name, cfg)
        if kind is None:
            continue
        unit = ctx.trace.unit_of(op)
        live = ctx.alive[unit] if unit is not None and ctx.unit == "tick" else n
        bound += yardstick.bound_s(kind, n, n, live, tb, k)
        measured += op.dur * 1e-9
        found[kind] = found.get(kind, 0) + 1
    counted = {kind: v for kind, v in ctx.launches.items() if v}
    if counted != found:
        print(f"hand_kernel_roofline: left out, launches in the trace {found} "
              f"against the program's counter {counted}", file=sys.stderr)
        return None
    if not found or measured <= 0:
        return None
    return 100.0 * bound / measured
