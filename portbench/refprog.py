"""The benchmark's reference with the program's surface (``program.ProgramBase``).

It runs the same configuration and the same mix through
``portbench/reference/``, which shares no code and no state with the
program. ``fdt`` is the float type of the draws, probabilities, latency and
float metrics: float32 as the configurations state, ``torch.bfloat16`` for
the control (``control.py``), the reference in the nearest lower precision.
"""

from __future__ import annotations

import torch

from portbench.reference.runs import converge_loop
from portbench.reference.state import Inputs, idle, init_state


class ReferenceBase:
    """What every engine's ``Reference`` (``portbench/engines/``) shares; an
    engine's ``build`` makes its three tick functions from
    ``portbench/reference/``."""

    def __init__(self, config: dict, traffic: dict, device, fdt=torch.float32):
        self.config, self.device, self.fdt = config, torch.device(device), fdt
        self.n = config["n"]
        self._tick, self._boot_tick0, self._boot_tick = self.build(
            config["protocol"], config["engine"], traffic)

    def build(self, proto: dict, engine: dict, traffic: dict):
        """``(tick, boot tick 0 or None, boot tick)`` of the reference."""
        raise NotImplementedError

    def fresh(self, seed: int):
        st = self.config["state"]
        return init_state(self.n, seed, self.device, track_latency=st["track_latency"],
                          instant_identity=st["instant_identity"],
                          timer_dtype=getattr(torch, st["timer_dtype"]), fdt=self.fdt)

    def inputs(self, sched):
        dev = self.device

        class _Stacked:
            def at(self, t):
                return Inputs(kill=torch.as_tensor(sched.kill[t], device=dev),
                              revive=torch.as_tensor(sched.revive[t], device=dev),
                              partition=torch.as_tensor(sched.partition[t], device=dev),
                              drop_rate=float(sched.drop_rate[t]),
                              manual_target=torch.as_tensor(sched.manual_target[t], device=dev))

        return _Stacked()

    def tick(self, st, inputs, t: int):
        return self._tick(st, inputs.at(t))

    def boot(self, st):
        m0 = None
        if self._boot_tick0 is not None:
            st, m0 = self._boot_tick0(st, idle(self.n, self.device))
        st, ticks, conv, _ = converge_loop(st, self._boot_tick, self.config["boot"]["max_ticks"])
        return st, ticks, conv, m0
