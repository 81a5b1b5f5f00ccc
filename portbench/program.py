"""The system under test: the port's entry points, driven as a user drives them.

``ProgramBase`` is what every engine's ``Program`` (``portbench/engines/``)
shares: fresh meshes (``sim/state.py::init_state``), the per-tick
``TickInputs``, a tick of the engine's build and the boot to agreement
(``sim/runner.py::converge_loop``, after the engine's tick 0 where it has
one). An engine's ``build`` makes the three tick functions from the
configuration, as a user of the port makes them. Only this module and the
engines' ``Program`` classes import the program (``kaboodle_tpu_torch``).
The reference adapter (``refprog.py``) has the same surface over the
benchmark's own reference.
"""

from __future__ import annotations

import dataclasses

import torch


class ProgramBase:
    """The port as one configuration runs it."""

    def __init__(self, config: dict, traffic: dict, device):
        from kaboodle_tpu_torch.config import SwimConfig

        self.config, self.device = config, torch.device(device)
        self.n = config["n"]
        self._tick, self._boot_tick0, self._boot_tick = self.build(
            SwimConfig(**config["protocol"]), config["engine"], traffic)

    def build(self, cfg, engine: dict, traffic: dict):
        """``(tick, boot tick 0 or None, boot tick)`` of the port's build."""
        raise NotImplementedError

    def fresh(self, seed: int):
        from kaboodle_tpu_torch.sim.state import init_state

        st = self.config["state"]
        return init_state(self.n, seed=seed, track_latency=st["track_latency"],
                          instant_identity=st["instant_identity"],
                          timer_dtype=getattr(torch, st["timer_dtype"]), device=self.device)

    def inputs(self, sched):
        """The run's ``TickInputs`` stacked on ``[T]``, on the device."""
        from kaboodle_tpu_torch.sim.state import TickInputs

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return TickInputs(kill=dev(sched.kill), revive=dev(sched.revive),
                          partition=dev(sched.partition), drop_rate=dev(sched.drop_rate),
                          manual_target=dev(sched.manual_target))

    def tick(self, st, inputs, t: int):
        return self._tick(st, inputs.at(t))

    def boot(self, st):
        """A broadcast boot to agreement: ``(state, ticks after tick 0,
        converged, tick-0 metrics or None)``."""
        from kaboodle_tpu_torch.sim.runner import converge_loop
        from kaboodle_tpu_torch.sim.state import idle_inputs

        m0 = None
        if self._boot_tick0 is not None:
            st, m0 = self._boot_tick0(st, idle_inputs(self.n, device=self.device))
        st, ticks, conv = converge_loop(st, self._boot_tick, self.config["boot"]["max_ticks"])
        return st, ticks, conv, m0


def fields(obj) -> dict:
    """A state's or metrics' tensors by field name (None fields left out)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def launches() -> dict:
    """Hand-kernel launches by kernel since the last reset (``ops/_cuda.py``)."""
    from kaboodle_tpu_torch.ops import _cuda

    return dict(_cuda.launches)


def reset_launches() -> None:
    from kaboodle_tpu_torch.ops import _cuda

    _cuda.reset_launches()
