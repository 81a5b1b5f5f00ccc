"""Declarative fault/churn scenarios compiled to stacked per-tick inputs.

A :class:`Scenario` is a schedule of kill / revive / partition / drop /
manual-ping events, built on the host with NumPy and fully deterministic
for a seed (the same schedules as the JAX package's ``Scenario`` for the
same seed). :meth:`Scenario.build` stacks them along a leading ``[T]`` axis
as the port's ``TickInputs`` for :func:`~kaboodle_tpu_torch.sim.runner.
simulate`; :meth:`Scenario.alive_trajectory` is the alive mask the tick
will compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.sim.state import TickInputs, resolve_device


@dataclasses.dataclass
class Scenario:
    """A mutable schedule of fault events over ``ticks`` ticks for ``n`` peers."""

    n: int
    ticks: int
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n < 1 or self.ticks < 1:
            raise ValueError("need n >= 1 and ticks >= 1")
        T, n = self.ticks, self.n
        self._kill = np.zeros((T, n), dtype=bool)
        self._revive = np.zeros((T, n), dtype=bool)
        self._partition = np.zeros((T, n), dtype=np.int32)
        self._drop_rate = np.zeros((T,), dtype=np.float32)
        self._manual = np.full((T, n), -1, dtype=np.int32)
        self._initial_alive = np.ones((n,), dtype=bool)
        self._rng = np.random.default_rng(self.seed)

    def start_dead(self, peers) -> "Scenario":
        """Peers that begin the run dead (joined later via revive_at/churn)."""
        self._initial_alive[np.asarray(peers)] = False
        return self

    def kill_at(self, tick: int, peers) -> "Scenario":
        """Silent leave (quirk Q8) at ``tick``."""
        self._kill[tick, np.asarray(peers)] = True
        return self

    def revive_at(self, tick: int, peers) -> "Scenario":
        """Rejoin-with-reset at ``tick`` (kaboodle.rs:144-152, 228-251)."""
        self._revive[tick, np.asarray(peers)] = True
        return self

    def churn(self, rate: float, start: int = 0, stop: int | None = None,
              protect=()) -> "Scenario":
        """Each tick in [start, stop) every live peer dies w.p. ``rate`` and
        every dead peer rejoins w.p. ``rate``; ``protect`` peers never die."""
        stop = self.ticks if stop is None else stop
        alive = self._alive_before(start)
        prot = np.zeros((self.n,), dtype=bool)
        prot[np.asarray(protect, dtype=np.int64)] = True
        for t in range(start, stop):
            untouched = ~self._kill[t] & ~self._revive[t]
            cur = (alive & ~self._kill[t]) | self._revive[t]
            u = self._rng.random(self.n)
            self._kill[t] |= cur & untouched & ~prot & (u < rate)
            self._revive[t] |= ~cur & untouched & (u < rate)
            alive = (alive & ~self._kill[t]) | self._revive[t]
        return self

    def partition_at(self, tick: int, groups, until: int | None = None) -> "Scenario":
        """Partition group ids from ``tick`` until ``until`` (exclusive)."""
        until = self.ticks if until is None else until
        self._partition[tick:until] = np.asarray(groups, dtype=np.int32)[None, :]
        return self

    def heal_at(self, tick: int) -> "Scenario":
        """Remove all partitions from ``tick`` onward."""
        self._partition[tick:] = 0
        return self

    def drop(self, rate: float, start: int = 0, stop: int | None = None) -> "Scenario":
        """Uniform random per-edge message drop probability over [start, stop)."""
        stop = self.ticks if stop is None else stop
        self._drop_rate[start:stop] = rate
        return self

    def manual_ping_at(self, tick: int, src: int, dst: int) -> "Scenario":
        """One manual ping (the ``ping_addrs`` API, lib.rs:268-297)."""
        self._manual[tick, src] = dst
        return self

    def _alive_before(self, tick: int) -> np.ndarray:
        alive = self._initial_alive.copy()
        for t in range(tick):
            alive = (alive & ~self._kill[t]) | self._revive[t]
        return alive

    def initial_alive(self) -> np.ndarray:
        """Alive mask to pass to ``init_state`` (bool [N])."""
        return self._initial_alive.copy()

    def alive_trajectory(self) -> np.ndarray:
        """bool [T, N]: the post-tick alive mask the tick will compute."""
        out = np.zeros((self.ticks, self.n), dtype=bool)
        alive = self._initial_alive.copy()
        for t in range(self.ticks):
            alive = (alive & ~self._kill[t]) | self._revive[t]
            out[t] = alive
        return out

    def build(self, device=None) -> TickInputs:
        """Stacked ``TickInputs`` on the card (or on ``device``)."""
        dev = resolve_device(device)
        return TickInputs(
            kill=torch.as_tensor(self._kill, device=dev),
            revive=torch.as_tensor(self._revive, device=dev),
            partition=torch.as_tensor(self._partition, device=dev),
            drop_rate=torch.as_tensor(self._drop_rate, device=dev),
            manual_target=torch.as_tensor(self._manual, device=dev),
            drop_ok=None,
        )


def all_fault_paths_scenario(
    n: int, ticks: int = 1, drop_rate: float = 0.1, revive: bool = True
) -> Scenario:
    """Every fault path live in one schedule: kill, revive/restart, a 2-way
    partition over the first half, random drop, and a manual ping per tick.

    ``revive=False`` drops only the revive event (whose rejoin runs the
    join-gossip path). The same schedule as the JAX package's."""
    if n < 4:
        raise ValueError("need n >= 4 to exercise every path")
    sc = Scenario(n, ticks).kill_at(0, [1]).drop(drop_rate)
    if revive:
        # On a 1-tick run reviving the killed peer would cancel the kill
        # (revive wins in the tick), so restart a live peer instead.
        sc.revive_at(ticks - 1, [3] if ticks == 1 else [1])
    sc.partition_at(0, np.arange(n, dtype=np.int32) % 2, until=max(1, ticks // 2))
    for t in range(ticks):
        sc.manual_ping_at(t, 0, 2)
    return sc


def baseline_scenario(config: int, n: int | None = None, ticks: int | None = None,
                      seed: int = 0) -> Scenario:
    """The five configs of BASELINE.json as scenarios (1-based).

    1. 4-peer demo mesh, fault-free.  2. 1,024 peers, no churn.
    3. 8,192 peers, 5 %/tick join+leave churn over ticks 1..T/2, peer 0
       protected.  4. 65,536 peers, fault-free.  5. 65,536 peers, 10 %
       drop + a 2-way partition over the middle third, healed for the last.
    ``n``/``ticks`` override the scale."""
    if config == 1:
        sc = Scenario(n or 4, ticks or 16, seed)
    elif config == 2:
        sc = Scenario(n or 1024, ticks or 32, seed)
    elif config == 3:
        sc = Scenario(n or 8192, ticks or 64, seed)
        sc.churn(0.05, start=1, stop=sc.ticks // 2, protect=[0])
    elif config == 4:
        sc = Scenario(n or 65536, ticks or 32, seed)
    elif config == 5:
        sc = Scenario(n or 65536, ticks or 96, seed)
        third = sc.ticks // 3
        sc.drop(0.10, stop=2 * third)
        groups = (np.arange(sc.n) % 2).astype(np.int32)
        sc.partition_at(third, groups)
        sc.heal_at(2 * third)
    else:
        raise ValueError(f"unknown baseline config {config!r} (want 1-5)")
    return sc
