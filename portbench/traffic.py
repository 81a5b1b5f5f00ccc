"""The one generator of every traffic mix: a mix is a file of parameters.

A mix (``portbench/traffic/<name>.json``) says how runs start, how long a
run is and what each of its ticks carries:

- ``start``: ``"fresh"`` (each run from a fresh mesh where every peer knows
  only itself) or ``"converged"`` (each run from a mesh booted to
  fingerprint agreement in set-up);
- ``run_ticks``: a run of that many ticks, or ``until_converged: true`` for
  a boot run to agreement (tick 0 and the configuration's boot loop);
- ``repeat``: whether a run that ends starts again from its start (every run
  of a cell is then the same run, drawn from one seed);
- ``faulty``: the tick build that reads churn, partitions and drops;
- ``churn`` ``{rate, start, stop, protect}``: each tick in [start, stop) every
  live peer dies with probability ``rate`` and every dead one rejoins with
  it (peers in ``protect`` never die); ``drop`` ``{rate, start, stop}``: a
  uniform per-datagram drop; ``partition`` ``{groups, start, stop}``: peer
  i in group ``i % groups``;
- ``warm_ticks`` / ``warm_runs``: what of the cell's own traffic set-up runs
  before the window (a boot run is the window's unit, else a tick);
  ``trace_units``: units a traced run profiles.

Every draw comes from ``--seed``: the churn from ``numpy.random.default_rng
(seed)`` one ``random(N)`` per churned tick, the mesh's counter-RNG key from
the seed's low 32 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Schedule:
    """One run's per-tick inputs, stacked on a leading ``[T]`` axis (numpy)."""

    kill: np.ndarray
    revive: np.ndarray
    partition: np.ndarray
    drop_rate: np.ndarray
    manual_target: np.ndarray
    initial_alive: np.ndarray

    @property
    def ticks(self) -> int:
        return self.kill.shape[0]

    def alive_after(self) -> np.ndarray:
        """bool ``[T, N]``: the alive mask a tick sees once its churn applies."""
        out = np.zeros(self.kill.shape, dtype=bool)
        alive = self.initial_alive.copy()
        for t in range(self.ticks):
            alive = (alive & ~self.kill[t]) | self.revive[t]
            out[t] = alive
        return out


def schedule(traffic: dict, n: int, seed: int) -> Schedule | None:
    """The per-tick inputs of one run of ``traffic`` at ``n`` peers, or None
    for a boot run (idle inputs to agreement)."""
    if traffic.get("until_converged"):
        return None
    T = int(traffic["run_ticks"])
    kill = np.zeros((T, n), dtype=bool)
    revive = np.zeros((T, n), dtype=bool)
    partition = np.zeros((T, n), dtype=np.int32)
    drop_rate = np.zeros((T,), dtype=np.float32)
    manual = np.full((T, n), -1, dtype=np.int32)
    alive0 = np.ones((n,), dtype=bool)
    if "churn" in traffic:
        c = traffic["churn"]
        rng = np.random.default_rng(seed)
        prot = np.zeros((n,), dtype=bool)
        prot[np.asarray(c.get("protect", []), dtype=np.int64)] = True
        alive = alive0.copy()
        for t in range(T):
            if c["start"] <= t < c["stop"]:
                u = rng.random(n)
                kill[t] = alive & ~prot & (u < c["rate"])
                revive[t] = ~alive & (u < c["rate"])
            alive = (alive & ~kill[t]) | revive[t]
    if "drop" in traffic:
        d = traffic["drop"]
        drop_rate[d["start"]:d["stop"]] = d["rate"]
    if "partition" in traffic:
        p = traffic["partition"]
        partition[p["start"]:p["stop"]] = (np.arange(n) % p["groups"]).astype(np.int32)
    return Schedule(kill, revive, partition, drop_rate, manual, alive0)
