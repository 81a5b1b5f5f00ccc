"""The simulated mesh's state and one tick's scenario inputs, as plain tensors.

Row i of the ``[N, N]`` planes is peer i's view of the mesh: ``state[i, j]``
a peer-state code (int8: 0 not a member, 1 Known, 2 WaitingForPing, 3
WaitingForIndirectPing) and ``timer[i, j]`` the tick stamp of that code.
``latency`` (a float plane, NaN for no sample) and ``id_view`` (the
identity word peer i holds for j) are the full state's; the lean state has
neither. uint32 words are int32 tensors holding the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.hashing import u32_to_i32
from portbench.reference.rng import row_chunks

NOT_MEMBER, KNOWN, WAITING_FOR_PING, WAITING_FOR_INDIRECT_PING = 0, 1, 2, 3


@dataclasses.dataclass
class State:
    state: torch.Tensor
    timer: torch.Tensor
    alive: torch.Tensor
    identity: torch.Tensor
    never_broadcast: torch.Tensor
    last_broadcast: torch.Tensor
    kpr_partner: torch.Tensor
    kpr_fp: torch.Tensor
    kpr_n: torch.Tensor
    tick: torch.Tensor
    key: torch.Tensor
    latency: torch.Tensor | None = None
    id_view: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.state.shape[-1]


@dataclasses.dataclass
class Inputs:
    """One tick's scenario: churn, partition groups, drop rate, manual pings."""

    kill: torch.Tensor
    revive: torch.Tensor
    partition: torch.Tensor
    drop_rate: float
    manual_target: torch.Tensor


@dataclasses.dataclass
class Metrics:
    messages_delivered: torch.Tensor
    converged: torch.Tensor
    agree_fraction: torch.Tensor
    mean_membership: torch.Tensor
    fingerprint_min: torch.Tensor
    fingerprint_max: torch.Tensor


def init_state(n: int, seed: int, device, alive=None, track_latency: bool = True,
               instant_identity: bool = False, timer_dtype=torch.int32,
               fdt=torch.float32) -> State:
    """A fresh mesh: every peer knows only itself, identities ``index + 1``,
    the carried key ``(0, seed)``; ``fdt`` is the latency plane's type."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ident = idx + 1
    state = torch.empty((n, n), dtype=torch.int8, device=device)
    for r0, r1 in row_chunks(n, n):
        state[r0:r1] = (idx[None, :] == idx[r0:r1, None]).to(torch.int8) * KNOWN
    alive_t = (torch.ones((n,), dtype=torch.bool, device=device) if alive is None
               else torch.as_tensor(alive, dtype=torch.bool, device=device))
    return State(
        state=state,
        timer=torch.zeros((n, n), dtype=timer_dtype, device=device),
        alive=alive_t,
        identity=ident,
        never_broadcast=torch.ones((n,), dtype=torch.bool, device=device),
        last_broadcast=torch.zeros((n,), dtype=torch.int32, device=device),
        kpr_partner=torch.full((n,), -1, dtype=torch.int32, device=device),
        kpr_fp=torch.zeros((n,), dtype=torch.int32, device=device),
        kpr_n=torch.zeros((n,), dtype=torch.int32, device=device),
        tick=torch.zeros((), dtype=torch.int32, device=device),
        key=torch.tensor([0, u32_to_i32(seed)], dtype=torch.int32, device=device),
        latency=torch.full((n, n), float("nan"), dtype=fdt, device=device)
        if track_latency else None,
        id_view=ident[None, :].expand(n, n).clone() if not instant_identity else None,
    )


def idle(n: int, device) -> Inputs:
    return Inputs(
        kill=torch.zeros((n,), dtype=torch.bool, device=device),
        revive=torch.zeros((n,), dtype=torch.bool, device=device),
        partition=torch.zeros((n,), dtype=torch.int32, device=device),
        drop_rate=0.0,
        manual_target=torch.full((n,), -1, dtype=torch.int32, device=device),
    )
