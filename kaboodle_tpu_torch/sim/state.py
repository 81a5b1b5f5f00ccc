"""Mesh state, per-tick inputs and per-tick metrics of the tick, as tensors.

Row i of the ``[N, N]`` planes is peer i's private view of the mesh:
``state[i, j]`` holds a spec code (int8) and ``timer[i, j]`` the tick stamp
of that code (int32, or int16 in lean mode). Everything else is ``[N]``.

The dtypes are the JAX package's, except that every uint32 field
(``identity``, ``id_view``, ``kpr_fp``, ``key``, the fingerprint metrics)
is an int32 tensor holding the same 32 bits (see ops/hashing.py).
``state_from_numpy`` / ``state_to_numpy`` and ``inputs_from_numpy`` carry
states and inputs across from and back to the JAX package's layout;
``fleet_from_numpy`` / ``fleet_to_numpy`` do the same for an ensemble
(``fleet.core.FleetState``: every leaf with a leading ``[E]`` axis).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.ops.hashing import u32_to_i32
from kaboodle_tpu_torch.ops.threefry import row_chunks
from kaboodle_tpu_torch.spec import KNOWN

_U32_FIELDS = ("identity", "kpr_fp", "key", "id_view")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names one.

    There is no silent CPU run: with no card and no explicit device this
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class MeshState:
    """Complete simulator state for N peers."""

    state: torch.Tensor  # int8  [N, N] spec state codes
    timer: torch.Tensor  # int32 [N, N] tick stamps (int16 in lean mode)
    alive: torch.Tensor  # bool  [N]
    identity: torch.Tensor  # int32 bits of uint32 [N]
    never_broadcast: torch.Tensor  # bool [N]
    last_broadcast: torch.Tensor  # int32 [N]
    kpr_partner: torch.Tensor  # int32 [N]
    kpr_fp: torch.Tensor  # int32 bits of uint32 [N]
    kpr_n: torch.Tensor  # int32 [N]
    tick: torch.Tensor  # int32 []
    key: torch.Tensor  # int32 bits of the uint32 [2] threefry key
    latency: torch.Tensor | None = None  # float32 [N, N], NaN = no sample
    id_view: torch.Tensor | None = None  # int32 bits of uint32 [N, N]

    @property
    def n(self) -> int:
        return self.state.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.state.device


@dataclasses.dataclass
class TickInputs:
    """Per-tick scenario inputs; stacked along a leading [T] axis for a run."""

    kill: torch.Tensor  # bool [N]
    revive: torch.Tensor  # bool [N]
    partition: torch.Tensor  # int32 [N]
    drop_rate: torch.Tensor  # float32 []
    manual_target: torch.Tensor  # int32 [N], -1 for none
    drop_ok: torch.Tensor | None = None  # bool [N, N]

    def at(self, t: int) -> "TickInputs":
        """Tick ``t`` of stacked inputs (``[T, ...]`` or an ensemble's ``[T, E, ...]``)."""
        return TickInputs(
            kill=self.kill[t], revive=self.revive[t], partition=self.partition[t],
            drop_rate=self.drop_rate[t], manual_target=self.manual_target[t],
            drop_ok=None if self.drop_ok is None else self.drop_ok[t],
        )


@dataclasses.dataclass
class TickMetrics:
    """Per-tick observability (stacked along [T] by ``simulate``)."""

    messages_delivered: torch.Tensor  # int32 []
    converged: torch.Tensor  # bool []
    agree_fraction: torch.Tensor  # float32 []
    mean_membership: torch.Tensor  # float32 []
    fingerprint_min: torch.Tensor  # int32 bits of uint32 []
    fingerprint_max: torch.Tensor  # int32 bits of uint32 []


def init_state(
    n: int,
    identities=None,
    seed: int = 0,
    alive=None,
    ring_contacts: int = 0,
    track_latency: bool = True,
    instant_identity: bool = False,
    timer_dtype: torch.dtype = torch.int32,
    announced: bool = False,
    device=None,
) -> MeshState:
    """Fresh mesh: every peer knows only itself (kaboodle.rs:144-152).

    The options are the JAX package's: ``ring_contacts=c`` seeds peer i with
    Known entries for peers (i+1..i+c) mod n, ``announced=True`` clears the
    never-broadcast flags, ``track_latency=False`` / ``instant_identity=True``
    drop the optional ``[N, N]`` planes, ``timer_dtype=torch.int16`` halves
    the timer plane (the tick count must stay below its max). ``identities``
    are uint32 words (default: index + 1). Runs on the card unless
    ``device`` names another."""
    dev = resolve_device(device)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if identities is None:
        ident = (idx + 1).to(torch.int32)
    else:
        ident = torch.as_tensor(np.asarray(identities, dtype=np.uint32).view(np.int32),
                                device=dev)
    if ring_contacts and ring_contacts >= n:
        raise ValueError("ring_contacts must be < n")
    # Peer i knows (i + d) mod n for d = 0..ring_contacts, written in row
    # chunks: no [N, N] temporary beside the int8 plane.
    state = torch.empty((n, n), dtype=torch.int8, device=dev)
    for r0, r1 in row_chunks(n, n):
        delta = (idx[None, :] - idx[r0:r1, None]) % n
        state[r0:r1] = (delta <= max(ring_contacts, 0)).to(torch.int8) * KNOWN
    if alive is None:
        alive_t = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        alive_t = torch.as_tensor(np.asarray(alive, dtype=bool), device=dev)
    return MeshState(
        state=state,
        timer=torch.zeros((n, n), dtype=timer_dtype, device=dev),
        alive=alive_t,
        identity=ident,
        never_broadcast=torch.full((n,), not announced, dtype=torch.bool, device=dev),
        last_broadcast=torch.zeros((n,), dtype=torch.int32, device=dev),
        kpr_partner=torch.full((n,), -1, dtype=torch.int32, device=dev),
        kpr_fp=torch.zeros((n,), dtype=torch.int32, device=dev),
        kpr_n=torch.zeros((n,), dtype=torch.int32, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        key=torch.tensor([0, u32_to_i32(seed)], dtype=torch.int32, device=dev),
        latency=torch.full((n, n), float("nan"), dtype=torch.float32, device=dev)
        if track_latency else None,
        id_view=ident[None, :].expand(n, n).clone() if not instant_identity else None,
    )


def idle_inputs(n: int, ticks: int | None = None, device=None) -> TickInputs:
    """No-fault inputs; with ``ticks`` set, stacked ``[T, ...]``."""
    dev = resolve_device(device)

    def shp(*s):
        return (ticks, *s) if ticks is not None else s

    return TickInputs(
        kill=torch.zeros(shp(n), dtype=torch.bool, device=dev),
        revive=torch.zeros(shp(n), dtype=torch.bool, device=dev),
        partition=torch.zeros(shp(n), dtype=torch.int32, device=dev),
        drop_rate=torch.zeros(shp(), dtype=torch.float32, device=dev),
        manual_target=torch.full(shp(n), -1, dtype=torch.int32, device=dev),
        drop_ok=None,
    )


def _from_np(a, field: str, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; keeps 0-d leaves 0-d
    if field in _U32_FIELDS:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(a, device=device)


def _to_np(x: torch.Tensor, field: str) -> np.ndarray:
    a = x.detach().cpu().numpy()
    if field in _U32_FIELDS:
        a = a.view(np.uint32)
    return a


def state_from_numpy(fields: dict, device=None) -> MeshState:
    """A ``MeshState`` from the JAX package's leaves taken through ``np.asarray``
    (uint32 leaves arrive as uint32; ``latency``/``id_view`` may be None)."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(MeshState):
        v = fields.get(f.name)
        kw[f.name] = None if v is None else _from_np(v, f.name, dev)
    return MeshState(**kw)


def state_to_numpy(st: MeshState) -> dict:
    """The JAX package's leaf layout of ``st``: uint32 fields as uint32."""
    return {
        f.name: None if getattr(st, f.name) is None else _to_np(getattr(st, f.name), f.name)
        for f in dataclasses.fields(MeshState)
    }


def fleet_from_numpy(fields: dict, device=None):
    """A ``FleetState`` from the JAX package's fleet leaves taken through
    ``np.asarray``: ``{"mesh": {field: [E, ...] array}, "drop_rate": [E]}``."""
    from kaboodle_tpu_torch.fleet.core import FleetState

    dev = resolve_device(device)
    return FleetState(
        mesh=state_from_numpy(fields["mesh"], device=dev),
        drop_rate=torch.as_tensor(np.array(fields["drop_rate"], dtype=np.float32), device=dev),
    )


def fleet_to_numpy(fleet) -> dict:
    """The JAX package's leaf layout of a ``FleetState`` (uint32 fields as
    uint32): ``{"mesh": {field: array}, "drop_rate": array}``."""
    return {"mesh": state_to_numpy(fleet.mesh),
            "drop_rate": fleet.drop_rate.detach().cpu().numpy()}


def inputs_from_numpy(fields: dict, device=None) -> TickInputs:
    """``TickInputs`` (single or stacked) from numpy leaves."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(TickInputs):
        v = fields.get(f.name)
        kw[f.name] = None if v is None else torch.as_tensor(np.array(v, order="C"), device=dev)
    return TickInputs(**kw)


def metrics_to_numpy(m: TickMetrics) -> dict:
    """The JAX package's metric layout: fingerprints as uint32."""
    out = {}
    for f in dataclasses.fields(TickMetrics):
        a = getattr(m, f.name).detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name.startswith("fingerprint") else a
    return out
