"""Blocked-sparse mesh state: ``[N, K]`` neighbor blocks instead of ``[N, N]``.

The port of ``kaboodle_tpu/sparseplane/state.py``. Layout (the
``blocked_topk`` plane layout of the JAX package's op table):

- ``nbr_idx``   int32 ``[N, K]`` -- peer id per slot, ``-1`` for an empty slot.
- ``nbr_state`` int8  ``[N, K]`` -- spec state code per slot (``0`` = empty,
  otherwise the codes of the dense ``state`` plane: Known / WaitingForPing /
  WaitingForIndirectPing).
- ``nbr_timer`` int32 or int16 ``[N, K]`` -- last-heard tick per slot, the
  blocked twin of the dense ``timer`` plane (same lean-int16 option).
- ``seed`` / ``cursor`` -- the counter-RNG words (uint32 in the JAX package;
  0-d int32 tensors holding the same bits here, as ``sim/state.py`` holds
  ``key``): every draw is re-derived from
  ``fold_in(fold_in(PRNGKey(seed), cursor), stream)`` and the position inside
  the shaped draw encodes ``(row, slot)``, so no ``[N, N]`` tensor exists.

Row ``i``'s membership view is ``{i} ∪ occupied slots`` -- self is implicit,
mirroring the dense diagonal -- so its fingerprint is the same commutative
``peer_record_hash`` sum the dense plane computes. Every uint32 field
(``identity``, ``seed``, ``cursor``, the fingerprint metrics) is an int32
tensor holding the same bits; ``sparse_state_from_numpy`` /
``sparse_state_to_numpy`` and ``sparse_metrics_to_numpy`` carry them across
from and back to the JAX package's layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.ops.hashing import peer_record_hash, u32_to_i32, wrap32
from kaboodle_tpu_torch.sim.state import resolve_device
from kaboodle_tpu_torch.spec import KNOWN

_TIMER_DTYPES = ("int32", "int16")
_U32_FIELDS = ("identity", "seed", "cursor", "fingerprint_min", "fingerprint_max")


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    """Static knobs of a blocked-sparse mesh (hashable: a program cache key).

    ``k`` is the block width (a power of two), ``gossip_fanout`` the number
    of membership records piggybacked on each ack (the blocked twin of the
    dense anti-entropy share), ``boot_contacts`` the ring contacts seeded at
    init/revive (the gossip-boot analogue of the dense join broadcast, which
    has no domain in a blocked world).
    """

    k: int = 16
    gossip_fanout: int = 4
    boot_contacts: int = 3
    timer_dtype: str = "int32"

    def __post_init__(self) -> None:
        if self.k < 2 or (self.k & (self.k - 1)) != 0:
            raise ValueError(f"k must be a power of two >= 2, got {self.k}")
        if not 1 <= self.gossip_fanout <= self.k:
            raise ValueError(
                f"gossip_fanout must be in [1, k={self.k}], got {self.gossip_fanout}"
            )
        if not 1 <= self.boot_contacts <= self.k:
            raise ValueError(
                f"boot_contacts must be in [1, k={self.k}], got {self.boot_contacts}"
            )
        if self.timer_dtype not in _TIMER_DTYPES:
            raise ValueError(
                f"timer_dtype must be one of {_TIMER_DTYPES}, got {self.timer_dtype!r}"
            )

    @property
    def timer_torch_dtype(self) -> torch.dtype:
        return torch.int16 if self.timer_dtype == "int16" else torch.int32


@dataclasses.dataclass
class SparseState:
    """The blocked-sparse planes (see the module docstring)."""

    nbr_idx: torch.Tensor  # int32 [N, K]
    nbr_state: torch.Tensor  # int8 [N, K]
    nbr_timer: torch.Tensor  # int32|int16 [N, K]
    alive: torch.Tensor  # bool [N]
    identity: torch.Tensor  # int32 bits of uint32 [N]
    tick: torch.Tensor  # int32 []
    seed: torch.Tensor  # int32 bits of the uint32 [] counter-RNG base
    cursor: torch.Tensor  # int32 bits of the uint32 [] cursor, +1 per tick

    @property
    def n(self) -> int:
        return self.nbr_idx.shape[0]

    @property
    def k(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.nbr_idx.device

    def to(self, device) -> "SparseState":
        return dataclasses.replace(self, **{f.name: getattr(self, f.name).to(device)
                                            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class SparseTickInputs:
    """Per-tick scenario inputs -- the blocked twin of ``TickInputs``.

    No ``partition``/``drop_ok`` matrices: edge faults are counter-draw
    bernoullis against the scalar ``drop_rate``. Stacked along a leading
    ``[T]`` axis for a run."""

    kill: torch.Tensor  # bool [N]
    revive: torch.Tensor  # bool [N]
    drop_rate: torch.Tensor  # float32 []

    def at(self, t: int) -> "SparseTickInputs":
        """Tick ``t`` of stacked inputs."""
        return SparseTickInputs(kill=self.kill[t], revive=self.revive[t],
                                drop_rate=self.drop_rate[t])

    def to(self, device) -> "SparseTickInputs":
        return SparseTickInputs(kill=self.kill.to(device), revive=self.revive.to(device),
                                drop_rate=self.drop_rate.to(device))


@dataclasses.dataclass
class SparseTickMetrics:
    """Per-tick metrics, field-compatible with the dense ``TickMetrics``."""

    messages_delivered: torch.Tensor  # int32
    converged: torch.Tensor  # bool
    agree_fraction: torch.Tensor  # float32
    mean_membership: torch.Tensor  # float32
    fingerprint_min: torch.Tensor  # int32 bits of uint32
    fingerprint_max: torch.Tensor  # int32 bits of uint32
    pings_sent: torch.Tensor  # int32
    block_fill: torch.Tensor  # float32 -- mean occupied fraction over alive rows


def init_sparse_state(
    n: int,
    spec: SparseSpec,
    seed: int = 0,
    identities=None,
    alive=None,
    contacts: int | None = None,
    device=None,
) -> SparseState:
    """Fresh blocked mesh with ``contacts`` ring neighbors seeded per row.

    ``contacts`` defaults to ``spec.boot_contacts``; pass ``n - 1`` (with
    ``k >= n - 1``) for a full-view boot. ``identities`` are uint32 words
    (default: all zero, as in the JAX package). Runs on the card unless
    ``device`` names another."""
    if n < 2:
        raise ValueError(f"need at least 2 peers, got n={n}")
    b = spec.boot_contacts if contacts is None else contacts
    b = min(b, n - 1, spec.k)
    if b < 1:
        raise ValueError(f"contacts resolves to {b}; need at least 1")
    dev = resolve_device(device)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    slots = torch.arange(spec.k, dtype=torch.int64, device=dev)
    # Ring contacts i+1 .. i+b, the seeding init_state uses for its dense
    # ``ring_contacts`` -- no self-reference since b <= n - 1.
    boot = slots[None, :] < b
    idx = torch.where(boot, (rows[:, None] + 1 + slots[None, :]) % n, -1).to(torch.int32)
    st = boot.to(torch.int8).mul(KNOWN).expand(n, spec.k).contiguous()
    if identities is None:
        ident = torch.zeros((n,), dtype=torch.int32, device=dev)
    else:
        ident = torch.as_tensor(np.asarray(identities, dtype=np.uint32).view(np.int32),
                                device=dev)
    if alive is None:
        alive_t = torch.ones((n,), dtype=torch.bool, device=dev)
    else:
        alive_t = torch.as_tensor(np.asarray(alive, dtype=bool), device=dev)
    return SparseState(
        nbr_idx=idx,
        nbr_state=st,
        nbr_timer=torch.zeros((n, spec.k), dtype=spec.timer_torch_dtype, device=dev),
        alive=alive_t,
        identity=ident,
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        seed=torch.tensor(u32_to_i32(seed), dtype=torch.int32, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
    )


def sparse_idle_inputs(n: int, ticks: int | None = None, device=None) -> SparseTickInputs:
    """No churn, no drops -- a leading ``ticks`` axis when given."""
    dev = resolve_device(device)
    shape = (n,) if ticks is None else (ticks, n)
    zeros = torch.zeros(shape, dtype=torch.bool, device=dev)
    drop = torch.zeros(() if ticks is None else (ticks,), dtype=torch.float32, device=dev)
    return SparseTickInputs(kill=zeros, revive=zeros.clone(), drop_rate=drop)


def sparse_fingerprint(st: SparseState) -> torch.Tensor:
    """Per-row membership fingerprint, int32 bits of uint32 ``[N]``.

    Commutative sum of ``peer_record_hash`` over the implicit self plus every
    occupied slot -- equal to ``membership_fingerprint`` of the equivalent
    dense membership matrix."""
    n = st.n
    rows = torch.arange(n, dtype=torch.int32, device=st.device)
    safe = st.nbr_idx.clamp(0, n - 1)
    self_h = peer_record_hash(rows, st.identity)
    slot_h = peer_record_hash(safe, st.identity[safe.long()])
    occ_sum = torch.where(st.nbr_state > 0, slot_h, 0).sum(dim=1, dtype=torch.int64)
    return wrap32(self_h.to(torch.int64) + occ_sum)


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


def sparse_state_from_numpy(fields: dict, device=None) -> SparseState:
    """A ``SparseState`` from the JAX package's leaves taken through
    ``np.asarray`` (uint32 leaves arrive as uint32). On the card unless
    ``device`` names another."""
    dev = resolve_device(device)
    return SparseState(**{f.name: _from_np(fields[f.name], f.name, dev)
                          for f in dataclasses.fields(SparseState)})


def sparse_state_to_numpy(state: SparseState) -> dict:
    """The JAX package's leaf layout of ``state``: uint32 fields as uint32."""
    return {f.name: _to_np(getattr(state, f.name), f.name)
            for f in dataclasses.fields(SparseState)}


def sparse_metrics_to_numpy(metrics: SparseTickMetrics) -> dict:
    """The JAX package's layout of (stacked) metrics: fingerprints as uint32."""
    return {f.name: _to_np(getattr(metrics, f.name), f.name)
            for f in dataclasses.fields(SparseTickMetrics)}
