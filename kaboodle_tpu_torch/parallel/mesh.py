"""Sharding layer: the N-peer axis split across the ranks of a device mesh.

The port of ``kaboodle_tpu/parallel/mesh.py``. The JAX package writes the
tick as a global-view program, places every row-indexed array with
``P('peers', ...)`` and lets GSPMD insert the collectives. PyTorch has no
partitioner, and ``torch.distributed`` is multi-controller: every rank is
a process of its own that holds its rows and runs the same program. So:

- a mesh is a ``torch.distributed`` :class:`DeviceMesh` with the dim
  ``("peers",)`` (:data:`PEER_AXIS`), one rank a device: ``cuda:<local
  rank>`` with NCCL on the card, or the CPU with gloo when the caller says
  ``device="cpu"``;
- the specs are torch's own placements: ``Shard(0)`` for the row axis of
  the ``[N, N]`` planes and ``[N]`` vectors, ``Replicate()`` for ``tick``
  and ``key`` (``inputs_specs``: the per-peer inputs row-sharded,
  ``drop_rate`` replicated). The tick does not run on DTensors: a rank
  holds its ``[N/R, N]`` rows as plain tensors (:func:`shard_state`), and
  the row-sharded tick (``phasegraph/exec.py`` built with the mesh's
  group) makes the collectives that GSPMD would insert explicit
  (``parallel/collectives.py``);
- :func:`gather_state` is the counterpart of ``np.asarray`` on a sharded
  array: every rank gets the whole state back, for saves and tests.

Each rank calls these functions with the same arguments, in the same
order; a run's metrics are the whole mesh's on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.sim.runner import _stack, converge_loop, state_agreement
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics, resolve_device

PEER_AXIS = "peers"
# How long a collective may wait for the other ranks before the group
# raises (a rank that died, or one that took another branch).
DEFAULT_TIMEOUT_S = 300.0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_device(device) -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` unless ``device`` says
    the CPU. Raises with no card and no device (``sim.state.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _init_group(device: torch.device, init_method: str, world: int, rank: int,
                timeout_s: float) -> None:
    dist.init_process_group(
        _backend(device), init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _device_mesh(device: torch.device, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def peer_group(mesh):
    """The process group of the mesh's peer axis (the row group of the tick)."""
    return mesh.get_group(PEER_AXIS)


def make_mesh(n_devices: int | None = None, device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """1-D device mesh over the peer axis: every rank of the job.

    Under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
    environment) the default group is initialised from the environment;
    with no launcher and no group yet, a one-rank group on this host.
    ``device`` is ``None`` (the card: ``cuda:<local rank>``, NCCL; raises
    with no card) or ``"cpu"`` (gloo). ``n_devices``, when given, must be
    the job's world size: every rank is a process that must join the mesh."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if {"RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
            _init_group(dev, "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                        timeout_s)
        else:
            _init_group(dev, f"tcp://127.0.0.1:{_free_port()}", 1, 0, timeout_s)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} devices; the job has {world} ranks, "
                         "and every rank must join the mesh")
    dev = _local_device(device)
    return _device_mesh(dev, (world,), (PEER_AXIS,))


def make_multihost_mesh(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """Peer-axis mesh over every rank of a multi-process (multi-host) job.

    Call once per process. With ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``, the rendezvous every process reaches) or
    ``num_processes > 1``, this process joins as rank ``process_id`` of
    ``num_processes``. With no arguments it reads ``torchrun``'s environment,
    or, on a plain single host, gives a one-rank group, as
    :func:`make_mesh` does. ``device`` as in :func:`make_mesh`: the card
    with NCCL unless ``"cpu"`` (gloo)."""
    if coordinator_address or (num_processes or 0) > 1:
        if coordinator_address is None:
            raise ValueError("a multi-process mesh needs a coordinator_address")
        if num_processes is None or process_id is None:
            raise ValueError("a multi-process mesh needs num_processes and process_id")
        init = coordinator_address
        if "://" not in init:
            init = "tcp://" + init
        if not dist.is_initialized():
            _init_group(resolve_device(device), init, int(num_processes), int(process_id),
                        timeout_s)
    return make_mesh(device=device, timeout_s=timeout_s)


def state_specs(state: MeshState | None = None) -> MeshState:
    """Placements for a ``MeshState`` on the 1-D peer mesh: the row axis
    ``Shard(0)``, ``tick`` and ``key`` ``Replicate()``. The optional planes
    get a placement only where ``state`` has them (both, with no state)."""
    row, rep = (Shard(0),), (Replicate(),)
    has_latency = state.latency is not None if state is not None else True
    has_id_view = state.id_view is not None if state is not None else True
    return MeshState(
        state=row, timer=row, alive=row, identity=row, never_broadcast=row,
        last_broadcast=row, kpr_partner=row, kpr_fp=row, kpr_n=row,
        tick=rep, key=rep,
        latency=row if has_latency else None,
        id_view=row if has_id_view else None,
    )


def inputs_specs(stacked: bool = False, with_drop_ok: bool = False) -> TickInputs:
    """Placements for ``TickInputs``; ``stacked`` adds the leading scan
    ``[T]`` axis (the row axis is then dim 1)."""
    row = (Shard(1 if stacked else 0),)
    rep = (Replicate(),)
    return TickInputs(kill=row, revive=row, partition=row, drop_rate=rep,
                      manual_target=row, drop_ok=row if with_drop_ok else None)


def _check_divisible(n: int, mesh) -> None:
    if n % mesh.size() != 0:
        raise ValueError(f"N={n} not divisible by mesh size {mesh.size()}")


def _rows(x: torch.Tensor, dim: int, row0: int, b: int, device) -> torch.Tensor:
    return x.narrow(dim, row0, b).contiguous().to(device)


def _place(obj, specs, mesh, n: int):
    """Each leaf of ``obj`` on the rank's device: its rows where its spec is
    ``Shard(d)``, whole where ``Replicate()``."""
    row0, b = C.row_range(n, peer_group(mesh))
    dev = mesh_device(mesh)
    out = {}
    for f in dataclasses.fields(obj):
        x, spec = getattr(obj, f.name), getattr(specs, f.name)
        if x is None:
            out[f.name] = None
        elif isinstance(spec[0], Shard):
            out[f.name] = _rows(x, spec[0].dim, row0, b, dev)
        else:
            out[f.name] = x.to(dev)
    return type(obj)(**out)


def shard_state(state: MeshState, mesh) -> MeshState:
    """This rank's rows of a whole ``MeshState`` (every rank passes the same
    state), on the rank's device."""
    _check_divisible(state.state.shape[0], mesh)
    return _place(state, state_specs(state), mesh, state.n)


def shard_inputs(inputs: TickInputs, mesh, stacked: bool = False) -> TickInputs:
    """This rank's rows of whole ``TickInputs`` (``stacked=True`` for ``[T, ...]``)."""
    n = inputs.kill.shape[-1]
    _check_divisible(n, mesh)
    specs = inputs_specs(stacked=stacked, with_drop_ok=inputs.drop_ok is not None)
    return _place(inputs, specs, mesh, n)


def gather_state(state: MeshState, mesh) -> MeshState:
    """The whole ``MeshState`` from every rank's rows, on every rank (the
    counterpart of ``np.asarray`` on a sharded array)."""
    group = peer_group(mesh)
    specs = state_specs(state)
    out = {}
    for f in dataclasses.fields(state):
        x, spec = getattr(state, f.name), getattr(specs, f.name)
        if x is not None and isinstance(spec[0], Shard):
            x = C.gather_rows(x, group, dim=spec[0].dim)
        out[f.name] = x
    return MeshState(**out)


def constrain_state(st: MeshState, mesh) -> MeshState:
    """Check that ``st`` is laid out as the rank's rows of the mesh.

    The JAX package pins the layout with a sharding constraint; here a
    rank's tensors ARE its rows, so this checks it instead and raises
    ``ValueError`` on a state that holds another row count (a whole state
    passed where the rank's rows belong, say). Returns ``st``."""
    n = st.n
    _, b = C.row_range(n, peer_group(mesh))
    specs = state_specs(st)
    for f in dataclasses.fields(st):
        x, spec = getattr(st, f.name), getattr(specs, f.name)
        if x is None:
            continue
        if isinstance(spec[0], Shard):
            dim = x.dim() - (2 if f.name in ("state", "timer", "latency", "id_view") else 1)
            if x.shape[dim] != b:
                raise ValueError(f"{f.name}: {x.shape[dim]} rows, the rank owns {b} of {n}")
        elif f.name == "tick" and x.dim() != st.state.dim() - 2:
            raise ValueError(f"tick: shape {tuple(x.shape)} is not replicated")
    return st


def row_matrix_sharding(mesh):
    """The ``[N, N]`` row-sharded placement, ``(Shard(0),)``, on ``mesh``."""
    del mesh
    return (Shard(0),)


def make_sharded_tick(cfg: SwimConfig, mesh, faulty: bool = True, telemetry: bool = False):
    """The row-sharded dense tick over ``mesh``'s peer axis (derived in
    ``phasegraph/derive.py::make_sharded_tick``)."""
    from kaboodle_tpu_torch.phasegraph.derive import make_sharded_tick as _derive

    return _derive(cfg, mesh, faulty=faulty, telemetry=telemetry)


def simulate_sharded(
    state: MeshState,
    inputs: TickInputs,
    cfg: SwimConfig,
    mesh,
    faulty: bool = True,
) -> tuple[MeshState, TickMetrics]:
    """Sharded twin of ``sim.runner.simulate``: the rank's rows of the state
    and of the stacked ``[T]`` inputs in, the rank's rows of the final state
    and the whole mesh's ``[T]`` metrics out."""
    tick = make_sharded_tick(cfg, mesh, faulty=faulty)
    per_tick = []
    for t in range(inputs.kill.shape[0]):
        state, m = tick(state, inputs.at(t))
        per_tick.append(m)
    return state, _stack(TickMetrics, per_tick)


def sharded_convergence_check(state: MeshState, mesh):
    """Fingerprint agreement of a row-sharded mesh without a tick: each
    rank's row fingerprints, then MIN / MAX / SUM all-reduces. Returns
    ``(converged, fp_min, fp_max, n_alive)``, equal on every rank."""
    return state_agreement(state, peer_group(mesh))


def run_until_converged_sharded(
    state: MeshState,
    cfg: SwimConfig,
    mesh,
    max_ticks: int = 64,
) -> tuple[MeshState, int, bool]:
    """Sharded twin of ``sim.runner.run_until_converged``: every rank stops
    on the same tick (the agreement test is all-reduced)."""
    tick = make_sharded_tick(cfg, mesh, faulty=False)
    return converge_loop(state, tick, max_ticks, group=peer_group(mesh))
