"""Ensemble sharding: the ``[E]`` axis (and the peer axis) over the ranks of a device mesh.

The port of ``kaboodle_tpu/fleet/sharding.py``, on the peer layer's design
(``parallel/mesh.py``): every rank a process holding its part of every
leaf as plain tensors, torch's placements as the specs, the collectives
explicit. Two layouts:

- **1-D ensemble mesh** (:func:`make_fleet_mesh`, dim ``("ensemble",)``):
  each rank holds ``E/R`` whole members. Members are independent, so the
  tick runs with no cross-rank traffic; only the fleet-wide ``any(~done)``
  of the convergence loop is all-reduced.
- **2-D ``E x peers`` mesh** (dims ``("ensemble", "peers")``): each rank
  holds ``E/Re`` members and ``N/Rp`` rows of each, ``[E/Re, N/Rp, N]``
  planes; the fleet tick runs as the row-sharded tick over the mesh's peer
  sub-group (``DeviceMesh["peers"]``), the batch axis in front.

The specs are the peer layer's ``state_specs`` with the ensemble axis in
front (``Shard(0)`` on ``ensemble``; the peer placements shifted one dim
on ``peers``), so the two layers cannot drift.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import (
    FleetState,
    fleet_converge_loop,
    fleet_idle_inputs,
)
from kaboodle_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    PEER_AXIS,
    inputs_specs,
    make_mesh,
    mesh_device,
    state_specs,
)
from kaboodle_tpu_torch.sim.runner import _stack
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics, resolve_device

ENSEMBLE_AXIS = "ensemble"


def make_fleet_mesh(
    ensemble_devices: int | None = None,
    peer_devices: int = 1,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """Device mesh for a fleet: 1-D over ``ensemble``, or 2-D ``E x peers``.

    ``peer_devices == 1`` gives the 1-D ensemble mesh over every rank of
    the job; with ``peer_devices > 1`` the ranks form
    ``(ensemble_devices, peer_devices)``, each member's peer group
    contiguous. Every rank of the job must be in the mesh (each is a
    process that runs the program), so ``ensemble_devices x peer_devices``
    must be the world size. The process group is made as
    ``parallel.make_mesh`` makes it (``device``: the card with NCCL unless
    ``"cpu"``, gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        make_mesh(device=device, timeout_s=timeout_s)
    world = dist.get_world_size()
    if ensemble_devices is None:
        if world % peer_devices != 0:
            raise ValueError(f"{world} devices not divisible by peer_devices={peer_devices}")
        ensemble_devices = world // peer_devices
    total = ensemble_devices * peer_devices
    if total > world:
        raise ValueError(f"asked for {total} devices, have {world}")
    if total != world:
        raise ValueError(f"asked for {total} devices; the job has {world} ranks, "
                         "and every rank must join the mesh")
    if peer_devices == 1:
        return init_device_mesh(dev.type, (ensemble_devices,), mesh_dim_names=(ENSEMBLE_AXIS,))
    return init_device_mesh(dev.type, (ensemble_devices, peer_devices),
                            mesh_dim_names=(ENSEMBLE_AXIS, PEER_AXIS))


def _peers(mesh) -> bool:
    return PEER_AXIS in (mesh.mesh_dim_names or ())


def _stacked(spec, peers_sharded: bool) -> tuple:
    """A peer-layer placement with the ensemble axis in front: ``Shard(0)``
    on ``ensemble``, and on ``peers`` the peer placement one dim down."""
    if not peers_sharded:
        return (Shard(0),)
    p = spec[0]
    return (Shard(0), Shard(p.dim + 1) if p.is_shard() else Replicate())


def _map(fn, obj, cls):
    return cls(**{f.name: None if getattr(obj, f.name) is None else fn(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def fleet_state_specs(fleet: FleetState | None = None, peers_sharded: bool = False) -> FleetState:
    """Placements for a ``FleetState`` (see the module docstring)."""
    base = state_specs(fleet.mesh if fleet is not None else None)
    mesh_specs = _map(lambda s: _stacked(s, peers_sharded), base, MeshState)
    drop = (Shard(0), Replicate()) if peers_sharded else (Shard(0),)
    return FleetState(mesh=mesh_specs, drop_rate=drop)


def fleet_inputs_specs(stacked: bool = False, with_drop_ok: bool = False,
                       peers_sharded: bool = False) -> TickInputs:
    """Placements for fleet ``TickInputs`` (``[E, ...]``; ``stacked`` adds the
    leading ``[T]`` axis, so every shard moves one dim down)."""
    base = inputs_specs(stacked=False, with_drop_ok=with_drop_ok)

    def spec(s):
        out = _stacked(s, peers_sharded)
        if stacked:
            out = tuple(Shard(p.dim + 1) if p.is_shard() else p for p in out)
        return out

    return _map(spec, base, TickInputs)


def _check_fleet_divisible(ensemble: int, n: int, mesh) -> None:
    e_dev = mesh.size(0)
    if ensemble % e_dev != 0:
        raise ValueError(f"E={ensemble} not divisible by ensemble mesh size {e_dev}")
    if _peers(mesh) and n % mesh.size(1) != 0:
        raise ValueError(f"N={n} not divisible by peer mesh size {mesh.size(1)}")


def _place(x: torch.Tensor, spec, mesh, dev) -> torch.Tensor:
    """This rank's block of ``x`` under the per-mesh-dim placements ``spec``."""
    coord = mesh.get_coordinate()
    for axis, p in enumerate(spec):
        if p.is_shard():
            size = x.shape[p.dim] // mesh.size(axis)
            x = x.narrow(p.dim, coord[axis] * size, size)
    return x.contiguous().to(dev)


def shard_fleet(fleet: FleetState, mesh) -> FleetState:
    """This rank's members (and rows, on a 2-D mesh) of a whole fleet."""
    _check_fleet_divisible(fleet.ensemble, fleet.n, mesh)
    specs = fleet_state_specs(fleet, _peers(mesh))
    dev = mesh_device(mesh)
    m = MeshState(**{
        f.name: None if getattr(fleet.mesh, f.name) is None
        else _place(getattr(fleet.mesh, f.name), getattr(specs.mesh, f.name), mesh, dev)
        for f in dataclasses.fields(MeshState)
    })
    return FleetState(mesh=m, drop_rate=_place(fleet.drop_rate, specs.drop_rate, mesh, dev))


def shard_fleet_inputs(inputs: TickInputs, mesh, stacked: bool = False) -> TickInputs:
    """This rank's block of whole fleet inputs (``stacked=True`` for ``[T, E, ...]``)."""
    specs = fleet_inputs_specs(stacked=stacked, with_drop_ok=inputs.drop_ok is not None,
                               peers_sharded=_peers(mesh))
    dev = mesh_device(mesh)
    return TickInputs(**{
        f.name: None if getattr(inputs, f.name) is None
        else _place(getattr(inputs, f.name), getattr(specs, f.name), mesh, dev)
        for f in dataclasses.fields(TickInputs)
    })


def gather_fleet(fleet: FleetState, mesh) -> FleetState:
    """The whole fleet from every rank's block, on every rank."""
    from kaboodle_tpu_torch.parallel.collectives import gather_rows

    specs = fleet_state_specs(fleet, _peers(mesh))

    def whole(x, spec):
        for axis in reversed(range(len(spec))):
            p = spec[axis]
            if p.is_shard():
                x = gather_rows(x, mesh.get_group(axis), dim=p.dim)
        return x

    m = MeshState(**{
        f.name: None if getattr(fleet.mesh, f.name) is None
        else whole(getattr(fleet.mesh, f.name), getattr(specs.mesh, f.name))
        for f in dataclasses.fields(MeshState)
    })
    return FleetState(mesh=m, drop_rate=whole(fleet.drop_rate, specs.drop_rate))


def make_fleet_constrainer(mesh):
    """``stacked MeshState -> the same state``, checked to be this rank's
    block of the fleet layout (the members and rows it owns): the port's
    stand-in for the JAX package's sharding constraint, shared by the
    sharded fleet tick and the sharded serve step."""
    peers = _peers(mesh)

    def constrain(st: MeshState) -> MeshState:
        if peers:
            rows = st.alive.shape[-1]
            if st.state.shape[-2] != rows or rows * mesh.size(1) != st.state.shape[-1]:
                raise ValueError(f"state holds {st.state.shape[-2]} rows, the rank owns "
                                 f"{st.state.shape[-1] // mesh.size(1)}")
        elif st.state.shape[-2] != st.state.shape[-1]:
            raise ValueError("a 1-D ensemble mesh holds whole members")
        return st

    return constrain


def fleet_vector_sharding(mesh) -> tuple:
    """Placements of per-member ``[E]`` vectors (drop knobs, generation
    counters): split along ``ensemble``, like ``drop_rate``."""
    return (Shard(0), Replicate()) if _peers(mesh) else (Shard(0),)


def peer_group_of(mesh):
    """The row group of a fleet mesh: its ``peers`` sub-group on a 2-D mesh,
    ``None`` on a 1-D one (each rank holds whole members)."""
    return mesh.get_group(PEER_AXIS) if _peers(mesh) else None


def make_sharded_fleet_tick(cfg: SwimConfig, mesh, faulty: bool = True,
                            telemetry: bool = False):
    """The fleet tick over this rank's members, its carry checked to stay
    this rank's block: the whole members on a 1-D mesh, the row-sharded
    tick over the peer sub-group on a 2-D one (full program, as the fleet
    tick is). ``telemetry=True`` is the telemetry build (per-member
    counters reduced over the peer group)."""
    from kaboodle_tpu_torch.phasegraph.exec import PALLAS_BATCH_ERROR, make_tick_fn

    if cfg.use_pallas_fp or cfg.use_pallas_oldest_k or cfg.use_pallas_suspicion:
        raise ValueError(PALLAS_BATCH_ERROR)
    vtick = make_tick_fn(dataclasses.replace(cfg, fast_path=False), faulty=faulty,
                         program="full", telemetry=telemetry, group=peer_group_of(mesh))
    constrain = make_fleet_constrainer(mesh)

    def sharded_tick(st: MeshState, inp: TickInputs):
        st, m = vtick(st, inp)
        return constrain(st), m

    return sharded_tick


def simulate_fleet_sharded(
    fleet: FleetState,
    inputs: TickInputs,
    cfg: SwimConfig,
    mesh,
    faulty: bool = True,
) -> tuple[FleetState, TickMetrics]:
    """Sharded twin of ``fleet.simulate_fleet``: this rank's block of the
    fleet and of the ``[T, E, ...]`` inputs in; its block of the final
    fleet and its members' ``[T, E/Re]`` metrics out."""
    tick = make_sharded_fleet_tick(cfg, mesh, faulty=faulty)
    state, rows = fleet.mesh, []
    for t in range(inputs.kill.shape[0]):
        state, m = tick(state, inputs.at(t))
        rows.append(m)
    return dataclasses.replace(fleet, mesh=state), _stack(TickMetrics, rows)


def run_fleet_until_converged_sharded(
    fleet: FleetState,
    cfg: SwimConfig,
    mesh,
    max_ticks: int = 64,
    faulty: bool = False,
):
    """Sharded twin of ``fleet.run_fleet_until_converged``: the masked loop
    over this rank's members, its fleet-wide ``any(~done)`` all-reduced
    over every rank, so all ranks tick the same number of times. Returns
    this rank's block of the fleet and its members' ``conv_tick`` and
    ``done``."""
    tick = make_sharded_fleet_tick(cfg, mesh, faulty=faulty)
    rows = fleet.mesh.state.shape[-2]
    idle = fleet_idle_inputs(rows, fleet.ensemble, drop_rate=fleet.drop_rate,
                             device=fleet.mesh.device)
    new_mesh, conv_tick, done = fleet_converge_loop(fleet.mesh, tick, idle, max_ticks,
                                                    group=peer_group_of(mesh),
                                                    any_group=dist.group.WORLD)
    return dataclasses.replace(fleet, mesh=new_mesh), conv_tick, done
