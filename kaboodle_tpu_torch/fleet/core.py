"""Batched ensemble simulation: E independent SWIM meshes as one tensor axis.

The port of ``kaboodle_tpu/fleet/core.py``. A :class:`FleetState` stacks E
complete ``MeshState``s along a leading ``[E]`` axis and one tick call
advances all of them: the dense tick of ``phasegraph/exec.py`` takes the
batch axis itself (``phasegraph/derive.py::make_fleet_tick``), so the
single-mesh tick at small N -- bound by launches and host syncs -- does E
meshes' work per launch and per sync.

Members share every static property (N, protocol config, state variant)
and vary in what is data: the per-member PRNG key (seed axis) and the
per-member ``drop_rate`` knob. An A/B over a static ``SwimConfig`` flag is
two fleets.

Parity contract (``tests/test_torch_fleet.py``): member k of a fleet is
bit-exact with a standalone single-mesh run from ``init_state(n,
seed=seeds[k])`` and with member k of the JAX package's fleet. Convergence-
bounded runs use a masked loop (:func:`fleet_converge_loop`): the fleet
ticks while any member is unconverged, a member that has converged is
frozen at exactly the tick it converged (:func:`freeze_members`), and its
convergence tick is recorded on the device in an ``[E]`` vector. The
loop's host predicate is fetched once a tick.

Entry points run on the card unless ``device`` names another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops.hashing import u32_to_i32
from kaboodle_tpu_torch.sim.runner import _stack, state_agreement
from kaboodle_tpu_torch.sim.state import (
    MeshState,
    TickInputs,
    TickMetrics,
    idle_inputs,
    init_state,
    resolve_device,
)
from kaboodle_tpu_torch.telemetry.counters import ProtocolCounters, TickTelemetry


@dataclasses.dataclass
class FleetState:
    """E stacked meshes + the per-member knob vector.

    ``mesh`` is a ``MeshState`` whose every leaf carries a leading ``[E]``
    axis (``state``: int8 ``[E, N, N]``, ``tick``: int32 ``[E]``, ``key``:
    ``[E, 2]``, ...). ``drop_rate`` is the per-member uniform message-drop
    knob of faulty runs (float32 ``[E]``; inert under ``faulty=False``).
    """

    mesh: MeshState
    drop_rate: torch.Tensor  # float32 [E]

    @property
    def ensemble(self) -> int:
        return self.mesh.alive.shape[0]

    @property
    def n(self) -> int:
        return self.mesh.state.shape[-1]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def init_fleet(
    n: int,
    ensemble: int,
    seeds=None,
    drop_rates=None,
    device=None,
    **init_state_kwargs,
) -> FleetState:
    """Fresh E-member fleet: member e is ``init_state(n, seed=seeds[e])``.

    All non-key state is the same across members at init (one mesh,
    broadcast); the per-member keys are ``prng_key(seeds[e])``, the keys the
    standalone inits would hold. ``seeds`` defaults to ``0..E-1``,
    ``drop_rates`` to all-zero. ``init_state_kwargs`` pass through
    (``ring_contacts``, ``track_latency``, ``instant_identity``,
    ``timer_dtype``, ``announced``): the lean-state knobs matter at fleet
    scale, the resident being E times one mesh. On the card unless
    ``device`` names another."""
    if ensemble < 1:
        raise ValueError("need ensemble >= 1")
    seeds = np.arange(ensemble, dtype=np.int64) if seeds is None else _host(seeds)
    if seeds.shape != (ensemble,):
        raise ValueError(f"seeds must be [{ensemble}], got {seeds.shape}")
    drop_rates = (np.zeros((ensemble,), dtype=np.float32) if drop_rates is None
                  else _host(drop_rates).astype(np.float32))
    if drop_rates.shape != (ensemble,):
        raise ValueError(f"drop_rates must be [{ensemble}], got {drop_rates.shape}")
    dev = resolve_device(device)
    base = init_state(n, seed=0, device=dev, **init_state_kwargs)
    stacked = {
        f.name: None if getattr(base, f.name) is None
        else getattr(base, f.name)[None].expand(ensemble, *getattr(base, f.name).shape).contiguous()
        for f in dataclasses.fields(MeshState)
    }
    stacked["key"] = torch.tensor([[0, u32_to_i32(int(s))] for s in seeds],
                                  dtype=torch.int32, device=dev)
    return FleetState(mesh=MeshState(**stacked),
                      drop_rate=torch.as_tensor(drop_rates, device=dev))


def _map_mesh(fn, *meshes: MeshState) -> MeshState:
    """Leafwise ``fn`` over MeshStates (``None`` leaves stay ``None``)."""
    return MeshState(**{
        f.name: None if getattr(meshes[0], f.name) is None
        else fn(*(getattr(m, f.name) for m in meshes))
        for f in dataclasses.fields(MeshState)
    })


def member_state(fleet: FleetState, e: int) -> MeshState:
    """Member ``e``'s mesh as a standalone (unstacked) ``MeshState``."""
    return _map_mesh(lambda x: x[e], fleet.mesh)


def _map_inputs(fn, *inputs: TickInputs) -> TickInputs:
    return TickInputs(**{
        f.name: None if getattr(inputs[0], f.name) is None
        else fn(*(getattr(i, f.name) for i in inputs))
        for f in dataclasses.fields(TickInputs)
    })


def fleet_idle_inputs(
    n: int,
    ensemble: int,
    ticks: int | None = None,
    drop_rate=None,
    device=None,
) -> TickInputs:
    """No-fault per-member inputs, ``[E, ...]`` (``[T, E, ...]`` with ticks).

    ``drop_rate`` is the per-member knob vector (float32 ``[E]``, default
    zero), broadcast along the tick axis when ``ticks`` is given. Derived
    from the single-mesh ``idle_inputs`` by broadcasting (views: the tick
    never writes its inputs), so a new ``TickInputs`` field keeps one idle
    definition. On the card unless ``device`` names another."""
    dev = resolve_device(device)
    if drop_rate is None:
        drop_rate = torch.zeros((ensemble,), dtype=torch.float32, device=dev)
    drop_rate = torch.as_tensor(drop_rate, dtype=torch.float32, device=dev)
    inputs = dataclasses.replace(
        _map_inputs(lambda x: x[None].expand(ensemble, *x.shape), idle_inputs(n, device=dev)),
        drop_rate=drop_rate,
    )
    if ticks is not None:
        inputs = _map_inputs(lambda x: x[None].expand(ticks, *x.shape), inputs)
    return inputs


def stack_member_inputs(inputs: list[TickInputs]) -> TickInputs:
    """Stack per-member ``TickInputs`` (e.g. from the Scenario DSL) along a
    new ``[E]`` axis. Stacked-[T] schedules stack to ``[E, T, ...]`` -- pass
    them through :func:`scan_axis_first` before :func:`simulate_fleet`."""
    return _map_inputs(lambda *xs: torch.stack(xs, dim=0), *inputs)


def scan_axis_first(inputs: TickInputs) -> TickInputs:
    """``[E, T, ...]`` member-major inputs -> the ``[T, E, ...]`` run layout."""
    return _map_inputs(lambda x: x.transpose(0, 1), inputs)


def freeze_members(active: torch.Tensor, old: MeshState, new: MeshState) -> MeshState:
    """Per-member carry select: advance to ``new`` where ``active[e]``.

    A member with ``active[e] == False`` keeps EVERY leaf of its old carry
    (state, timers, tick counter, PRNG key), so its trajectory is bit-
    identical to never having taken the tick. Used by
    :func:`fleet_converge_loop` (freezing converged members) and, in the
    JAX package, by the per-member warp runner."""
    ensemble = active.shape[0]

    def sel(o, n):
        return torch.where(active.view(ensemble, *([1] * (n.dim() - 1))), n, o)

    return _map_mesh(sel, old, new)


def make_fleet_tick_fn(cfg: SwimConfig, faulty: bool = True, telemetry: bool = False):
    """The fleet tick: the dense tick over the ``[E]`` axis, full program only
    (``phasegraph/derive.py::make_fleet_tick``). ``telemetry=True`` returns
    per-member ``TickTelemetry`` (counters ``[E]``, digests ``[E, N]``),
    member e bit-exact with a standalone telemetry tick."""
    from kaboodle_tpu_torch.phasegraph.derive import make_fleet_tick

    return make_fleet_tick(cfg, faulty=faulty, telemetry=telemetry)


def simulate_fleet(
    fleet: FleetState,
    inputs: TickInputs,
    cfg: SwimConfig,
    faulty: bool = True,
    telemetry: bool = False,
) -> tuple[FleetState, TickMetrics | TickTelemetry]:
    """Run the fleet tick over ``[T, E, ...]`` stacked inputs.

    The ensemble twin of ``sim.runner.simulate``: returns the final fleet
    and per-tick per-member metrics (``TickMetrics`` leaves ``[T, E]``), or
    with ``telemetry=True`` the stacked ``TickTelemetry`` (metrics and
    ``ProtocolCounters`` ``[T, E]``, digests ``[T, E, N]``)."""
    vtick = make_fleet_tick_fn(cfg, faulty=faulty, telemetry=telemetry)
    mesh, rows = fleet.mesh, []
    for t in range(inputs.kill.shape[0]):
        mesh, out = vtick(mesh, inputs.at(t))
        rows.append(out)
    if telemetry:
        out = TickTelemetry(
            metrics=_stack(TickMetrics, [r.metrics for r in rows]),
            counters=_stack(ProtocolCounters, [r.counters for r in rows]),
            fp=torch.stack([r.fp for r in rows]),
        )
    else:
        out = _stack(TickMetrics, rows)
    return dataclasses.replace(fleet, mesh=mesh), out


def fleet_converge_loop(
    mesh: MeshState,
    vtick,
    idle: TickInputs,
    max_ticks: int,
    group=None,
    any_group=None,
) -> tuple[MeshState, torch.Tensor, torch.Tensor]:
    """Masked loop of a fleet tick until every member agrees.

    The ensemble form of ``sim.runner.converge_loop``: the loop runs while
    any member is unconverged and fewer than ``max_ticks`` ticks have run
    (one host fetch a tick), and a converged member's carry is frozen by an
    ``[E]``-mask select, so its state stops at exactly the end-of-tick state
    where its fingerprints first agreed.

    Returns ``(final_mesh, conv_tick, converged)``: ``conv_tick[e]`` is the
    tick count at which member e converged (== the standalone run's
    ``ticks_run``), ``max_ticks`` where it never did. Agreement is also
    tested at entry: a member converged at tick 0 freezes at once and
    reports ``conv_tick == 0``.

    On a mesh of ranks (``fleet/sharding.py``), ``group`` is the row group
    the members' rows are sharded over (agreement all-reduced over it) and
    ``any_group`` the group the loop's ``any(~done)`` is all-reduced over,
    so every rank runs the same ticks."""
    from kaboodle_tpu_torch.parallel.collectives import global_any

    done = state_agreement(mesh, group)[0]
    conv_tick = torch.where(
        done, 0, torch.full_like(done, max_ticks, dtype=torch.int32)).to(torch.int32)
    i = 0
    while i < max_ticks and bool(global_any(~done, any_group)):
        new, m = vtick(mesh, idle)
        mesh = freeze_members(~done, mesh, new)
        conv_tick = torch.where(~done & m.converged, i + 1, conv_tick).to(torch.int32)
        done = done | m.converged
        i += 1
    return mesh, conv_tick, done


def run_fleet_until_converged(
    fleet: FleetState,
    cfg: SwimConfig,
    max_ticks: int = 64,
    faulty: bool = False,
) -> tuple[FleetState, torch.Tensor, torch.Tensor]:
    """Tick the whole fleet until every member converges (or ``max_ticks``).

    Each member's convergence tick is recorded on the device (``[E]``
    int32, for ``fleet/stats.py``). ``faulty=False`` is the fault-free
    build (``fleet.drop_rate`` inert, the ``run_until_converged`` twin);
    ``faulty=True`` is the fault build, whose per-member ``drop_rate`` gates
    delivery -- the drop-rate sweep's mode (``fleet/bench.py``)."""
    vtick = make_fleet_tick_fn(cfg, faulty=faulty)
    idle = fleet_idle_inputs(fleet.n, fleet.ensemble, drop_rate=fleet.drop_rate,
                             device=fleet.mesh.device)
    mesh, conv_tick, done = fleet_converge_loop(fleet.mesh, vtick, idle, max_ticks)
    return dataclasses.replace(fleet, mesh=mesh), conv_tick, done
