"""The entry-point registry: every program family the port dispatches.

The port of ``kaboodle_tpu/analysis/ir/registry.py``, with its 31 names in
its order. Each :class:`EntryPoint` builds one program family at toy scale
(``TRACE_N = 32``: the program's structure does not depend on N) on the
port's engine that the JAX entry builds on, with the same example
arguments. ``costscope`` walks it (``costscope/extract.py``); the tests
hold every entry's outputs to the JAX entry's.

``build(device)`` returns ``(fn, example_args)``: on the card unless
``device`` names another (``device="cpu"``), as every entry point of the
port. Two differences from the JAX registry, both for the port's card:

- the one-mesh dense tick entries and the sharded tick run with the three
  kernel flags on (:data:`KERNEL_FLAGS`), the port's card path: the hand
  kernels are bit-exact with the formulations the JAX entries run with
  their flags off, and each is one unit of the costscope counter. The
  fleet, serve and leap entries keep them off (the fleet refuses them;
  the leaps, the blocked and the sparse tick have no kernel);
- a ``sharded=True`` entry needs a process group: its mesh is every rank
  of the job (``parallel.make_mesh``; a one-rank group of its own when
  there is none). Its ``fn`` takes and returns this rank's blocks, and
  ``fn.gather(out, args)`` brings an output whole onto every rank.

:func:`output_arrays` flattens an output (the port's tensors, or any
array-likes in the same dataclasses) into named numpy arrays. This module
imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

TRACE_N = 32  # toy trace scale; program structure is N-independent
TRACE_E = 4  # fleet ensemble width at trace scale
LEAP_K = 8  # leap span length traced (one representative power of two)
# The kernel flags of the entries whose engine runs the hand kernels.
KERNEL_FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One program entry point: ``build(device) -> (fn, example_args)``.

    ``lean`` marks the int16-timer programs (KB401's widening pass),
    ``sharded`` the programs over a process group (their records carry the
    collectives' bytes; KB404). ``const_budget_bytes`` is KB403's threshold
    for a tensor made from host data inside the call, the JAX registry's:
    4,096 bytes, 2,048 for ``ops.crc32``."""

    name: str
    build: Callable[..., tuple[Callable, tuple]]
    lean: bool = False
    sharded: bool = False
    const_budget_bytes: int = 4096


def _cfg(kernels: bool = False, **kw):
    from kaboodle_tpu_torch.config import SwimConfig

    return SwimConfig(deterministic=True, **(KERNEL_FLAGS if kernels else {}), **kw)


def _full_state(device, n: int = TRACE_N):
    from kaboodle_tpu_torch.sim.state import init_state

    return init_state(n, seed=0, device=device)


def _lean_state(device, n: int = TRACE_N, converged: bool = False):
    import torch

    from kaboodle_tpu_torch.sim.state import init_state

    return init_state(
        n,
        seed=0,
        timer_dtype=torch.int16,
        track_latency=False,
        instant_identity=True,
        ring_contacts=n - 1 if converged else 0,
        announced=converged,
        device=device,
    )


def _converged_state(device, n: int = TRACE_N):
    from kaboodle_tpu_torch.sim.state import init_state

    return init_state(n, seed=0, ring_contacts=n - 1, announced=True, device=device)


def _idle(device, n: int = TRACE_N):
    from kaboodle_tpu_torch.sim.state import idle_inputs

    return idle_inputs(n, device=device)


# -- builders ---------------------------------------------------------------
# Every tick/leap builder goes through kaboodle_tpu_torch.phasegraph.derive,
# the one place the engines are assembled.


def _tick_faulty(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    return make_dense_tick(_cfg(True), faulty=True), (_full_state(device), _idle(device))


def _tick_faultfree(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    return make_dense_tick(_cfg(True), faulty=False), (_full_state(device), _idle(device))


def _tick_fused(device=None):
    # The fused program alone, with no dispatch guard.
    from kaboodle_tpu_torch.phasegraph.derive import make_fused_tick

    return make_fused_tick(_cfg(True), faulty=True), (_full_state(device), _idle(device))


def _tick_lean(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    return make_dense_tick(_cfg(True), faulty=False), (_lean_state(device), _idle(device))


def _tick_random(device=None):
    # deterministic=False: the real counter-keyed sampling draws.
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    cfg = SwimConfig(deterministic=False, **KERNEL_FLAGS)
    return make_dense_tick(cfg, faulty=True), (_full_state(device), _idle(device))


def _tick_blocked(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_chunked_tick

    fn = make_chunked_tick(_cfg(), faulty=True, block=TRACE_N // 2)
    return fn, (_full_state(device), _idle(device))


def _sparse_build(timer_dtype: str, device):
    # The blocked_topk steady tick: [N, K] neighbor blocks + counter-based
    # draws, with a sparse-legal config (join broadcast off).
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.phasegraph.derive import make_sparse_tick
    from kaboodle_tpu_torch.sparseplane import (
        SparseSpec,
        init_sparse_state,
        sparse_idle_inputs,
    )

    cfg = SwimConfig(deterministic=False, join_broadcast_enabled=False)
    spec = SparseSpec(k=8, gossip_fanout=2, boot_contacts=2, timer_dtype=timer_dtype)
    fn = make_sparse_tick(cfg, spec, faulty=True)
    return fn, (init_sparse_state(TRACE_N, spec, seed=0, device=device),
                sparse_idle_inputs(TRACE_N, device=device))


def _tick_sparse(device=None):
    return _sparse_build("int32", device)


def _tick_sparse_lean(device=None):
    return _sparse_build("int16", device)


def _tick_telemetry(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    return (make_dense_tick(_cfg(True), faulty=True, telemetry=True),
            (_full_state(device), _idle(device)))


def _tick_telemetry_lean(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick

    return (make_dense_tick(_cfg(True), faulty=False, telemetry=True),
            (_lean_state(device), _idle(device)))


def _tick_blocked_telemetry(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_chunked_tick

    fn = make_chunked_tick(_cfg(), faulty=True, block=TRACE_N // 2, telemetry=True)
    return fn, (_full_state(device), _idle(device))


def _tick_fleet_telemetry(device=None):
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_fleet_tick

    fleet = init_fleet(TRACE_N // 2, TRACE_E, device=device)
    inputs = fleet_idle_inputs(TRACE_N // 2, TRACE_E, device=device)
    return make_fleet_tick(_cfg(), faulty=True, telemetry=True), (fleet.mesh, inputs)


def _recorder_scan_telemetry(device=None):
    # The converged-run body: the telemetry tick + the flight-recorder ring.
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick
    from kaboodle_tpu_torch.telemetry.recorder import init_recorder, record_tick

    tick = make_dense_tick(_cfg(True), faulty=False, telemetry=True)
    rec0 = init_recorder(8, TRACE_N, device=device)

    def tick_and_record(st, inp, rec):
        st, out = tick(st, inp)
        return st, record_tick(rec, st.tick - 1, out)

    return tick_and_record, (_full_state(device), _idle(device), rec0)


def _leap(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    return make_warp_leap(_cfg(), LEAP_K), (_converged_state(device),)


def _leap_lean(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    return make_warp_leap(_cfg(), LEAP_K), (_lean_state(device, converged=True),)


def _leap_hybrid(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    return make_warp_leap(_cfg(), LEAP_K, hybrid=True), (_converged_state(device),)


def _leap_hybrid_lean(device=None):
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    return (make_warp_leap(_cfg(), LEAP_K, hybrid=True),
            (_lean_state(device, converged=True),))


def _masked_fleet_leap(device, k_m):
    # The masked hybrid leap over the ensemble axis (the JAX entry vmaps
    # it; the port's leap takes the leading [E] axis itself).
    import torch

    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    n = TRACE_N // 2
    fleet = init_fleet(n, TRACE_E, ring_contacts=n - 1, announced=True, device=device)
    leap = make_warp_leap(_cfg(), LEAP_K, hybrid=True, masked=True)
    return leap, (fleet.mesh, torch.tensor(k_m, dtype=torch.int32, device=fleet.mesh.device))


def _leap_fleet_masked(device=None):
    return _masked_fleet_leap(device, [LEAP_K // 2] * TRACE_E)


def _lane_vectors(e: int, device):
    import torch

    return (
        torch.ones((e,), dtype=torch.bool, device=device),  # active
        torch.ones((e,), dtype=torch.bool, device=device),  # until_conv
        torch.full((e,), 16, dtype=torch.int32, device=device),  # remaining
        torch.zeros((e,), dtype=torch.int32, device=device),  # ticks_run
        torch.full((e,), -1, dtype=torch.int32, device=device),  # conv_tick
    )


def _serve_step(device=None, telemetry: bool = False):
    # The serve pool's resident chunk program.
    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_serve_step

    fleet = init_fleet(TRACE_N // 2, TRACE_E, device=device)
    fn = make_serve_step(_cfg(), chunk=4, telemetry=telemetry)
    return fn, (fleet.mesh, fleet.drop_rate, *_lane_vectors(TRACE_E, fleet.mesh.device))


def _serve_step_telemetry(device=None):
    return _serve_step(device, telemetry=True)


def _serve_reseed(device=None):
    # The retire/re-seed program: a fresh init_state written into a lane
    # (in place, as the port's pool does) + the generation bump. The lane,
    # seed and drop knob are host numbers, as the pool passes them.
    import torch

    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.serve.pool import make_reseed_fn

    n = TRACE_N // 2
    fleet = init_fleet(n, TRACE_E, device=device)
    dev = fleet.mesh.device
    generation = torch.zeros((TRACE_E,), dtype=torch.int32, device=dev)
    fn = make_reseed_fn(n)
    return fn, (fleet.mesh, generation, fleet.drop_rate, 0, 0, 0.0)


def _fleet_mesh(device, peer_devices: int = 1):
    """A fleet mesh over every rank (1-D ``ensemble``, or ``E x peers`` with
    ``peer_devices`` > 1 where the world divides), and the ensemble width
    the JAX entry takes: ``max(TRACE_E, world)``."""
    import torch.distributed as dist

    from kaboodle_tpu_torch.fleet.sharding import make_fleet_mesh
    from kaboodle_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        make_mesh(device=device)
    world = dist.get_world_size()
    peers = peer_devices if world % peer_devices == 0 else 1
    mesh = make_fleet_mesh(world // peers, peers, device=device)
    return mesh, max(TRACE_E, world)  # E must divide across the mesh


def _whole_fleet_state(mesh):
    """``whole(st, drop_rate)``: the whole stacked state of a fleet from every
    rank's block."""
    from kaboodle_tpu_torch.fleet.core import FleetState
    from kaboodle_tpu_torch.fleet.sharding import gather_fleet

    def gather(st, drop_rate):
        return gather_fleet(FleetState(mesh=st, drop_rate=drop_rate), mesh).mesh

    return gather


def _serve_step_sharded(device=None):
    # The ShardedLanePool's chunk program on the 1-D ensemble mesh: this
    # rank's lanes of the state, the whole [E] run vectors.
    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.fleet.sharding import shard_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_sharded_serve_step

    mesh, e = _fleet_mesh(device)
    fleet = shard_fleet(init_fleet(TRACE_N // 2, e, device=device), mesh)
    step = make_sharded_serve_step(_cfg(), 4, mesh)
    whole = _whole_fleet_state(mesh)

    def fn(st, drop_rate, *lanes):
        return step(st, drop_rate, *lanes)

    fn.gather = lambda out, args: (whole(out[0], args[1]), out[1])
    return fn, (fleet.mesh, fleet.drop_rate, *_lane_vectors(e, fleet.mesh.device))


def _serve_leap(device=None):
    # The serve engine's warped-lane dispatch: the masked fleet leap with
    # horizon lanes fast-forwarding and k_m == 0 lanes frozen.
    return _masked_fleet_leap(device, [LEAP_K, 0, LEAP_K // 2, 0])


def _tick_fleet(device=None):
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet
    from kaboodle_tpu_torch.phasegraph.derive import make_fleet_tick

    fleet = init_fleet(TRACE_N // 2, TRACE_E, device=device)
    inputs = fleet_idle_inputs(TRACE_N // 2, TRACE_E, device=device)
    return make_fleet_tick(_cfg(), faulty=True), (fleet.mesh, inputs)


def _tick_sharded(device=None):
    from kaboodle_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        shard_inputs,
        shard_state,
    )
    from kaboodle_tpu_torch.phasegraph.derive import make_sharded_tick

    mesh = make_mesh(device=device)
    tick = make_sharded_tick(_cfg(True), mesh, faulty=False)

    def fn(st, inp):
        return tick(st, inp)

    fn.gather = lambda out, args: (gather_state(out[0], mesh), out[1])
    return fn, (shard_state(_full_state(device), mesh), shard_inputs(_idle(device), mesh))


def _leap_sharded(device=None):
    from kaboodle_tpu_torch.parallel.mesh import (
        constrain_state,
        gather_state,
        make_mesh,
        peer_group,
        shard_state,
    )
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap

    mesh = make_mesh(device=device)
    leap = make_warp_leap(_cfg(), LEAP_K, group=peer_group(mesh))

    def fn(st):
        return constrain_state(leap(st), mesh)

    fn.gather = lambda out, args: gather_state(out, mesh)
    return fn, (shard_state(_converged_state(device), mesh),)


def _tick_fleet_sharded(device=None):
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet
    from kaboodle_tpu_torch.fleet.sharding import (
        ENSEMBLE_AXIS,
        make_sharded_fleet_tick,
        shard_fleet,
        shard_fleet_inputs,
    )
    from kaboodle_tpu_torch.parallel.collectives import gather_rows
    from kaboodle_tpu_torch.sim.state import TickMetrics

    # The E x peers mesh: on a 1-D ensemble mesh the port's fleet tick
    # makes no collective at all (each rank holds whole members; the JAX
    # partitioner all-gathers an [E, N, N] int32 plane there), so the entry
    # takes the layout whose cross-rank bytes the audit can see.
    mesh, e = _fleet_mesh(device, peer_devices=2)
    fleet = shard_fleet(init_fleet(TRACE_N // 2, e, device=device), mesh)
    inputs = shard_fleet_inputs(fleet_idle_inputs(TRACE_N // 2, e, device=device), mesh)
    tick = make_sharded_fleet_tick(_cfg(), mesh, faulty=True)
    whole = _whole_fleet_state(mesh)
    group = mesh.get_group(ENSEMBLE_AXIS)

    def fn(st, inp):
        return tick(st, inp)

    def gather(out, args):
        m = TickMetrics(**{f.name: gather_rows(getattr(out[1], f.name), group, dim=0)
                           for f in dataclasses.fields(TickMetrics)})
        return whole(out[0], fleet.drop_rate), m

    fn.gather = gather
    return fn, (fleet.mesh, inputs)


def _ops_fused_fp(device=None):
    import torch

    from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count
    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    n = 128  # the JAX kernels' lane alignment (n % 128 == 0)
    return (
        lambda s, i: fused_fp_count(s, i),
        (torch.zeros((n, n), dtype=torch.int8, device=dev),
         torch.ones((n,), dtype=torch.int32, device=dev)),
    )


def _ops_fused_oldest_k(device=None):
    import torch

    from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k
    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    n = 128
    return (
        lambda s, t, a: fused_oldest_k(s, t, a, 5),
        (torch.zeros((n, n), dtype=torch.int8, device=dev),
         torch.zeros((n, n), dtype=torch.int32, device=dev),
         torch.ones((n,), dtype=torch.bool, device=dev)),
    )


def _ops_fused_suspicion(device=None):
    import torch

    from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion
    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    n = 128
    return (
        lambda s, t, a, th: fused_suspicion(s, t, a, th),
        (torch.zeros((n, n), dtype=torch.int8, device=dev),
         torch.zeros((n, n), dtype=torch.int32, device=dev),
         torch.ones((n,), dtype=torch.bool, device=dev),
         torch.tensor(0, dtype=torch.int32, device=dev)),
    )


def _ops_crc32(device=None):
    import torch

    from kaboodle_tpu_torch.ops.crc32 import membership_crc32
    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    n = 16  # the byte scan is O(N) steps; keep it small
    return (
        membership_crc32,
        (torch.ones((n, n), dtype=torch.bool, device=dev),
         torch.ones((n,), dtype=torch.int32, device=dev)),
    )


ENTRY_POINTS: tuple[EntryPoint, ...] = (
    EntryPoint("phasegraph.tick.faulty", _tick_faulty),
    EntryPoint("phasegraph.tick.faultfree", _tick_faultfree),
    EntryPoint("phasegraph.tick.fused", _tick_fused),
    EntryPoint("phasegraph.tick.lean", _tick_lean, lean=True),
    EntryPoint("phasegraph.tick.random", _tick_random),
    EntryPoint("phasegraph.tick.blocked", _tick_blocked),
    EntryPoint("phasegraph.tick.sparse", _tick_sparse),
    EntryPoint("phasegraph.tick.sparse.lean", _tick_sparse_lean, lean=True),
    EntryPoint("phasegraph.tick.telemetry", _tick_telemetry),
    EntryPoint("phasegraph.tick.telemetry.lean", _tick_telemetry_lean, lean=True),
    EntryPoint("phasegraph.tick.blocked.telemetry", _tick_blocked_telemetry),
    EntryPoint("phasegraph.tick.fleet.telemetry", _tick_fleet_telemetry),
    EntryPoint("sim.recorder.telemetry", _recorder_scan_telemetry),
    EntryPoint("phasegraph.leap", _leap),
    EntryPoint("phasegraph.leap.lean", _leap_lean, lean=True),
    EntryPoint("phasegraph.leap.hybrid", _leap_hybrid),
    EntryPoint("phasegraph.leap.hybrid.lean", _leap_hybrid_lean, lean=True),
    EntryPoint("phasegraph.leap.fleet", _leap_fleet_masked),
    EntryPoint("phasegraph.tick.fleet", _tick_fleet),
    EntryPoint("phasegraph.serve.step", _serve_step),
    EntryPoint("phasegraph.serve.step.telemetry", _serve_step_telemetry),
    EntryPoint("phasegraph.serve.step.sharded", _serve_step_sharded, sharded=True),
    EntryPoint("serve.reseed", _serve_reseed),
    EntryPoint("serve.leap", _serve_leap),
    EntryPoint("phasegraph.tick.sharded", _tick_sharded, sharded=True),
    EntryPoint("phasegraph.leap.sharded", _leap_sharded, sharded=True),
    EntryPoint("phasegraph.tick.fleet.sharded", _tick_fleet_sharded, sharded=True),
    EntryPoint("ops.fused_fp", _ops_fused_fp),
    EntryPoint("ops.fused_oldest_k", _ops_fused_oldest_k),
    EntryPoint("ops.fused_suspicion", _ops_fused_suspicion),
    EntryPoint("ops.crc32", _ops_crc32, const_budget_bytes=2048),
)


def select_entries(names: Sequence[str] | None) -> tuple[EntryPoint, ...]:
    """The registry, optionally filtered to the named entries (exact match)."""
    if not names:
        return ENTRY_POINTS
    by_name = {e.name: e for e in ENTRY_POINTS}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"unknown entry point(s): {', '.join(missing)}")
    return tuple(by_name[n] for n in names)


def output_arrays(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """``obj``'s leaves as ``{path: numpy array}``: dataclass fields by
    name, sequence items by index, ``None`` leaves dropped. The leaves are
    the port's tensors or anything ``np.asarray`` takes."""
    if obj is None:
        return {}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(obj)]
    else:
        if hasattr(obj, "detach"):  # a torch tensor
            return {prefix: obj.detach().cpu().numpy()}
        return {prefix: np.asarray(obj)}
    out: dict[str, np.ndarray] = {}
    for name, x in items:
        out.update(output_arrays(x, f"{prefix}.{name}" if prefix else name))
    return out
