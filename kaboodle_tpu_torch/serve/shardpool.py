"""The sharded lane pool: one pool's ``[E]`` lanes spread over a device mesh.

The port of ``kaboodle_tpu/serve/shardpool.py``. A :class:`ShardedLanePool`
is a :class:`~kaboodle_tpu_torch.serve.pool.LanePool` whose resident fleet
lives on a ``fleet.sharding`` device mesh instead of one card: the ``[E]``
lane axis splits across the ``ensemble`` mesh axis and, on a 2-D
``E x peers`` mesh, each lane's ``[N]`` peer rows split across the
``peers`` axis, so ONE pool serves big-N requests whose state exceeds a
single device. The admission protocol is untouched: same host run vectors,
same lane reseed/insert/gather, same serve-step contract. The pool
overrides the JAX pool's seams (``_bind_programs`` plus the warp dispatch
hooks), swapping in the sharded twins:

- **serve step** -- ``phasegraph.derive.make_sharded_serve_step``: the
  masked converge chunk over each rank's lanes (and rows), the loop's
  ``any(~done)`` all-reduced over every rank, the ``[E]`` outputs gathered
  over the ensemble axis.
- **reseed / insert** -- the same lane writes, each rank writing only the
  lanes and rows it owns. An insert's member is the leading rank's: it
  sends each owning rank its rows.
- **member gather** -- a member reassembled from its shards (a
  collective), on every rank.
- **fleet leap** -- the masked hybrid span program over the peer group,
  cached in the warp ``leap_cache`` under a mesh-distinct family key.

**Multi-controller.** The JAX pool runs under one controller that drives
every device. ``torch.distributed`` runs a controller on every rank, and
every rank must make the same collectives in the same order. So the
leading rank (global rank 0) serves -- its engine calls the pool inline --
and every other rank runs :func:`follow`: before each public pool call the
leader broadcasts the call (its name and host arguments) over a gloo group
of the pool's own, and each follower makes the same call on its own lanes
and rows. ``close()`` (``ServeEngine.close`` calls it) ends the followers;
``close(error=...)`` ends them with the leader's error. The host run
vectors are the same on every rank, and so are the ``[E]`` generation
counters (every rank bumps the lane a reseed or insert writes).

Bit-exactness vs the single-device pool on the same admission schedule is
pinned by tests/test_torch_shardpool.py.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import FleetState
from kaboodle_tpu_torch.fleet.sharding import (
    ENSEMBLE_AXIS,
    _check_fleet_divisible,
    _peers,
    gather_fleet,
    make_fleet_constrainer,
    make_fleet_mesh,
    peer_group_of,
    shard_fleet,
)
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, mesh_device, state_specs
from kaboodle_tpu_torch.serve.pool import (
    SCENARIOS,
    LanePool,
    _np_u32,
    _seed32,
)
from kaboodle_tpu_torch.sim.runner import state_agreement
from kaboodle_tpu_torch.sim.state import MeshState, init_state

LEADER = 0  # the global rank that serves; every other rank follows


def member_sharding(device_mesh, member: MeshState | None = None) -> MeshState:
    """Placements of ONE member's ``MeshState`` on the pool's device mesh:
    the peer layer's row sharding when the mesh has a ``peers`` axis, fully
    replicated otherwise. A reseed, an insert and a gather all split or
    join a member by these."""
    specs = state_specs(member)
    if not _peers(device_mesh):
        specs = MeshState(**{
            f.name: None if getattr(specs, f.name) is None else (Replicate(),)
            for f in dataclasses.fields(MeshState)
        })
    return specs


@dataclasses.dataclass(frozen=True)
class _Layout:
    """This rank's block of a pool: lanes ``lane0 ..`` (``lanes`` of them),
    and of each the rows of peer coordinate ``peer`` (all rows on a 1-D
    mesh, where ``peer`` is 0)."""

    lane0: int
    lanes: int
    peer: int

    def owns(self, lane: int) -> bool:
        return self.lane0 <= lane < self.lane0 + self.lanes


def _layout(device_mesh, lanes: int) -> _Layout:
    coord = device_mesh.get_coordinate()
    e_l = lanes // device_mesh.size(0)
    return _Layout(lane0=coord[0] * e_l, lanes=e_l, peer=coord[1] if _peers(device_mesh) else 0)


def _owner_ranks(device_mesh, lane: int, lanes: int) -> list[int]:
    """Global ranks holding lane ``lane``, in peer order."""
    c = lane // (lanes // device_mesh.size(0))
    return [int(r) for r in device_mesh.mesh[c].reshape(-1)]


def _member_rows(member: MeshState, device_mesh, p: int, n: int) -> MeshState:
    """Peer coordinate ``p``'s block of a whole member (all of it on a 1-D mesh)."""
    specs = member_sharding(device_mesh, member)
    rows = n // device_mesh.size(1) if _peers(device_mesh) else n
    out = {}
    for f in dataclasses.fields(MeshState):
        x, spec = getattr(member, f.name), getattr(specs, f.name)
        if x is not None and spec[0].is_shard():
            x = x.narrow(spec[0].dim, p * rows, rows)
        out[f.name] = x
    return MeshState(**out)


def _write_rows(state: MeshState, lane_local: int, block: MeshState) -> None:
    for f in dataclasses.fields(MeshState):
        leaf = getattr(state, f.name)
        if leaf is not None:
            leaf[lane_local].copy_(getattr(block, f.name))


# -- the program set, process-wide, keyed by the device mesh ---------------


@functools.lru_cache(maxsize=None)
def _sharded_step_program(cfg, chunk: int, faulty: bool, telemetry: bool, device_mesh):
    """The sharded serve step, shared process-wide (the sharded twin of
    ``pool._step_program``; a ``DeviceMesh`` hashes, so the device mesh
    rides in the cache key)."""
    from kaboodle_tpu_torch.phasegraph.derive import make_sharded_serve_step

    return make_sharded_serve_step(cfg, chunk, device_mesh, faulty=faulty, telemetry=telemetry)


@functools.lru_cache(maxsize=None)
def _sharded_reseed_program(n: int, scenario: str, state_kwargs_items: tuple, device_mesh):
    """The reseed: every rank bumps the lane's generation; the ranks that
    own the lane write their rows of ``init_state(n, seed)`` and its drop
    knob."""
    shape_kw = SCENARIOS[scenario]
    kw = dict(shape_kw(n) if callable(shape_kw) else shape_kw)
    kw.update(dict(state_kwargs_items))
    constrain = make_fleet_constrainer(device_mesh)

    def reseed(mesh, generation, drop_rate, lane, seed, drop):
        lane, seed = int(lane), _seed32(seed)
        lay = _layout(device_mesh, generation.shape[0])
        if lay.owns(lane):
            fresh = init_state(n, seed=seed, device=mesh.state.device, **kw)
            _write_rows(mesh, lane - lay.lane0, _member_rows(fresh, device_mesh, lay.peer, n))
            drop_rate[lane - lay.lane0] = float(np.float32(drop))
        generation[lane] += 1
        return constrain(mesh), generation, drop_rate

    return reseed


@functools.lru_cache(maxsize=None)
def _sharded_insert_program(device_mesh):
    """The restore write. The leading rank holds the whole member: it
    writes its own rows and sends each other owning rank its rows, leaf by
    leaf (bool and int16 as their bytes); each owning rank receives and
    writes them. Every rank bumps the lane's generation. ``member`` is read
    on the leading rank only."""
    constrain = make_fleet_constrainer(device_mesh)

    def insert(mesh, generation, lane, member):
        lane = int(lane)
        lanes = generation.shape[0]
        n = mesh.state.shape[-1]
        lay = _layout(device_mesh, lanes)
        me = dist.get_rank()
        owners = _owner_ranks(device_mesh, lane, lanes)
        names = [f.name for f in dataclasses.fields(MeshState)
                 if getattr(mesh, f.name) is not None]
        if me == LEADER:
            for p, r in enumerate(owners):
                block = _member_rows(member, device_mesh, p, n)
                if r == me:
                    _write_rows(mesh, lane - lay.lane0, block)
                    continue
                for name in names:
                    x = getattr(block, name).to(mesh.state.device)
                    dist.send(C._wire(x), dst=r)
        elif me in owners:
            local = lane - lay.lane0
            for name in names:
                leaf = getattr(mesh, name)
                buf = C._wire(torch.empty_like(leaf[local]))
                dist.recv(buf, src=LEADER)
                leaf[local].copy_(C._unwire(buf, leaf.dtype))
        generation[lane] += 1
        return constrain(mesh), generation

    return insert


@functools.lru_cache(maxsize=None)
def _sharded_member_fetch(device_mesh):
    """The member gather: each peer group joins the rows of its rank's
    copy of the lane's local slot, then the lane's owner group's first
    rank broadcasts the whole member to every rank. A private copy."""
    peer = peer_group_of(device_mesh)

    def fetch(mesh, lane):
        lane = int(lane)
        lanes = mesh.alive.shape[0] * device_mesh.size(0)
        local = lane % mesh.alive.shape[0]
        src = _owner_ranks(device_mesh, lane, lanes)[0]
        specs = member_sharding(device_mesh)
        out = {}
        for f in dataclasses.fields(MeshState):
            leaf = getattr(mesh, f.name)
            if leaf is None:
                out[f.name] = None
                continue
            spec = getattr(specs, f.name)[0]
            x = (C.gather_rows(leaf[local], peer, dim=spec.dim) if spec.is_shard()
                 else leaf[local].clone())
            w = C._wire(x)
            if dist.get_world_size() > 1:
                dist.broadcast(w, src=src)
            out[f.name] = C._unwire(w, leaf.dtype)
        return MeshState(**out)

    return fetch


@functools.lru_cache(maxsize=None)
def _sharded_agree_program(device_mesh):
    """The harvest agreement: each member's rows reduced over the peer
    group, the ``[E]`` rows gathered over the ensemble axis."""
    peer, ens = peer_group_of(device_mesh), device_mesh.get_group(ENSEMBLE_AXIS)

    def agree(mesh):
        conv, fp_min, fp_max, n_alive = state_agreement(mesh, peer)
        rows = torch.stack([conv.to(torch.int32), fp_min.to(torch.int32),
                            fp_max.to(torch.int32), n_alive.to(torch.int32)])
        conv, fp_min, fp_max, n_alive = C.gather_rows(rows, ens, dim=-1)
        return conv.to(torch.bool), fp_min, fp_max, n_alive

    return agree


@functools.lru_cache(maxsize=None)
def _sharded_signature(cfg, device_mesh):
    """The ``[E, 4]`` activity signature rows: each member's terms reduced
    over the peer group, the rows gathered over the ensemble axis."""
    from kaboodle_tpu_torch.warp.horizon import make_signature_fn

    sig = make_signature_fn(cfg, group=peer_group_of(device_mesh))
    ens = device_mesh.get_group(ENSEMBLE_AXIS)
    return lambda mesh: C.gather_rows(sig(mesh), ens, dim=0)


def _sharded_fleet_leap(cfg, K: int, device_mesh):
    """The masked hybrid fleet leap over the peer group, its carry checked
    by the fleet constrainer, cached in the warp ``leap_cache`` under a
    mesh-distinct family key (the same pow2 bucket vocabulary and reuse
    accounting as the single-device fleet family)."""
    from kaboodle_tpu_torch.phasegraph.derive import make_warp_leap
    from kaboodle_tpu_torch.warp.runner import leap_cache

    def build():
        leap = make_warp_leap(cfg, K, hybrid=True, masked=True,
                              group=peer_group_of(device_mesh))
        constrain = make_fleet_constrainer(device_mesh)
        return lambda mesh, k_m: constrain(leap(mesh, k_m))

    return leap_cache.get((cfg, "fleet-sharded", device_mesh), "hybrid", K, build)


# Counted by ``pool.program_builds`` with the single-device pool's caches.
PROGRAM_CACHES = (_sharded_step_program, _sharded_reseed_program, _sharded_insert_program,
                  _sharded_member_fetch, _sharded_agree_program, _sharded_signature)


# -- the follower protocol --------------------------------------------------


def _announced(method=None, *, send=None):
    """Wrap a public pool method so that, called on the leading rank from
    outside the pool, it first broadcasts ``(name, args, kwargs)`` to the
    followers. ``send(*args, **kwargs)`` returns the ``(args, kwargs)``
    broadcast (default: the call's own)."""
    if method is None:
        return functools.partial(_announced, send=send)
    name = method.__name__

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self._depth == 0 and self._leader:
            a, kw = (args, kwargs) if send is None else send(*args, **kwargs)
            self._announce(name, a, kw)
        self._depth += 1
        try:
            return method(self, *args, **kwargs)
        finally:
            self._depth -= 1

    return call


def follow(pool: "ShardedLanePool") -> int:
    """The follower's loop: receive each call the leading rank announces on
    ``pool`` and make the same call on this rank's lanes and rows, until
    the leader's ``close()``. Returns the number of calls followed; raises
    ``RuntimeError`` when the leader closed with an error. A call that
    raises ``ValueError`` (a refused admission, say) raised the same on the
    leader, before any collective: the loop goes on."""
    if pool._leader:
        raise ValueError("the leading rank serves; only the other ranks follow")
    calls = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=LEADER, group=pool._group)
        op, args, kwargs = box[0]
        if op == "shutdown":
            if args and args[0]:
                raise RuntimeError(f"the leading rank closed the pool with an error: {args[0]}")
            return calls
        calls += 1
        try:
            getattr(pool, op)(*args, **kwargs)
        except ValueError:
            pass


def _host_fleet(fleet: FleetState, generation):
    """A fleet and its generation counters as CPU tensors (what a broadcast pickles)."""
    mesh = dataclasses.replace(fleet.mesh, **{
        f.name: getattr(fleet.mesh, f.name).cpu()
        for f in dataclasses.fields(MeshState) if getattr(fleet.mesh, f.name) is not None
    })
    gen = generation.cpu() if isinstance(generation, torch.Tensor) else np.asarray(generation)
    return (FleetState(mesh=mesh, drop_rate=fleet.drop_rate.cpu()), gen), {}


class ShardedLanePool(LanePool):
    """A lane pool resident on a device mesh (see the module docstring).

    ``device_mesh`` is a ``fleet.sharding.make_fleet_mesh`` mesh -- 1-D
    ``ensemble`` (each lane whole on one rank) or 2-D ``E x peers`` (each
    lane's rows split too), made over every rank of the job (on the card
    with NCCL unless ``device="cpu"``, gloo; ``device`` is read only when
    no mesh is given). ``lanes`` must divide by the ensemble mesh size and
    ``n`` by the peer mesh size, exactly like ``shard_fleet``. Every rank
    constructs the pool with the same arguments; rank 0 then serves and the
    others run :func:`follow`.
    """

    def __init__(
        self,
        n: int,
        lanes: int,
        cfg: SwimConfig | None = None,
        faulty: bool = False,
        telemetry: bool = False,
        chunk: int = 8,
        device_mesh=None,
        device=None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        **state_kwargs,
    ) -> None:
        if device_mesh is None:
            device_mesh = make_fleet_mesh(device=device, timeout_s=timeout_s)
        self.device_mesh = device_mesh
        _check_fleet_divisible(lanes, n, device_mesh)
        # The pool's own command channel (host objects only), made by every
        # rank: its broadcasts never interleave with the mesh's collectives.
        self._group = dist.new_group(backend="gloo",
                                     timeout=datetime.timedelta(seconds=timeout_s))
        self._leader = dist.get_rank() == LEADER
        self._world = dist.get_world_size()
        self._depth = 0
        self._closed = False
        super().__init__(n, lanes, cfg=cfg, faulty=faulty, telemetry=telemetry, chunk=chunk,
                         device=mesh_device(device_mesh), **state_kwargs)
        # This rank's block of the freshly initialized resident; the host
        # run vectors and the [E] generation counters stay whole.
        self._place_resident()

    def _place_resident(self) -> None:
        fleet = shard_fleet(FleetState(mesh=self.mesh, drop_rate=self.drop), self.device_mesh)
        self.mesh, self.drop = fleet.mesh, fleet.drop_rate

    def _bind_programs(self, kw_items: tuple) -> None:
        self._step = _sharded_step_program(self.cfg, self.chunk, self.faulty, self.telemetry,
                                           self.device_mesh)
        self._reseed = {name: _sharded_reseed_program(self.n, name, kw_items, self.device_mesh)
                        for name in SCENARIOS}
        self._insert = _sharded_insert_program(self.device_mesh)
        self._agree = _sharded_agree_program(self.device_mesh)

    # -- the command channel -----------------------------------------------

    def _announce(self, op: str, args, kwargs) -> None:
        if self._closed:
            raise RuntimeError("the sharded pool is closed: its followers have stopped")
        if self._world > 1:
            dist.broadcast_object_list([(op, tuple(args), dict(kwargs))], src=LEADER,
                                       group=self._group)

    def close(self, error: str | None = None) -> None:
        """On the leading rank: end the followers (with ``error``, if given,
        which each follower raises). Idempotent; a no-op on a follower."""
        if self._leader and not self._closed:
            self._announce("shutdown", (error,), {})
            self._closed = True

    # -- lifecycle: announced, then made on every rank ------------------------

    admit = _announced(LanePool.admit)
    resume = _announced(LanePool.resume)
    park = _announced(LanePool.park)
    release = _announced(LanePool.release)
    set_run_counters = _announced(LanePool.set_run_counters)
    step = _announced(LanePool.step)
    advance_leaped = _announced(LanePool.advance_leaped)

    @_announced(send=lambda lane, member: ((lane, None), {}))
    def insert(self, lane: int, member) -> int:
        """The base insert; ``member`` is read on the leading rank only,
        which sends each owning rank its rows."""
        return LanePool.insert(self, lane, member)

    @_announced
    def member(self, lane: int):
        """Lane ``lane``'s whole member on every rank, reassembled from its
        shards: a private copy (a collective: call it on the round loop)."""
        return _sharded_member_fetch(self.device_mesh)(self.mesh, lane)

    @_announced
    def member_snapshot(self, lane: int):
        """A zero-arg thunk for the spill writer, with the gather made HERE,
        on the round-loop thread. The gather is a collective (it joins a
        member from its shards); made from the background spill thread it
        would interleave with the round loop's collectives and deadlock the
        ranks. The gather's result is a private copy, so later in-place
        writes to the lane never reach it; the writer thread does only the
        device->host copy and the disk write."""
        member = self.member(lane)
        return lambda: member

    # -- warp dispatch hooks -----------------------------------------------

    @_announced
    def signature(self):
        return _sharded_signature(self.cfg, self.device_mesh)(self.mesh)

    @_announced(send=lambda K, k_m, memo=None: ((K, np.asarray(k_m)), {}))
    def leap(self, K: int, k_m, memo=None) -> tuple[int, bool]:
        # The span memo is deliberately inert here, as in the JAX pool:
        # keying a lane requires digesting its rows on the host, and
        # fetching a sharded mesh back every round would serialize the
        # cross-rank reassembly the sharded pool exists to avoid. Rounds
        # always dispatch; the base pool is the memo tier.
        lay = _layout(self.device_mesh, self.lanes)
        local = np.asarray(k_m)[lay.lane0:lay.lane0 + lay.lanes]
        self.mesh = _sharded_fleet_leap(self.cfg, K, self.device_mesh)(
            self.mesh, torch.as_tensor(local, dtype=torch.int32, device=self.device))
        return 0, True

    @_announced
    def agreement(self):
        conv, fp_min, fp_max, n_alive = self._agree(self.mesh)
        return (conv.cpu().numpy(), _np_u32(fp_min), _np_u32(fp_max), n_alive.cpu().numpy())

    # -- warmup ------------------------------------------------------------

    @_announced
    def warmup(self) -> None:
        """The base warmup plus an insert of a host-loaded member: lane 0's
        own state re-inserted through a host round trip (bit-identical,
        state-preserving), the path a restore from disk takes. Lane 0's
        generation ends 4 higher, as in the JAX pool."""
        super().warmup()
        member0 = self.member(0)
        host_member = dataclasses.replace(member0, **{
            f.name: getattr(member0, f.name).cpu()
            for f in dataclasses.fields(MeshState) if getattr(member0, f.name) is not None
        })
        self.mesh, self.generation = self._insert(self.mesh, self.generation, 0, host_member)

    # -- checkpoint adoption -----------------------------------------------

    @_announced
    def fleet_state(self) -> FleetState:
        """The whole resident on every rank (``checkpoint.save_fleet`` input)."""
        return gather_fleet(FleetState(mesh=self.mesh, drop_rate=self.drop), self.device_mesh)

    @_announced(send=_host_fleet)
    def load_fleet_state(self, fleet: FleetState, generation) -> None:
        """Adopt a whole checkpointed resident (the leading rank's, sent to
        every rank), each rank keeping its block."""
        super().load_fleet_state(fleet, generation)
        self._place_resident()

    def stats(self) -> dict:
        out = super().stats()
        out["device_mesh"] = {name: int(self.device_mesh.size(i))
                              for i, name in enumerate(self.device_mesh.mesh_dim_names)}
        return out
