"""Derived tick builds: each engine the port runs, built from the one tick.

The port of ``kaboodle_tpu/phasegraph/derive.py``. Every builder wraps a
function the port already has, so the protocol exists once, under
``phasegraph/``:

==========  ==============================================================
engine      derivation
==========  ==============================================================
dense       ``exec.py``'s full and fused programs under the per-tick
            dispatch (``make_dense_tick``); ``make_fused_tick`` is the
            fused program alone
chunked     the row-blocked program (``make_chunked_tick`` -> blocked.py)
sharded     the dense tick built with a mesh's row group
            (``make_sharded_tick``): each rank its rows, the cross-row
            reads through ``parallel/collectives.py``
fleet       the dense tick over a leading ensemble axis
            (``make_fleet_tick``): the same tick function given ``[E, ...]``
            leaves, full program only
warp        the span program: k (near-)quiescent ticks as one batched pass
            (``make_warp_leap`` -> span.py)
serve       the masked fleet converge chunk of a lane pool
            (``make_serve_step``): the fleet tick with per-lane activity,
            budgets and convergence freezes; ``make_sharded_serve_step``
            runs it over a fleet device mesh
sparse      the blocked_topk ``[N, K]`` tick (``make_sparse_tick`` ->
            sparseplane/kernel.py)
==========  ==============================================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.phasegraph import build_graph, plan
from kaboodle_tpu_torch.phasegraph.blocked import make_chunked_tick_fn
from kaboodle_tpu_torch.phasegraph.exec import PALLAS_BATCH_ERROR, make_tick_fn
from kaboodle_tpu_torch.phasegraph.span import make_leap_fn

# The engines this module builds (the JAX package's names, in its order).
ENGINES = ("dense", "fused", "chunked", "sharded", "fleet", "warp", "serve", "sparse")



def _tail_passes(program) -> dict[str, tuple[str, ...]]:
    return {p.name: p.op_names for p in program.tail}


# The sparse program's tail passes and their ops: the plan of the default
# blocked_topk graph (the same for ``faulty`` True and False). The kernel
# runs them in ``sparseplane.kernel.SPARSE_TAIL_PASSES`` order.
SPARSE_PASSES = _tail_passes(plan(
    build_graph(SwimConfig(join_broadcast_enabled=False), layout="blocked_topk"), "sparse"))


def make_dense_tick(cfg: SwimConfig, faulty: bool = True, telemetry: bool = False) -> Callable:
    """The production dense tick: full + fused programs, per-tick dispatch."""
    return make_tick_fn(cfg, faulty=faulty, telemetry=telemetry)


def make_fused_tick(cfg: SwimConfig, faulty: bool = True, telemetry: bool = False) -> Callable:
    """The fused program alone, with no dispatch guard: the caller owns the
    precondition that no tick has a Join broadcast or suspicion activity."""
    return make_tick_fn(cfg, faulty=faulty, telemetry=telemetry, program="fused")


def make_chunked_tick(
    cfg: SwimConfig,
    faulty: bool = True,
    block: int = 1024,
    drop: bool = True,
    boot_union: bool = False,
    telemetry: bool = False,
) -> Callable:
    """The row-blocked (O(block·N)-transient) derivation."""
    return make_chunked_tick_fn(cfg, faulty=faulty, block=block, drop=drop,
                                boot_union=boot_union, telemetry=telemetry)


def make_sharded_tick(
    cfg: SwimConfig, mesh, faulty: bool = True, telemetry: bool = False
) -> Callable:
    """The dense tick over ``mesh``'s peer axis: each rank its rows.

    The same tick function as :func:`make_dense_tick`, built with the
    mesh's peer group: the dispatch predicate and every gate are all-reduced,
    both programs run on the rank's rows, and the cross-row reads are the
    collectives of ``parallel/collectives.py``. ``cfg`` passes through
    unchanged, kernel flags included: the kernels run on the rank's rows.
    Every output carry is checked to be the rank's rows
    (``parallel.mesh.constrain_state``); ``st`` is the rank's rows of the
    state (``parallel.mesh.shard_state``) and ``inp`` of the inputs."""
    from kaboodle_tpu_torch.parallel.mesh import constrain_state, peer_group

    tick = make_tick_fn(cfg, faulty=faulty, telemetry=telemetry, group=peer_group(mesh))

    def sharded_tick(st, inp):
        st, m = tick(st, inp)
        return constrain_state(st, mesh), m

    sharded_tick.graph = tick.graph
    sharded_tick.programs = tick.programs
    sharded_tick.pred_terms = tick.programs["fused"].pred_terms  # the dispatch predicate
    return sharded_tick


def make_fleet_tick(
    cfg: SwimConfig, faulty: bool = True, telemetry: bool = False
) -> Callable:
    """The dense tick over the leading ensemble axis, full program only.

    ``fast_path=False``, as in the JAX package: the dispatch would run the
    full program for the whole ensemble whenever any member needs it, which
    on fault scenarios is nearly every tick; the dispatch is bit-exact by
    contract, so member trajectories are unchanged. The hand kernels take
    one mesh, so a config with a ``use_pallas_*`` flag on is refused here
    with the JAX package's ``ValueError``."""
    if cfg.use_pallas_fp or cfg.use_pallas_oldest_k or cfg.use_pallas_suspicion:
        raise ValueError(PALLAS_BATCH_ERROR)
    return make_tick_fn(dataclasses.replace(cfg, fast_path=False), faulty=faulty,
                        program="full", telemetry=telemetry)


def make_sparse_tick(cfg: SwimConfig, spec, faulty: bool = True) -> Callable:
    """The blocked_topk-layout tick: ``[N, K]`` neighbor blocks, counter RNG.

    ``spec`` is a :class:`~kaboodle_tpu_torch.sparseplane.state.SparseSpec`.
    The tick is built from ``plan(build_graph(cfg, faulty=faulty,
    layout="blocked_topk"), "sparse")``, which the kernel checks against the
    passes it runs, and carries it as ``tick.graph`` / ``tick.programs``;
    ``tick.passes`` is its tail, pass by pass."""
    from kaboodle_tpu_torch.sparseplane.kernel import make_sparse_tick_fn

    tick = make_sparse_tick_fn(cfg, spec, faulty=faulty)
    tick.passes = _tail_passes(tick.programs["sparse"])
    return tick


def make_warp_leap(cfg: SwimConfig, k: int, hybrid: bool = False, masked: bool = False,
                   group=None) -> Callable:
    """The span / hybrid program: k (near-)quiescent ticks as one pass.

    ``hybrid=True`` is the near-quiescent program (strict span + sterile
    anti-entropy); ``masked=True`` takes a per-member span length
    ``k_m <= k``, so one call advances an ensemble to per-member horizons;
    ``group`` builds the leap over a row group (each rank its rows)."""
    return make_leap_fn(cfg, k, hybrid=hybrid, masked=masked, group=group)


@dataclasses.dataclass
class ServeStepOut:
    """Per-lane outputs of one serve step chunk (all leaves ``[E]``).

    ``conv_tick`` is the ticks-run count at the lane's FIRST observed
    fingerprint agreement (``-1`` until then) -- for a converge-mode lane it
    equals the ``ticks_run`` a standalone ``run_until_converged`` of the
    same seed would report. ``counters`` is the chunk's per-lane
    ``ProtocolCounters`` delta (``None`` unless the step was built with
    ``telemetry=True``); frozen lanes contribute zero."""

    remaining: torch.Tensor  # int32 [E] tick budget left
    ticks_run: torch.Tensor  # int32 [E] ticks executed since admission
    conv_tick: torch.Tensor  # int32 [E] ticks_run at first agreement, -1 before
    done: torch.Tensor  # bool [E] lane finished (converged or budget exhausted)
    messages: torch.Tensor  # int32 [E] unicasts delivered this chunk
    counters: object | None = None  # ProtocolCounters with [E] leaves


def make_serve_step(
    cfg: SwimConfig,
    chunk: int,
    faulty: bool = False,
    telemetry: bool = False,
    device_mesh=None,
) -> Callable:
    """The serving engine's resident program: a masked fleet converge chunk.

    One call advances a whole lane pool up to ``chunk`` ticks: every lane
    that is occupied (``active``), unfinished and within budget ticks in
    lockstep through the fleet tick; everything else -- free lanes, freshly
    converged converge-mode lanes, exhausted budgets -- freezes bit-exactly
    via ``fleet.core.freeze_members``. Everything a request varies is data
    (per-lane drop knob, activity masks, tick budgets, run counters), so
    the serving loop calls this one program for every admission mix.

    Per-lane semantics (``until_conv`` selects the request mode):

    - converge mode (``until_conv[e]``): the lane freezes at the end-of-tick
      state where its fingerprints first agree -- the ``run_until_converged``
      contract, so a lane admitted mid-flight is bit-exact with the
      standalone run of the same seed (with ``remaining`` as the
      ``max_ticks`` bound).
    - horizon mode (``~until_conv[e]``): the lane runs exactly its budget
      (convergence observed and recorded, not a stop condition).

    The JAX program's ``lax.while_loop`` (``any(~done) & (i < chunk)``) is a
    Python loop here with one host fetch of ``any(~done)`` a tick, as in
    ``fleet/core.py::fleet_converge_loop``; lanes sit at different ticks,
    and the fleet tick reads each member's ``tick`` and draw keys on the
    device. Like the fleet tick, the build is full-program-only and the
    per-lane ``drop_rate`` knob is inert unless ``faulty=True``.
    ``telemetry=True`` derives from the telemetry build of the fleet tick
    and accumulates each lane's ``ProtocolCounters`` over the ticks it
    actually advanced, in the counters' own dtype (``gossip_bytes`` mod
    2^32), frozen ticks contributing zero.

    Returns ``serve_step(mesh, drop_rate, active, until_conv, remaining,
    ticks_run, conv_tick) -> (mesh, ServeStepOut)``; the vectors are
    tensors or numpy arrays and the outputs tensors on the mesh's device.

    ``device_mesh`` (a ``fleet.sharding.make_fleet_mesh`` mesh) builds the
    sharded step of :func:`make_sharded_serve_step`: the state and
    ``drop_rate`` are this rank's block, the run vectors the whole ``[E]``
    (each rank reads its lanes), and the outputs the whole ``[E]`` again.
    """
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, freeze_members
    from kaboodle_tpu_torch.sim.runner import state_agreement
    from kaboodle_tpu_torch.telemetry.counters import ProtocolCounters, add_counters

    if chunk < 1:
        raise ValueError("serve step chunk must be >= 1")
    peer = ens = any_group = None
    if device_mesh is None:
        vtick = make_fleet_tick(cfg, faulty=faulty, telemetry=telemetry)
    else:
        import torch.distributed as dist

        from kaboodle_tpu_torch.fleet.sharding import (
            ENSEMBLE_AXIS,
            make_sharded_fleet_tick,
            peer_group_of,
        )

        vtick = make_sharded_fleet_tick(cfg, device_mesh, faulty=faulty, telemetry=telemetry)
        peer, ens = peer_group_of(device_mesh), device_mesh.get_group(ENSEMBLE_AXIS)
        any_group = dist.group.WORLD
    fields = [f.name for f in dataclasses.fields(ProtocolCounters)]

    def serve_step(mesh, drop_rate, active, until_conv, remaining, ticks_run, conv_tick):
        dev = mesh.state.device
        ensemble, rows = mesh.alive.shape[0], mesh.state.shape[-2]
        lane0 = 0 if ens is None else C.rank(ens) * ensemble  # this rank's first lane

        def vec(x, dtype):
            if not isinstance(x, torch.Tensor):
                x = np.array(x)  # a writable host copy of the [E] vector
            x = torch.as_tensor(x, dtype=dtype).to(dev)
            return x if ens is None else x[lane0:lane0 + ensemble]

        active, until_conv = vec(active, torch.bool), vec(until_conv, torch.bool)
        remaining, ticks_run = vec(remaining, torch.int32), vec(ticks_run, torch.int32)
        conv_tick = vec(conv_tick, torch.int32)
        idle = fleet_idle_inputs(rows, ensemble, drop_rate=drop_rate, device=dev)
        # Entry test, like the standalone converge loop: a converge-mode
        # lane already at agreement freezes at once with conv_tick ==
        # ticks_run (0 for a freshly admitted converged-init lane).
        conv0 = state_agreement(mesh, peer)[0]
        conv_tick = torch.where(active & conv0 & (conv_tick < 0), ticks_run, conv_tick)
        done = ~active | (until_conv & conv0) | (remaining <= 0)
        messages = torch.zeros((ensemble,), dtype=torch.int32, device=dev)
        ctr = None
        if telemetry:
            ctr = ProtocolCounters(**{
                name: torch.zeros((ensemble,), dtype=torch.int32, device=dev) for name in fields
            })
        i = 0
        # The gate is every lane's, on every rank: each runs the same ticks.
        while i < chunk and bool(C.global_any(~done, any_group)):
            new, out = vtick(mesh, idle)
            m = out.metrics if telemetry else out  # reduced over the peer group
            adv = ~done
            mesh = freeze_members(adv, mesh, new)
            ticks_run = torch.where(adv, ticks_run + 1, ticks_run)
            remaining = torch.where(adv, remaining - 1, remaining)
            messages = messages + torch.where(adv, m.messages_delivered, 0)
            if telemetry:
                ctr = add_counters(ctr, ProtocolCounters(**{
                    name: torch.where(adv, getattr(out.counters, name), 0) for name in fields
                }))
            conv_now = adv & m.converged
            conv_tick = torch.where(conv_now & (conv_tick < 0), ticks_run, conv_tick)
            done = done | (until_conv & conv_now) | (remaining <= 0)
            i += 1
        if ens is not None:  # every rank's lanes, in lane order: one gather
            vecs = [remaining, ticks_run, conv_tick, done.to(torch.int32), messages]
            if telemetry:
                vecs += [getattr(ctr, name) for name in fields]
            vecs = list(C.gather_rows(torch.stack(vecs), ens, dim=-1))
            remaining, ticks_run, conv_tick, messages = vecs[0], vecs[1], vecs[2], vecs[4]
            done = vecs[3].to(torch.bool)
            if telemetry:
                ctr = ProtocolCounters(**dict(zip(fields, vecs[5:])))
        return mesh, ServeStepOut(remaining=remaining, ticks_run=ticks_run,
                                  conv_tick=conv_tick, done=done, messages=messages,
                                  counters=ctr)

    return serve_step


def make_sharded_serve_step(
    cfg: SwimConfig,
    chunk: int,
    mesh,
    faulty: bool = False,
    telemetry: bool = False,
) -> Callable:
    """The serve step over a fleet device mesh (``fleet.sharding.make_fleet_mesh``).

    The sharded twin of :func:`make_serve_step`: the same step, with each
    rank ticking its lanes through ``fleet.sharding.make_sharded_fleet_tick``
    (whole members on a 1-D ``ensemble`` mesh; on a 2-D ``E x peers`` mesh
    each member's rows over the peer group, its metrics and counters
    reduced there), its carry checked by ``make_fleet_constrainer`` after
    every tick. The entry agreement is reduced over the peer group, the
    loop's ``any(~done)`` over every rank, so all ranks run the same ticks
    and make the same collectives; the ``[E]`` outputs are gathered over
    the ensemble axis, so every rank holds the same whole run vectors.
    Every rank calls it with the same whole ``[E]`` run vectors and its
    own block of the state and of ``drop_rate``."""
    return make_serve_step(cfg, chunk, faulty=faulty, telemetry=telemetry, device_mesh=mesh)
