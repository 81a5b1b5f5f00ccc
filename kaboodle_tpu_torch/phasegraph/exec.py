"""The executable tick: the full and the fused program, and the dispatch between them.

The port of ``kaboodle_tpu/phasegraph/exec.py::make_tick_fn``. Round
structure per tick t (reference kaboodle.rs:746-786):

  A  active phase: Join broadcasts, suspicion handling (escalation to
     indirect ping / removals), random ping, manual pings.
  B  broadcast delivery: Join inserts + join-response KnownPeers.
  1  call 1: Pings + PingRequests delivered.
  2  call 2: direct Acks, proxy Pings, join responses; gossip inserts (Q6).
  3  call 3: the suspects' Acks at the proxies.
  4  call 4: forwarded Acks.
  G  anti-entropy: each peer resolves <= 1 KnownPeersRequest (D2).

Two programs run a tick. ``_rest`` is the full program: one pass per
gated phase. ``_fast`` is the fused program: on a tick with no Join
broadcast and no suspicion activity every delivery mask derives from
``[N]`` vectors, so the update is one composed write. The dispatch takes
``_fast`` exactly when the predicate ``any_a2 | any_join`` is false
(``any_join`` only exists with Join broadcasts on). Both programs and the
predicate come from the planner: each build plans its graph
(``build_graph(cfg, faulty, telemetry)``) into the ``full`` and ``fused``
programs, checks them against the op bodies this module has
(``_check_programs``), and ORs the fused program's ``pred_terms``. The
tick carries them as ``tick.graph`` and ``tick.programs``.

``_cut`` is the stage probe: a cut label of the graph (``A``, ``c1``,
``c2``, ``c34``, ``G``: after the ping-target draw, call 1, call 2, calls
3-4 and the anti-entropy partner pick) ends the full program right after
that op and returns the partial state with ``tick + 1`` and zeroed
metrics. Timing successive cuts splits a tick into its stages in context.

Where the JAX tick has ``lax.cond``, this tick has a Python ``if`` on a
device value; each gated branch is an identity when its gate is false, so
the two are the same function. Tensors are never updated in place: a
phase's result is a new tensor, as in the JAX program.

The three fused kernels sit where the JAX tick calls its Pallas kernels:
``fused_suspicion`` in the prologue of every tick
(``cfg.use_pallas_suspicion``), ``fused_fp_count`` behind every
``fp_count`` (``cfg.use_pallas_fp``) and ``fused_oldest_k`` in the full
program's ping-target draw (``cfg.use_pallas_oldest_k``). Unlike the JAX
package there is no ``N % 128`` guard: a flag that is on means the kernel
(on a CUDA tensor) or its plain version (on a CPU tensor), for any N.

The same tick advances an ensemble: every leaf of the ``MeshState`` may
carry a leading ``[E]`` axis (planes ``[E, N, N]``, vectors ``[E, N]``,
``tick`` ``[E]``, ``key`` ``[E, 2]``, ``TickInputs.drop_rate`` ``[E]``),
and member e then gets exactly its standalone tick -- the port of the JAX
package's ``vmap`` over this function (``derive.py::make_fleet_tick``).
Each gate stays one host sync for the whole ensemble ("does any member
need this phase"); where a gated branch is an identity for a member whose
own predicate is false the branch runs for all, and where it is not (the
proxies, ``fp2``/``n2``, the G-phase recounts) the result is selected per
member, as ``vmap`` turns ``lax.cond`` into a select. Reductions that feed
metrics and counters reduce per member; index reads go through the
per-member helpers ``_take`` / ``_take_rows``. The tick and the draw keys
are read on the device (``rng.state_draw_keys``), so only the gates fetch
to the host -- and K3's threshold, an int argument of the kernel.

``group=`` builds the row-sharded tick: the port of the JAX package's
sharded twin (``parallel/mesh.py``), where GSPMD inserts the collectives.
A rank holds rows ``row0 .. row0 + B - 1`` of every plane (``[.., B, N]``)
and of every per-peer vector (``[.., B]``); ``tick`` and ``key`` are
replicated. Each read across rows goes through ``parallel/collectives.py``
-- the gathered vectors, the transposes, the ring contractions, the cell
fetches, the scatters into other ranks' rows and the reductions of the
metrics -- and every gate is a predicate over all ranks, so every rank takes
the same branches and calls the same collectives in the same order. Every
draw is the rank's rows of the dense draw, and the kernels run on the
rank's rows; the bits are the dense tick's. With no group each helper is
the identity and this is the dense tick.

``telemetry=True`` builds the same tick with protocol counters added
(``telemetry/counters.py``): it returns ``(state, TickTelemetry(metrics,
counters, fp))``, with the JAX package's counter definitions bit for bit.
Every counter is read from masks and states the tick computes anyway, inside
gates the tick takes anyway, so the telemetry build adds no host sync and the
state trajectory is the same with telemetry on or off. A ``telemetry=False``
build computes none of it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import _cuda, threefry
from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count, fused_fp_count_plain
from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k
from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion
from kaboodle_tpu_torch.ops.hashing import (
    as_u32,
    peer_record_hash,
    wrap32,
    wrap_sum,
)
from kaboodle_tpu_torch.ops.sampling import (
    bernoulli_matrix,
    broadcast_reply_prob,
    choose_among_candidates,
    choose_k_members,
    choose_one_of_oldest_k,
)
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.phasegraph import rng as pg_rng
from kaboodle_tpu_torch.phasegraph.graph import build_graph
from kaboodle_tpu_torch.phasegraph.plan import plan
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.telemetry.counters import RECORD_BYTES, ProtocolCounters, TickTelemetry

INF = torch.iinfo(torch.int32).max
_NAN = float("nan")
# The JAX fleet's refusal (derive.py:115-119): the kernels take one mesh.
PALLAS_BATCH_ERROR = (
    "fleet: the fused Pallas stage kernels do not support vmap; "
    "use the default jnp formulations (use_pallas_*=False)"
)


# The op bodies this module implements, by program region: the prologue
# runs before the dispatch, ``_rest`` runs the full program's tail in graph
# order, ``_fast`` the fused program's two passes (the A3 draw, then the
# folded update). ``_check_programs`` holds a build's plans to them, so a
# graph op with no body here is a build error, never a silent drift.
_PROLOGUE_OPS = frozenset(
    ("rng_streams", "churn", "delivery_gate", "row_stats", "join_gate",
     "manual_targets")
)
_FULL_TAIL_OPS = frozenset(
    ("suspicion", "probe_draw", "join_insert", "failed_delivery",
     "join_replies", "call1", "call2", "calls34", "anti_entropy",
     "counters", "finish")
)
_FUSED_DRAW_OPS = frozenset(("probe_draw",))
_FUSED_UPDATE_OPS = frozenset(
    ("call1", "call2", "anti_entropy", "counters", "finish")
)
_PRED_TERMS = frozenset(("any_a2", "any_join"))
# The ops ``_rest`` can end after, by their cut label.
_CUT_LABELS = frozenset(("A", "c1", "c2", "c34", "G"))


def _check_programs(graph, full_prog, fused_prog) -> None:
    names = {op.name for op in graph.ops}
    unimplemented = names - _PROLOGUE_OPS - _FULL_TAIL_OPS
    if unimplemented:
        raise NotImplementedError(
            f"graph ops without exec bodies: {sorted(unimplemented)}"
        )
    for op in graph.prologue:
        if op.name not in _PROLOGUE_OPS:
            raise NotImplementedError(f"{op.name}: no prologue body")
    if not set(full_prog.op_names()) <= _PROLOGUE_OPS | _FULL_TAIL_OPS:
        raise NotImplementedError(f"full plan runs ops without bodies: {full_prog.op_names()}")
    draw, update = fused_prog.tail
    if not (set(draw.op_names) <= _FUSED_DRAW_OPS
            and set(update.op_names) <= _FUSED_UPDATE_OPS):
        raise NotImplementedError(
            "fused plan groups ops this module does not fold: "
            f"draw={draw.op_names} update={update.op_names}"
        )
    if not set(fused_prog.pred_terms) <= _PRED_TERMS:
        raise NotImplementedError(
            f"unknown dispatch pred terms {fused_prog.pred_terms}"
        )
    if not set(graph.cut_labels) <= _CUT_LABELS:
        raise NotImplementedError(f"unknown cut labels {graph.cut_labels}")


def dispatch_pred_terms(cfg: SwimConfig) -> tuple[str, ...]:
    """The activity terms whose disjunction sends a tick to the full program:
    the fused plan's ``pred_terms`` (the same for faulty and fault-free builds)."""
    return plan(build_graph(cfg), "fused").pred_terms


def _matmul_flops(a: torch.Tensor, b: torch.Tensor) -> int:
    return 2 * a.numel() * b.shape[-1]


@_cuda.cost_unit(_matmul_flops)
def _bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean OR-matmul ``(a @ b) > 0`` with an int32 accumulator.

    An int8 product in PyTorch accumulates in int8 and wraps, so the CPU
    multiplies int32 and the card takes ``torch._int_mm`` (int8 in, int32
    out). Its operands must have every side a multiple of 8 and more than
    16 rows; other shapes are zero-padded to that. ``[E, ., .]`` operands
    multiply per member (``_int_mm`` is 2-D: one product a member)."""
    if a.device.type != "cuda":
        return (a.to(torch.int32) @ b.to(torch.int32)) > 0
    if a.dim() == 3:
        return torch.stack([_bool_matmul(a[e], b[e]) for e in range(a.shape[0])])
    m, k = a.shape
    n = b.shape[1]
    if m > 16 and m % 8 == 0 and k % 8 == 0 and n % 8 == 0:
        # bool and int8 share their bytes: reinterpret, do not copy.
        return torch._int_mm(a.contiguous().view(torch.int8),
                             b.contiguous().view(torch.int8)) > 0

    def up(x):
        return max(32, -(-x // 8) * 8)

    ap = torch.zeros((up(m), up(k)), dtype=torch.int8, device=a.device)
    bp = torch.zeros((up(k), up(n)), dtype=torch.int8, device=a.device)
    ap[:m, :k] = a
    bp[:k, :n] = b
    return torch._int_mm(ap, bp)[:m, :n] > 0


def _member_offset(x: torch.Tensor, batch: tuple, stride: int):
    """``x`` plus ``e * stride`` along the leading ``[E]`` of ``batch``, so a
    per-member index addresses member e's block of a flattened tensor."""
    if not batch:
        return x
    e = torch.arange(batch[0], dtype=torch.int64, device=x.device)
    return x + (e * stride).view(-1, *([1] * (x.dim() - 1)))


def _take(src: torch.Tensor, i: torch.Tensor, mesh_dims: int) -> torch.Tensor:
    """``src[e][i[e]]`` per member: ``i`` indexes the flattened last
    ``mesh_dims`` dims of ``src``, and carries ``src``'s leading batch dims."""
    batch = tuple(src.shape[: src.dim() - mesh_dims])
    cells = src[(0,) * len(batch)].numel() if batch else src.numel()
    flat = _member_offset(i.long(), batch, cells)
    return src.reshape(-1)[flat.reshape(-1)].view(i.shape)


def _take_vec(vec: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``vec[i]`` per member, -1-safe (clipped): ``vec`` ``[..., N]``."""
    return _take(vec, i.clamp(min=0), 1)


def _take_cell(plane: torch.Tensor, s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``plane[s, d]`` per member, -1-safe: ``plane`` ``[..., N, N]``."""
    n = plane.shape[-1]
    return _take(plane, s.clamp(min=0).long() * n + d.clamp(min=0).long(), 2)


def _take_rows(plane: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``plane[i]`` (whole rows) per member, -1-safe: ``[..., N, N]``."""
    n = plane.shape[-1]
    batch = tuple(plane.shape[:-2])
    flat = _member_offset(i.clamp(min=0).long(), batch, plane.shape[-2])
    return plane.reshape(-1, n)[flat.reshape(-1)].view(*i.shape, n)


def _scatter_or(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, val: torch.Tensor):
    """``dst[rows, cols] |= val`` per member, with -1-safe (clipped) indices.

    Only the True updates are written, so duplicate indices cannot let a
    False overwrite a True. ``dst`` is ``[..., B, N]`` (rows local to it)."""
    n = dst.shape[-1]
    flat = rows.clamp(min=0).long() * n + cols.clamp(min=0).long()
    flat = _member_offset(flat.expand(val.shape), tuple(dst.shape[:-2]), dst.shape[-2] * n)
    out = dst.clone()
    out.view(-1)[flat[val]] = True
    return out


def _col_mark(idx, tgt, val):
    """mark[d, s] = (tgt[s] == d) & val[s] -- sender s's datagram lands at its target."""
    return (idx[:, None] == tgt[..., None, :]) & val[..., None, :]


def _row_mark(idx, tgt, val):
    """mark[s, d] = (tgt[s] == d) & val[s] -- row s marks its own target."""
    return (idx[None, :] == tgt[..., :, None]) & val[..., :, None]


def _add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 wraparound ``a + b`` of two 32-bit word tensors."""
    return wrap32(a.to(torch.int64) + b.to(torch.int64))


def _drop_gate(ok: torch.Tensor, key: threefry.Key, rate: torch.Tensor,
               row0: int = 0) -> torch.Tensor:
    """``ok & (uniform(key, (n, n)) >= rate)``, drawn in chunks; per member
    under ``[E]`` keys and rates (a rate of 0 keeps every edge: ``u >= 0``).
    ``ok``'s rows are rows ``row0 ..`` of the draw."""
    out = ok.clone()
    draw = tuple(ok.shape[-2:])
    batched = rate.dim() > 0
    rate = rate[..., None, None]
    for part, at, rows in threefry.draw_chunks(key, *draw, row0=row0):
        u = threefry.bits_to_uniform(threefry.random_bits(part, draw, ok.device, rows))
        out[at] &= u >= (rate[at[0]] if batched else rate)  # at[0]: the members
    return out


def make_tick_fn(
    cfg: SwimConfig,
    faulty: bool = True,
    program: str | None = None,
    telemetry: bool = False,
    group=None,
    _cut: str | None = None,
) -> Callable[[MeshState, TickInputs], tuple[MeshState, TickMetrics | TickTelemetry]]:
    """Build the tick function for a protocol config.

    ``faulty=False`` leaves out churn, partitions and drops (the fault-free
    build). ``program`` selects the program: ``None`` (the default) the
    per-tick dispatch, ``"full"`` the full program alone, ``"fused"`` the
    fused program alone with no dispatch guard -- the caller then owns the
    precondition that no tick has a Join broadcast or suspicion activity.
    ``telemetry=True`` returns ``(state, TickTelemetry)`` instead of
    ``(state, TickMetrics)`` (module docstring). The tick takes one mesh or
    an ensemble (leaves with a leading ``[E]`` axis; metrics and counters
    then ``[E]``, digests ``[E, N]``); an ensemble with a kernel flag on
    raises ``ValueError``, the kernels taking one mesh. ``group`` (a
    ``torch.distributed`` process group) builds the row-sharded tick over
    its ranks (module docstring): the state and inputs are then each rank's
    rows, and so are the digests; metrics and counters are the whole mesh's
    on every rank.

    ``_cut`` is the stage probe, not protocol surface: a label of
    ``tick.graph.cut_labels`` ends the full program right after the op that
    carries it, and the tick returns the partial state (``tick + 1``) with
    zeroed metrics. A cut build always runs the full program (no dispatch);
    it takes neither ``telemetry=True``, nor ``program="fused"``, nor a
    ``group``. The tick carries its graph and its planned programs as
    ``tick.graph`` and ``tick.programs`` (``"full"``, ``"fused"``).
    """
    # The op graph of this build and the two programs the dispatch composes;
    # the cut labels and the dispatch predicate are read off them.
    graph = build_graph(cfg, faulty=faulty, telemetry=telemetry)
    if _cut is not None and _cut not in graph.cut_labels:
        # A typoed label would time a whole tick under a stage's name.
        raise ValueError(f"unknown _cut label {_cut!r}")
    if telemetry and _cut is not None:
        # Counters over a truncated tick would be numbers with real names.
        raise ValueError("telemetry=True is incompatible with a _cut probe")
    if program not in (None, "full", "fused"):
        raise ValueError(f"unknown program {program!r}")
    if program == "fused" and _cut is not None:
        raise ValueError("_cut probes truncate the full program only")
    if group is not None and _cut is not None:
        raise ValueError("_cut probes run on the dense tick: the row-sharded tick has no cut")
    full_prog = plan(graph, "full")
    fused_prog = plan(graph, "fused")
    _check_programs(graph, full_prog, fused_prog)
    det = cfg.deterministic
    kernel_flags = cfg.use_pallas_fp or cfg.use_pallas_oldest_k or cfg.use_pallas_suspicion
    pred_terms = fused_prog.pred_terms
    gossip_backdate = cfg.max_peer_share_age_ticks if cfg.backdate_gossip_inserts else 0
    timeout = cfg.ping_timeout_ticks

    def tick(st: MeshState, inp: TickInputs) -> tuple[MeshState, TickMetrics]:
        n = st.n
        dev = st.device
        batch = tuple(st.state.shape[:-2])  # () for one mesh, (E,) for an ensemble
        nb = len(batch)
        if nb and kernel_flags:
            raise ValueError(PALLAS_BATCH_ERROR)
        row0, nr = C.row_range(n, group)  # this rank's rows (all of them with no group)
        if st.state.shape[-2] != nr:
            raise ValueError(f"state holds {st.state.shape[-2]} rows, the rank owns {nr}")
        t = st.tick  # read on the device, never fetched
        tp, tv = t.view(*batch, 1, 1), t.view(*batch, 1)  # against planes / [.., N] rows
        tT = tp.to(st.timer.dtype)  # what a timer write stores (int16 stays int16)
        key_proxy, key_ping, key_bern, key_drop = pg_rng.state_draw_keys(st.key, t)

        idx = torch.arange(n, dtype=torch.int32, device=dev)  # peer ids: the columns
        ridx = idx[row0:row0 + nr]  # the rows' own peer ids
        lidx = torch.arange(nr, dtype=torch.int32, device=dev)  # local row indices
        rows = ridx.expand(*batch, nr)  # each row's own index, as a per-member index
        eye = ridx[:, None] == idx[None, :]
        S, T = st.state, st.timer
        lat, idv = st.latency, st.id_view
        has_lat = lat is not None
        has_idv = idv is not None
        alive, never_b, last_b = st.alive, st.never_broadcast, st.last_broadcast
        zero32 = torch.zeros((), dtype=torch.int32, device=dev)
        zero_b = torch.zeros(batch, dtype=torch.int32, device=dev)  # a per-member 0

        def gather(*xs):
            """Every rank's rows of row-indexed tensors (the tensors themselves
            with no group)."""
            return C.gather_many(xs, group, nb)

        def msum(x, dtype=None):
            """Sum over each member's cells (the whole tensor for one mesh)."""
            if not nb:
                return x.sum(dtype=dtype)
            return x.sum(dim=tuple(range(nb, x.dim())), dtype=dtype)

        def select(pred, a, b):
            """Per member: ``a`` where the member's own gate ``pred`` holds, else
            its skip branch ``b``. One mesh only reaches this inside the gate
            that took ``a``, so ``a`` it is."""
            if not nb:
                return a
            return torch.where(pred.view(*batch, *([1] * (a.dim() - nb))), a, b)

        # ---- churn: silent kill (Q8) + revive-with-reset --------------------
        if faulty:
            alive = (alive & ~inp.kill) | inp.revive
            # The per-peer vectors every rank reads at other peers' columns.
            ident_g, alive_g, part_g, kprp_g, kprf_g, kprn_g = gather(
                st.identity, alive, inp.partition, st.kpr_partner, st.kpr_fp, st.kpr_n)
        else:
            ident_g, alive_g, kprp_g, kprf_g, kprn_g = gather(
                st.identity, alive, st.kpr_partner, st.kpr_fp, st.kpr_n)
        id_row = ident_g[..., None, :]
        if faulty:
            rv = inp.revive
            rvc = rv[..., :, None]
            S = torch.where(rvc, torch.where(eye, KNOWN, 0).to(torch.int8), S)
            T = torch.where(rvc, torch.where(eye, tT, 0).to(T.dtype), T)
            if has_lat:
                lat = torch.where(rvc, _NAN, lat)
            if has_idv:
                idv = torch.where(rvc, torch.where(eye, id_row, zero32), idv)
            never_b = never_b | rv
        else:
            rv = torch.zeros((*batch, nr), dtype=torch.bool, device=dev)

        # ---- delivery gate: ok[s, d] ----------------------------------------
        # ``ok_edge(s, d, own)`` reads ok at global peer ids; ``own`` names the
        # index that is the rank's own row ("s" or "d"), or None for neither.
        # ``ok_t()`` is the rank's rows of ok's transpose ([receiver, sender]).
        ok_sym = True  # ok[s, d] == ok[d, s]: no drop gate or drop mask
        if faulty:
            ok = alive[..., :, None] & alive_g[..., None, :]
            ok = ok & (inp.partition[..., :, None] == part_g[..., None, :])
            if inp.drop_ok is not None:
                ok = ok & inp.drop_ok
                ok_sym = False
            elif bool((inp.drop_rate > 0).any()):  # replicated: no collective
                ok = _drop_gate(ok, key_drop, inp.drop_rate, row0)
                ok_sym = False
            ok_t_memo = []

            def ok_edge(s, d, own):
                if own == "s":
                    return _take_cell(ok, s - row0, d)
                if group is None:
                    return _take_cell(ok, s, d)
                if own == "d":
                    return _take_cell(ok_t(), d - row0, s)
                s, d = torch.broadcast_tensors(s, d)
                return C.take_cells(ok, s, d, group, nb)

            def ok_outer():
                return ok

            def ok_t():
                if group is None:
                    return ok.transpose(-1, -2)
                if ok_sym:
                    return ok
                if not ok_t_memo:
                    ok_t_memo.append(C.transpose(ok, group))
                return ok_t_memo[0]
        else:

            def ok_edge(s, d, own):
                return _take_vec(alive_g, s) & _take_vec(alive_g, d)

            def ok_outer():
                return alive[..., :, None] & alive_g[..., None, :]

            def ok_t():
                return ok_outer().transpose(-1, -2) if group is None else ok_outer()

        # ---- Phase-A row stats on the pre-tick snapshot ---------------------
        S0, T0 = S, T
        thr = tp - timeout
        if cfg.use_pallas_suspicion:
            # The kernel takes its threshold as an int: the tick's one fetch
            # of its own state (one mesh only; an ensemble runs no kernel).
            row_count0, jstar_pre, has_timed, has_cand_pre, wfip_any = fused_suspicion(
                S, T, alive, int(t) - timeout, row0
            )
        else:
            aged0 = alive[..., :, None] & (T0.to(torch.int32) <= thr)
            row_count0 = (S > 0).sum(dim=-1, dtype=torch.int32)
            has_timed = (aged0 & (S0 == WAITING_FOR_PING)).any(dim=-1)
            wfip_any = (aged0 & (S0 == WAITING_FOR_INDIRECT_PING)).any(dim=-1)
            jstar_pre = has_cand_pre = None
        any_a2 = C.global_any(wfip_any | has_timed, group)

        rec_hash = peer_record_hash(idx, ident_g)
        rec_row = rec_hash[..., None, :]
        rec64 = as_u32(rec_row)
        pid_row = idx.to(torch.int64)[None, :]

        def fp_count(S_now, idv_now):
            """Row fingerprints + membership counts at a point in the tick."""
            ident = idv_now if has_idv else rec_hash
            if cfg.use_pallas_fp:
                return fused_fp_count(S_now, ident)
            return fused_fp_count_plain(S_now, ident)

        def apply_marks(S, T, lat, idv, mark):
            """Q1 mark pass for one delivery wave (mark[d, s]: s reached d)."""
            if has_lat:
                waiting = (S == WAITING_FOR_PING) | (S == WAITING_FOR_INDIRECT_PING)
                sample = (tp - T.to(torch.int32)).to(torch.float32)
                upd = torch.where(torch.isnan(lat), sample, 0.8 * sample + 0.2 * lat)
                lat = torch.where(mark & waiting, upd, lat)
            if has_idv:
                idv = torch.where(mark, id_row, idv)
            S = torch.where(mark, KNOWN, S)
            T = torch.where(mark, tT, T)
            return S, T, lat, idv

        def apply_marks_delta(S, T, lat, idv, mark):
            """apply_marks + the exact (fp, count) delta the wave causes."""
            member_b = S > 0
            newm = mark & ~member_b
            if has_idv:
                old = torch.where(member_b, as_u32(peer_record_hash(pid_row, idv)), 0)
                dfp = wrap32(torch.where(mark, rec64 - old, 0).sum(dim=-1))
            else:
                dfp = wrap_sum(torch.where(newm, rec_row, zero32))
            dn = newm.sum(dim=-1, dtype=torch.int32)
            S, T, lat, idv = apply_marks(S, T, lat, idv, mark)
            return S, T, lat, idv, dfp, dn

        def _early_return(S, T, lat, idv):
            """A ``_cut`` exit: the partial state, zeroed metrics."""
            partial = MeshState(
                state=S, timer=T, alive=alive, identity=st.identity,
                never_broadcast=never_b, last_broadcast=last_b,
                kpr_partner=st.kpr_partner, kpr_fp=st.kpr_fp, kpr_n=st.kpr_n,
                tick=st.tick + 1, key=st.key, latency=lat, id_view=idv,
            )
            f32 = torch.zeros(batch, dtype=torch.float32, device=dev)
            metrics = TickMetrics(
                messages_delivered=zero_b, converged=torch.zeros(batch, dtype=torch.bool,
                                                                 device=dev),
                agree_fraction=f32, mean_membership=f32,
                fingerprint_min=zero_b, fingerprint_max=zero_b,
            )
            return partial, metrics

        # ================= A. Active phase =================================
        # A1: maybe_broadcast_join (kaboodle.rs:228-251).
        if cfg.join_broadcast_enabled:
            lonely = row_count0 <= 1
            join_b = alive & (
                never_b | (lonely & ((tv - last_b) >= cfg.rebroadcast_interval_ticks))
            )
            last_b = torch.where(join_b, tv, last_b)
            never_b = never_b & ~join_b
            any_join = C.global_any(join_b, group)
        else:
            join_b = torch.zeros((*batch, nr), dtype=torch.bool, device=dev)
            any_join = torch.zeros((), dtype=torch.bool, device=dev)

        # A4: manual pings; self-pings and out-of-range targets drop (D8).
        man_tgt = torch.where(
            alive & (inp.manual_target != ridx) & (inp.manual_target < n),
            inp.manual_target, -1,
        ).to(torch.int32)

        def _anti_entropy(S, T, lat, idv, partner, del_kpr, del_rep, fp_g, n_g):
            """Call-G apply (kaboodle.rs:707-740), shared by both programs.

            The telemetry build also returns the records in the replies SENT
            (int64 per member): a partner answers every delivered request
            (``del_kpr`` gates the send, ``del_rep`` only the reply's
            delivery), and the share excludes the requester, subtracted per
            edge. A member with no delivered request keeps its state and
            ``(fp_g, n_g)``, as its own skip branch does."""
            if not bool(C.global_any(del_kpr, group)):
                if telemetry:
                    return S, T, lat, idv, fp_g, n_g, torch.zeros(batch, dtype=torch.int64,
                                                                  device=dev)
                return S, T, lat, idv, fp_g, n_g
            partner_g, del_kpr_g = gather(partner, del_kpr)
            mark_g = _col_mark(ridx, partner_g, del_kpr_g)  # partner marks requester
            S, T, lat, idv = apply_marks(S, T, lat, idv, mark_g)
            # The reply share is taken before the requester-marks-partner write.
            S_share, T_share = S, T

            def share_plane():
                return (S_share == KNOWN) & ~eye & (
                    (tp - T_share.to(torch.int32)) < cfg.max_peer_share_age_ticks
                )

            share_f = srow = None
            if telemetry:
                share_f = share_plane()
                share_cnt = share_f.sum(dim=-1, dtype=torch.int32)
                if group is None:
                    own = _take_cell(share_f, partner, rows)  # the requester's cell
                else:  # the partners' rows come home once, for this and the reply
                    srow = C.ring_take_rows(share_f, partner, group)
                    own = srow.gather(-1, rows.long()[..., None])[..., 0]
                (share_cnt_g,) = gather(share_cnt)
                ae_records = msum(torch.where(
                    del_kpr, _take_vec(share_cnt_g, partner) - own.to(torch.int32), 0),
                    torch.int64)
            mark_rep = _row_mark(idx, partner, del_rep)  # requester marks partner
            S = torch.where(mark_rep, KNOWN, S)
            T = torch.where(mark_rep, tT, T)
            if bool(C.global_any(del_rep, group)):
                if share_f is None:
                    share_f = share_plane()
                if srow is None:
                    srow = C.ring_take_rows(share_f, partner, group)
                rep_ins = del_rep[..., :, None] & srow & ~eye & ~(S > 0)
                S = torch.where(rep_ins, KNOWN, S)
                T = torch.where(rep_ins, (tp - gossip_backdate).to(T.dtype), T)
                if has_idv:
                    idv = torch.where(rep_ins, id_row, idv)
            fp_f, n_f = fp_count(S, idv)
            if nb:
                kpr_m = C.member_any(del_kpr, group, nb)
                fp_f, n_f = select(kpr_m, fp_f, fp_g), select(kpr_m, n_f, n_g)
            if telemetry:
                return S, T, lat, idv, fp_f, n_f, ae_records
            return S, T, lat, idv, fp_f, n_f

        def _ae_phase01(fp_g, n_g, fp1_g, n1_g, del_ack, del_ack_man, ping_tgt):
            """Anti-entropy candidate phases 0-1 (take_sync_request order);
            ``fp1_g``/``n1_g`` are every peer's call-1 digests."""
            m0 = (kprp_g[..., None, :] == ridx[:, None]) & alive[..., :, None] & (
                ~rv[..., :, None])
            match0 = m0 & (kprf_g[..., None, :] != fp_g[..., :, None]) & (
                n_g[..., :, None] <= kprn_g[..., None, :]
            )
            prio0 = torch.where(match0, idx[None, :], INF).amin(dim=-1)
            peer0 = prio0  # sender == candidate peer for KPR candidates
            m_d = del_ack & (_take_vec(fp1_g, ping_tgt) != fp_g) & (
                n_g <= _take_vec(n1_g, ping_tgt))
            m_m = del_ack_man & (_take_vec(fp1_g, man_tgt) != fp_g) & (
                n_g <= _take_vec(n1_g, man_tgt))
            prio_d = torch.where(m_d, n + ping_tgt, INF)
            prio_m = torch.where(m_m, n + man_tgt, INF)
            prio1 = torch.minimum(prio_d, prio_m)
            peer1 = torch.where(prio_d <= prio_m, ping_tgt, man_tgt)
            return prio0, peer0, prio1, peer1

        def _finish(S, T, lat, idv, kpr_partner_new, fp_g, n_g, fp_f, n_f, msgs,
                    counters=None, records=None):
            """Metrics + next-state assembly, shared by both programs.

            In the telemetry build ``counters`` carries the program's event
            counts (this rank's rows) and ``records`` the gossip records sent;
            the two pre/post-state counters (suspicions refuted:
            WaitingForIndirectPing at S0 and Known now; armed timers: waiting
            cells of alive rows at tick end) are filled in here, every sum is
            reduced over the ranks, and ``fp_f`` rides out as the flight
            recorder's digest plane."""
            converged, fpa_min, fpa_max, n_alive = C.fingerprint_agreement(alive, fp_f, group)
            agree = msum(alive & (fp_f == fpa_min[..., None]), torch.int32)
            sums = [msgs, agree]
            if telemetry:
                counters = dataclasses.replace(
                    counters,
                    suspicions_refuted=msum((S0 == WAITING_FOR_INDIRECT_PING) & (S == KNOWN),
                                            torch.int32),
                    armed_timers=msum(alive[..., :, None] & (
                        (S == WAITING_FOR_PING) | (S == WAITING_FOR_INDIRECT_PING)), torch.int32),
                )
                names = [f.name for f in dataclasses.fields(ProtocolCounters)
                         if f.name != "gossip_bytes"]
                sums += [getattr(counters, k) for k in names] + [records]
            sums = C.reduce_sum_many(sums, group)
            msgs, agree = sums[:2]
            if telemetry:
                counters = dataclasses.replace(
                    counters, gossip_bytes=_gossip_bytes(sums[-1]),
                    **dict(zip(names, sums[2:-1])))
            # A float sum: taken over the whole [N] vector, in the dense order.
            member_f = C.gather_rows(torch.where(alive, n_f, 0).to(torch.float32), group)
            denom = n_alive.clamp(min=1)
            new_state = MeshState(
                state=S, timer=T, alive=alive, identity=st.identity,
                never_broadcast=never_b, last_broadcast=last_b,
                kpr_partner=kpr_partner_new.to(torch.int32), kpr_fp=fp_g, kpr_n=n_g,
                tick=st.tick + 1, key=st.key, latency=lat, id_view=idv,
            )
            metrics = TickMetrics(
                messages_delivered=msgs.to(torch.int32),
                converged=converged,
                agree_fraction=agree.to(torch.float32) / denom,
                mean_membership=msum(member_f) / denom,
                fingerprint_min=fpa_min,
                fingerprint_max=fpa_max,
            )
            if telemetry:
                return new_state, TickTelemetry(metrics=metrics, counters=counters, fp=fp_f)
            return new_state, metrics

        def _i32(x):
            return msum(x, torch.int32)

        def _gossip_bytes(records):
            """RECORD_BYTES x records mod 2^32, as int32 bits (int64 ``records``)."""
            return wrap32(RECORD_BYTES * records)

        def _rest():
            """The full program's tail: A2 suspicion handling onward."""
            # The gates below are predicates over every rank's rows.
            S_, T_, lat_, idv_ = S, T, lat, idv
            if cfg.use_pallas_suspicion:
                jstar, has_cand = jstar_pre, has_cand_pre
            else:
                timed_wfp = alive[..., :, None] & (S0 == WAITING_FOR_PING) & (
                    T0.to(torch.int32) <= thr
                )
                tsel = torch.where(timed_wfp, T0, torch.iinfo(T0.dtype).max)
                min_t = tsel.amin(dim=-1)
                jstar_mask = timed_wfp & (T0 == min_t[..., None])
                jstar = torch.where(jstar_mask, idx[None, :], INF).amin(dim=-1)
                jstar = torch.where(has_timed, jstar, -1).to(torch.int32)
                has_cand = ((S0 == KNOWN) & ~eye).any(dim=-1)
            escalate = has_timed & has_cand
            insta_remove = has_timed & ~has_cand  # no proxies -> drop (:599-605)
            jstar_cell = idx[None, :] == jstar[..., :, None]
            any_rem = bool(C.global_any(wfip_any | insta_remove, group))
            escalating = bool(C.global_any(escalate, group))
            joining = bool(any_join)
            # Each member's own escalation gate (only an ensemble selects on it).
            esc_m = C.member_any(escalate, group, nb) if nb else None

            # A2: handle_suspected_peers on the pre-tick snapshot.
            k_prox = min(cfg.num_indirect_ping_peers, n)
            no_proxies = torch.zeros((*batch, nr, k_prox), dtype=torch.int32, device=dev)
            if escalating:
                known_cand = (S0 == KNOWN) & ~eye
                proxies, proxies_valid = choose_k_members(
                    known_cand, cfg.num_indirect_ping_peers, key_proxy, det, row0
                )
                proxies = select(esc_m, proxies, no_proxies)
            else:
                proxies = no_proxies
                proxies_valid = torch.zeros((*batch, nr, k_prox), dtype=torch.bool, device=dev)
            proxies_valid = proxies_valid & escalate[..., :, None]

            def _a2_rem():
                r = alive[..., :, None] & (S0 == WAITING_FOR_INDIRECT_PING) & (
                    T0.to(torch.int32) <= thr
                )
                return r | (insta_remove[..., :, None] & jstar_cell)

            deaths = zero_b
            if bool(any_a2):
                rem = _a2_rem()
                if telemetry:
                    # The WFIP timeouts and the insta-removals (each a timed-out
                    # WaitingForPing cell) are disjoint: rem counts both.
                    deaths = _i32(rem)
                S_ = torch.where(rem, 0, S_)
                if has_lat:
                    lat_ = torch.where(rem, _NAN, lat_)
                esc_cell = escalate[..., :, None] & jstar_cell
                S_ = torch.where(esc_cell, WAITING_FOR_INDIRECT_PING, S_)
                T_ = torch.where(esc_cell, tT, T_)

            # A3: ping_random_peer (kaboodle.rs:655-703) on the post-A2 state.
            if cfg.use_pallas_oldest_k:
                kk = 1 if det else cfg.num_candidate_target_peers
                cand_idx, cand_valid = fused_oldest_k(S_, T_, alive, kk, row0)
                ping_tgt = choose_among_candidates(cand_idx, cand_valid, key_ping, det, row0)
            else:
                elig = alive[..., :, None] & (S_ == KNOWN) & ~eye
                ping_tgt = choose_one_of_oldest_k(
                    T_, elig, cfg.num_candidate_target_peers, key_ping, det,
                    method=cfg.oldest_k_method, row0=row0,
                )
            has_ping = ping_tgt >= 0
            tgt_cell = _row_mark(idx, ping_tgt, has_ping)
            S_ = torch.where(tgt_cell, WAITING_FOR_PING, S_)
            T_ = torch.where(tgt_cell, tT, T_)
            if _cut == "A":
                return _early_return(S_, T_, lat_, idv_)

            member_a = S_ > 0
            row_count_a = member_a.sum(dim=-1, dtype=torch.int32)

            # ============= B. Broadcast delivery ============================
            if cfg.join_broadcast_enabled:
                # [receiver, origin]; row-major again after the transpose, so
                # every plane written through it stays contiguous.
                (join_b_g,) = gather(join_b)
                Jm = (join_b_g[..., None, :] & ok_t() & ~eye).contiguous()
                is_new_ro = Jm & ~member_a
                S_ = torch.where(Jm, KNOWN, S_)
                T_ = torch.where(Jm, tT, T_)
                if has_idv:
                    idv_ = torch.where(Jm, id_row, idv_)
            else:
                Jm = torch.zeros((*batch, nr, n), dtype=torch.bool, device=dev)
                is_new_ro = Jm

            if not cfg.faithful_failed_broadcast and any_rem:
                # Failed(j) from i delivered at r (r != j) removes j; a
                # same-tick Join(j) wins only against origins i < j.
                rem = _a2_rem()
                rem_gt = rem & (ridx[:, None] > idx[None, :])
                okt = ok_t()
                fail_del = ~eye & torch.where(
                    Jm, C.ring_or_matmul(okt, rem_gt, group, _bool_matmul),
                    C.ring_or_matmul(okt, rem, group, _bool_matmul),
                )
                S_ = torch.where(fail_del, 0, S_)
                if has_lat:
                    lat_ = torch.where(fail_del, _NAN, lat_)

            # Join responses (kaboodle.rs:333-392) and the gossip union.
            reply_del = reply_t = gossip = None
            join_records = torch.zeros(batch, dtype=torch.int64, device=dev) if telemetry else None
            if cfg.join_broadcast_enabled and joining:
                n_after = row_count_a[..., :, None] + torch.cumsum(is_new_ro, dim=-1,
                                                                   dtype=torch.int32)
                reply_p = broadcast_reply_prob(n_after)
                bern = bernoulli_matrix(key_bern, reply_p, (nr, n), det, row0)
                reply = is_new_ro & bern  # [r, o]
                reply_del = reply & ok_outer()
                reply_t = C.transpose(reply_del, group)  # [o, r]
                base_c = None  # the D5-capped start-of-round map
                if telemetry:
                    # Records in the join-response shares SENT (``reply``, not
                    # ``reply_del``). Uncapped, the share to joiner o is r's
                    # sequential map at reply time, of size ``n_after``; over
                    # the D5 cap it is the capped base plus this round's
                    # joiners not already in it.
                    rec_cnt = n_after
                    if cfg.max_share_peers:
                        cap = cfg.max_share_peers
                        base_c = member_a & (
                            torch.cumsum(member_a, dim=-1, dtype=torch.int32) <= cap)
                        clen = row_count_a.clamp(max=cap)[..., :, None] + torch.cumsum(
                            Jm & ~base_c, dim=-1, dtype=torch.int32)
                        rec_cnt = torch.where(n_after <= cap, n_after, clen)
                    join_records = msum(torch.where(reply, rec_cnt, 0), torch.int64)
                if bool(C.global_any(reply_del, group)):
                    share_base = member_a
                    if cfg.max_share_peers and n > cfg.max_share_peers:
                        # D5: cap to the lowest-index members of the map.
                        if base_c is None:
                            within_cap = (
                                torch.cumsum(member_a, dim=-1, dtype=torch.int32)
                                <= cfg.max_share_peers
                            )
                            base_c = member_a & within_cap
                        share_base = base_c
                    term1 = C.ring_or_matmul(reply_t, share_base, group, _bool_matmul)  # [o, j]
                    term2 = C.ring_or_matmul(reply_t, Jm, group, _bool_matmul)
                    tri = idx[None, :] <= ridx[:, None]  # j <= o
                    gossip = term1 | (term2 & tri)

            # ============= Call 1: Pings + PingRequests =====================
            ok_ping = has_ping & ok_edge(rows, ping_tgt, "s")
            ok_man = (man_tgt >= 0) & ok_edge(rows, man_tgt, "s")
            del_pr = proxies_valid & ok_edge(rows[..., None], proxies, "s")  # [.., N, k]
            del_ack = ok_ping & ok_edge(ping_tgt, rows, "d")  # tgt -> pinger
            del_ack_man = ok_man & ok_edge(man_tgt, rows, "d")
            ping_tgt_g, ok_ping_g, man_tgt_g, ok_man_g, del_ack_g, del_ack_man_g = gather(
                ping_tgt, ok_ping, man_tgt, ok_man, del_ack, del_ack_man)
            mark1 = _col_mark(ridx, ping_tgt_g, ok_ping_g) | _col_mark(ridx, man_tgt_g, ok_man_g)
            if escalating:
                proxies_g, del_pr_g = gather(proxies, del_pr)
                for kk in range(proxies.shape[-1]):
                    mark1 = mark1 | _col_mark(ridx, proxies_g[..., kk], del_pr_g[..., kk])
            fp0, n0 = fp_count(S_, idv_)
            S_, T_, lat_, idv_, dfp1, dn1 = apply_marks_delta(S_, T_, lat_, idv_, mark1)
            fp1, n1 = _add32(fp0, dfp1), n0 + dn1
            if _cut == "c1":
                return _early_return(S_, T_, lat_, idv_)

            del_pping = del_pr & ok_edge(proxies, jstar[..., None], None)  # proxy -> suspect

            # ============= Call 2: Acks, proxy Pings, join responses ========
            mark2 = _row_mark(idx, ping_tgt, del_ack) | _row_mark(idx, man_tgt, del_ack_man)
            if reply_t is not None:  # joiner marks join-responder
                mark2 = mark2 | reply_t.contiguous()
            if escalating:  # suspect marks proxy
                mark2 = C.scatter_or_rows(mark2, jstar[..., None], proxies, del_pping, group, nb)
            S_, T_, lat_, idv_, dfp2, dn2 = apply_marks_delta(S_, T_, lat_, idv_, mark2)

            if gossip is not None:  # gossip-learned peers, back-dated (Q6)
                gossip_new = gossip & ~(S_ > 0)
                S_ = torch.where(gossip_new, KNOWN, S_)
                T_ = torch.where(gossip_new, (tp - gossip_backdate).to(T_.dtype), T_)
                if has_idv:
                    idv_ = torch.where(gossip_new, id_row, idv_)

            no_fp = torch.zeros((*batch, nr), dtype=torch.int32, device=dev)
            if escalating:
                fp2, n2 = fp_count(S_, idv_)
                fp2, n2 = select(esc_m, fp2, no_fp), select(esc_m, n2, no_fp)
            else:
                fp2 = n2 = no_fp
            if _cut == "c2":
                return _early_return(S_, T_, lat_, idv_)

            del_pack = del_pping & ok_edge(jstar[..., None], proxies, None)  # [.., N, k]
            pop_hit = ((_take_vec(ping_tgt_g, proxies) == jstar[..., None])
                       & _take_vec(del_ack_g, proxies)) | (
                (_take_vec(man_tgt_g, proxies) == jstar[..., None])
                & _take_vec(del_ack_man_g, proxies)
            )
            fwd_c = del_pr & pop_hit  # proxy forwards its call-2 ack payload (fp1)
            del_fwd_c = fwd_c & ok_edge(proxies, rows[..., None], "d")
            fwd = del_pack & ~pop_hit
            del_fwd = fwd & ok_edge(proxies, rows[..., None], "d")

            # ======== Calls 3 + 4: escalation-only delivery waves ===========
            if escalating:
                no_marks = torch.zeros((*batch, nr, n), dtype=torch.bool, device=dev)
                mark3 = C.scatter_or_rows(no_marks, proxies, jstar[..., None], del_pack,
                                          group, nb)
                mark3 = _scatter_or(mark3, lidx[:, None], proxies, del_fwd_c)
                S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, mark3)
                mark4 = _scatter_or(no_marks, lidx[:, None], proxies, del_fwd)
                S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, mark4)
                if not cfg.faithful_indirect_ack:
                    cleared = (del_fwd | del_fwd_c).any(dim=-1)
                    clr_cell = cleared[..., :, None] & jstar_cell & (S_ > 0)
                    S_ = torch.where(clr_cell, KNOWN, S_)
                    T_ = torch.where(clr_cell, tT, T_)
            if _cut == "c34":
                return _early_return(S_, T_, lat_, idv_)

            # ============= G. Anti-entropy ==================================
            if joining or escalating:
                fp_g, n_g = fp_count(S_, idv_)
                if nb:
                    recount = C.member_any(join_b, group, nb) | esc_m
                    fp_g = select(recount, fp_g, _add32(fp1, dfp2))
                    n_g = select(recount, n_g, n1 + dn2)
            else:
                fp_g, n_g = _add32(fp1, dfp2), n1 + dn2

            fp1_g, n1_g, fp2_g, n2_g, fp_g_g, n_g_g = gather(fp1, n1, fp2, n2, fp_g, n_g)
            prio0, peer0, prio1, peer1 = _ae_phase01(
                fp_g, n_g, fp1_g, n1_g, del_ack, del_ack_man, ping_tgt
            )
            # Phase 2 (call-3 acks) and phase 3 (call-4 forwarded acks).
            base2, base3 = 2 * n, 3 * n
            x_fp2, x_n2 = _take_vec(fp2_g, jstar), _take_vec(n2_g, jstar)
            m_px = del_pack & (x_fp2[..., None] != _take_vec(fp_g_g, proxies)) & (
                _take_vec(n_g_g, proxies) <= x_n2[..., None])
            prio_proxy = C.scatter_min(
                n, proxies.reshape(*batch, -1),
                torch.where(m_px, base2 + jstar[..., None], INF).reshape(*batch, -1), group,
            )
            peer_proxy = prio_proxy - base2
            x_fp1, x_n1 = _take_vec(fp1_g, jstar), _take_vec(n1_g, jstar)
            m_cf = del_fwd_c & (x_fp1[..., None] != fp_g[..., None]) & (
                n_g[..., None] <= x_n1[..., None])
            prio_coinc = torch.where(m_cf, base2 + proxies, INF).amin(dim=-1)
            prio2 = torch.minimum(prio_proxy, prio_coinc)
            peer2 = torch.where(prio_proxy <= prio_coinc, peer_proxy, jstar)
            m_f = del_fwd & (x_fp2[..., None] != fp_g[..., None]) & (
                n_g[..., None] <= x_n2[..., None])
            prio3 = torch.where(m_f, base3 + proxies, INF).amin(dim=-1)
            peer3 = jstar

            best = torch.minimum(torch.minimum(prio0, prio1), torch.minimum(prio2, prio3))
            partner = torch.where(
                best == prio0, peer0,
                torch.where(best == prio1, peer1, torch.where(best == prio2, peer2, peer3)),
            ).to(torch.int32)
            has_req = (best != INF) & alive
            partner = torch.where(has_req, partner, -1)
            del_kpr = has_req & ok_edge(rows, partner, "s")
            del_rep = del_kpr & ok_edge(partner, rows, "d")  # partner -> requester
            if _cut == "G":
                return _early_return(S_, T_, lat_, idv_)

            S_, T_, lat_, idv_, fp_f, n_f, *ae = _anti_entropy(
                S_, T_, lat_, idv_, partner, del_kpr, del_rep, fp_g, n_g
            )
            msgs = sum(
                msum(x, torch.int64)
                for x in (ok_ping, ok_man, del_pr, del_ack, del_ack_man, del_pping,
                          del_pack, del_fwd_c, del_fwd, del_kpr, del_rep)
            )
            if reply_del is not None:
                msgs = msgs + msum(reply_del, torch.int64)
            counters = records = None
            if telemetry:
                counters = ProtocolCounters(
                    pings_sent=_i32(has_ping) + _i32(man_tgt >= 0) + _i32(del_pr),
                    acks_sent=_i32(ok_ping) + _i32(ok_man) + _i32(del_pping) + _i32(fwd)
                    + _i32(fwd_c),
                    ping_reqs_sent=_i32(proxies_valid),
                    suspicions_raised=_i32(escalate),
                    suspicions_refuted=zero_b,  # filled by _finish
                    deaths_declared=deaths,
                    joins_disseminated=_i32(Jm) if joining else zero_b,
                    gossip_bytes=None,  # filled by _finish, from records
                    armed_timers=zero_b,  # filled by _finish
                )
                records = ae[0] + join_records
            return _finish(
                S_, T_, lat_, idv_, torch.where(del_kpr, partner, -1),
                fp_g, n_g, fp_f, n_f, msgs, counters, records,
            )

        def _fast():
            """The fused program: a tick with no Join broadcast and no
            suspicion activity (A2 is a no-op, no proxies, no join replies,
            calls 3-4 carry nothing). Every mask is a one-hot outer form of
            ``[N]`` vectors, so the A3 write, the call-1 and call-2 marks and
            both waves' exact (fp, count) deltas compose from the ORIGINAL
            (S, T) in one update."""
            S_, T_, lat_, idv_ = S, T, lat, idv
            elig = alive[..., :, None] & (S_ == KNOWN) & ~eye
            ping_tgt = choose_one_of_oldest_k(
                T_, elig, cfg.num_candidate_target_peers, key_ping, det,
                method=cfg.oldest_k_method, row0=row0,
            )
            has_ping = ping_tgt >= 0
            ok_ping = has_ping & ok_edge(rows, ping_tgt, "s")
            ok_man = (man_tgt >= 0) & ok_edge(rows, man_tgt, "s")
            del_ack = ok_ping & ok_edge(ping_tgt, rows, "d")
            del_ack_man = ok_man & ok_edge(man_tgt, rows, "d")

            tgt_cell = _row_mark(idx, ping_tgt, has_ping)
            ping_tgt_g, ok_ping_g, man_tgt_g, ok_man_g = gather(ping_tgt, ok_ping, man_tgt, ok_man)
            mark1 = _col_mark(ridx, ping_tgt_g, ok_ping_g) | _col_mark(ridx, man_tgt_g, ok_man_g)
            mark2 = _row_mark(idx, ping_tgt, del_ack) | _row_mark(idx, man_tgt, del_ack_man)
            mark_k = mark1 | mark2

            member0 = S_ > 0
            n0 = member0.sum(dim=-1, dtype=torch.int32)
            member1 = member0 | mark1
            dn1 = (mark1 & ~member0).sum(dim=-1, dtype=torch.int32)
            dn2 = (mark2 & ~member1).sum(dim=-1, dtype=torch.int32)
            if has_idv:
                old_hash = torch.where(member0, as_u32(peer_record_hash(pid_row, idv_)), 0)
                fp0 = wrap32(old_hash.sum(dim=-1))
                dfp1 = wrap32(torch.where(mark1, rec64 - old_hash, 0).sum(dim=-1))
                hash1 = torch.where(mark1, rec64, old_hash)
                dfp2 = wrap32(torch.where(mark2, rec64 - hash1, 0).sum(dim=-1))
                idv_ = torch.where(mark_k, id_row, idv_)
            else:
                fp0 = wrap_sum(torch.where(member0, rec_row, zero32))
                dfp1 = wrap_sum(torch.where(mark1 & ~member0, rec_row, zero32))
                dfp2 = wrap_sum(torch.where(mark2 & ~member1, rec_row, zero32))
            if has_lat:
                # Wave-ordered EWMA sampling, composed: wave 1 samples where
                # the post-A3 state was waiting, wave 2 where the post-wave-1
                # state still was.
                S_a3 = torch.where(tgt_cell, WAITING_FOR_PING, S_)
                T_a3 = torch.where(tgt_cell, tT, T_)
                waiting1 = (S_a3 == WAITING_FOR_PING) | (S_a3 == WAITING_FOR_INDIRECT_PING)
                sample1 = (tp - T_a3.to(torch.int32)).to(torch.float32)
                upd1 = torch.where(torch.isnan(lat_), sample1, 0.8 * sample1 + 0.2 * lat_)
                lat1 = torch.where(mark1 & waiting1, upd1, lat_)
                S_1 = torch.where(mark1, KNOWN, S_a3)
                T_1 = torch.where(mark1, tT, T_a3)
                waiting2 = (S_1 == WAITING_FOR_PING) | (S_1 == WAITING_FOR_INDIRECT_PING)
                sample2 = (tp - T_1.to(torch.int32)).to(torch.float32)
                upd2 = torch.where(torch.isnan(lat1), sample2, 0.8 * sample2 + 0.2 * lat1)
                lat_ = torch.where(mark2 & waiting2, upd2, lat1)
            S_ = torch.where(mark_k, KNOWN, torch.where(tgt_cell, WAITING_FOR_PING, S_))
            T_ = torch.where(mark_k | tgt_cell, tT, T_)
            fp1, n1 = _add32(fp0, dfp1), n0 + dn1
            fp_g, n_g = _add32(fp1, dfp2), n1 + dn2

            # G: anti-entropy candidates, phases 0 and 1 only.
            fp1_g, n1_g = gather(fp1, n1)
            prio0, peer0, prio1, peer1 = _ae_phase01(
                fp_g, n_g, fp1_g, n1_g, del_ack, del_ack_man, ping_tgt
            )
            best = torch.minimum(prio0, prio1)
            partner = torch.where(best == prio0, peer0, peer1).to(torch.int32)
            has_req = (best != INF) & alive
            partner = torch.where(has_req, partner, -1)
            del_kpr = has_req & ok_edge(rows, partner, "s")
            del_rep = del_kpr & ok_edge(partner, rows, "d")

            S_, T_, lat_, idv_, fp_f, n_f, *ae = _anti_entropy(
                S_, T_, lat_, idv_, partner, del_kpr, del_rep, fp_g, n_g
            )
            msgs = sum(
                msum(x, torch.int64)
                for x in (ok_ping, ok_man, del_ack, del_ack_man, del_kpr, del_rep)
            )
            counters = records = None
            if telemetry:
                # No escalation, join or A2 removal on these ticks: the
                # counters those feed are structurally zero.
                counters = ProtocolCounters(
                    pings_sent=_i32(has_ping) + _i32(man_tgt >= 0),
                    acks_sent=_i32(ok_ping) + _i32(ok_man),
                    ping_reqs_sent=zero_b,
                    suspicions_raised=zero_b,
                    suspicions_refuted=zero_b,  # filled by _finish
                    deaths_declared=zero_b,
                    joins_disseminated=zero_b,
                    gossip_bytes=None,  # filled by _finish, from records
                    armed_timers=zero_b,  # filled by _finish
                )
                records = ae[0]
            return _finish(
                S_, T_, lat_, idv_, torch.where(del_kpr, partner, -1),
                fp_g, n_g, fp_f, n_f, msgs, counters, records,
            )

        # ---- dispatch ------------------------------------------------------
        # On an ensemble the gate is whether ANY member needs the full
        # program; the full program is exact for every member (the dispatch
        # contract), so the fused one runs only when no member needs more.
        # A cut always runs the full program.
        if program == "fused":
            return _fast()
        if program == "full" or not cfg.fast_path or _cut is not None:
            return _rest()
        terms = {"any_a2": any_a2, "any_join": any_join}
        pred = terms[pred_terms[0]]
        for term in pred_terms[1:]:
            pred = pred | terms[term]
        return _rest() if bool(pred) else _fast()

    tick.graph = graph
    tick.programs = {"full": full_prog, "fused": fused_prog}
    return tick
