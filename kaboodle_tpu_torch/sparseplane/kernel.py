"""The blocked-sparse SWIM tick: segment gather/scatter over ``[N, K]`` blocks.

The port of ``kaboodle_tpu/sparseplane/kernel.py``, bit-exact with it per
tick in every ``SparseState`` and ``SparseTickMetrics`` field. The passes
are ``SPARSE_TAIL_PASSES``; a build plans ``plan(build_graph(cfg,
layout="blocked_topk"), "sparse")`` and refuses a program whose tail is
not those passes in this order (:func:`_sparse_program`):

  expiry    suspicion twin: WaitingForIndirectPing slots age out, the oldest
            timed-out WaitingForPing slot per row escalates to an indirect
            ping chain over counter-drawn proxy slots.
  draw      probe-draw twin: uniform pick among the oldest-k Known slots
            (``ops/sampling.py::choose_one_of_oldest_k`` over ``[N, K]``).
  exchange  ping/ack delivery: the ack refreshes the armed slot; the ping
            sender-marks the sender inside the *target's* block.
  gossip    each delivered ack piggybacks ``gossip_fanout`` random sharable
            records from the target's block.
  repair    bounded block edits (sparseplane/repair.py).
  finish    fingerprint + metrics + counter advance.

As in the JAX package, no hand kernel runs on this path: every pass is a
handful of PyTorch ops over ``[N, K]``, ``[N, D, K]`` or ``[N, C, K]``,
inside a ``kaboodle:sparse_<pass>`` profiler range (``telemetry/trace.py``).

Keys: the six stream keys are derived on the device from the state's
``seed`` and ``cursor`` tensors (``rng.stream_keys``, one batched fold), as
the dense tick derives its keys from ``key`` and ``tick``. Carrying the
cursor on the host would tie the state to a host counter that checkpoints
and callers must keep in step; reading it back once a tick would be a host
sync the JAX scan does not have. So the tick fetches nothing from the
device: a run of ticks is queued without a wait.

Where a straight transcription of the JAX tick would go wrong:

- ``jnp.argmax`` returns the first maximum; here every argmax is
  :func:`_first_argmax` (the max, then the smallest index holding it), so
  the tie order does not rest on ``torch.argmax`` and bool masks need no
  CUDA argmax for ``bool``.
- The JAX sender-mark is ``.at[mark_rows, mslot].set(..., mode="drop")``
  with row ``n`` as the "not delivered" sentinel; an out-of-range row is a
  device assert in torch. Here the marks are a scatter-max of 0/1 flags
  into the ``[N * K]`` cells at the target's (valid) row: an undelivered
  ping scatters 0, which leaves its cell unmarked -- JAX's drop -- and no
  row is clamped onto a real cell. Delivered marks are conflict-free by
  slot identity (a sender's id sits in at most one occupied slot of its
  target's block), and a max does not depend on the order anyway.
- The unknown-sender candidate (``.at[pc_rows].max(rows, mode="drop")``)
  is ``scatter_reduce_(..., "amax", include_self=True)`` from a ``-1``
  vector, an undelivered ping scattering ``-1``: deterministic, max being
  commutative.
- int16 timers wrap as in JAX: ``now_t`` is the low 16 bits of the tick,
  the backdated gossip stamp ``now_t - backdate`` is an int16 subtraction,
  and ages are taken in int32 from the widened timer.
- The float32 ``mean_membership`` and ``block_fill`` sums are exact integer
  counts converted to float32 once. At test sizes every partial sum is
  below 2^24, so they equal the JAX float sums bit for bit; at N = 2^20,
  K = 16 the membership sum passes 2^24 and the JAX value depends on its
  summation order, while this one does not depend on the device.

Known deviations from the dense oracle (distributional, not bitwise) are
the JAX package's, listed in its kernel's docstring.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.ops.hashing import fingerprint_agreement
from kaboodle_tpu_torch.ops.sampling import choose_one_of_oldest_k
from kaboodle_tpu_torch.phasegraph import build_graph, plan
from kaboodle_tpu_torch.sparseplane import rng as sprng
from kaboodle_tpu_torch.sparseplane.repair import repair_blocks, reseed_revived
from kaboodle_tpu_torch.sparseplane.state import (
    SparseState,
    SparseTickInputs,
    SparseTickMetrics,
    SparseSpec,
    sparse_fingerprint,
)
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.telemetry.trace import op_scope

# The tail passes this kernel runs, in its order.
SPARSE_TAIL_PASSES = ("expiry", "draw", "exchange", "gossip", "repair", "finish")

# Stream order of the keys the tick derives (``rng.stream_keys``).
_STREAMS = (sprng.STREAM_PROXY, sprng.STREAM_CHAIN, sprng.STREAM_DRAW,
            sprng.STREAM_PING, sprng.STREAM_ACK, sprng.STREAM_GOSSIP)


def _validate(cfg: SwimConfig) -> None:
    if cfg.join_broadcast_enabled:
        raise ValueError(
            "blocked_topk layout has no broadcast domain: build the config "
            "with join_broadcast_enabled=False (gossip boot via ring "
            "contacts replaces the join broadcast)"
        )
    if not cfg.faithful_failed_broadcast:
        raise ValueError(
            "intended-semantics failed-broadcast replay is dense-only "
            "([N, N, N] delivery replay); blocked_topk requires "
            "faithful_failed_broadcast=True"
        )
    if not cfg.faithful_indirect_ack:
        raise ValueError(
            "blocked_topk implements only the faithful indirect-ack "
            "attribution (forwarded ack refreshes the proxy, quirk Q11); "
            "set faithful_indirect_ack=True"
        )


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax(x, axis=-1)`` as int32: the FIRST index of the maximum.

    ``x`` is an integer or bool tensor (bools compare as 0/1)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    width = x.shape[-1]
    pos = torch.arange(width, dtype=torch.int32, device=x.device)
    at_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(at_max, pos, width).amin(dim=-1)


def _rank_pick(mask: torch.Tensor, want: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot of the ``want``-th True per row: mask ``[N, K]``, want ``[N, D]``.

    Returns ``(slot [N, D] int32, ok [N, D] bool)`` -- ``ok`` is False where
    the requested rank exceeds the row's population (slot 0 there)."""
    rank = mask.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1  # [N, K]
    sel = mask[:, None, :] & (rank[:, None, :] == want[:, :, None])  # [N, D, K]
    return _first_argmax(sel), sel.any(dim=-1)


def _clip_rank(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``clip(floor(u * count), 0, max(count - 1, 0))`` per row, in float32 then int32."""
    want = torch.floor(u * count[:, None].to(torch.float32)).to(torch.int32)
    return torch.minimum(want.clamp(min=0), (count - 1).clamp(min=0)[:, None])


def _sparse_program(cfg: SwimConfig, faulty: bool):
    """``(graph, program)``: the blocked_topk graph of a build and its
    ``sparse`` plan, checked against the passes this kernel runs."""
    graph = build_graph(cfg, faulty=faulty, layout="blocked_topk")
    program = plan(graph, "sparse")
    planned = tuple(p.name for p in program.tail)
    implemented = tuple(n for n in SPARSE_TAIL_PASSES if n in planned)
    if planned != implemented:
        raise AssertionError(
            f"sparse plan/kernel drift: planner tail {planned}, kernel "
            f"implements {SPARSE_TAIL_PASSES}"
        )
    return graph, program


def make_sparse_tick_fn(cfg: SwimConfig, spec: SparseSpec, faulty: bool = True):
    """Build the blocked-sparse tick: ``(SparseState, SparseTickInputs) ->
    (SparseState, SparseTickMetrics)``, on the state's device. The tick
    carries its graph and its planned program as ``tick.graph`` and
    ``tick.programs`` (``"sparse"``)."""
    _validate(cfg)
    graph, program = _sparse_program(cfg, faulty)
    timeout = int(cfg.ping_timeout_ticks)
    share_age = int(cfg.max_peer_share_age_ticks)
    n_proxy = int(cfg.num_indirect_ping_peers)
    kc = int(cfg.num_candidate_target_peers)
    g = int(spec.gossip_fanout)
    det = bool(cfg.deterministic)
    backdate = share_age if cfg.backdate_gossip_inserts else 0

    def tick(st: SparseState, inp: SparseTickInputs):
        n, k = st.nbr_idx.shape
        dev = st.nbr_idx.device
        tdt = st.nbr_timer.dtype
        i8 = torch.int8
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        slots = torch.arange(k, dtype=torch.int32, device=dev)
        t32 = st.tick
        now_t = t32.to(tdt)  # the low bits: int16 timers wrap as in JAX
        k_proxy, k_chain, k_draw, k_ping, k_ack, k_gossip = sprng.stream_keys(
            st.seed, st.cursor, _STREAMS)
        known_c = torch.tensor(KNOWN, dtype=i8, device=dev)

        nbr_idx, nbr_state, nbr_timer = st.nbr_idx, st.nbr_state, st.nbr_timer
        alive = st.alive

        with op_scope("sparse_churn"):
            # -- churn (prologue): alive flips; revived rows gossip-boot fresh.
            if faulty:
                revived = inp.revive & ~alive
                alive = (alive | inp.revive) & ~inp.kill
                nbr_idx, nbr_state, nbr_timer = reseed_revived(
                    nbr_idx, nbr_state, nbr_timer, revived, spec.boot_contacts, now_t)
                drop = inp.drop_rate
            else:
                drop = torch.zeros((), dtype=torch.float32, device=dev)

        with op_scope("sparse_expiry"):
            # -- expiry: age suspicion timers, escalate the oldest timed-out
            # WaitingForPing slot per row through an indirect-ping chain.
            age = t32 - nbr_timer.to(torch.int32)  # [N, K]
            act = alive[:, None]
            wfip_exp = (nbr_state == WAITING_FOR_INDIRECT_PING) & (age >= timeout) & act
            wfp_timed = (nbr_state == WAITING_FOR_PING) & (age >= timeout) & act

            esc_slot = _first_argmax(torch.where(wfp_timed, age, -(1 << 30)))
            has_timed = wfp_timed.any(dim=1)
            esc_oh = (slots[None, :] == esc_slot[:, None]) & has_timed[:, None]

            known = nbr_state == KNOWN
            pcnt = known.sum(dim=1, dtype=torch.int32)
            escalate = has_timed & (pcnt > 0)
            insta = has_timed & (pcnt == 0)  # no proxies: remove instantly

            if det:
                want_p = torch.arange(n_proxy, dtype=torch.int32, device=dev)[None, :].expand(
                    n, n_proxy)
            else:
                want_p = _clip_rank(threefry.uniform(k_proxy, (n, n_proxy), dev), pcnt)
            pslot, p_ok = _rank_pick(known, want_p)  # [N, P]
            pj = nbr_idx.gather(1, pslot.long())
            pj_c = pj.clamp(0, n - 1).long()
            suspect = nbr_idx.gather(1, esc_slot[:, None].long())[:, 0]
            suspect_c = suspect.clamp(0, n - 1).long()

            if faulty:
                u_ch = threefry.uniform(k_chain, (n, n_proxy, 4), dev)
                legs = (u_ch >= drop).all(dim=-1)  # all 4 unicast legs land
            else:
                legs = torch.ones((n, n_proxy), dtype=torch.bool, device=dev)
            chain_ok = (escalate[:, None] & p_ok & legs & alive[pj_c]
                        & alive[suspect_c][:, None])

            remove = wfip_exp | (esc_oh & insta[:, None])
            to_wfip = esc_oh & escalate[:, None]
            # Faithful indirect-ack (quirk Q11): the forwarded ack refreshes the
            # PROXY slot at the requester; the suspect stays WaitingForIndirectPing.
            refresh_p = ((slots[None, None, :] == pslot[:, :, None])
                         & chain_ok[:, :, None]).any(dim=1)
            nbr_state = torch.where(remove, torch.tensor(0, dtype=i8, device=dev), nbr_state)
            nbr_idx = torch.where(remove, -1, nbr_idx)
            nbr_state = torch.where(to_wfip, torch.tensor(WAITING_FOR_INDIRECT_PING, dtype=i8,
                                                          device=dev), nbr_state)
            nbr_timer = torch.where(to_wfip, now_t, nbr_timer)
            nbr_state = torch.where(refresh_p, known_c, nbr_state)
            nbr_timer = torch.where(refresh_p, now_t, nbr_timer)
            chain_msgs = 4 * chain_ok.sum(dtype=torch.int32)

        with op_scope("sparse_draw"):
            # -- draw: ping target = uniform among the oldest-kc Known slots.
            tslot = choose_one_of_oldest_k(nbr_timer, nbr_state == KNOWN, kc, k_draw,
                                           deterministic=det, method=cfg.oldest_k_method)
            has_ping = alive & (tslot >= 0)
            tslot_c = tslot.clamp(0, k - 1)
            tgt = nbr_idx.gather(1, tslot_c[:, None].long())[:, 0]
            tgt_c = tgt.clamp(0, n - 1).long()
            arm = (slots[None, :] == tslot_c[:, None]) & has_ping[:, None]
            nbr_state = torch.where(arm, torch.tensor(WAITING_FOR_PING, dtype=i8, device=dev),
                                    nbr_state)
            nbr_timer = torch.where(arm, now_t, nbr_timer)

        with op_scope("sparse_exchange"):
            # -- exchange: counter-draw bernoullis in place of the dense [N, N]
            # delivery gate; the ack closes the probe, the ping sender-marks.
            if faulty:
                u_ping = threefry.uniform(k_ping, (n,), dev)
                u_ack = threefry.uniform(k_ack, (n,), dev)
                del_ping = has_ping & alive[tgt_c] & (u_ping >= drop)
                del_ack = del_ping & (u_ack >= drop)
            else:
                del_ping = has_ping & alive[tgt_c]
                del_ack = del_ping

            ackref = arm & del_ack[:, None]
            nbr_state = torch.where(ackref, known_c, nbr_state)
            nbr_timer = torch.where(ackref, now_t, nbr_timer)

            # Sender-mark inside the target's block: the slot holding the sender's
            # id. A scatter-max of delivered flags (see the module docstring):
            # undelivered pings scatter 0 and mark nothing.
            blk_t = nbr_idx[tgt_c]  # [N, K] gather of target blocks
            occ_t = nbr_state[tgt_c] > 0
            eq = (blk_t == rows[:, None]) & occ_t
            mfound = eq.any(dim=1)
            mslot = _first_argmax(eq)
            cell = tgt_c * k + mslot.long()
            mark = torch.zeros((n * k,), dtype=torch.int32, device=dev).scatter_reduce_(
                0, cell, (del_ping & mfound).to(torch.int32), "amax", include_self=True)
            mark = mark.view(n, k) > 0
            nbr_state = torch.where(mark, known_c, nbr_state)
            nbr_timer = torch.where(mark, now_t, nbr_timer)

            # Unknown sender: becomes an insert candidate at the receiver (max
            # keeps exactly one per receiver per tick, deterministically).
            ping_cand = torch.full((n,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
                0, tgt_c, torch.where(del_ping & ~mfound, rows, -1), "amax", include_self=True)
            exch_msgs = del_ping.sum(dtype=torch.int32) + del_ack.sum(dtype=torch.int32)

        with op_scope("sparse_gossip"):
            # -- gossip: each delivered ack piggybacks g random sharable records
            # from the target's block (Known, heard strictly within share_age).
            share_ok = (nbr_state == KNOWN) & ((t32 - nbr_timer.to(torch.int32)) < share_age)
            srow = share_ok[tgt_c]  # [N, K] sharable mask of my ping target
            scnt = srow.sum(dim=1, dtype=torch.int32)
            if det:
                want_g = torch.arange(g, dtype=torch.int32, device=dev)[None, :].expand(n, g)
            else:
                want_g = _clip_rank(threefry.uniform(k_gossip, (n, g), dev), scnt)
            gslot, g_ok = _rank_pick(srow, want_g)
            gcand = nbr_idx[tgt_c].gather(1, gslot.long())
            gcand = torch.where(del_ack[:, None] & g_ok, gcand, -1)

        with op_scope("sparse_repair"):
            # -- repair: fold the tick's candidates into empty slots. Ping
            # sender-marks carry a fresh stamp and go first so they win dedup
            # against the same peer arriving backdated via gossip.
            cand = torch.cat([ping_cand[:, None], gcand], dim=1)
            gstamp = now_t - backdate  # in the timer dtype: wraps as in JAX
            stamps = torch.cat([now_t.expand(n, 1), gstamp.expand(n, g)], dim=1)
            nbr_idx, nbr_state, nbr_timer = repair_blocks(nbr_idx, nbr_state, nbr_timer,
                                                          cand, stamps)

        with op_scope("sparse_finish"):
            # -- finish: fingerprint, agreement, counter advance.
            new_st = SparseState(
                nbr_idx=nbr_idx, nbr_state=nbr_state, nbr_timer=nbr_timer, alive=alive,
                identity=st.identity, tick=t32 + 1, seed=st.seed, cursor=st.cursor + 1,
            )
            fp = sparse_fingerprint(new_st)
            converged, fp_min, fp_max, n_alive = fingerprint_agreement(alive, fp)
            agree = (alive & (fp == fp_min)).sum(dtype=torch.int32)
            occf = nbr_state > 0
            mem = 1 + occf.sum(dim=1, dtype=torch.int64)
            denom = n_alive.clamp(min=1)
            mem_sum = torch.where(alive, mem, 0).sum().to(torch.float32)
            fill_sum = (occf & alive[:, None]).sum().to(torch.float32)
            metrics = SparseTickMetrics(
                messages_delivered=exch_msgs + chain_msgs,
                converged=converged,
                agree_fraction=agree.to(torch.float32) / denom,
                mean_membership=mem_sum / denom,
                fingerprint_min=fp_min,
                fingerprint_max=fp_max,
                pings_sent=has_ping.sum(dtype=torch.int32),
                block_fill=fill_sum / (denom.to(torch.float32) * k),
            )
        return new_st, metrics

    tick.graph = graph
    tick.programs = {"sparse": program}
    return tick
