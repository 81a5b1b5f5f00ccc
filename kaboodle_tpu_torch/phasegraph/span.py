"""The leap: k (near-)quiescent ticks as one batched pass, bit-exact with k dense ticks.

The port of ``kaboodle_tpu/phasegraph/span.py``. Inside a warp span (the
activity signature of ``warp/horizon.py`` clear of the dense bits, no
scheduled event) membership, aliveness, identity views and broadcast
bookkeeping are fixed points of the dense tick, and the only per-tick work
left is

- the A3 ping-target draw (uniform among the 5 longest-unheard Known
  peers), keyed per tick by ``tick_stream_key(key, t, STREAM_TICK_PING)``
  exactly as the dense tick keys it;
- the timer refreshes that draw causes: ``timer[i, tgt_i] = t`` and
  ``timer[tgt_i, i] = t``;
- the latency-EWMA decay on the pinged edges (``lat <- 0.2 * lat``, first
  sample 0 where still NaN: every in-span sample is zero ticks);
- with ``hybrid=True``, the sterile anti-entropy pass: the dense fused
  tick's phase-0/1 KnownPeersRequest partner selection against the
  span-invariant fingerprints, its request and reply timer marks, and the
  kpr ledger.

The oldest-k structure is kept incrementally: each row is cut into
segments of ``W`` columns, and per ``(row, segment)`` the 5
lexicographically smallest ``(timer, column)`` pairs are carried. Target
selection reduces the ``[N, 5 B]`` summary; the refresh re-reduces only the
touched segments (a ``[2N or 4N, W]`` gather) and writes them back. A step
writes O(N) cells of the ``[N, N]`` plane.

The JAX ``lax.scan`` is a Python loop of ``k`` steps here, its carry on the
device: a step queues its work and fetches nothing, so a leap is one host
pass over ``k`` steps with no round trip. The scatters that JAX writes as
``.at[...]`` run on flat indices of tensors the leap owns (clones of the
entry state's), per member under ``[E]`` leaves (``masked=True``: the
fleet runner's per-member span lengths).

Built with a row group (``group=``, ``parallel/``), the leap runs on the
rank's rows: the draws are its rows of the dense draws, the refreshes of
its own rows are local, and the refreshes that land in other rows --
``timer[tgt_i, i]`` and, in the hybrid program, the request mark at
``(partner_i, i)`` -- come to their owners as every rank's targets and
partners, gathered once a step. The phase-0 priority, a scatter-min over
every requester, is all-reduced; the span-invariant fingerprints, map
sizes and aliveness are gathered once a leap.

``_SPAN_PASSES`` and ``_HYBRID_PASSES`` are the passes this module
implements; a build plans the fault-free graph into the ``span`` or
``hybrid`` program and refuses a program whose passes differ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.ops.hashing import membership_fingerprint
from kaboodle_tpu_torch.ops.sampling import pick_candidate
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.phasegraph import rng as pg_rng
from kaboodle_tpu_torch.phasegraph.exec import INF, _member_offset, _take_vec
from kaboodle_tpu_torch.phasegraph.graph import build_graph
from kaboodle_tpu_torch.phasegraph.plan import plan
from kaboodle_tpu_torch.sim.state import MeshState
from kaboodle_tpu_torch.spec import KNOWN
from kaboodle_tpu_torch.telemetry.trace import op_scope

# The span program's passes this module implements (``plan(graph, "span").tail``).
_SPAN_PASSES = {
    "draw": ("rng_streams", "probe_draw"),
    "refresh": ("call1", "call2"),
    "ledger": ("anti_entropy", "finish"),
}

# The hybrid (near-quiescent) program's passes: the strict span plus the
# sterile anti-entropy pass, as implemented (``plan(graph, "hybrid").tail``).
_HYBRID_PASSES = {
    "draw": ("rng_streams", "probe_draw"),
    "refresh": ("call1", "call2"),
    "ae": ("anti_entropy",),
    "ledger": ("finish",),
}

# Segment width: columns per (row, segment) summary.
_SEG_W = 64
# Steps whose ping draws are made in one batch.
_DRAW_STEPS = 256


def _lex_k_smallest(t: torch.Tensor, c: torch.Tensor, k: int, tmax: int):
    """Per row: the k lex-smallest ``(t, c)`` pairs, ties toward lower ``c``.

    ``c`` carries each entry's column explicitly (it may broadcast against
    ``t``), so this ranks gathered segments and stacked summaries alike;
    ``t == tmax`` is the ineligible sentinel. Returns ``(t_k, c_k, valid)``,
    each ``[..., k]``, in ascending order: the order of the dense tick's
    stable k-smallest. Every compare stays in ``t``'s dtype."""
    prev_t = torch.full(t.shape[:-1], torch.iinfo(t.dtype).min, dtype=t.dtype, device=t.device)
    prev_c = torch.full(t.shape[:-1], -1, dtype=torch.int32, device=t.device)
    out_t, out_c, out_v = [], [], []
    for _ in range(k):
        pt, pc = prev_t[..., None], prev_c[..., None]
        after = (t > pt) | ((t == pt) & (c > pc))
        t_r = torch.where(after, t, tmax).amin(dim=-1)
        c_r = torch.where(after & (t == t_r[..., None]), c, INF).amin(dim=-1)
        out_t.append(t_r)
        out_c.append(c_r)
        out_v.append(t_r != tmax)
        prev_t, prev_c = t_r, c_r
    return torch.stack(out_t, dim=-1), torch.stack(out_c, dim=-1), torch.stack(out_v, dim=-1)


def _ping_uniform(key: torch.Tensor, tick: torch.Tensor, rows: int,
                  row0: int = 0) -> torch.Tensor:
    """The dense tick's ping-draw uniforms for ``tick`` (any shape): float32
    ``[*tick.shape, rows]`` from ``tick_stream_key(key, tick,
    STREAM_TICK_PING)``, rows ``row0 ..`` of the dense draw."""
    words = threefry._u32(key)
    ping = pg_rng.tick_stream_key((words[..., 0], words[..., 1]), tick, pg_rng.STREAM_TICK_PING)
    return threefry.uniform(ping, (rows,), key.device, row0)


def make_leap_fn(cfg: SwimConfig, k: int, hybrid: bool = False, masked: bool = False,
                 group=None) -> Callable:
    """Build the k-tick leap for a protocol config.

    ``hybrid=True`` builds the near-quiescent program: the strict span plus
    the sterile anti-entropy pass. Under the signature's sterility bits
    every anti-entropy reply is a subset of the requester's map, so the
    program is bit-equal to k dense fused ticks; a strictly quiescent
    state is its degenerate case.

    ``masked=True`` returns ``leap(state, k_m)`` with a per-member span
    length ``k_m <= k`` (an int32 tensor of the state's batch shape, or
    anything ``torch.as_tensor`` takes): steps past ``k_m`` are no-ops
    (timers, latency, ledger and tick counter freeze), so one call advances
    an ``[E]`` ensemble with every member at its own horizon; ``k_m == 0``
    leaves a member bit-unchanged. Otherwise ``leap(state)`` takes one mesh.

    ``group`` builds the row-sharded leap (module docstring): the state is
    the rank's rows, and every rank must call it with the same ``k``.

    Precondition (the caller's, from the signature; never re-checked here):
    the state is in the program's class and the next ``k`` (``k_m``) ticks
    carry no scheduled event and end before the earliest timer expiry.
    """
    if k < 1:
        raise ValueError("need k >= 1")
    # Every op outside these passes must have been pruned by the planner.
    mode = "hybrid" if hybrid else "span"
    want = _HYBRID_PASSES if hybrid else _SPAN_PASSES
    got = {p.name: p.op_names for p in plan(build_graph(cfg, faulty=False), mode).tail}
    if got != want:
        raise NotImplementedError(f"{mode} plan {got} != leap implementation {want}")
    det = cfg.deterministic
    kk = cfg.num_candidate_target_peers

    def leap_impl(st: MeshState, k_m: torch.Tensor | None) -> MeshState:
        S, T, alive = st.state, st.timer, st.alive
        n, dev = st.n, S.device
        batch = tuple(S.shape[:-2])
        row0, nr = C.row_range(n, group)  # this rank's rows (all with no group)
        n_cand = min(kk, n)
        W = min(_SEG_W, n)
        B = -(-n // W)  # segments per row
        BW = B * W
        tmax, tmin = torch.iinfo(T.dtype).max, torch.iinfo(T.dtype).min
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        ridx = idx[row0:row0 + nr]  # the rows' own peer ids
        rows = ridx.expand(*batch, nr)  # each row's own index, per member
        lrows = torch.arange(nr, dtype=torch.int32, device=dev).expand(*batch, nr)
        every = idx.expand(*batch, n)  # every peer, as a sender of remote marks
        eye = ridx[:, None] == idx[None, :]

        def flat(i: torch.Tensor, stride: int) -> torch.Tensor:
            """Per-member flat index: ``i`` plus member e's offset ``e * stride``."""
            return _member_offset(i.long(), batch, stride)

        # Membership and aliveness are span invariants, so the masked scores
        # (what the dense draw ranks) can be the carry: every in-span write
        # lands on an eligible cell. Padded to the segment grid with
        # ineligible sentinel columns.
        elig = alive[..., :, None] & (S == KNOWN) & ~eye
        scores = torch.full((*batch, nr, BW), tmax, dtype=T.dtype, device=dev)
        scores[..., :n] = torch.where(elig, T, tmax)
        cols = torch.arange(BW, dtype=torch.int32, device=dev).view(B, W)
        # Entry summaries, [*, N, B, n_cand]: the one O(N^2) reduction.
        sum_t, sum_c, _ = _lex_k_smallest(scores.view(*batch, nr, B, W), cols, n_cand, tmax)
        scores_f = scores.view(-1)
        sum_t_f, sum_c_f = sum_t.view(-1, n_cand), sum_c.view(-1, n_cand)
        lat = None if st.latency is None else st.latency.clone()  # written in place

        def row_fp(member):
            ident = st.id_view if st.id_view is not None else C.gather_rows(st.identity, group)
            return membership_fingerprint(member, ident)

        if hybrid:
            # What the sterile pass ranks against: invariant in-class, so
            # every peer's is gathered once.
            member = S > 0
            fp = row_fp(member)
            n_row = member.sum(dim=-1, dtype=torch.int32)
            fp_g, n_row_g, alive_g = C.gather_many([fp, n_row, alive], group, len(batch))
        kprp, kprf, kprn = st.kpr_partner, st.kpr_fp, st.kpr_n

        if not masked:
            # The draw batch: each step's key is a pure function of (key,
            # tick, stream), so the draws derive in [_DRAW_STEPS, N] blocks
            # up front (a block, not the whole [k, N], bounds the memory of
            # a long leap).
            ticks = st.tick[..., None] + torch.arange(k, dtype=torch.int32, device=dev)
        seg = torch.arange(W, dtype=torch.int32, device=dev)

        for step in range(k):
            if masked:
                active = (step < k_m)[..., None]  # a device flag per member
                t = st.tick + step
                u = None if det else _ping_uniform(st.key, t, nr, row0)
            else:
                t = ticks[..., step]
                if not det and step % _DRAW_STEPS == 0:
                    us = _ping_uniform(st.key, ticks[..., step:step + _DRAW_STEPS], nr, row0)
                u = None if det else us[..., step % _DRAW_STEPS, :]
            tT = t.to(T.dtype)[..., None]  # wraps into int16 as the dense tick does

            # Cross-segment selection: a row's oldest 5 are among its
            # per-segment oldest 5s, in the dense draw's (timer, col) order.
            _, cand_idx, cand_valid = _lex_k_smallest(
                sum_t.view(*batch, nr, B * n_cand), sum_c.view(*batch, nr, B * n_cand),
                n_cand, tmax,
            )
            tgt = pick_candidate(cand_idx.clamp(max=n - 1), cand_valid, u)
            has_ping = tgt >= 0  # False exactly on dead/empty rows
            if masked:
                has_ping = has_ping & active
            tgtc = tgt.clamp(min=0)

            if hybrid:
                # Phase 0: last tick's KPR senders, priority = sender index,
                # as an O(N) scatter-min (the dense tick's [N, N] compare
                # gives the same minimum); sender aliveness unchecked, as
                # in the dense tick. Phase 1: this tick's acks (every ping
                # is delivered and acked in-class), priority = n + target.
                cand0 = (kprp >= 0) & (kprf != _take_vec(fp_g, kprp)) & (
                    _take_vec(n_row_g, kprp) <= kprn)
                prio0 = C.scatter_min(n, kprp, torch.where(cand0, rows, INF), group)
                prio0 = torch.where(alive, prio0, INF)
                cand1 = has_ping & (_take_vec(fp_g, tgt) != fp) & (
                    n_row <= _take_vec(n_row_g, tgt))
                prio1 = torch.where(cand1, n + tgt, INF)
                best = torch.minimum(prio0, prio1)
                has_req = (best != INF) & alive
                partner = torch.where(has_req, torch.where(best == prio0, prio0, tgt), -1)
                partner = partner.to(torch.int32)
                pc2 = partner.clamp(min=0)
                del_kpr = has_req & _take_vec(alive_g, partner)
                if masked:
                    del_kpr = del_kpr & active
                # Ping stamp + ack re-stamp at (i, tgt_i), Q1 mark at
                # (tgt_i, i), request mark at (partner_i, i), reply mark at
                # (i, partner_i): all write this tick's value. The marks
                # in other rows come from every peer, kept where they land
                # in this rank's rows.
                tgt_g, ping_g, pc2_g, kpr_g = C.gather_many(
                    [tgtc, has_ping, pc2, del_kpr], group, len(batch))
                t_mine = (tgt_g >= row0) & (tgt_g < row0 + nr)
                p_mine = (pc2_g >= row0) & (pc2_g < row0 + nr)
                rows_u = torch.cat([lrows, torch.where(t_mine, tgt_g - row0, 0),
                                    torch.where(p_mine, pc2_g - row0, 0), lrows], dim=-1)
                cols_u = torch.cat([tgtc, every, every, pc2], dim=-1)
                hit = torch.cat([has_ping, ping_g & t_mine, kpr_g & p_mine, del_kpr], dim=-1)
            else:
                tgt_g, ping_g = C.gather_many([tgtc, has_ping], group, len(batch))
                t_mine = (tgt_g >= row0) & (tgt_g < row0 + nr)
                rows_u = torch.cat([lrows, torch.where(t_mine, tgt_g - row0, 0)], dim=-1)
                cols_u = torch.cat([tgtc, every], dim=-1)
                hit = torch.cat([has_ping, ping_g & t_mine], dim=-1)
            # One scatter-max with a dtype-min no-op: a pingless row's
            # entry at (i, 0) can share its cell with another row's live
            # mark, so duplicates carry different values and only a max
            # reduction (never a plain put) is deterministic.
            val = torch.where(hit, tT, tmin)
            r64 = rows_u.long()
            scores_f.scatter_reduce_(0, flat(r64 * BW + cols_u, nr * BW).reshape(-1),
                                     val.reshape(-1), reduce="amax", include_self=True)

            # Touched segments re-reduced from the updated scores and
            # written back. Duplicate (row, segment) pairs re-reduce the same
            # updated segment, so they write equal values and a plain put
            # is exact; an untouched listed segment rewrites its own values.
            blocks_u = cols_u // W
            seg_cols = blocks_u[..., None] * W + seg  # [*, M, W] global columns
            seg_t = scores_f[flat(r64[..., None] * BW + seg_cols, nr * BW)]
            new_t, new_c, _ = _lex_k_smallest(seg_t, seg_cols, n_cand, tmax)
            at = flat(r64 * B + blocks_u, nr * B).reshape(-1)
            sum_t_f[at] = new_t.reshape(-1, n_cand)
            sum_c_f[at] = new_c.reshape(-1, n_cand)

            if lat is not None:
                # One zero-tick EWMA sample per pinged edge: NaN -> 0.0,
                # else 0.2 * old, in float32. Each row writes its own cell.
                lat_f = lat.view(-1)
                cell = flat(lrows.long() * n + tgtc, nr * n)
                cur = lat_f[cell]
                upd = torch.where(torch.isnan(cur), 0.0, 0.2 * cur)
                lat_f[cell] = torch.where(has_ping, upd, cur)

            if hybrid:
                # The kpr ledger the dense _finish writes every tick.
                led_p = torch.where(del_kpr, partner, -1)
                if masked:
                    kprp = torch.where(active, led_p, kprp)
                    kprf = torch.where(active, fp, kprf)
                    kprn = torch.where(active, n_row, kprn)
                else:
                    kprp, kprf, kprn = led_p, fp, n_row

        if not hybrid:
            # The anti-entropy ledger at the span's last tick, written once:
            # no request in flight, the (invariant) fingerprint and map size.
            member = S > 0
            fp = row_fp(member)
            n_row = member.sum(dim=-1, dtype=torch.int32)
            led_p = torch.full((*batch, nr), -1, dtype=torch.int32, device=dev)
            if masked:
                ran = (k_m > 0)[..., None]  # k_m == 0 leaves the ledger untouched
                kprp = torch.where(ran, led_p, kprp)
                kprf = torch.where(ran, fp, kprf)
                kprn = torch.where(ran, n_row, kprn)
            else:
                kprp, kprf, kprn = led_p, fp, n_row

        return dataclasses.replace(
            st,
            timer=torch.where(elig, scores[..., :n], T),
            latency=lat,
            tick=st.tick + (k_m if masked else k),
            kpr_partner=kprp,
            kpr_fp=kprf,
            kpr_n=kprn,
        )

    if masked:
        def leap(st: MeshState, k_m) -> MeshState:
            with op_scope("leap"):
                return leap_impl(st, torch.as_tensor(k_m, dtype=torch.int32, device=st.device))
    else:
        def leap(st: MeshState) -> MeshState:
            with op_scope("leap"):
                return leap_impl(st, None)

    leap.passes = _HYBRID_PASSES if hybrid else _SPAN_PASSES
    return leap
