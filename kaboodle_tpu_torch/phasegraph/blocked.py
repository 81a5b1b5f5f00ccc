"""The row-blocked tick: the dense tick with every ``[N, N]`` pass cut into row blocks.

The port of ``kaboodle_tpu/phasegraph/blocked.py::make_chunked_tick_fn``.
It is the same tick as ``phasegraph/exec.py`` (reference kaboodle.rs:
746-786), the same ops in the same order, re-expressed as a sequence of
passes, each a Python loop over row blocks of size ``block``:

- every ``[N, N]`` read or write touches one ``[block, N]`` slice at a
  time, so transients are O(block * N) instead of O(N^2);
- the O(N^3) join-gossip union and the intended-semantics Failed
  delivery are two-level blocked contractions: receiver blocks outside,
  an OR over sender blocks inside, each a ``[B, B] x [B, N]`` product;
- a pass writes into output buffers allocated once for the whole pass
  and never into the tensors it reads, so every block of a pass reads the
  same input snapshot. That is the two-pass delivery order the cross-row
  phases (the anti-entropy share gather, the unions, the Failed delivery)
  rely on, as ``lax.map`` bodies give it in the JAX package.

Where the JAX tick has ``lax.cond``, this tick has a Python ``if`` on the
same predicate: one host sync per gate. The three kernel flags
(``use_pallas_*``) do not apply here, as in the JAX package: this path is
its own memory-bound formulation and runs no hand kernel.

Parity contract (the JAX package's, ``tests/test_torch_chunked.py``):

- bit-exact with the JAX package's ``make_chunked_tick_fn``, per tick, in
  deterministic and random mode;
- bit-exact with the dense ``make_tick_fn`` whenever the tick consumes only
  per-row draws: all of deterministic mode, and random mode on ticks with
  no escalation, no join reply and no random drop;
- D10: the matrix-shaped draws (escalation proxies, join-reply Bernoulli,
  random drop) are drawn per block from ``fold_in(key, block_index)`` at
  shape ``(block, N)``, the JAX blocked tick's stream layout, not the dense
  tick's single ``[N, N]`` draw.

Memory at N = 65,536, lean state with int16 timers: 12 GiB of state, 12 GiB
of each pass's new state, the caller's copy of the input state, and
O(block * N) temporaries. A join tick adds the ``reply_del`` and ``gossip``
bool residents (4 GiB each), a tick with random drop the bool drop gate
(4 GiB; only on ticks whose ``drop_rate`` is above 0).
"""

from __future__ import annotations

from typing import Callable

import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops import threefry
from kaboodle_tpu_torch.ops.hashing import (
    as_u32,
    fingerprint_agreement,
    peer_record_hash,
    wrap32,
    wrap_sum,
)
from kaboodle_tpu_torch.ops.sampling import (
    _stable_k_smallest_iter,
    bernoulli_matrix,
    broadcast_reply_prob,
    choose_among_candidates,
    choose_k_members,
)
from kaboodle_tpu_torch.phasegraph import rng as pg_rng
from kaboodle_tpu_torch.phasegraph.exec import INF, _add32, _bool_matmul
from kaboodle_tpu_torch.phasegraph.graph import build_graph
from kaboodle_tpu_torch.phasegraph.plan import plan
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs, TickMetrics
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.telemetry.counters import RECORD_BYTES, ProtocolCounters, TickTelemetry

_NAN = float("nan")

# The graph ops this tick has bodies for. A build plans its graph into the
# ``blocked`` program and refuses one that runs an op outside this set.
BLOCKED_OPS = frozenset({
    "rng_streams", "churn", "delivery_gate", "row_stats", "join_gate",
    "manual_targets", "suspicion", "probe_draw", "join_insert",
    "failed_delivery", "join_replies", "call1", "call2", "calls34",
    "anti_entropy", "counters", "finish",
})


def _over_blocks(n: int, block: int, body):
    """``body(s0)`` for every row block, its ``[block, ...]`` results written
    into ``[N, ...]`` buffers allocated once: no block result is kept."""
    outs = None
    single = False
    for s0 in range(0, n, block):
        res = body(s0)
        if outs is None:
            single = not isinstance(res, tuple)
            outs = tuple(torch.empty((n, *r.shape[1:]), dtype=r.dtype, device=r.device)
                         for r in ((res,) if single else res))
        for o, r in zip(outs, (res,) if single else res):
            o[s0:s0 + block] = r
    return outs[0] if single else outs


def _sum_over_blocks(n: int, block: int, body) -> torch.Tensor:
    """The int64 sum over row blocks of ``body(s0)``, a boolean ``[block, N]`` mask."""
    return sum(body(s0).sum(dtype=torch.int64) for s0 in range(0, n, block))


def make_chunked_tick_fn(
    cfg: SwimConfig,
    faulty: bool = True,
    block: int = 1024,
    drop: bool = True,
    boot_union: bool = False,
    telemetry: bool = False,
) -> Callable[[MeshState, TickInputs], tuple[MeshState, TickMetrics | TickTelemetry]]:
    """Build the row-blocked tick for a config (module docstring).

    ``block`` must divide N (checked at the first tick). ``drop=False``
    leaves the random drop out, so no ``[N, N]`` gate is ever built; an
    explicit ``inp.drop_ok`` still applies. ``telemetry=True`` returns
    ``(state, TickTelemetry)`` with the dense tick's counter definitions.

    ``boot_union=True`` replaces the O(N^3) join-gossip contraction with its
    closed form for the fresh broadcast-boot avalanche:

        gossip[o, j] = reply_del[j, o]
                     | (join_b[j] & (cnt[o] - reply_del[j, o] > 0) & (j <= o))

    with ``cnt[o] = sum_r reply_del[r, o]``. Its precondition is the
    caller's: a fault-free tick whose start-of-round maps are the singletons
    {self}, i.e. tick 0 of a broadcast boot from ``init_state(ring_contacts=0)``.
    On any other tick its result is undefined. With ``faulty=True`` it
    raises here.
    """
    if boot_union and faulty:
        raise ValueError(
            "boot_union=True requires faulty=False: the closed-form join "
            "union assumes fault-free delivery on the boot tick"
        )
    # The blocked program: the full program's ops in the full order, row-blocked.
    prog = plan(build_graph(cfg, faulty=faulty, telemetry=telemetry), "blocked")
    unknown = set(prog.op_names()) - BLOCKED_OPS
    if unknown:
        raise NotImplementedError(f"graph ops without blocked bodies: {sorted(unknown)}")
    det = cfg.deterministic
    timeout = cfg.ping_timeout_ticks
    gossip_backdate = cfg.max_peer_share_age_ticks if cfg.backdate_gossip_inserts else 0

    def tick(st: MeshState, inp: TickInputs):
        n = st.n
        if n % block != 0:
            raise ValueError(f"block {block} does not divide N={n}")
        dev = st.device
        t = int(st.tick)
        key = tuple(int(w) & threefry.M32 for w in st.key.tolist())
        key_proxy, key_ping, key_bern, key_drop = pg_rng.tick_draw_keys(key, t)

        def blocks(body):
            return _over_blocks(n, block, body)

        def count(body):
            return _sum_over_blocks(n, block, body)

        S, T = st.state, st.timer
        tmax = torch.iinfo(T.dtype).max
        lat, idv = st.latency, st.id_view
        has_lat = lat is not None
        has_idv = idv is not None
        alive, never_b, last_b = st.alive, st.never_broadcast, st.last_broadcast
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        id_row = st.identity[None, :]
        rec_hash = peer_record_hash(idx, st.identity)
        rec_row = as_u32(rec_hash)[None, :]
        pid_row = idx.to(torch.int64)[None, :]
        zero32 = torch.zeros((), dtype=torch.int32, device=dev)
        # ``t - timer >= timeout`` and ``t - timer < age`` as comparisons of
        # the timer itself: no widened copy of a timer block.
        thr = t - timeout
        share_floor = t - cfg.max_peer_share_age_ticks

        def rows(s0):
            return slice(s0, s0 + block)

        def blk_eye(s0):
            return idx[rows(s0), None] == idx[None, :]

        def fp_of(member, vb):
            """Row fingerprints (int32 bits) and counts of a membership block."""
            if has_idv:
                fp = wrap32(torch.where(member, as_u32(peer_record_hash(pid_row, vb)), 0).sum(
                    dim=-1))
            else:
                fp = wrap_sum(torch.where(member, rec_hash[None, :], zero32))
            return fp, member.sum(dim=-1, dtype=torch.int32)

        def fp_rows(SS, VV):
            return lambda s0: fp_of(SS[rows(s0)] > 0, VV[rows(s0)] if has_idv else None)

        def ewma(Sb, Tb, lb, mark):
            """The latency EWMA of one delivery wave: a sample where the
            marked cell was waiting on a ping."""
            waiting = (Sb == WAITING_FOR_PING) | (Sb == WAITING_FOR_INDIRECT_PING)
            sample = (t - Tb.to(torch.int32)).to(torch.float32)
            upd = torch.where(torch.isnan(lb), sample, 0.8 * sample + 0.2 * lb)
            return torch.where(mark & waiting, upd, lb)

        def apply_marks(Sb, Tb, lb, vb, mark):
            """Q1 mark pass for one delivery wave on a row block."""
            if has_lat:
                lb = ewma(Sb, Tb, lb, mark)
            if has_idv:
                vb = torch.where(mark, id_row, vb)
            return torch.where(mark, KNOWN, Sb), torch.where(mark, t, Tb), lb, vb

        def planes(*xs):
            return tuple(x for x in xs if x is not None)

        def unpack(res, with_lat=has_lat, with_idv=has_idv):
            it = iter(res)
            S_, T_ = next(it), next(it)
            return S_, T_, next(it) if with_lat else None, next(it) if with_idv else None

        # ---- churn: silent kill (Q8) + revive-with-reset -------------------
        if faulty:
            alive = (alive & ~inp.kill) | inp.revive
            rv = inp.revive
            if bool(rv.any()):

                def churn_rows(s0):
                    sl = rows(s0)
                    rv_b, eye_b = rv[sl, None], blk_eye(s0)
                    out = [torch.where(rv_b, eye_b.to(torch.int8) * KNOWN, S[sl]),
                           torch.where(rv_b, eye_b.to(T.dtype) * t, T[sl])]
                    if has_lat:
                        out.append(torch.where(rv_b, _NAN, lat[sl]))
                    if has_idv:
                        out.append(torch.where(rv_b, torch.where(eye_b, id_row, zero32), idv[sl]))
                    return tuple(out)

                S, T, lat, idv = unpack(blocks(churn_rows))
            never_b = never_b | rv
        else:
            rv = torch.zeros((n,), dtype=torch.bool, device=dev)

        # ---- delivery gate -------------------------------------------------
        # Aliveness and partition stay [N] vectors; the random drop is one
        # bool resident drawn per block (D10), so edge gathers and block
        # slices read the same gate.
        drop_mat = None
        if faulty:
            part = inp.partition
            if inp.drop_ok is not None:
                drop_mat = inp.drop_ok
            elif drop and bool(inp.drop_rate > 0):
                drop_mat = blocks(lambda s0: threefry.uniform(
                    threefry.fold_in(key_drop, s0 // block), (block, n), dev) >= inp.drop_rate)

            def ok_edge(s, d):
                s, d = s.clamp(min=0).long(), d.clamp(min=0).long()
                e = alive[s] & alive[d] & (part[s] == part[d])
                return e if drop_mat is None else e & drop_mat[s, d]

            def ok_rows(s0):
                """ok[s, d] for the s-block: delivery FROM these rows."""
                sl = rows(s0)
                o = alive[sl, None] & alive[None, :] & (part[sl, None] == part[None, :])
                return o if drop_mat is None else o & drop_mat[sl]

            def okT_rows(s0):
                """ok[s, r] transposed to [B(r), N(s)]: delivery INTO the block."""
                sl = rows(s0)
                o = alive[None, :] & alive[sl, None] & (part[None, :] == part[sl, None])
                return o if drop_mat is None else o & drop_mat[:, sl].t().contiguous()
        else:

            def ok_edge(s, d):
                return alive[s.clamp(min=0).long()] & alive[d.clamp(min=0).long()]

            def ok_rows(s0):
                return alive[rows(s0), None] & alive[None, :]

            def okT_rows(s0):
                return alive[None, :] & alive[rows(s0), None]

        # ---- phase-A row stats on the post-churn snapshot -----------------
        S0, T0 = S, T

        def stats_rows(s0):
            sl = rows(s0)
            Sb, Tb = S0[sl], T0[sl]
            al_b = alive[sl, None]
            aged = al_b & (Tb <= thr)
            timed_wfp = aged & (Sb == WAITING_FOR_PING)
            # D1 escalation pick: the oldest timed-out WaitingForPing, ties
            # to the lower index.
            min_t = torch.where(timed_wfp, Tb, tmax).amin(dim=-1)
            jmask = timed_wfp & (Tb == min_t[:, None])
            has_timed = timed_wfp.any(dim=-1)
            jstar = torch.where(jmask, idx[None, :], INF).amin(dim=-1)
            return ((Sb > 0).sum(dim=-1, dtype=torch.int32), has_timed,
                    (aged & (Sb == WAITING_FOR_INDIRECT_PING)).any(dim=-1),
                    torch.where(has_timed, jstar, -1).to(torch.int32),
                    ((Sb == KNOWN) & ~blk_eye(s0)).any(dim=-1))

        row_count0, has_timed, wfip_any, jstar, has_cand = blocks(stats_rows)
        any_a2 = bool(wfip_any.any() | has_timed.any())
        escalate = has_timed & has_cand
        insta_remove = has_timed & ~has_cand
        escalating = bool(escalate.any())
        any_rem = bool(wfip_any.any() | insta_remove.any())

        # ---- A1 join broadcast throttle (kaboodle.rs:228-251) --------------
        if cfg.join_broadcast_enabled:
            lonely = row_count0 <= 1
            join_b = alive & (
                never_b | (lonely & ((t - last_b) >= cfg.rebroadcast_interval_ticks))
            )
            last_b = torch.where(join_b, t, last_b)
            never_b = never_b & ~join_b
            joining = bool(join_b.any())
        else:
            join_b = torch.zeros((n,), dtype=torch.bool, device=dev)
            joining = False

        man_tgt = torch.where(
            alive & (inp.manual_target != idx) & (inp.manual_target < n),
            inp.manual_target, -1,
        ).to(torch.int32)

        # ---- proxies (escalation-gated; D10 streams in random mode) -------
        k_prox = min(cfg.num_indirect_ping_peers, n)
        if escalating:
            proxies, proxies_valid = blocks(lambda s0: choose_k_members(
                (S0[rows(s0)] == KNOWN) & ~blk_eye(s0), cfg.num_indirect_ping_peers,
                threefry.fold_in(key_proxy, s0 // block), det))
        else:
            proxies = torch.zeros((n, k_prox), dtype=torch.int32, device=dev)
            proxies_valid = torch.zeros((n, k_prox), dtype=torch.bool, device=dev)
        proxies_valid = proxies_valid & escalate[:, None]

        # ---- A2 apply (kaboodle.rs:558-653) --------------------------------
        def jstar_is(s0):
            return idx[None, :] == jstar[rows(s0), None]

        def rem_rows(s0):
            """A2 removals of a row block, from the pre-A2 snapshot."""
            sl = rows(s0)
            r = alive[sl, None] & (S0[sl] == WAITING_FOR_INDIRECT_PING) & (T0[sl] <= thr)
            return r | (insta_remove[sl, None] & jstar_is(s0))

        if any_a2:

            def a2_rows(s0):
                sl = rows(s0)
                rem = rem_rows(s0)
                esc_cell = escalate[sl, None] & jstar_is(s0)
                Sb = torch.where(esc_cell, WAITING_FOR_INDIRECT_PING, torch.where(rem, 0, S[sl]))
                out = (Sb, torch.where(esc_cell, t, T[sl]))
                return out + (torch.where(rem, _NAN, lat[sl]),) if has_lat else out

            S, T, lat, _ = unpack(blocks(a2_rows), with_idv=False)

        # ---- intended-semantics Failed delivery (non-default; Q3 off) -----
        # fail_del[r, j]: Failed(j) from origin i delivered at r removes j; a
        # same-tick Join(j) wins only against origins i < j. A blocked
        # contraction over the origin axis; ``rem`` recomputed per origin
        # block from the pre-A2 snapshot.
        fail_del = None
        if not cfg.faithful_failed_broadcast and any_rem:

            def fail_rows(s0):
                okT_b = okT_rows(s0)  # [B(r), N(i)]: origin i delivers to r
                gt = torch.zeros((block, n), dtype=torch.bool, device=dev)
                anyv = torch.zeros((block, n), dtype=torch.bool, device=dev)
                for i0 in range(0, n, block):
                    rem_b = rem_rows(i0)  # [B(i), N(j)]
                    rem_gt = rem_b & (idx[rows(i0), None] > idx[None, :])
                    ok_i = okT_b[:, rows(i0)]
                    gt |= _bool_matmul(ok_i, rem_gt)
                    anyv |= _bool_matmul(ok_i, rem_b)
                eye_b = blk_eye(s0)
                if cfg.join_broadcast_enabled:
                    Jm_b = join_b[None, :] & okT_b & ~eye_b
                    return ~eye_b & torch.where(Jm_b, gt, anyv)
                return ~eye_b & anyv

            fail_del = blocks(fail_rows)

        # ---- A3 ping-target candidates + the per-row draw ------------------
        kk = 1 if det else min(cfg.num_candidate_target_peers, n)

        def a3_rows(s0):
            sl = rows(s0)
            Sb, Tb = S[sl], T[sl]
            elig = alive[sl, None] & (Sb == KNOWN) & ~blk_eye(s0)
            return _stable_k_smallest_iter(torch.where(elig, Tb, tmax), kk, tmax)

        cand_idx, cand_valid = blocks(a3_rows)
        # The per-row pick over the candidate lists is the dense tick's draw.
        ping_tgt = choose_among_candidates(cand_idx, cand_valid, key_ping, det)
        has_ping = ping_tgt >= 0

        # ---- delivery vectors (calls 1-4) ----------------------------------
        ok_ping = has_ping & ok_edge(idx, ping_tgt)
        ok_man = (man_tgt >= 0) & ok_edge(idx, man_tgt)
        del_pr = proxies_valid & ok_edge(idx[:, None], proxies)
        del_ack = ok_ping & ok_edge(ping_tgt, idx)
        del_ack_man = ok_man & ok_edge(man_tgt, idx)
        del_pping = del_pr & ok_edge(proxies, jstar[:, None])
        del_pack = del_pping & ok_edge(jstar[:, None], proxies)
        pc = proxies.clamp(min=0).long()
        pop_hit = ((ping_tgt[pc] == jstar[:, None]) & del_ack[pc]) | (
            (man_tgt[pc] == jstar[:, None]) & del_ack_man[pc]
        )
        fwd_c = del_pr & pop_hit
        del_fwd_c = fwd_c & ok_edge(proxies, idx[:, None])
        fwd = del_pack & ~pop_hit
        del_fwd = fwd & ok_edge(proxies, idx[:, None])

        def inblk_marks(s0, marks):
            """OR of ``(rows, cols, vals)`` scatters, restricted to this block's rows."""
            out = torch.zeros((block, n), dtype=torch.bool, device=dev)
            for r, c, v in marks:
                sel = v & (r >= s0) & (r < s0 + block)
                out[(r.expand_as(sel)[sel] - s0).long(),
                    c.expand_as(sel)[sel].clamp(min=0).long()] = True
            return out

        # ---- composed write pass: A3 write -> B (Jm, fail) -> wave 1 ->
        # wave 2 -> gossip insert, with exact per-wave (fp, count) deltas.
        # Marks write (KNOWN, now, sender identity) in both waves, so the
        # last-writer chain is order-free.
        def compose_rows(reply_del, gossip):
            def body(s0):
                sl = rows(s0)
                gi = idx[sl]
                Sb, Tb = S[sl], T[sl]
                lb = lat[sl] if has_lat else None
                vb = idv[sl] if has_idv else None
                tgt_cell = (idx[None, :] == ping_tgt[sl, None]) & has_ping[sl, None]
                # m1[d, s]: datagrams landing at rows d of this block.
                m1 = ((gi[:, None] == ping_tgt[None, :]) & ok_ping[None, :]) | (
                    (gi[:, None] == man_tgt[None, :]) & ok_man[None, :])
                if escalating:
                    for k in range(proxies.shape[-1]):
                        m1 |= (gi[:, None] == proxies[None, :, k]) & del_pr[None, :, k]
                # m2[s, d]: rows s of this block marking their own targets.
                m2 = ((idx[None, :] == ping_tgt[sl, None]) & del_ack[sl, None]) | (
                    (idx[None, :] == man_tgt[sl, None]) & del_ack_man[sl, None])
                if reply_del is not None:  # joiner o marks each responder r
                    m2 |= reply_del[:, sl].t()
                if escalating:  # suspect jstar[i] marks proxy p
                    m2 |= inblk_marks(s0, [(jstar[:, None], proxies, del_pping)])

                # State after A3 + B: the wave-1 read state.
                S_B = torch.where(tgt_cell, WAITING_FOR_PING, Sb)
                stamp = tgt_cell
                if reply_del is not None:  # Join(o) delivered at r: r knows o
                    Jm_b = join_b[None, :] & okT_rows(s0) & ~blk_eye(s0)
                    S_B = torch.where(Jm_b, KNOWN, S_B)
                    stamp = stamp | Jm_b
                    if has_idv:
                        vb = torch.where(Jm_b, id_row, vb)
                T_B = torch.where(stamp, t, Tb)
                if fail_del is not None:
                    S_B = torch.where(fail_del[sl], 0, S_B)
                m_B = S_B > 0

                # fp0/n0 on the post-B state and each wave's exact delta.
                if has_idv:
                    old = torch.where(m_B, as_u32(peer_record_hash(pid_row, vb)), 0)
                    fp0 = wrap32(old.sum(dim=-1))
                    dfp1 = wrap32(torch.where(m1, rec_row - old, 0).sum(dim=-1))
                    hash1 = torch.where(m1, rec_row, old)
                    dfp2 = wrap32(torch.where(m2, rec_row - hash1, 0).sum(dim=-1))
                    del old, hash1
                else:
                    fp0 = fp_of(m_B, None)[0]
                    dfp1 = fp_of(m1 & ~m_B, None)[0]
                    dfp2 = fp_of(m2 & ~(m_B | m1), None)[0]
                n0 = m_B.sum(dim=-1, dtype=torch.int32)
                dn1 = (m1 & ~m_B).sum(dim=-1, dtype=torch.int32)
                dn2 = (m2 & ~(m_B | m1)).sum(dim=-1, dtype=torch.int32)

                # Latency EWMA with the waves in order.
                if has_lat:
                    if fail_del is not None:
                        lb = torch.where(fail_del[sl], _NAN, lb)
                    lb = ewma(S_B, T_B, lb, m1)
                    lb = ewma(torch.where(m1, KNOWN, S_B), torch.where(m1, t, T_B), lb, m2)

                mark_k = m1 | m2
                S_2 = torch.where(mark_k, KNOWN, S_B)
                T_2 = torch.where(mark_k, t, T_B)
                if has_idv:
                    vb = torch.where(mark_k, id_row, vb)
                if gossip is not None:
                    g_ins = gossip[sl] & ~(S_2 > 0)
                    S_2 = torch.where(g_ins, KNOWN, S_2)
                    T_2 = torch.where(g_ins, t - gossip_backdate, T_2)
                    if has_idv:
                        vb = torch.where(g_ins, id_row, vb)
                return (S_2, T_2, fp0, n0, dfp1, dn1, dfp2, dn2) + planes(lb, vb)

            return body

        msgs_join = zero32
        join_records = torch.zeros((), dtype=torch.int64, device=dev)
        reply_del = gossip = None
        if joining:
            # Membership counts on the post-A2 state (A3 moves none).
            row_count_a = blocks(lambda s0: (S[rows(s0)] > 0).sum(dim=-1, dtype=torch.int32))
            cap = cfg.max_share_peers

            def reply_rows(s0):
                # reply_del[r, o] for responder rows r (kaboodle.rs:333-392).
                sl = rows(s0)
                Jm_b = join_b[None, :] & okT_rows(s0) & ~blk_eye(s0)
                member_b = S[sl] > 0
                is_new = Jm_b & ~member_b
                n_after = row_count_a[sl, None] + torch.cumsum(is_new, dim=1, dtype=torch.int32)
                bern = bernoulli_matrix(threefry.fold_in(key_bern, s0 // block),
                                        broadcast_reply_prob(n_after), (block, n), det)
                reply = is_new & bern
                if not telemetry:
                    return reply & ok_rows(s0)
                # Records in the join-response shares SENT from these rows
                # (``reply``, not ``reply & ok``): uncapped the sequential
                # map at reply time, over the D5 cap the capped base plus
                # this round's joiners not already in it.
                rec_cnt = n_after
                if cap:
                    base_c = member_b & (torch.cumsum(member_b, dim=1, dtype=torch.int32) <= cap)
                    clen = row_count_a[sl].clamp(max=cap)[:, None] + torch.cumsum(
                        Jm_b & ~base_c, dim=1, dtype=torch.int32)
                    rec_cnt = torch.where(n_after <= cap, n_after, clen)
                recs = torch.where(reply, rec_cnt, 0).sum(dim=-1, dtype=torch.int64)
                return reply & ok_rows(s0), recs

            if telemetry:
                reply_del, join_rec_rows = blocks(reply_rows)
                join_records = join_rec_rows.sum()
            else:
                reply_del = blocks(reply_rows)
            msgs_join = reply_del.sum(dtype=torch.int32)

            if boot_union:
                # Closed-form avalanche union (make_chunked_tick_fn docstring).
                cnt = reply_del.sum(dim=0, dtype=torch.int32)  # [N(o)]

                def union_rows_boot(s0):
                    sl = rows(s0)
                    rep_t = reply_del[:, sl].t()  # [B(o), N(j)]
                    others = (cnt[sl, None] - rep_t.to(torch.int32)) > 0
                    tri = idx[None, :] <= idx[sl, None]  # j <= o
                    return rep_t | (join_b[None, :] & others & tri)

                gossip = blocks(union_rows_boot)
            elif bool(reply_del.any()):
                # The O(N^3) contraction, gated on a reply existing (a
                # rebroadcast into a full mesh yields none).

                def share_rows(r0):
                    member_r = S[rows(r0)] > 0
                    if cap and n > cap:  # D5: the lowest-index members only
                        return member_r & (torch.cumsum(member_r, dim=1, dtype=torch.int32) <= cap)
                    return member_r

                def union_rows(s0):
                    # gossip[o, j] for joiner rows o: OR over responders r of
                    # reply_del[r, o] & (share_base[r, j] | (Jm[r, j] & j <= o)).
                    sl = rows(s0)
                    t1 = torch.zeros((block, n), dtype=torch.bool, device=dev)
                    t2 = torch.zeros((block, n), dtype=torch.bool, device=dev)
                    for r0 in range(0, n, block):
                        rep_t = reply_del[rows(r0), sl].t()  # [B(o), B(r)]
                        jm_r = join_b[None, :] & okT_rows(r0) & ~blk_eye(r0)
                        t1 |= _bool_matmul(rep_t, share_rows(r0))
                        t2 |= _bool_matmul(rep_t, jm_r)
                    return t1 | (t2 & (idx[None, :] <= idx[sl, None]))

                gossip = blocks(union_rows)

        comp = blocks(compose_rows(reply_del, gossip))
        del reply_del, gossip
        S, T, fp0, n0, dfp1, dn1, dfp2, dn2, *rest = comp
        del comp
        it = iter(rest)
        lat = next(it) if has_lat else None
        idv = next(it) if has_idv else None
        fp1, n1 = _add32(fp0, dfp1), n0 + dn1

        # ---- fp2 (escalation-gated full read) ------------------------------
        if escalating:
            fp2, n2 = blocks(fp_rows(S, idv))
        else:
            fp2 = torch.zeros((n,), dtype=torch.int32, device=dev)
            n2 = torch.zeros((n,), dtype=torch.int32, device=dev)

        # ---- calls 3 + 4 (escalation-gated scatter waves) ------------------
        if escalating:
            jb = jstar[:, None].expand_as(proxies)
            ib = idx[:, None].expand_as(proxies)

            def calls34_rows(s0):
                sl = rows(s0)
                Sb, Tb = S[sl], T[sl]
                lb = lat[sl] if has_lat else None
                vb = idv[sl] if has_idv else None
                # mark3: proxy marks suspect + suspector marks pinger-proxy.
                mark3 = inblk_marks(s0, [(proxies, jb, del_pack), (ib, proxies, del_fwd_c)])
                Sb, Tb, lb, vb = apply_marks(Sb, Tb, lb, vb, mark3)
                mark4 = inblk_marks(s0, [(ib, proxies, del_fwd)])
                Sb, Tb, lb, vb = apply_marks(Sb, Tb, lb, vb, mark4)
                if not cfg.faithful_indirect_ack:
                    cleared = (del_fwd | del_fwd_c)[sl].any(dim=-1)
                    clr = cleared[:, None] & jstar_is(s0) & (Sb > 0)
                    Sb = torch.where(clr, KNOWN, Sb)
                    Tb = torch.where(clr, t, Tb)
                return planes(Sb, Tb, lb, vb)

            S, T, lat, idv = unpack(blocks(calls34_rows))

        # ---- fp_g: the delta chain on quiet ticks, a recompute else -------
        if joining or escalating:
            fp_g, n_g = blocks(fp_rows(S, idv))
        else:
            fp_g, n_g = _add32(fp1, dfp2), n1 + dn2

        # ---- anti-entropy candidates (kaboodle.rs:707-740) -----------------
        def prio0_rows(s0):
            sl = rows(s0)
            m0 = (st.kpr_partner[None, :] == idx[sl, None]) & alive[sl, None] & ~rv[sl, None]
            match0 = m0 & (st.kpr_fp[None, :] != fp_g[sl, None]) & (
                n_g[sl, None] <= st.kpr_n[None, :])
            return torch.where(match0, idx[None, :], INF).amin(dim=-1)

        prio0 = blocks(prio0_rows)
        peer0 = prio0  # sender == candidate peer for KPR candidates
        pt, mt = ping_tgt.clamp(min=0).long(), man_tgt.clamp(min=0).long()
        m_d = del_ack & (fp1[pt] != fp_g) & (n_g <= n1[pt])
        m_m = del_ack_man & (fp1[mt] != fp_g) & (n_g <= n1[mt])
        prio_d = torch.where(m_d, n + ping_tgt, INF)
        prio_m = torch.where(m_m, n + man_tgt, INF)
        prio1 = torch.minimum(prio_d, prio_m)
        peer1 = torch.where(prio_d <= prio_m, ping_tgt, man_tgt)

        base2, base3 = 2 * n, 3 * n
        jc = jstar.clamp(min=0).long()
        x_fp2, x_n2 = fp2[jc], n2[jc]
        m_px = del_pack & (x_fp2[:, None] != fp_g[pc]) & (n_g[pc] <= x_n2[:, None])
        prio_proxy = torch.full((n,), INF, dtype=torch.int32, device=dev).scatter_reduce(
            0, pc.reshape(-1), torch.where(m_px, base2 + jstar[:, None], INF).reshape(-1),
            reduce="amin", include_self=True,
        )
        peer_proxy = prio_proxy - base2
        x_fp1, x_n1 = fp1[jc], n1[jc]
        m_cf = del_fwd_c & (x_fp1[:, None] != fp_g[:, None]) & (n_g[:, None] <= x_n1[:, None])
        prio_coinc = torch.where(m_cf, base2 + proxies, INF).amin(dim=-1)
        prio2 = torch.minimum(prio_proxy, prio_coinc)
        peer2 = torch.where(prio_proxy <= prio_coinc, peer_proxy, jstar)
        m_f = del_fwd & (x_fp2[:, None] != fp_g[:, None]) & (n_g[:, None] <= x_n2[:, None])
        prio3 = torch.where(m_f, base3 + proxies, INF).amin(dim=-1)
        peer3 = jstar

        best = torch.minimum(torch.minimum(prio0, prio1), torch.minimum(prio2, prio3))
        partner = torch.where(
            best == prio0, peer0,
            torch.where(best == prio1, peer1, torch.where(best == prio2, peer2, peer3)),
        ).to(torch.int32)
        has_req = (best != INF) & alive
        partner = torch.where(has_req, partner, -1)
        del_kpr = has_req & ok_edge(idx, partner)
        del_rep = del_kpr & ok_edge(partner, idx)

        # ---- call-G apply: two passes, so the share snapshot is the
        # post-mark_g state (the oracle's two-pass order) -------------------
        ae_records = torch.zeros((), dtype=torch.int64, device=dev)
        if bool(del_kpr.any()):

            def g1_rows(s0):
                sl = rows(s0)
                mark_g = (idx[sl, None] == partner[None, :]) & del_kpr[None, :]
                return planes(*apply_marks(S[sl], T[sl], lat[sl] if has_lat else None,
                                           idv[sl] if has_idv else None, mark_g))

            S, T, lat, idv = unpack(blocks(g1_rows))

            def g2_rows(s0):
                sl = rows(s0)
                Sb, Tb = S[sl], T[sl]
                ptb = partner[sl]
                mark_rep = (idx[None, :] == ptb[:, None]) & del_rep[sl, None]
                Sb = torch.where(mark_rep, KNOWN, Sb)
                Tb = torch.where(mark_rep, t, Tb)
                # The filtered share from the partner's post-mark_g row
                # (kaboodle.rs:483-501): the pass input, the exact snapshot.
                pcl = ptb.clamp(min=0).long()
                share = (S[pcl] == KNOWN) & (idx[None, :] != ptb[:, None]) & (
                    T[pcl] > share_floor)
                rep_ins = del_rep[sl, None] & share & ~blk_eye(s0) & ~(Sb > 0)
                out = [torch.where(rep_ins, KNOWN, Sb),
                       torch.where(rep_ins, t - gossip_backdate, Tb)]
                if has_idv:
                    out.append(torch.where(rep_ins, id_row, idv[sl]))
                if telemetry:
                    # Records in the replies these requesters' partners SENT:
                    # every delivered request is answered; the requester's
                    # own column is subtracted.
                    own = share[:, sl].diagonal().to(torch.int64)
                    out.append(torch.where(del_kpr[sl],
                                           share.sum(dim=-1, dtype=torch.int64) - own, 0))
                return tuple(out)

            g2 = blocks(g2_rows)
            S, T = g2[0], g2[1]
            if has_idv:
                idv = g2[2]
            if telemetry:
                ae_records = g2[-1].sum()
            del g2
            fp_f, n_f = blocks(fp_rows(S, idv))
        else:
            fp_f, n_f = fp_g, n_g

        # ---- metrics + next state ------------------------------------------
        msgs = sum(
            x.sum(dtype=torch.int64)
            for x in (ok_ping, ok_man, del_pr, del_ack, del_ack_man, del_pping,
                      del_pack, del_fwd_c, del_fwd, del_kpr, del_rep)
        ) + msgs_join
        converged, fpa_min, fpa_max, n_alive = fingerprint_agreement(alive, fp_f)
        agree = (alive & (fp_f == fpa_min)).sum(dtype=torch.int32)
        denom = n_alive.clamp(min=1)
        new_state = MeshState(
            state=S, timer=T, alive=alive, identity=st.identity,
            never_broadcast=never_b, last_broadcast=last_b,
            kpr_partner=torch.where(del_kpr, partner, -1).to(torch.int32),
            kpr_fp=fp_g, kpr_n=n_g, tick=st.tick + 1, key=st.key,
            latency=lat, id_view=idv,
        )
        metrics = TickMetrics(
            messages_delivered=msgs.to(torch.int32),
            converged=converged,
            agree_fraction=agree.to(torch.float32) / denom,
            # f32 accumulation: an int32 sum wraps at N = 65,536.
            mean_membership=torch.where(alive, n_f, 0).to(torch.float32).sum() / denom,
            fingerprint_min=fpa_min,
            fingerprint_max=fpa_max,
        )
        if not telemetry:
            return new_state, metrics

        # ---- telemetry counters (the dense tick's definitions, blocked) ----
        def i32(x):
            return x.sum(dtype=torch.int32)

        deaths = count(rem_rows).to(torch.int32) if any_a2 else zero32
        joins_diss = zero32
        if joining:
            joins_diss = count(
                lambda s0: join_b[None, :] & okT_rows(s0) & ~blk_eye(s0)).to(torch.int32)
        counters = ProtocolCounters(
            pings_sent=i32(has_ping) + i32(man_tgt >= 0) + i32(del_pr),
            acks_sent=i32(ok_ping) + i32(ok_man) + i32(del_pping) + i32(fwd) + i32(fwd_c),
            ping_reqs_sent=i32(proxies_valid),
            suspicions_raised=i32(escalate),
            suspicions_refuted=count(lambda s0: (S0[rows(s0)] == WAITING_FOR_INDIRECT_PING)
                                     & (S[rows(s0)] == KNOWN)).to(torch.int32),
            deaths_declared=deaths,
            joins_disseminated=joins_diss,
            gossip_bytes=wrap32(RECORD_BYTES * (ae_records + join_records)),
            armed_timers=count(lambda s0: alive[rows(s0), None] & (
                (S[rows(s0)] == WAITING_FOR_PING)
                | (S[rows(s0)] == WAITING_FOR_INDIRECT_PING))).to(torch.int32),
        )
        return new_state, TickTelemetry(metrics=metrics, counters=counters, fp=fp_f)

    return tick
