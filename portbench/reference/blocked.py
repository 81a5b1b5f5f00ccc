"""The same SWIM tick with every ``[N, N]`` pass cut into row blocks.

The reference for a mesh too large for whole-plane temporaries: each pass
reads one ``[block, N]`` slice at a time and writes into buffers allocated
for the whole pass, so every block of a pass reads the same snapshot. The
matrix-shaped draws (escalation proxies, join-reply Bernoulli, random drop)
are drawn per block from ``fold_in(key, block_index)`` at shape ``(block,
N)``; the per-row draws are the whole-mesh tick's. ``boot_union=True`` is
the closed form of the join-gossip union for tick 0 of a broadcast boot
(every start-of-round map the singleton {self}, fault-free):

    gossip[o, j] = reply_del[j, o] | (join_b[j] & (cnt[o] - reply_del[j, o] > 0) & (j <= o))

with ``cnt[o] = sum_r reply_del[r, o]``.
"""

from __future__ import annotations

import torch

from portbench.reference import rng
from portbench.reference.dense import INF, add32, bool_matmul
from portbench.reference.hashing import (
    as_u32,
    fingerprint_agreement,
    peer_record_hash,
    wrap32,
    wrap_sum,
)
from portbench.reference.sampling import (
    bernoulli_matrix,
    broadcast_reply_prob,
    choose_among_candidates,
    choose_k_members,
    stable_k_smallest,
)
from portbench.reference.state import (
    KNOWN,
    WAITING_FOR_INDIRECT_PING,
    WAITING_FOR_PING,
    Inputs,
    Metrics,
    State,
)

_NAN = float("nan")


def _over_blocks(n: int, block: int, body):
    outs, single = None, False
    for s0 in range(0, n, block):
        res = body(s0)
        if outs is None:
            single = not isinstance(res, tuple)
            outs = tuple(torch.empty((n, *r.shape[1:]), dtype=r.dtype, device=r.device)
                         for r in ((res,) if single else res))
        for o, r in zip(outs, (res,) if single else res):
            o[s0:s0 + block] = r
    return outs[0] if single else outs


def make_blocked_tick(proto: dict, block: int, faulty: bool = True, drop: bool = True,
                      boot_union: bool = False, fdt=torch.float32):
    """The row-blocked tick; ``block`` divides N."""
    timeout = proto["ping_timeout_ticks"]
    share_age = proto["max_peer_share_age_ticks"]
    backdate = share_age if proto["backdate_gossip_inserts"] else 0
    k_cand = proto["num_candidate_target_peers"]
    k_ind = proto["num_indirect_ping_peers"]
    cap = proto["max_share_peers"]
    joins_on = proto["join_broadcast_enabled"]

    def tick(st: State, inp: Inputs) -> tuple[State, Metrics]:
        n = st.n
        if n % block:
            raise ValueError(f"block {block} does not divide N={n}")
        dev = st.state.device
        t = int(st.tick)
        key = tuple(int(w) & rng.M32 for w in st.key.tolist())
        key_proxy, key_ping, key_bern, key_drop = rng.tick_draw_keys(key, t)

        def blocks(body):
            return _over_blocks(n, block, body)

        S, T = st.state, st.timer
        tmax = torch.iinfo(T.dtype).max
        lat, idv = st.latency, st.id_view
        has_lat, has_idv = lat is not None, idv is not None
        alive, never_b, last_b = st.alive, st.never_broadcast, st.last_broadcast
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        id_row = st.identity[None, :]
        rec_hash = peer_record_hash(idx, st.identity)
        rec_row = as_u32(rec_hash)[None, :]
        pid_row = idx.to(torch.int64)[None, :]
        zero32 = torch.zeros((), dtype=torch.int32, device=dev)
        thr = t - timeout
        share_floor = t - share_age

        def rows(s0):
            return slice(s0, s0 + block)

        def blk_eye(s0):
            return idx[rows(s0), None] == idx[None, :]

        def fp_of(member, vb):
            if has_idv:
                h = as_u32(peer_record_hash(pid_row, vb))
                fp = wrap32(torch.where(member, h, 0).sum(dim=-1))
            else:
                fp = wrap_sum(torch.where(member, rec_hash[None, :], zero32))
            return fp, member.sum(dim=-1, dtype=torch.int32)

        def fp_rows(SS, VV):
            return lambda s0: fp_of(SS[rows(s0)] > 0, VV[rows(s0)] if has_idv else None)

        def ewma(Sb, Tb, lb, mark):
            waiting = (Sb == WAITING_FOR_PING) | (Sb == WAITING_FOR_INDIRECT_PING)
            sample = (t - Tb.to(torch.int32)).to(fdt)
            upd = torch.where(torch.isnan(lb), sample, 0.8 * sample + 0.2 * lb)
            return torch.where(mark & waiting, upd, lb)

        def apply_marks(Sb, Tb, lb, vb, mark):
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

        # churn: silent kill, revive with reset
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

        # delivery gate: alive and partition as [N] vectors, the drop drawn per block
        drop_mat = None
        if faulty:
            part = inp.partition
            if drop and float(inp.drop_rate) > 0:
                rate = torch.as_tensor(inp.drop_rate, dtype=fdt, device=dev)
                drop_mat = blocks(lambda s0: rng.uniform(
                    rng.fold_in(key_drop, s0 // block), (block, n), dev, fdt) >= rate)

            def ok_edge(s, d):
                s, d = s.clamp(min=0).long(), d.clamp(min=0).long()
                e = alive[s] & alive[d] & (part[s] == part[d])
                return e if drop_mat is None else e & drop_mat[s, d]

            def ok_rows(s0):
                sl = rows(s0)
                o = alive[sl, None] & alive[None, :] & (part[sl, None] == part[None, :])
                return o if drop_mat is None else o & drop_mat[sl]

            def okT_rows(s0):
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

        # phase-A row stats on the post-churn snapshot
        S0, T0 = S, T

        def stats_rows(s0):
            sl = rows(s0)
            Sb, Tb = S0[sl], T0[sl]
            aged = alive[sl, None] & (Tb <= thr)
            timed_wfp = aged & (Sb == WAITING_FOR_PING)
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

        # A1: join broadcast throttle
        if joins_on:
            lonely = row_count0 <= 1
            due = (t - last_b) >= proto["rebroadcast_interval_ticks"]
            join_b = alive & (never_b | (lonely & due))
            last_b = torch.where(join_b, t, last_b).to(torch.int32)
            never_b = never_b & ~join_b
            joining = bool(join_b.any())
        else:
            join_b = torch.zeros((n,), dtype=torch.bool, device=dev)
            joining = False

        man_tgt = torch.where(alive & (inp.manual_target != idx) & (inp.manual_target < n),
                              inp.manual_target, -1).to(torch.int32)

        # proxies, drawn per block
        if escalating:
            proxies, proxies_valid = blocks(lambda s0: choose_k_members(
                (S0[rows(s0)] == KNOWN) & ~blk_eye(s0), k_ind, rng.fold_in(key_proxy, s0 // block)))
        else:
            proxies = torch.zeros((n, min(k_ind, n)), dtype=torch.int32, device=dev)
            proxies_valid = torch.zeros((n, min(k_ind, n)), dtype=torch.bool, device=dev)
        proxies_valid = proxies_valid & escalate[:, None]

        def jstar_is(s0):
            return idx[None, :] == jstar[rows(s0), None]

        def rem_rows(s0):
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

        fail_del = None
        if not proto["faithful_failed_broadcast"] and any_rem:

            def fail_rows(s0):
                okT_b = okT_rows(s0)
                gt = torch.zeros((block, n), dtype=torch.bool, device=dev)
                anyv = torch.zeros((block, n), dtype=torch.bool, device=dev)
                for i0 in range(0, n, block):
                    rem_b = rem_rows(i0)
                    ok_i = okT_b[:, rows(i0)]
                    gt |= bool_matmul(ok_i, rem_b & (idx[rows(i0), None] > idx[None, :]))
                    anyv |= bool_matmul(ok_i, rem_b)
                eye_b = blk_eye(s0)
                if joins_on:
                    return ~eye_b & torch.where(join_b[None, :] & okT_b & ~eye_b, gt, anyv)
                return ~eye_b & anyv

            fail_del = blocks(fail_rows)

        # A3: ping-target candidates per block, the per-row draw whole
        def a3_rows(s0):
            sl = rows(s0)
            elig = alive[sl, None] & (S[sl] == KNOWN) & ~blk_eye(s0)
            return stable_k_smallest(torch.where(elig, T[sl], tmax), min(k_cand, n), tmax)

        cand_idx, cand_valid = blocks(a3_rows)
        ping_tgt = choose_among_candidates(cand_idx, cand_valid, key_ping, fdt)
        has_ping = ping_tgt >= 0

        ok_ping = has_ping & ok_edge(idx, ping_tgt)
        ok_man = (man_tgt >= 0) & ok_edge(idx, man_tgt)
        del_pr = proxies_valid & ok_edge(idx[:, None], proxies)
        del_ack = ok_ping & ok_edge(ping_tgt, idx)
        del_ack_man = ok_man & ok_edge(man_tgt, idx)
        del_pping = del_pr & ok_edge(proxies, jstar[:, None])
        del_pack = del_pping & ok_edge(jstar[:, None], proxies)
        pc = proxies.clamp(min=0).long()
        pop_hit = ((ping_tgt[pc] == jstar[:, None]) & del_ack[pc]) | (
            (man_tgt[pc] == jstar[:, None]) & del_ack_man[pc])
        fwd_c = del_pr & pop_hit
        del_fwd_c = fwd_c & ok_edge(proxies, idx[:, None])
        fwd = del_pack & ~pop_hit
        del_fwd = fwd & ok_edge(proxies, idx[:, None])

        def inblk_marks(s0, marks):
            out = torch.zeros((block, n), dtype=torch.bool, device=dev)
            for r, c, v in marks:
                sel = v & (r >= s0) & (r < s0 + block)
                out[(r.expand_as(sel)[sel] - s0).long(),
                    c.expand_as(sel)[sel].clamp(min=0).long()] = True
            return out

        # composed write: A3 -> B -> wave 1 -> wave 2 -> gossip insert
        def compose_rows(reply_del, gossip):
            def body(s0):
                sl = rows(s0)
                gi = idx[sl]
                Sb, Tb = S[sl], T[sl]
                lb = lat[sl] if has_lat else None
                vb = idv[sl] if has_idv else None
                tgt_cell = (idx[None, :] == ping_tgt[sl, None]) & has_ping[sl, None]
                m1 = ((gi[:, None] == ping_tgt[None, :]) & ok_ping[None, :]) | (
                    (gi[:, None] == man_tgt[None, :]) & ok_man[None, :])
                if escalating:
                    for k in range(proxies.shape[-1]):
                        m1 |= (gi[:, None] == proxies[None, :, k]) & del_pr[None, :, k]
                m2 = ((idx[None, :] == ping_tgt[sl, None]) & del_ack[sl, None]) | (
                    (idx[None, :] == man_tgt[sl, None]) & del_ack_man[sl, None])
                if reply_del is not None:
                    m2 |= reply_del[:, sl].t()
                if escalating:
                    m2 |= inblk_marks(s0, [(jstar[:, None], proxies, del_pping)])
                S_B = torch.where(tgt_cell, WAITING_FOR_PING, Sb)
                stamp = tgt_cell
                if reply_del is not None:
                    Jm_b = join_b[None, :] & okT_rows(s0) & ~blk_eye(s0)
                    S_B = torch.where(Jm_b, KNOWN, S_B)
                    stamp = stamp | Jm_b
                    if has_idv:
                        vb = torch.where(Jm_b, id_row, vb)
                T_B = torch.where(stamp, t, Tb)
                if fail_del is not None:
                    S_B = torch.where(fail_del[sl], 0, S_B)
                m_B = S_B > 0
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
                    T_2 = torch.where(g_ins, t - backdate, T_2)
                    if has_idv:
                        vb = torch.where(g_ins, id_row, vb)
                return (S_2, T_2, fp0, n0, dfp1, dn1, dfp2, dn2) + planes(lb, vb)

            return body

        msgs_join = zero32
        reply_del = gossip = None
        if joining:
            row_count_a = blocks(lambda s0: (S[rows(s0)] > 0).sum(dim=-1, dtype=torch.int32))

            def reply_rows(s0):
                sl = rows(s0)
                Jm_b = join_b[None, :] & okT_rows(s0) & ~blk_eye(s0)
                is_new = Jm_b & ~(S[sl] > 0)
                n_after = row_count_a[sl, None] + torch.cumsum(is_new, dim=1, dtype=torch.int32)
                bern = bernoulli_matrix(rng.fold_in(key_bern, s0 // block),
                                        broadcast_reply_prob(n_after, fdt), (block, n), fdt)
                return is_new & bern & ok_rows(s0)

            reply_del = blocks(reply_rows)
            msgs_join = reply_del.sum(dtype=torch.int32)
            if boot_union:
                cnt = reply_del.sum(dim=0, dtype=torch.int32)

                def union_rows_boot(s0):
                    sl = rows(s0)
                    rep_t = reply_del[:, sl].t()
                    others = (cnt[sl, None] - rep_t.to(torch.int32)) > 0
                    return rep_t | (join_b[None, :] & others & (idx[None, :] <= idx[sl, None]))

                gossip = blocks(union_rows_boot)
            elif bool(reply_del.any()):

                def share_rows(r0):
                    member_r = S[rows(r0)] > 0
                    if cap and n > cap:
                        return member_r & (torch.cumsum(member_r, dim=1, dtype=torch.int32) <= cap)
                    return member_r

                def union_rows(s0):
                    sl = rows(s0)
                    t1 = torch.zeros((block, n), dtype=torch.bool, device=dev)
                    t2 = torch.zeros((block, n), dtype=torch.bool, device=dev)
                    for r0 in range(0, n, block):
                        rep_t = reply_del[rows(r0), sl].t()
                        jm_r = join_b[None, :] & okT_rows(r0) & ~blk_eye(r0)
                        t1 |= bool_matmul(rep_t, share_rows(r0))
                        t2 |= bool_matmul(rep_t, jm_r)
                    return t1 | (t2 & (idx[None, :] <= idx[sl, None]))

                gossip = blocks(union_rows)

        comp = blocks(compose_rows(reply_del, gossip))
        del reply_del, gossip
        S, T, fp0, n0, dfp1, dn1, dfp2, dn2, *rest = comp
        del comp
        it = iter(rest)
        lat = next(it) if has_lat else None
        idv = next(it) if has_idv else None
        fp1, n1 = add32(fp0, dfp1), n0 + dn1

        if escalating:
            fp2, n2 = blocks(fp_rows(S, idv))
        else:
            fp2 = n2 = torch.zeros((n,), dtype=torch.int32, device=dev)

        # calls 3 and 4
        if escalating:
            jb = jstar[:, None].expand_as(proxies)
            ib = idx[:, None].expand_as(proxies)

            def calls34_rows(s0):
                sl = rows(s0)
                Sb, Tb = S[sl], T[sl]
                lb = lat[sl] if has_lat else None
                vb = idv[sl] if has_idv else None
                mark3 = inblk_marks(s0, [(proxies, jb, del_pack), (ib, proxies, del_fwd_c)])
                Sb, Tb, lb, vb = apply_marks(Sb, Tb, lb, vb, mark3)
                mark4 = inblk_marks(s0, [(ib, proxies, del_fwd)])
                Sb, Tb, lb, vb = apply_marks(Sb, Tb, lb, vb, mark4)
                if not proto["faithful_indirect_ack"]:
                    cleared = (del_fwd | del_fwd_c)[sl].any(dim=-1)
                    clr = cleared[:, None] & jstar_is(s0) & (Sb > 0)
                    Sb = torch.where(clr, KNOWN, Sb)
                    Tb = torch.where(clr, t, Tb)
                return planes(Sb, Tb, lb, vb)

            S, T, lat, idv = unpack(blocks(calls34_rows))

        if joining or escalating:
            fp_g, n_g = blocks(fp_rows(S, idv))
        else:
            fp_g, n_g = add32(fp1, dfp2), n1 + dn2

        # anti-entropy candidates (kaboodle.rs:707-740)
        def prio0_rows(s0):
            sl = rows(s0)
            m0 = (st.kpr_partner[None, :] == idx[sl, None]) & alive[sl, None] & ~rv[sl, None]
            match0 = m0 & (st.kpr_fp[None, :] != fp_g[sl, None]) & (
                n_g[sl, None] <= st.kpr_n[None, :])
            return torch.where(match0, idx[None, :], INF).amin(dim=-1)

        prio0 = blocks(prio0_rows)
        peer0 = prio0
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
            reduce="amin", include_self=True)
        peer_proxy = prio_proxy - base2
        x_fp1, x_n1 = fp1[jc], n1[jc]
        m_cf = del_fwd_c & (x_fp1[:, None] != fp_g[:, None]) & (n_g[:, None] <= x_n1[:, None])
        prio_coinc = torch.where(m_cf, base2 + proxies, INF).amin(dim=-1)
        prio2 = torch.minimum(prio_proxy, prio_coinc)
        peer2 = torch.where(prio_proxy <= prio_coinc, peer_proxy, jstar)
        m_f = del_fwd & (x_fp2[:, None] != fp_g[:, None]) & (n_g[:, None] <= x_n2[:, None])
        prio3 = torch.where(m_f, base3 + proxies, INF).amin(dim=-1)
        best = torch.minimum(torch.minimum(prio0, prio1), torch.minimum(prio2, prio3))
        partner = torch.where(best == prio0, peer0, torch.where(
            best == prio1, peer1, torch.where(best == prio2, peer2, jstar))).to(torch.int32)
        has_req = (best != INF) & alive
        partner = torch.where(has_req, partner, -1)
        del_kpr = has_req & ok_edge(idx, partner)
        del_rep = del_kpr & ok_edge(partner, idx)

        # call G: two passes, the share read from the post-mark state
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
                pcl = ptb.clamp(min=0).long()
                share = (S[pcl] == KNOWN) & (idx[None, :] != ptb[:, None]) & (T[pcl] > share_floor)
                rep_ins = del_rep[sl, None] & share & ~blk_eye(s0) & ~(Sb > 0)
                out = [torch.where(rep_ins, KNOWN, Sb), torch.where(rep_ins, t - backdate, Tb)]
                if has_idv:
                    out.append(torch.where(rep_ins, id_row, idv[sl]))
                return tuple(out)

            g2 = blocks(g2_rows)
            S, T = g2[0], g2[1]
            if has_idv:
                idv = g2[2]
            del g2
            fp_f, n_f = blocks(fp_rows(S, idv))
        else:
            fp_f, n_f = fp_g, n_g

        msgs = sum(x.sum(dtype=torch.int64) for x in (
            ok_ping, ok_man, del_pr, del_ack, del_ack_man, del_pping, del_pack,
            del_fwd_c, del_fwd, del_kpr, del_rep)) + msgs_join
        converged, fpa_min, fpa_max, n_alive = fingerprint_agreement(alive, fp_f)
        agree = (alive & (fp_f == fpa_min)).sum(dtype=torch.int32)
        denom = n_alive.clamp(min=1)
        new = State(state=S, timer=T, alive=alive, identity=st.identity,
                    never_broadcast=never_b, last_broadcast=last_b,
                    kpr_partner=torch.where(del_kpr, partner, -1).to(torch.int32),
                    kpr_fp=fp_g, kpr_n=n_g, tick=st.tick + 1, key=st.key,
                    latency=lat, id_view=idv)
        metrics = Metrics(
            messages_delivered=msgs.to(torch.int32), converged=converged,
            agree_fraction=agree.to(fdt) / denom,
            mean_membership=torch.where(alive, n_f, 0).to(fdt).sum() / denom,
            fingerprint_min=fpa_min, fingerprint_max=fpa_max)
        return new, metrics

    return tick
