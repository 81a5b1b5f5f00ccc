"""One SWIM tick over the whole ``[N, N]`` mesh, in plain PyTorch.

The protocol of serval/kaboodle (src/kaboodle.rs:746-786) in lockstep, as
the benchmark's reference states it. Round structure of tick t:

  A  active phase: Join broadcasts, suspicion handling (escalation to an
     indirect ping, removals), the random ping, manual pings.
  B  broadcast delivery: Join inserts and the join-response shares.
  1  call 1: Pings and PingRequests delivered.
  2  call 2: direct Acks, proxy Pings, join responses; gossip inserts.
  3  call 3: the suspects' Acks at the proxies.
  4  call 4: forwarded Acks.
  G  anti-entropy: each peer resolves at most one KnownPeersRequest.

A tick with no Join broadcast and no suspicion activity takes the short
form (every delivery mask derives from ``[N]`` vectors, composed into one
write), as the reference's own dispatch does. Tensors are never updated in
place. ``fdt`` is the float type of the draws, the probabilities and the
latency EWMA (float32 as configured; the control lowers it).
"""

from __future__ import annotations

import torch

from portbench.reference import rng
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
    choose_one_of_oldest_k,
    fp_count,
    oldest_k,
    suspicion_stats,
)
from portbench.reference.state import (
    KNOWN,
    WAITING_FOR_INDIRECT_PING,
    WAITING_FOR_PING,
    Inputs,
    Metrics,
    State,
)

INF = torch.iinfo(torch.int32).max
_NAN = float("nan")


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a @ b) > 0`` over booleans: counted in int32 on the CPU, in float16
    on a card (a sum of non-negative terms with one 1 rounds to a positive
    number, so the test is exact in any float format)."""
    if a.device.type == "cuda":
        return (a.to(torch.float16) @ b.to(torch.float16)) > 0
    return (a.to(torch.int32) @ b.to(torch.int32)) > 0


def _take_cell(plane, s, d):
    n = plane.shape[-1]
    return plane.reshape(-1)[(s.clamp(min=0).long() * n + d.clamp(min=0).long()).reshape(-1)
                             ].view(torch.broadcast_shapes(s.shape, d.shape))


def _take_vec(vec, i):
    return vec[i.clamp(min=0).long()]


def _take_rows(plane, i):
    return plane[i.clamp(min=0).long()]


def _scatter_or(dst, rows, cols, val):
    n = dst.shape[-1]
    flat = (rows.clamp(min=0).long() * n + cols.clamp(min=0).long()).expand(val.shape)
    out = dst.clone()
    out.view(-1)[flat[val]] = True
    return out


def _col_mark(idx, tgt, val):
    """mark[d, s] = (tgt[s] == d) & val[s]."""
    return (idx[:, None] == tgt[None, :]) & val[None, :]


def _row_mark(idx, tgt, val):
    """mark[s, d] = (tgt[s] == d) & val[s]."""
    return (idx[None, :] == tgt[:, None]) & val[:, None]


def add32(a, b):
    return wrap32(a.to(torch.int64) + b.to(torch.int64))


def make_tick(proto: dict, faulty: bool = True, fdt=torch.float32):
    """The tick for a protocol (the configuration's ``protocol`` group)."""
    timeout = proto["ping_timeout_ticks"]
    share_age = proto["max_peer_share_age_ticks"]
    backdate = share_age if proto["backdate_gossip_inserts"] else 0
    k_cand = proto["num_candidate_target_peers"]
    k_ind = proto["num_indirect_ping_peers"]
    cap = proto["max_share_peers"]
    joins_on = proto["join_broadcast_enabled"]

    def tick(st: State, inp: Inputs) -> tuple[State, Metrics]:
        n = st.n
        dev = st.state.device
        t = int(st.tick)
        key = tuple(int(w) & rng.M32 for w in st.key.tolist())
        key_proxy, key_ping, key_bern, key_drop = rng.tick_draw_keys(key, t)
        T_dt = st.timer.dtype
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        eye = idx[:, None] == idx[None, :]
        S, T = st.state, st.timer
        lat, idv = st.latency, st.id_view
        has_lat, has_idv = lat is not None, idv is not None
        alive, never_b, last_b = st.alive, st.never_broadcast, st.last_broadcast
        zero32 = torch.zeros((), dtype=torch.int32, device=dev)
        id_row = st.identity[None, :]
        tT = torch.tensor(t, dtype=T_dt, device=dev)

        # churn: silent kill, revive with reset
        if faulty:
            alive = (alive & ~inp.kill) | inp.revive
            rv = inp.revive
            rvc = rv[:, None]
            S = torch.where(rvc, torch.where(eye, KNOWN, 0).to(torch.int8), S)
            T = torch.where(rvc, torch.where(eye, tT, 0).to(T_dt), T)
            if has_lat:
                lat = torch.where(rvc, _NAN, lat)
            if has_idv:
                idv = torch.where(rvc, torch.where(eye, id_row, zero32), idv)
            never_b = never_b | rv
            part = inp.partition
            ok = alive[:, None] & alive[None, :] & (part[:, None] == part[None, :])
            if float(inp.drop_rate) > 0:
                rate = torch.as_tensor(inp.drop_rate, dtype=fdt, device=dev)
                gate = torch.empty((n, n), dtype=torch.bool, device=dev)
                for r0, r1 in rng.row_chunks(n, n):
                    u = rng.bits_to_uniform(rng.random_bits(key_drop, (n, n), dev, (r0, r1)), fdt)
                    gate[r0:r1] = u >= rate
                ok = ok & gate
        else:
            rv = torch.zeros((n,), dtype=torch.bool, device=dev)
            ok = alive[:, None] & alive[None, :]

        def ok_edge(s, d):
            return _take_cell(ok, s, d)

        okT = ok.transpose(0, 1)

        # Phase-A row stats on the pre-tick snapshot
        S0, T0 = S, T
        thr = t - timeout
        row_count0, jstar, has_timed, has_cand, wfip_any = suspicion_stats(S, T, alive, thr)
        any_a2 = bool(wfip_any.any() | has_timed.any())

        rec_hash = peer_record_hash(idx, st.identity)
        rec_row = rec_hash[None, :]
        rec64 = as_u32(rec_row)
        pid_row = idx.to(torch.int64)[None, :]

        def fpc(S_now, idv_now):
            return fp_count(S_now, idv_now if has_idv else rec_hash)

        def ewma(S_, T_, lat_, mark):
            waiting = (S_ == WAITING_FOR_PING) | (S_ == WAITING_FOR_INDIRECT_PING)
            sample = (t - T_.to(torch.int32)).to(fdt)
            upd = torch.where(torch.isnan(lat_), sample, 0.8 * sample + 0.2 * lat_)
            return torch.where(mark & waiting, upd, lat_)

        def apply_marks(S_, T_, lat_, idv_, mark):
            if has_lat:
                lat_ = ewma(S_, T_, lat_, mark)
            if has_idv:
                idv_ = torch.where(mark, id_row, idv_)
            return torch.where(mark, KNOWN, S_), torch.where(mark, tT, T_), lat_, idv_

        def apply_marks_delta(S_, T_, lat_, idv_, mark):
            member_b = S_ > 0
            newm = mark & ~member_b
            if has_idv:
                old = torch.where(member_b, as_u32(peer_record_hash(pid_row, idv_)), 0)
                dfp = wrap32(torch.where(mark, rec64 - old, 0).sum(dim=-1))
            else:
                dfp = wrap_sum(torch.where(newm, rec_row, zero32))
            dn = newm.sum(dim=-1, dtype=torch.int32)
            S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, mark)
            return S_, T_, lat_, idv_, dfp, dn

        # A1: join broadcast throttle (kaboodle.rs:228-251)
        if joins_on:
            lonely = row_count0 <= 1
            due = (t - last_b) >= proto["rebroadcast_interval_ticks"]
            join_b = alive & (never_b | (lonely & due))
            last_b = torch.where(join_b, t, last_b).to(torch.int32)
            never_b = never_b & ~join_b
            any_join = bool(join_b.any())
        else:
            join_b = torch.zeros((n,), dtype=torch.bool, device=dev)
            any_join = False

        # A4: manual pings; self-pings and out-of-range targets drop
        man_tgt = torch.where(alive & (inp.manual_target != idx) & (inp.manual_target < n),
                              inp.manual_target, -1).to(torch.int32)

        def anti_entropy(S_, T_, lat_, idv_, partner, del_kpr, del_rep, fp_g, n_g):
            """Call G (kaboodle.rs:707-740): the partner marks the requester,
            then the requester marks the partner and takes its share."""
            if not bool(del_kpr.any()):
                return S_, T_, lat_, idv_, fp_g, n_g
            S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, _col_mark(idx, partner, del_kpr))
            share = (S_ == KNOWN) & ~eye & ((t - T_.to(torch.int32)) < share_age)
            mark_rep = _row_mark(idx, partner, del_rep)
            S_ = torch.where(mark_rep, KNOWN, S_)
            T_ = torch.where(mark_rep, tT, T_)
            if bool(del_rep.any()):
                rep_ins = del_rep[:, None] & _take_rows(share, partner) & ~eye & ~(S_ > 0)
                S_ = torch.where(rep_ins, KNOWN, S_)
                T_ = torch.where(rep_ins, torch.tensor(t - backdate, dtype=T_dt, device=dev), T_)
                if has_idv:
                    idv_ = torch.where(rep_ins, id_row, idv_)
            fp_f, n_f = fpc(S_, idv_)
            return S_, T_, lat_, idv_, fp_f, n_f

        def ae_phase01(fp_g, n_g, fp1, n1, del_ack, del_ack_man, ping_tgt):
            m0 = (st.kpr_partner[None, :] == idx[:, None]) & alive[:, None] & ~rv[:, None]
            match0 = m0 & (st.kpr_fp[None, :] != fp_g[:, None]) & (
                n_g[:, None] <= st.kpr_n[None, :])
            prio0 = torch.where(match0, idx[None, :], INF).amin(dim=-1)
            m_d = del_ack & (_take_vec(fp1, ping_tgt) != fp_g) & (n_g <= _take_vec(n1, ping_tgt))
            m_m = del_ack_man & (_take_vec(fp1, man_tgt) != fp_g) & (n_g <= _take_vec(n1, man_tgt))
            prio_d = torch.where(m_d, n + ping_tgt, INF)
            prio_m = torch.where(m_m, n + man_tgt, INF)
            return prio0, prio0, torch.minimum(prio_d, prio_m), torch.where(
                prio_d <= prio_m, ping_tgt, man_tgt)

        def finish(S_, T_, lat_, idv_, kpr_new, fp_g, n_g, fp_f, n_f, msgs):
            converged, fpa_min, fpa_max, n_alive = fingerprint_agreement(alive, fp_f)
            agree = (alive & (fp_f == fpa_min)).sum(dtype=torch.int32)
            denom = n_alive.clamp(min=1)
            new = State(state=S_, timer=T_, alive=alive, identity=st.identity,
                        never_broadcast=never_b, last_broadcast=last_b,
                        kpr_partner=kpr_new.to(torch.int32), kpr_fp=fp_g, kpr_n=n_g,
                        tick=st.tick + 1, key=st.key, latency=lat_, id_view=idv_)
            metrics = Metrics(
                messages_delivered=msgs.to(torch.int32), converged=converged,
                agree_fraction=agree.to(fdt) / denom,
                mean_membership=torch.where(alive, n_f, 0).to(fdt).sum() / denom,
                fingerprint_min=fpa_min, fingerprint_max=fpa_max)
            return new, metrics

        def full():
            S_, T_, lat_, idv_ = S, T, lat, idv
            escalate = has_timed & has_cand
            insta_remove = has_timed & ~has_cand
            jstar_cell = idx[None, :] == jstar[:, None]
            any_rem = bool((wfip_any | insta_remove).any())
            escalating = bool(escalate.any())

            # A2: handle suspected peers on the pre-tick snapshot
            if escalating:
                proxies, proxies_valid = choose_k_members((S0 == KNOWN) & ~eye, k_ind, key_proxy)
            else:
                proxies = torch.zeros((n, min(k_ind, n)), dtype=torch.int32, device=dev)
                proxies_valid = torch.zeros((n, min(k_ind, n)), dtype=torch.bool, device=dev)
            proxies_valid = proxies_valid & escalate[:, None]

            def a2_rem():
                r = alive[:, None] & (S0 == WAITING_FOR_INDIRECT_PING) & (T0.to(torch.int32) <= thr)
                return r | (insta_remove[:, None] & jstar_cell)

            if any_a2:
                rem = a2_rem()
                S_ = torch.where(rem, 0, S_)
                if has_lat:
                    lat_ = torch.where(rem, _NAN, lat_)
                esc_cell = escalate[:, None] & jstar_cell
                S_ = torch.where(esc_cell, WAITING_FOR_INDIRECT_PING, S_)
                T_ = torch.where(esc_cell, tT, T_)

            # A3: ping a random one of the oldest Known peers
            cand_idx, cand_valid = oldest_k(S_, T_, alive, k_cand)
            ping_tgt = choose_among_candidates(cand_idx, cand_valid, key_ping, fdt)
            has_ping = ping_tgt >= 0
            tgt_cell = _row_mark(idx, ping_tgt, has_ping)
            S_ = torch.where(tgt_cell, WAITING_FOR_PING, S_)
            T_ = torch.where(tgt_cell, tT, T_)
            member_a = S_ > 0
            row_count_a = member_a.sum(dim=-1, dtype=torch.int32)

            # B: broadcast delivery, [receiver, origin]
            if joins_on:
                Jm = (join_b[None, :] & okT & ~eye).contiguous()
                is_new_ro = Jm & ~member_a
                S_ = torch.where(Jm, KNOWN, S_)
                T_ = torch.where(Jm, tT, T_)
                if has_idv:
                    idv_ = torch.where(Jm, id_row, idv_)
            else:
                Jm = torch.zeros((n, n), dtype=torch.bool, device=dev)
                is_new_ro = Jm

            if not proto["faithful_failed_broadcast"] and any_rem:
                rem = a2_rem()
                rem_gt = rem & (idx[:, None] > idx[None, :])
                fail_del = ~eye & torch.where(Jm, bool_matmul(okT, rem_gt), bool_matmul(okT, rem))
                S_ = torch.where(fail_del, 0, S_)
                if has_lat:
                    lat_ = torch.where(fail_del, _NAN, lat_)

            # Join responses (kaboodle.rs:333-392) and the gossip union
            reply_del = reply_t = gossip = None
            if joins_on and any_join:
                n_after = row_count_a[:, None] + torch.cumsum(is_new_ro, dim=-1, dtype=torch.int32)
                reply = is_new_ro & bernoulli_matrix(
                    key_bern, broadcast_reply_prob(n_after, fdt), (n, n), fdt)
                reply_del = reply & ok
                reply_t = reply_del.transpose(0, 1)
                if bool(reply_del.any()):
                    share_base = member_a
                    if cap and n > cap:
                        within = torch.cumsum(member_a, dim=-1, dtype=torch.int32) <= cap
                        share_base = member_a & within
                    term1 = bool_matmul(reply_t, share_base)
                    term2 = bool_matmul(reply_t, Jm)
                    gossip = term1 | (term2 & (idx[None, :] <= idx[:, None]))

            # Call 1: Pings and PingRequests
            ok_ping = has_ping & ok_edge(idx, ping_tgt)
            ok_man = (man_tgt >= 0) & ok_edge(idx, man_tgt)
            del_pr = proxies_valid & ok_edge(idx[:, None], proxies)
            del_ack = ok_ping & ok_edge(ping_tgt, idx)
            del_ack_man = ok_man & ok_edge(man_tgt, idx)
            mark1 = _col_mark(idx, ping_tgt, ok_ping) | _col_mark(idx, man_tgt, ok_man)
            if escalating:
                for kk in range(proxies.shape[-1]):
                    mark1 = mark1 | _col_mark(idx, proxies[:, kk], del_pr[:, kk])
            fp0, n0 = fpc(S_, idv_)
            S_, T_, lat_, idv_, dfp1, dn1 = apply_marks_delta(S_, T_, lat_, idv_, mark1)
            fp1, n1 = add32(fp0, dfp1), n0 + dn1
            del_pping = del_pr & ok_edge(proxies, jstar[:, None])

            # Call 2: Acks, proxy Pings, join responses
            mark2 = _row_mark(idx, ping_tgt, del_ack) | _row_mark(idx, man_tgt, del_ack_man)
            if reply_t is not None:
                mark2 = mark2 | reply_t.contiguous()
            if escalating:
                mark2 = _scatter_or(mark2, jstar[:, None], proxies, del_pping)
            S_, T_, lat_, idv_, dfp2, dn2 = apply_marks_delta(S_, T_, lat_, idv_, mark2)
            if gossip is not None:
                gossip_new = gossip & ~(S_ > 0)
                S_ = torch.where(gossip_new, KNOWN, S_)
                T_ = torch.where(gossip_new, torch.tensor(t - backdate, dtype=T_dt, device=dev), T_)
                if has_idv:
                    idv_ = torch.where(gossip_new, id_row, idv_)
            if escalating:
                fp2, n2 = fpc(S_, idv_)
            else:
                fp2 = n2 = torch.zeros((n,), dtype=torch.int32, device=dev)

            del_pack = del_pping & ok_edge(jstar[:, None], proxies)
            pop_hit = ((_take_vec(ping_tgt, proxies) == jstar[:, None])
                       & _take_vec(del_ack, proxies)) | (
                (_take_vec(man_tgt, proxies) == jstar[:, None]) & _take_vec(del_ack_man, proxies))
            fwd_c = del_pr & pop_hit
            del_fwd_c = fwd_c & ok_edge(proxies, idx[:, None])
            fwd = del_pack & ~pop_hit
            del_fwd = fwd & ok_edge(proxies, idx[:, None])

            # Calls 3 and 4
            if escalating:
                no_marks = torch.zeros((n, n), dtype=torch.bool, device=dev)
                mark3 = _scatter_or(no_marks, proxies, jstar[:, None], del_pack)
                mark3 = _scatter_or(mark3, idx[:, None], proxies, del_fwd_c)
                S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, mark3)
                mark4 = _scatter_or(no_marks, idx[:, None], proxies, del_fwd)
                S_, T_, lat_, idv_ = apply_marks(S_, T_, lat_, idv_, mark4)
                if not proto["faithful_indirect_ack"]:
                    cleared = (del_fwd | del_fwd_c).any(dim=-1)
                    clr = cleared[:, None] & jstar_cell & (S_ > 0)
                    S_ = torch.where(clr, KNOWN, S_)
                    T_ = torch.where(clr, tT, T_)

            # G: anti-entropy
            if any_join or escalating:
                fp_g, n_g = fpc(S_, idv_)
            else:
                fp_g, n_g = add32(fp1, dfp2), n1 + dn2
            prio0, peer0, prio1, peer1 = ae_phase01(
                fp_g, n_g, fp1, n1, del_ack, del_ack_man, ping_tgt)
            base2, base3 = 2 * n, 3 * n
            x_fp2, x_n2 = _take_vec(fp2, jstar), _take_vec(n2, jstar)
            m_px = del_pack & (x_fp2[:, None] != _take_vec(fp_g, proxies)) & (
                _take_vec(n_g, proxies) <= x_n2[:, None])
            prio_proxy = torch.full((n,), INF, dtype=torch.int32, device=dev).scatter_reduce(
                -1, proxies.reshape(-1).clamp(min=0).long(),
                torch.where(m_px, base2 + jstar[:, None], INF).reshape(-1),
                reduce="amin", include_self=True)
            peer_proxy = prio_proxy - base2
            x_fp1, x_n1 = _take_vec(fp1, jstar), _take_vec(n1, jstar)
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
            S_, T_, lat_, idv_, fp_f, n_f = anti_entropy(
                S_, T_, lat_, idv_, partner, del_kpr, del_rep, fp_g, n_g)
            msgs = sum(x.sum(dtype=torch.int64) for x in (
                ok_ping, ok_man, del_pr, del_ack, del_ack_man, del_pping, del_pack,
                del_fwd_c, del_fwd, del_kpr, del_rep))
            if reply_del is not None:
                msgs = msgs + reply_del.sum(dtype=torch.int64)
            return finish(S_, T_, lat_, idv_, torch.where(del_kpr, partner, -1),
                          fp_g, n_g, fp_f, n_f, msgs)

        def short():
            """A tick with no Join broadcast and no suspicion activity."""
            S_, T_, lat_, idv_ = S, T, lat, idv
            elig = alive[:, None] & (S_ == KNOWN) & ~eye
            ping_tgt = choose_one_of_oldest_k(T_, elig, k_cand, key_ping, fdt)
            has_ping = ping_tgt >= 0
            ok_ping = has_ping & ok_edge(idx, ping_tgt)
            ok_man = (man_tgt >= 0) & ok_edge(idx, man_tgt)
            del_ack = ok_ping & ok_edge(ping_tgt, idx)
            del_ack_man = ok_man & ok_edge(man_tgt, idx)
            tgt_cell = _row_mark(idx, ping_tgt, has_ping)
            mark1 = _col_mark(idx, ping_tgt, ok_ping) | _col_mark(idx, man_tgt, ok_man)
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
                S_a3 = torch.where(tgt_cell, WAITING_FOR_PING, S_)
                T_a3 = torch.where(tgt_cell, tT, T_)
                lat1 = ewma(S_a3, T_a3, lat_, mark1)
                S_1, T_1 = torch.where(mark1, KNOWN, S_a3), torch.where(mark1, tT, T_a3)
                lat_ = ewma(S_1, T_1, lat1, mark2)
            S_ = torch.where(mark_k, KNOWN, torch.where(tgt_cell, WAITING_FOR_PING, S_))
            T_ = torch.where(mark_k | tgt_cell, tT, T_)
            fp1, n1 = add32(fp0, dfp1), n0 + dn1
            fp_g, n_g = add32(fp1, dfp2), n1 + dn2
            prio0, peer0, prio1, peer1 = ae_phase01(
                fp_g, n_g, fp1, n1, del_ack, del_ack_man, ping_tgt)
            best = torch.minimum(prio0, prio1)
            partner = torch.where(best == prio0, peer0, peer1).to(torch.int32)
            has_req = (best != INF) & alive
            partner = torch.where(has_req, partner, -1)
            del_kpr = has_req & ok_edge(idx, partner)
            del_rep = del_kpr & ok_edge(partner, idx)
            S_, T_, lat_, idv_, fp_f, n_f = anti_entropy(
                S_, T_, lat_, idv_, partner, del_kpr, del_rep, fp_g, n_g)
            msgs = sum(x.sum(dtype=torch.int64) for x in (
                ok_ping, ok_man, del_ack, del_ack_man, del_kpr, del_rep))
            return finish(S_, T_, lat_, idv_, torch.where(del_kpr, partner, -1),
                          fp_g, n_g, fp_f, n_f, msgs)

        return full() if (any_a2 or any_join) else short()

    return tick
