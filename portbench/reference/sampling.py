"""The tick's random selections and row statistics, in plain PyTorch.

The draws are the reference protocol's (kaboodle.rs): the ping target among
the ``k`` longest-unheard Known peers (:661-675), ``choose_multiple`` of the
indirect-ping proxies (:595-597) and the join-reply Bernoulli (:344-353).
Every top-k ranks on a key that is unique per cell (value, then column), so
no tie is left to the order a sort happens to give.

``fp_count``, ``suspicion_stats`` and ``oldest_k`` state what the three row
kernels of the program compute, written out as array expressions.
``fdt`` is the float type a draw is compared in (float32 as configured).
"""

from __future__ import annotations

import torch

from portbench.reference import rng
from portbench.reference.hashing import peer_record_hash, wrap_sum
from portbench.reference.state import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING

_COL = 1 << 32


def stable_k_smallest(scores: torch.Tensor, k: int, tmax: int):
    """``(idx, valid)`` of the k smallest scores per row, ties to the lower
    index: k rounds of a lexicographic min over (score, index)."""
    n = scores.shape[-1]
    idxr = torch.arange(n, dtype=torch.int32, device=scores.device)[None, :]
    prev_s = torch.full(scores.shape[:-1], torch.iinfo(scores.dtype).min,
                        dtype=scores.dtype, device=scores.device)
    prev_i = torch.full(scores.shape[:-1], -1, dtype=torch.int32, device=scores.device)
    out_i, out_v = [], []
    for _ in range(k):
        after = (scores > prev_s[..., None]) | (
            (scores == prev_s[..., None]) & (idxr > prev_i[..., None]))
        s_r = torch.where(after, scores, tmax).amin(dim=-1)
        i_r = torch.where(after & (scores == s_r[..., None]), idxr, n).amin(dim=-1)
        out_i.append(i_r)
        out_v.append(s_r != tmax)
        prev_s, prev_i = s_r, i_r
    return torch.stack(out_i, dim=-1).clamp(max=n - 1), torch.stack(out_v, dim=-1)


def pick_candidate(idx, valid, u):
    """``floor(u * count)``-th valid candidate per row, -1 where none."""
    count = valid.sum(dim=-1, dtype=torch.int32)
    choice = torch.floor(u * count.to(u.dtype)).to(torch.int64)
    choice = torch.minimum(choice, (count - 1).clamp(min=0).to(torch.int64))
    chosen = idx.gather(-1, choice[..., None])[..., 0]
    return torch.where(count > 0, chosen, -1).to(torch.int32)


def choose_among_candidates(idx, valid, key, fdt):
    return pick_candidate(idx, valid, rng.uniform(key, (idx.shape[-2],), idx.device, fdt))


def choose_one_of_oldest_k(timer, eligible, k, key, fdt):
    """Uniform choice among the k eligible cells with the smallest timer."""
    k = min(k, timer.shape[-1])
    tmax = torch.iinfo(timer.dtype).max
    idx, valid = stable_k_smallest(torch.where(eligible, timer, tmax), k, tmax)
    return choose_among_candidates(idx, valid, key, fdt)


def choose_k_members(eligible, k, key):
    """Per row, up to ``k`` distinct eligible members by Gumbel top-k: rank on
    (eligible, order bits, -index), in row chunks."""
    n_rows, n = eligible.shape
    k = min(k, n)
    dev = eligible.device
    rev_col = (_COL - 1) - torch.arange(n, dtype=torch.int64, device=dev)
    idx = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    valid = torch.empty((n_rows, k), dtype=torch.bool, device=dev)
    for r0, r1 in rng.row_chunks(n_rows, n):
        el = eligible[r0:r1]
        g = rng.gumbel_order_bits(key, (n_rows, n), dev, (r0, r1))
        v = torch.where(el, g + 1, 0)
        top = torch.topk(v * _COL + rev_col, k, dim=-1, largest=True, sorted=True).indices
        idx[r0:r1] = top.to(torch.int32)
        valid[r0:r1] = el.gather(-1, top)
    return idx, valid


def bernoulli_matrix(key, prob, shape, fdt):
    """Bernoulli draws of a 2-D ``shape`` with broadcastable probabilities."""
    prob = prob.expand(tuple(shape))
    out = torch.empty(tuple(shape), dtype=torch.bool, device=prob.device)
    for r0, r1 in rng.row_chunks(*shape):
        u = rng.bits_to_uniform(rng.random_bits(key, shape, prob.device, (r0, r1)), fdt)
        out[r0:r1] = u < prob[r0:r1]
    return out


def broadcast_reply_prob(num_known, fdt):
    """``max(1, 100 - n^2) / 100`` with ``n = len - 2``; ``n <= 0`` replies."""
    n_other = num_known.to(torch.int32) - 2
    n_clamped = n_other.clamp(max=10)
    pct = (100 - n_clamped * n_clamped).clamp(min=1).to(fdt) / 100.0
    return torch.where(n_other <= 0, torch.ones((), dtype=fdt, device=pct.device), pct)


def fp_count(state, identity):
    """Row fingerprints and membership counts: ``identity`` the ``[N, N]``
    views or the ``[N]`` record hashes."""
    member = state > 0
    n = state.shape[-1]
    if identity.shape == state.shape:
        pid = torch.arange(n, dtype=torch.int64, device=state.device)[None, :]
        h = peer_record_hash(pid, identity)
    else:
        h = identity[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return wrap_sum(torch.where(member, h, zero)), member.sum(dim=-1, dtype=torch.int32)


def suspicion_stats(state, timer, alive, thr: int):
    """Phase-A row statistics: count, the oldest timed-out WaitingForPing
    (``jstar``, -1 for none), has_timed, has_cand and an aged
    WaitingForIndirectPing on an alive row."""
    n = state.shape[-1]
    T = timer.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=state.device)
    count = (state > 0).sum(dim=-1, dtype=torch.int32)
    aged = alive[:, None] & (T <= thr)
    timed = aged & (state == WAITING_FOR_PING)
    t_min = torch.where(timed, T, torch.iinfo(torch.int32).max).amin(dim=-1)
    jstar = torch.where(timed & (T == t_min[:, None]), idx[None, :], n).amin(dim=-1)
    has_timed = timed.any(dim=-1)
    jstar = torch.where(has_timed, jstar, -1).to(torch.int32)
    has_cand = ((state == KNOWN) & (idx[None, :] != idx[:, None])).any(dim=-1)
    wfip = (aged & (state == WAITING_FOR_INDIRECT_PING)).any(dim=-1)
    return count, jstar, has_timed, has_cand, wfip


def oldest_k(state, timer, alive, k: int):
    """The k smallest ``(timer, j)`` per row over the cells Known, not the
    row's own, on an alive row and with a timer below its type's max."""
    n = state.shape[-1]
    T = timer.to(torch.int32)
    col = torch.arange(n, dtype=torch.int32, device=state.device)
    tmax = torch.iinfo(timer.dtype).max
    elig = alive[:, None] & (state == KNOWN) & (col[None, :] != col[:, None]) & (T != tmax)
    i32 = torch.iinfo(torch.int32)
    prev_t = torch.full((n,), i32.min, dtype=torch.int32, device=state.device)
    prev_i = torch.full((n,), -1, dtype=torch.int32, device=state.device)
    out_i, out_v = [], []
    for _ in range(k):
        after = (T > prev_t[:, None]) | ((T == prev_t[:, None]) & (col[None, :] > prev_i[:, None]))
        cand = elig & after
        t_r = torch.where(cand, T, i32.max).amin(dim=-1)
        i_r = torch.where(cand & (T == t_r[:, None]), col[None, :], n).amin(dim=-1)
        out_i.append(i_r.clamp(max=n - 1))
        out_v.append(t_r != i32.max)
        prev_t, prev_i = t_r, i_r
    return torch.stack(out_i, dim=-1).to(torch.int32), torch.stack(out_v, dim=-1)
