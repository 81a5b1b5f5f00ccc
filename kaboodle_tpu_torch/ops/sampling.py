"""Masked random-selection primitives of the tick, bit-exact with the JAX package.

The reference makes three kinds of random draws per tick (ChaChaRng,
kaboodle.rs:164): the ping target among the 5 longest-unheard Known peers
(kaboodle.rs:661-675), ``choose_multiple`` of 3 proxies (kaboodle.rs:
595-597), and the broadcast-reply Bernoulli (kaboodle.rs:344-353). Every
draw here takes the same threefry key as its JAX counterpart and gives the
same picks.

``torch.topk`` promises no order among equal values, so every top-k here
ranks on a composite int64 key that is unique per cell: the value first,
then the column index, in the order ``lax.top_k`` (stable) gives.

Every function takes a leading ensemble axis too (``[E, N, N]`` masks,
``[E, N]`` rows) with a key of ``[E]`` words: member e gets the draw its
own key gives a single mesh, as the JAX package's ``vmap`` does.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.ops import threefry

_COL = 1 << 32


def _stable_k_smallest_topk(scores: torch.Tensor, k: int, tmax: int):
    """(idx, valid) of the k smallest scores per row, ties toward the lower index."""
    n = scores.shape[-1]
    col = torch.arange(n, dtype=torch.int64, device=scores.device)
    comp = scores.to(torch.int64) * _COL + col
    idx = torch.topk(comp, k, dim=-1, largest=False, sorted=True).indices
    return idx.to(torch.int32), scores.gather(-1, idx) != tmax


def _stable_k_smallest_iter(scores: torch.Tensor, k: int, tmax: int):
    """(idx, valid) of the k smallest scores per row, ties toward the lower index.

    k rounds of lexicographic min-reduction over (score, index): round r
    takes the min over entries strictly after round r-1's pick."""
    n = scores.shape[-1]
    idxr = torch.arange(n, dtype=torch.int32, device=scores.device)[None, :]
    prev_s = torch.full(scores.shape[:-1], torch.iinfo(scores.dtype).min,
                        dtype=scores.dtype, device=scores.device)
    prev_i = torch.full(scores.shape[:-1], -1, dtype=torch.int32, device=scores.device)
    out_i, out_v = [], []
    for _ in range(k):
        after_prev = (scores > prev_s[..., None]) | (
            (scores == prev_s[..., None]) & (idxr > prev_i[..., None])
        )
        s_r = torch.where(after_prev, scores, tmax).amin(dim=-1)
        i_r = torch.where(after_prev & (scores == s_r[..., None]), idxr, n).amin(dim=-1)
        out_i.append(i_r)
        out_v.append(s_r != tmax)
        prev_s, prev_i = s_r, i_r
    idx = torch.stack(out_i, dim=-1).clamp(max=n - 1)
    return idx, torch.stack(out_v, dim=-1)


def choose_one_of_oldest_k(
    timer: torch.Tensor,
    eligible: torch.Tensor,
    k: int,
    key: threefry.Key,
    deterministic: bool = False,
    method: str = "iter",
    row0: int = 0,
) -> torch.Tensor:
    """Per row: uniform choice among the k eligible entries with the smallest
    timer (ties toward the lower index). int32 ``[..., N]``, -1 where none.

    The ineligibility sentinel is the timer dtype's max (int16 in lean mode).
    ``row0`` is the first row's index in the whole draw (a rank's rows)."""
    n = timer.shape[-1]
    k = min(k, n)
    tmax = torch.iinfo(timer.dtype).max
    scores = torch.where(eligible, timer, tmax)
    if deterministic and method == "iter":
        idx, valid = _stable_k_smallest_iter(scores, 1, tmax)
        return torch.where(valid[..., 0], idx[..., 0], -1).to(torch.int32)
    pick = _stable_k_smallest_iter if method == "iter" else _stable_k_smallest_topk
    idx, valid = pick(scores, k, tmax)
    return choose_among_candidates(idx, valid, key, deterministic, row0)


def choose_among_candidates(
    idx: torch.Tensor,
    valid: torch.Tensor,
    key: threefry.Key,
    deterministic: bool = False,
    row0: int = 0,
) -> torch.Tensor:
    """Uniform pick per row from ``(idx, valid)`` candidate lists ``[..., N, k]``;
    the rows are rows ``row0 ..`` of the draw."""
    if deterministic:
        return pick_candidate(idx, valid, None)
    u = threefry.uniform(key, (idx.shape[-2],), idx.device, row0)
    return pick_candidate(idx, valid, u)


def pick_candidate(idx: torch.Tensor, valid: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
    """The draw-free core of :func:`choose_among_candidates`: ``floor(u * count)``
    in float32, or the first candidate when ``u`` is None."""
    count = valid.sum(dim=-1, dtype=torch.int32)
    if u is None:
        choice = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=idx.device)
    else:
        choice = torch.floor(u * count.to(torch.float32)).to(torch.int64)
        choice = torch.minimum(choice, (count - 1).clamp(min=0).to(torch.int64))
    chosen = idx.gather(-1, choice[..., None])[..., 0]
    return torch.where(count > 0, chosen, -1).to(torch.int32)


def choose_k_members(
    eligible: torch.Tensor,
    k: int,
    key: threefry.Key,
    deterministic: bool = False,
    row0: int = 0,
):
    """Per row: up to ``k`` distinct members of the mask, uniformly at random
    (Gumbel-top-k, the reference's ``choose_multiple``). Deterministic mode
    takes the lowest indices. Returns ``(idx int32 [..., N, k], valid bool
    [..., N, k])``; a leading ensemble axis of ``eligible`` goes with ``[E]``
    key words. The rows are rows ``row0 ..`` of the dense draw.

    Ranks on ``(eligible, Gumbel order bits, -index)``, computed in chunks
    (``threefry.draw_chunks``) so no ``[N, N]`` int64 key is ever whole."""
    *batch, n_rows, n = eligible.shape
    k = min(k, n)
    dev = eligible.device
    rev_col = (_COL - 1) - torch.arange(n, dtype=torch.int64, device=dev)
    idx = torch.empty((*batch, n_rows, k), dtype=torch.int32, device=dev)
    valid = torch.empty((*batch, n_rows, k), dtype=torch.bool, device=dev)
    if deterministic:  # no draw: chunk by the mask's own shape
        key = (torch.zeros(batch, dtype=torch.int64, device=dev),) * 2 if batch else (0, 0)
    for part, at, rows in threefry.draw_chunks(key, n_rows, n, row0):
        el = eligible[at]
        if deterministic:
            v = el.to(torch.int64)
        else:
            g = threefry.gumbel_order_bits(part, (n_rows, n), dev, rows)
            v = torch.where(el, g + 1, 0)
        top = torch.topk(v * _COL + rev_col, k, dim=-1, largest=True, sorted=True).indices
        idx[at] = top.to(torch.int32)
        valid[at] = el.gather(-1, top)
    return idx, valid


def bernoulli_matrix(
    key: threefry.Key,
    prob: torch.Tensor,
    shape: tuple[int, ...],
    deterministic: bool = False,
    row0: int = 0,
) -> torch.Tensor:
    """Bernoulli draws with per-element (broadcastable) float32 probabilities.

    ``shape`` is one mesh's draw; under ``[E]`` key words the result is
    ``[E, *shape]``. Deterministic mode: every draw with positive
    probability succeeds. ``row0`` places ``shape``'s rows at rows
    ``row0 ..`` of the dense draw (a rank's rows)."""
    full = threefry.batch_shape(key) + tuple(shape)
    if deterministic:
        return (prob > 0).expand(full)
    prob = prob.expand(full)
    if len(shape) == 1:
        return threefry.uniform(key, shape, prob.device, row0) < prob
    out = torch.empty(full, dtype=torch.bool, device=prob.device)
    for part, at, rows in threefry.draw_chunks(key, *shape, row0=row0):
        u = threefry.bits_to_uniform(threefry.random_bits(part, shape, prob.device, rows))
        out[at] = u < prob[at]
    return out


def broadcast_reply_prob(num_known: torch.Tensor) -> torch.Tensor:
    """The reply-dampening curve ``max(1, 100 - n^2)/100`` with ``n = len - 2``
    (kaboodle.rs:344-353), float32; ``n <= 0`` replies for certain."""
    n_other = num_known.to(torch.int32) - 2
    n_clamped = n_other.clamp(max=10)
    pct = (100 - n_clamped * n_clamped).clamp(min=1).to(torch.float32) / 100.0
    return torch.where(n_other <= 0, 1.0, pct)
