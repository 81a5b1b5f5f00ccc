"""Bounded per-tick neighbor-block repair.

The port of ``kaboodle_tpu/sparseplane/repair.py``. Membership churn in a
blocked world is a block *edit* problem: gossip shares and ping sender-marks
produce at most ``C = gossip_fanout + 1`` insert candidates per row per
tick, and dead peers free slots when the suspicion pass expires them. This
pass folds the candidate list into the block with fixed shapes only --
candidate validation, the in-block membership test, intra-list dedup and
rank-matched placement into empty slots are ``[N, C, K]`` tensor ops.

Overflow policy: candidates beyond the free slots of a row are dropped.
SWIM re-offers membership continuously (every ack piggybacks a fresh
share), so a dropped insert is retried by the protocol within a few ticks.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.spec import KNOWN


def repair_blocks(
    nbr_idx: torch.Tensor,
    nbr_state: torch.Tensor,
    nbr_timer: torch.Tensor,
    cand: torch.Tensor,
    cand_stamp: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert up to ``C`` candidates per row into that row's empty slots.

    ``cand`` is int32 ``[N, C]`` (``-1`` = no candidate), ``cand_stamp`` the
    matching timer stamps in the block's timer dtype. Earlier columns win
    dedup ties -- callers order candidates by provenance priority. Returns
    the edited ``(idx, state, timer)`` as new tensors."""
    n, _ = nbr_idx.shape
    c = cand.shape[1]
    rows = torch.arange(n, dtype=torch.int32, device=nbr_idx.device)

    occ = nbr_state > 0
    valid = (cand >= 0) & (cand != rows[:, None])
    # Already in the block?  [N, C, K] membership test against occupied slots.
    in_block = ((cand[:, :, None] == nbr_idx[:, None, :]) & occ[:, None, :]).any(dim=-1)
    valid = valid & ~in_block

    # Intra-list dedup: a candidate loses to any identical valid candidate in
    # an earlier column (columns already deduped, as the JAX loop reads them).
    for j in range(1, c):
        dup = torch.zeros((n,), dtype=torch.bool, device=nbr_idx.device)
        for i in range(j):
            dup |= valid[:, i] & (cand[:, j] == cand[:, i])
        valid[:, j] &= ~dup

    # Rank-match placement: the r-th surviving candidate of a row fills the
    # r-th empty slot of that row; ranks are unique within a row, so at most
    # one candidate lands on a slot and the masked sums pick it out.
    cand_rank = valid.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1  # [N, C]
    empty = ~occ
    slot_rank = empty.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1  # [N, K]
    place = (valid[:, :, None] & empty[:, None, :]
             & (cand_rank[:, :, None] == slot_rank[:, None, :]))  # [N, C, K]

    filled = place.any(dim=1)  # [N, K]
    new_idx = torch.where(place, cand[:, :, None], 0).sum(dim=1, dtype=torch.int32)
    new_stamp = torch.where(place, cand_stamp[:, :, None].to(torch.int32), 0).sum(
        dim=1, dtype=torch.int32).to(nbr_timer.dtype)

    nbr_idx = torch.where(filled, new_idx, nbr_idx)
    nbr_state = torch.where(filled, torch.tensor(KNOWN, dtype=torch.int8,
                                                 device=nbr_state.device), nbr_state)
    nbr_timer = torch.where(filled, new_stamp, nbr_timer)
    return nbr_idx, nbr_state, nbr_timer


def reseed_revived(
    nbr_idx: torch.Tensor,
    nbr_state: torch.Tensor,
    nbr_timer: torch.Tensor,
    revived: torch.Tensor,
    boot_contacts: int,
    now_t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reset revived rows to fresh ring boot contacts.

    A blocked world has no broadcast domain, so revival re-enters through
    the gossip boot of init: clear the block, seed ``boot_contacts`` ring
    neighbors at ``now_t`` (a 0-d tensor in the timer dtype), and let ack
    piggybacking rebuild the view."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    b = min(boot_contacts, n - 1, k)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.arange(k, dtype=torch.int32, device=dev)
    boot_col = slots[None, :] < b  # [1, K]
    ring = (rows[:, None] + 1 + slots[None, :]) % n

    m = revived[:, None]
    i8 = torch.int8
    nbr_idx = torch.where(m, torch.where(boot_col, ring, -1), nbr_idx)
    nbr_state = torch.where(m, torch.where(boot_col, torch.tensor(KNOWN, dtype=i8, device=dev),
                                           torch.tensor(0, dtype=i8, device=dev)), nbr_state)
    nbr_timer = torch.where(m, torch.where(boot_col, now_t.to(nbr_timer.dtype),
                                           torch.zeros((), dtype=nbr_timer.dtype, device=dev)),
                            nbr_timer)
    return nbr_idx, nbr_state, nbr_timer
