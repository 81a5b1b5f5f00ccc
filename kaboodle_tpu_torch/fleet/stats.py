"""On-device Monte Carlo statistics over the ensemble axis.

The port of ``kaboodle_tpu/fleet/stats.py``. Everything here is a
reduction over ``[E]`` (or ``[T, E]``) device tensors -- quantiles,
survival curves, trajectory envelopes, per-knob marginals -- so a sweep
hands the host a handful of numbers, never E per-member round trips. The
inputs are what the fleet runners return: ``conv_tick`` / ``converged``
``[E]`` from ``run_fleet_until_converged``, stacked ``TickMetrics``
(leaves ``[T, E]``) from ``simulate_fleet``, and the per-member knob vector
the sweep assigned.

Quantiles: linear interpolation over the sorted converged subset (NumPy's
default ``np.quantile`` method), in float32 on the device; NaN where no
member converged.
"""

from __future__ import annotations

import torch

from kaboodle_tpu_torch.sim.state import TickMetrics

_I32MAX = torch.iinfo(torch.int32).max


def _masked_quantiles(values: torch.Tensor, mask: torch.Tensor, qs: tuple) -> torch.Tensor:
    """Linear-interpolation quantiles of ``values[mask]``, float32 ``[..., len(qs)]``.

    ``mask`` may carry leading dims (one mask per row, each over the same
    ``[E]`` values). Sort with masked-out entries pushed to the end, then
    interpolate between the two order statistics bracketing ``q * (m - 1)``
    where m is the mask count. NaN when the mask is empty."""
    e = values.shape[-1]
    s = torch.sort(torch.where(mask, values, _I32MAX), dim=-1).values.to(torch.float32)
    m = mask.sum(dim=-1, dtype=torch.int32)[..., None]
    q = torch.tensor(qs, dtype=torch.float32, device=values.device)
    pos = q * (m - 1).clamp(min=0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo + 1, (m - 1).clamp(min=0))
    frac = pos - lo.to(torch.float32)
    lo = lo.clamp(0, e - 1).long()
    hi = hi.clamp(0, e - 1).long()
    v = s.gather(-1, lo) * (1.0 - frac) + s.gather(-1, hi) * frac
    return torch.where(m > 0, v, torch.full_like(v, float("nan")))


def convergence_quantiles(
    conv_tick: torch.Tensor,
    converged: torch.Tensor,
    qs: tuple = (0.5, 0.9, 0.99),
) -> torch.Tensor:
    """Quantiles of the convergence-tick distribution over converged members:
    float32 ``[len(qs)]``, NaN where nothing converged."""
    return _masked_quantiles(conv_tick, converged, tuple(qs))


def survival_curve(
    conv_tick: torch.Tensor,
    converged: torch.Tensor,
    max_ticks: int,
) -> torch.Tensor:
    """Fraction of members still unconverged after each tick.

    float32 ``[max_ticks + 1]``: entry t is P(member unconverged after t
    ticks), stepping down toward the never-converged fraction."""
    e = conv_tick.shape[0]
    t = torch.arange(max_ticks + 1, dtype=torch.int32, device=conv_tick.device)
    unconv = ~converged[None, :] | (conv_tick[None, :] > t[:, None])
    return unconv.sum(dim=-1, dtype=torch.float32) / float(e)


def agree_fraction_trajectory(metrics: TickMetrics) -> dict:
    """Ensemble envelope of the agree-fraction trajectory.

    From stacked fleet metrics (leaves ``[T, E]``): the per-tick mean, min
    and max over members of ``agree_fraction``, and the per-tick converged
    member fraction -- each float32 ``[T]``."""
    af = metrics.agree_fraction
    e = af.shape[-1]
    return {
        "mean": af.mean(dim=-1),
        "min": af.amin(dim=-1),
        "max": af.amax(dim=-1),
        "converged_fraction": metrics.converged.sum(dim=-1, dtype=torch.float32) / float(e),
    }


def knob_marginals(
    knob: torch.Tensor,
    values: torch.Tensor,
    conv_tick: torch.Tensor,
    converged: torch.Tensor,
) -> dict:
    """Per-knob-value marginals of the convergence outcome.

    ``knob`` float32 ``[E]`` is each member's knob setting, ``values``
    float32 ``[B]`` the sweep grid (members sit on grid points exactly, so
    membership is an equality test). Returns per-bin vectors ``[B]``:
    member count, converged fraction, and mean convergence tick over the
    bin's converged members (NaN where none converged)."""
    onehot = knob[:, None] == values[None, :]  # [E, B]
    members = onehot.sum(dim=0, dtype=torch.int32)
    conv_hot = onehot & converged[:, None]
    conv_count = conv_hot.sum(dim=0, dtype=torch.int32)
    tick_sum = torch.where(conv_hot, conv_tick[:, None], 0).to(torch.float32).sum(dim=0)
    mean_tick = torch.where(
        conv_count > 0,
        tick_sum / conv_count.clamp(min=1).to(torch.float32),
        torch.full_like(tick_sum, float("nan")),
    )
    frac = conv_count.to(torch.float32) / members.clamp(min=1).to(torch.float32)
    return {"members": members, "converged_fraction": frac, "mean_conv_tick": mean_tick}


def knob_quantiles(
    knob: torch.Tensor,
    values: torch.Tensor,
    conv_tick: torch.Tensor,
    converged: torch.Tensor,
    qs: tuple = (0.5, 0.9, 0.99),
) -> torch.Tensor:
    """Convergence-tick quantiles per knob value: float32 ``[B, len(qs)]``,
    one masked quantile row per grid point (one batched sort)."""
    masks = converged[None, :] & (knob[None, :] == values[:, None])  # [B, E]
    return _masked_quantiles(conv_tick, masks, tuple(qs))
