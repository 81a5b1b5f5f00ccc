"""Event horizon and activity signature: how far ahead nothing protocol-relevant happens.

The port of ``kaboodle_tpu/warp/horizon.py``. A *warp span* is a run of
ticks a span program (``phasegraph/span.py``) may replay in one batched
pass instead of k dense ticks. Its horizon has two parts:

1. **Host-static events.** The scenario schedule is data known before the
   run: :func:`static_event_ticks` reduces a stacked ``TickInputs`` to a
   bool ``[T]`` "this tick carries an event" mask on the host, and
   :func:`next_static_event` scans it forward. An all-True ``drop_ok`` and
   an all-equal partition vector are not events (they gate nothing).
2. **State-borne activity**, read on the device. :func:`make_quiescence_fn`
   is the predicate under which the dense fault-free tick reduces to the
   strict span program; :func:`make_signature_fn` is the one-row activity
   signature ``[class_key, earliest_expiry, n_alive, tick]`` the runners
   fetch once per span to pick a program (strict, hybrid or dense) and a
   span length; :func:`make_expiry_fn` is the earliest waiting-cell
   deadline alone (``INT32_MAX`` when no timer is armed).

Every device function takes one mesh or an ensemble: under leaves with a
leading ``[E]`` axis each reduction runs per member and the result gains
that axis (``bool [E]``, ``int32 [E]``, ``int32 [E, 4]``), the JAX
package's ``vmap`` of the same function.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.ops.hashing import fingerprint_agreement, membership_fingerprint
from kaboodle_tpu_torch.parallel import collectives as C
from kaboodle_tpu_torch.phasegraph import build_graph, plan
from kaboodle_tpu_torch.phasegraph.exec import _take_vec
from kaboodle_tpu_torch.sim.state import MeshState, TickInputs
from kaboodle_tpu_torch.spec import KNOWN

_I32MAX = torch.iinfo(torch.int32).max


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def static_event_ticks(inputs: TickInputs, group=None) -> np.ndarray:
    """bool ``[T]``: tick carries a scheduled fault or manual event (host side).

    A tick is eventful iff its inputs can change delivery or state against
    the idle fault-free tick: a kill or revive, a partition vector that
    splits, a positive drop rate, an in-range manual ping, or a ``drop_ok``
    matrix that blocks an edge. One fetch of the schedule per run. With a
    row group the inputs are the rank's rows: the partition vectors are
    gathered whole and the mask is OR-reduced, equal on every rank."""
    part_t = C.gather_rows(inputs.partition, group)
    kill, revive = _np(inputs.kill), _np(inputs.revive)
    part, manual = _np(part_t), _np(inputs.manual_target)
    eventful = (
        kill.any(axis=-1)
        | revive.any(axis=-1)
        | (part != part[:, :1]).any(axis=-1)
        | (_np(inputs.drop_rate) > 0)
        | (manual >= 0).any(axis=-1)
    )
    if inputs.drop_ok is not None:
        eventful |= ~_np(inputs.drop_ok).all(axis=(-2, -1))
    if group is not None:
        flags = torch.as_tensor(eventful.astype(np.int32), device=inputs.kill.device)
        eventful = _np(C.reduce_max(flags, group)) > 0
    return eventful


def next_static_event(eventful: np.ndarray, t: int) -> int:
    """Index of the first eventful tick at or after ``t`` (``len`` if none)."""
    hits = np.nonzero(eventful[t:])[0]
    return int(t + hits[0]) if hits.size else int(eventful.shape[0])


def _any(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``x.any()`` per member: over every dim after the ``nb`` batch dims."""
    return x.flatten(nb).any(dim=-1)


def _row_fp(st: MeshState, member: torch.Tensor) -> torch.Tensor:
    return membership_fingerprint(
        member, st.id_view if st.id_view is not None else st.identity
    )


def _kpr_fires(st: MeshState, fp: torch.Tensor, n_row: torch.Tensor,
               alive=None) -> torch.Tensor:
    """Per row: last tick's KnownPeersRequest would match at its alive
    receiver (the dense tick's phase-0 anti-entropy candidate). ``fp``,
    ``n_row`` and ``alive`` (default the state's) are every peer's."""
    p = st.kpr_partner
    return (
        (p >= 0)
        & _take_vec(st.alive if alive is None else alive, p)
        & (st.kpr_fp != _take_vec(fp, p))
        & (_take_vec(n_row, p) <= st.kpr_n)
    )


def _waiting_expiry(st: MeshState, waiting: torch.Tensor, cfg: SwimConfig, nb: int):
    """(armed, earliest deadline) per member: ``min(timer) + ping_timeout``
    over the waiting cells, ``INT32_MAX`` where none is armed.

    The minimum is taken in the timer's dtype and widened once, so no
    int32 ``[N, N]`` copy of an int16 plane is made; it equals the JAX
    package's ``min(timer + timeout)`` for every timer below
    ``INT32_MAX - ping_timeout_ticks``."""
    armed = _any(waiting, nb)
    tmax = torch.iinfo(st.timer.dtype).max
    t_min = torch.where(waiting, st.timer, tmax).flatten(nb).amin(dim=-1)
    expiry = torch.where(armed, t_min.to(torch.int32) + cfg.ping_timeout_ticks, _I32MAX)
    return armed, expiry.to(torch.int32)


@functools.lru_cache(maxsize=None)
def make_quiescence_fn(cfg: SwimConfig):
    """``MeshState -> bool`` on the device: may the strict leap replay the next ticks?

    True iff ``n_alive >= 2``; no alive row holds a waiting cell; every
    alive row's membership is exactly the alive set; identity views (when
    tracked) hold the current words at every member cell; fingerprints
    agree over alive rows; no carried KnownPeersRequest can match at its
    receiver; and, with Join broadcasts on, no alive peer still owes its
    first Join. Each condition is what makes a dense-tick phase a no-op
    inside the span (the JAX docstring names them phase by phase)."""

    def quiescent(st: MeshState) -> torch.Tensor:
        S, alive = st.state, st.alive
        nb = S.dim() - 2
        idx = torch.arange(st.n, device=S.device, dtype=torch.int64)
        eye = idx[:, None] == idx[None, :]
        member = S > 0
        arow = alive[..., :, None]

        no_waiting = ~_any(arow & member & (S != KNOWN), nb)
        full_alive = ~_any(arow & (member != (alive[..., None, :] | eye)), nb)
        fp = _row_fp(st, member)
        conv, _, _, n_alive = fingerprint_agreement(alive, fp)
        q = no_waiting & full_alive & conv & (n_alive >= 2)
        if st.id_view is not None:
            q = q & ~_any(arow & member & (st.id_view != st.identity[..., None, :]), nb)
        n_row = member.sum(dim=-1, dtype=torch.int32)
        q = q & ~_kpr_fires(st, fp, n_row).any(dim=-1)
        if cfg.join_broadcast_enabled:
            q = q & ~(alive & st.never_broadcast).any(dim=-1)
        return q

    return quiescent


@functools.lru_cache(maxsize=None)
def make_expiry_fn(cfg: SwimConfig):
    """``MeshState -> int32`` on the device: the earliest waiting-cell deadline.

    ``min`` over alive rows' waiting cells of ``timer + ping_timeout_ticks``
    (the tick at which A2 would escalate or remove that entry),
    ``INT32_MAX`` when no timer is armed."""

    def expiry(st: MeshState) -> torch.Tensor:
        nb = st.state.dim() - 2
        waiting = st.alive[..., :, None] & (st.state > 0) & (st.state != KNOWN)
        return _waiting_expiry(st, waiting, cfg, nb)[1]

    return expiry


def earliest_timer_expiry(st: MeshState, cfg: SwimConfig) -> int:
    """Host convenience: the earliest tick at which phase A2 could fire
    (``INT32_MAX`` when no timer is armed). A hybrid span entered at tick t
    covers at most the ticks in ``[t, earliest_timer_expiry)``."""
    return int(make_expiry_fn(cfg)(st))


# ---------------------------------------------------------------------------
# The activity signature

# Signature term bits. The first two are the phase-op activity terms of the
# hybrid program (:func:`hybrid_pred_terms`);
# the rest are the state-borne sterility terms the hybrid program needs.
# ``make_signature_fn`` checks that the program's terms stay inside this
# vocabulary, so a new rare-phase term fails loudly instead of being leaped.
SIG_ANY_A2 = 1 << 0  # a suspicion timer has ALREADY matured (A2 fires now)
SIG_ANY_JOIN = 1 << 1  # a Join broadcast is owed (never_broadcast / lonely)
SIG_ARMED = 1 << 2  # waiting cells exist in alive rows (timers armed)
SIG_WAIT_ALIVE = 1 << 3  # some waiting cell targets an ALIVE peer (refutable)
SIG_KNOWN_DEAD = 1 << 4  # some alive row still Knows a dead peer (unacked ping)
SIG_MISSING = 1 << 5  # some alive row is missing an alive peer (AE inserts)
SIG_FP_DISAGREE = 1 << 6  # fingerprints disagree over alive rows (AE traffic)
SIG_IDENT_STALE = 1 << 7  # an identity view lags the sender's current word
SIG_KPR_LIVE = 1 << 8  # a carried KnownPeersRequest could fire (phase 0)
SIG_TOO_FEW = 1 << 9  # n_alive < 2

_OP_TERM_BITS = {"any_a2": SIG_ANY_A2, "any_join": SIG_ANY_JOIN}


def hybrid_pred_terms(cfg: SwimConfig) -> tuple[str, ...]:
    """The hybrid program's activity terms, in the planner's order:
    ``plan(build_graph(cfg, faulty=False), "hybrid").pred_terms``
    (``any_join`` exists only with Join broadcasts on)."""
    return plan(build_graph(cfg, faulty=False), "hybrid").pred_terms


# Bits any leap program (strict or hybrid) refuses; the hybrid program
# models armed-but-unexpired timers, disagreeing fingerprints and a live
# phase-0 ledger exactly, so those three stay leapable.
DENSE_BITS = (
    SIG_ANY_A2 | SIG_ANY_JOIN | SIG_WAIT_ALIVE | SIG_KNOWN_DEAD
    | SIG_MISSING | SIG_IDENT_STALE | SIG_TOO_FEW
)
HYBRID_BITS = SIG_ARMED | SIG_FP_DISAGREE | SIG_KPR_LIVE

_BUCKET_SHIFT = 16
_TERM_NAMES = {
    SIG_ANY_A2: "any_a2", SIG_ANY_JOIN: "any_join",
    SIG_ARMED: "armed", SIG_WAIT_ALIVE: "waiting_on_alive",
    SIG_KNOWN_DEAD: "known_dead", SIG_MISSING: "missing_alive",
    SIG_FP_DISAGREE: "fp_disagree", SIG_IDENT_STALE: "ident_stale",
    SIG_KPR_LIVE: "kpr_live", SIG_TOO_FEW: "too_few",
}


@dataclasses.dataclass(frozen=True)
class ActivityClass:
    """Host-side decode of one signature fetch (one int32[4] row per span).

    ``key`` is the memoization class: term bits | active-row-count bucket
    (powers of two). ``mode`` is the engine the class maps to: ``"leap"``
    (strictly quiescent: every bit clear), ``"hybrid"`` (only
    hybrid-modelable bits set) or ``"dense"``."""

    key: int
    expiry: int
    n_alive: int
    tick: int

    @property
    def bits(self) -> int:
        return self.key & ((1 << _BUCKET_SHIFT) - 1)

    @property
    def bucket(self) -> int:
        return self.key >> _BUCKET_SHIFT

    @property
    def mode(self) -> str:
        if self.bits & DENSE_BITS:
            return "dense"
        return "leap" if self.bits == 0 else "hybrid"

    def describe(self) -> dict:
        """JSON-able decode (ledger rows)."""
        return {
            "key": self.key,
            "mode": self.mode,
            "terms": [v for b, v in _TERM_NAMES.items() if self.bits & b],
            "active_row_bucket": self.bucket,
        }


def decode_signature(row) -> ActivityClass:
    """``int32[4]`` fetch row (a tensor, array or sequence) -> :class:`ActivityClass`."""
    k, e, a, t = (int(x) for x in _np(row).reshape(4))
    return ActivityClass(key=k, expiry=e, n_alive=a, tick=t)


@functools.lru_cache(maxsize=None)
def make_signature_fn(cfg: SwimConfig, group=None):
    """``MeshState -> int32[4]`` on the device: the activity signature.

    One reduction pass over (S, T) giving ``[class_key, earliest_expiry,
    n_alive, tick]``: everything the warp runner needs to pick a span
    program and length in one fetch. ``class_key`` packs the term bits
    with the active-row count bucketed to powers of two. All bits clear is
    exactly :func:`make_quiescence_fn`'s predicate.

    With a row group (``parallel/``) the state is the rank's rows: every
    term is reduced over the ranks (flags by MAX, the expiry by MIN, the
    counts by SUM), so every rank reads the same signature and leaps the
    same span."""
    unknown = set(hybrid_pred_terms(cfg)) - set(_OP_TERM_BITS)
    if unknown:
        raise NotImplementedError(
            f"hybrid plan declares signature terms {sorted(unknown)} the "
            "activity signature does not measure — extend horizon.py's "
            "vocabulary before leaping past them"
        )
    def signature(st: MeshState) -> torch.Tensor:
        S, alive = st.state, st.alive
        nb = S.dim() - 2
        dev = S.device
        row0, nr = C.row_range(st.n, group)
        idx = torch.arange(st.n, device=dev, dtype=torch.int64)
        eye = idx[row0:row0 + nr, None] == idx[None, :]
        member = S > 0
        ident_g, alive_g = C.gather_many([st.identity, alive], group, nb)
        arow, acol = alive[..., :, None], alive_g[..., None, :]

        waiting = arow & member & (S != KNOWN)
        armed, expiry = _waiting_expiry(st, waiting, cfg, nb)
        wait_alive = _any(waiting & acol, nb)
        known_dead = _any(arow & (S == KNOWN) & ~eye & ~acol, nb)
        missing = _any(arow & acol & ~member & ~eye, nb)
        fp = membership_fingerprint(member, st.id_view if st.id_view is not None else ident_g)
        conv, _, _, n_alive = C.fingerprint_agreement(alive, fp, group)
        if st.id_view is not None:
            ident_stale = _any(arow & member & (st.id_view != ident_g[..., None, :]), nb)
        else:
            ident_stale = torch.zeros_like(armed)
        n_row = member.sum(dim=-1, dtype=torch.int32)
        fp_g, n_row_g = C.gather_many([fp, n_row], group, nb)
        kpr_live = _kpr_fires(st, fp_g, n_row_g, alive_g).any(dim=-1)
        join_owed = torch.zeros_like(armed)
        if cfg.join_broadcast_enabled:
            # Conservative: a lonely row becomes rebroadcast-due at a
            # data-dependent tick, so loneliness itself forces dense.
            join_owed = (alive & st.never_broadcast).any(dim=-1) | (
                alive & (n_row <= 1)).any(dim=-1)
        cnt = waiting.any(dim=-1).sum(dim=-1, dtype=torch.int32)
        if group is not None:  # every rank's rows: one all-reduce a kind
            flags = torch.stack([armed, wait_alive, known_dead, missing, ident_stale,
                                 kpr_live, join_owed], dim=-1).to(torch.int32)
            armed, wait_alive, known_dead, missing, ident_stale, kpr_live, join_owed = (
                C.reduce_max(flags, group) > 0).unbind(-1)
            expiry = C.reduce_min(expiry, group)
            cnt = C.reduce_sum(cnt, group)
        any_a2 = armed & (expiry <= st.tick)

        bits = torch.zeros_like(expiry)
        for flag, b in (
            (any_a2, SIG_ANY_A2), (join_owed, SIG_ANY_JOIN), (armed, SIG_ARMED),
            (wait_alive, SIG_WAIT_ALIVE), (known_dead, SIG_KNOWN_DEAD),
            (missing, SIG_MISSING), (~conv, SIG_FP_DISAGREE),
            (ident_stale, SIG_IDENT_STALE), (kpr_live, SIG_KPR_LIVE),
            (n_alive < 2, SIG_TOO_FEW),
        ):
            bits = bits | torch.where(flag, b, 0).to(torch.int32)
        # Active-row count, bucketed to powers of two: bucket b covers
        # (2^(b-2), 2^(b-1)] rows, bucket 0 none. A cache key, not a
        # correctness input. The thresholds 0, 1, 2, 4, .., 2^30 are made
        # on the device (no host copy).
        pow2 = 1 << torch.arange(31, dtype=torch.int32, device=dev)
        bucket = ((cnt > 0).to(torch.int32)
                  + (cnt[..., None] > pow2).sum(dim=-1, dtype=torch.int32))
        key = bits | (bucket << _BUCKET_SHIFT)
        return torch.stack([key, expiry, n_alive.to(torch.int32), st.tick], dim=-1)

    return signature
