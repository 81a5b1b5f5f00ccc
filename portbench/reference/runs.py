"""Runs of the tick: fingerprint agreement and the loop to convergence."""

from __future__ import annotations

from portbench.reference.hashing import fingerprint_agreement, row_fingerprints
from portbench.reference.state import State, idle


def converged(st: State) -> bool:
    """Whether every alive peer holds the same membership fingerprint."""
    if st.id_view is not None:
        fp = row_fingerprints(st.state > 0, st.id_view)
    else:
        fp = row_fingerprints(st.state > 0, st.identity)
    return bool(fingerprint_agreement(st.alive, fp)[0])


def converge_loop(st: State, tick, max_ticks: int):
    """Tick with idle inputs until agreement (judged on entry and after each
    tick) or ``max_ticks``: ``(state, ticks_run, converged, metrics)``."""
    inp = idle(st.n, st.state.device)
    conv = converged(st)
    ticks, metrics = 0, []
    while not conv and ticks < max_ticks:
        st, m = tick(st, inp)
        metrics.append(m)
        ticks += 1
        conv = bool(m.converged)
    return st, ticks, conv, metrics
