"""The phase-op vocabulary: every SWIM tick phase as declarative metadata.

One :class:`PhaseOp` per protocol phase (the lockstep round letters of
sim/kernel.py's docstring), declaring

- the persistent state **fields** it reads and writes (``MeshState`` plane
  names — the planner validates fusion legality against these),
- the tick-local values it **gives** and **takes** (the dataflow between
  ops inside one tick — the planner validates produce-before-consume),
- its **activity** mask: the traced predicate under which the op does real
  work. Ops whose activity is guaranteed False by the fused-dispatch
  predicate are *pruned* from the fused program; the predicate itself is
  derived from the pruned ops' ``pred_term`` declarations (plan.py).
- ``mask_rank``: 1 if every write mask the op applies is derivable from
  O(N) vectors (one-hot outer compares — foldable into a composed where
  chain), 2 if it needs an [N, N] intermediate (matmuls, scatters on both
  dims) and therefore can never fold,
- its **span** fate inside a warp quiescent span: ``live`` (still runs),
  ``degenerate`` (collapses to the timer-restamp / latency-decay /
  ledger-fixed-point form the leap batches), or ``invariant`` (provably a
  no-op — horizon.py's quiescence predicate is exactly the conjunction of
  these invariance conditions),
- its **hybrid** fate inside a *near*-quiescent span (Warp 2.0): ``live``
  (runs as in the strict span), ``sterile`` (runs in a membership-moving-
  free closed form — anti-entropy traffic whose marks refresh timers and
  rewrite the ledger but provably insert nothing), or ``invariant``
  (excluded by the activity signature — ``sig_term`` names the signature
  bit whose truth would make the op active, so warp/horizon.py's
  signature vocabulary is derived from the ops, not hand-listed twice).

The port of ``kaboodle_tpu/phasegraph/ops.py``, the same table op for op
and field for field (pinned by tests/test_torch_phasegraph.py). This module
is pure metadata -- it imports no torch -- so the planner runs at import
cost. The executable bodies live in exec.py (dense/fused), blocked.py
(chunked), span.py (leap) and sparseplane/kernel.py (sparse), keyed by op
name; each engine checks its planned program against the bodies it has at
build time.
"""

from __future__ import annotations

import dataclasses

# Persistent MeshState planes (state fields ops may read/write). "S"/"T"
# are the [N, N] membership-state and timer matrices; the rest are O(N).
FIELDS = (
    "S", "T", "lat", "idv", "alive", "identity", "never_b", "last_b",
    "kpr_partner", "kpr_fp", "kpr_n", "tick", "key",
)

# TickInputs planes (per-tick scenario inputs).
INPUTS = ("kill", "revive", "partition", "drop_rate", "drop_ok", "manual_target")

# Plane layouts. "dense" is the [N, N] formulation every engine ran since
# the seed; "blocked_topk" stores each row's membership view in a [N, K]
# top-K-neighbor block (K a pow2 knob) with counter-based threefry draws
# replacing every materialized [N, N] uniform — the million-peer format
# (sparseplane/).
LAYOUTS = ("dense", "blocked_topk")

# Which layouts each persistent plane supports, and what the dense plane
# decomposes into under blocked_topk. Planes listed dense-only name the
# subsystems a blocked world compiles out: the join plane needs a broadcast
# domain, latency/id-view tracking and the KPR ledger are [N, N]-shaped
# diagnostics whose blocked analogue is the ack-piggyback gossip share.
PLANE_LAYOUTS = {
    "S": ("dense", "blocked_topk"),
    "T": ("dense", "blocked_topk"),
    "lat": ("dense",),
    "idv": ("dense",),
    "alive": ("dense", "blocked_topk"),
    "identity": ("dense", "blocked_topk"),
    "never_b": ("dense",),
    "last_b": ("dense",),
    "kpr_partner": ("dense",),
    "kpr_fp": ("dense",),
    "kpr_n": ("dense",),
    "tick": ("dense", "blocked_topk"),
    "key": ("dense", "blocked_topk"),
}

# The blocked twins each dense plane decomposes into (SparseState fields):
# S -> (neighbor-index, per-slot state code), T -> per-slot timer, and the
# carried threefry key -> the checkpointable (seed, cursor) counter pair.
BLOCKED_PLANES = {
    "S": ("nbr_idx", "nbr_state"),
    "T": ("nbr_timer",),
    "key": ("seed", "cursor"),
}

# PhaseOp.sparse vocabulary: the op's fate in a blocked_topk build.
SPARSE_FATES = ("row", "block", "absent")

# The LEGACY dense 5-way key layout: what each row of the per-tick
# ``split(key, 5)`` fed before Warp 3.0 re-keyed the dense draws onto
# per-(key, tick, stream) counter keys (phasegraph/rng.py — the
# ``rng_streams`` op below). The row names survive as the draw-site
# vocabulary: keyscope (analysis/rng/) names sinks by these rows (via
# the split index of any remaining chain-coupled sink, or the
# STREAM_TICK_* id of a migrated one), and the warp ledger's why-dense
# terms join through them. Reordering or appending here is a
# provenance-visible event, never a silent desync.
KEY_LAYOUT = ("proxy", "ping", "bern", "drop", "next")
KEY_PROXY, KEY_PING, KEY_BERN, KEY_DROP, KEY_NEXT = range(len(KEY_LAYOUT))


def split_tick_keys(key):
    """LEGACY one-tick key fork: ``split(key, 5)`` rows in KEY_LAYOUT order.

    Returns ``(key_proxy, key_ping, key_bern, key_drop, key_next)``, each a
    threefry word pair (``ops/threefry.py``), bit for bit the rows of
    ``jax.random.split(key, 5)``. No engine consumes this chain anymore
    (exec/blocked/span derive counter keys via ``rng.tick_draw_keys``); it
    remains the executable definition of the pre-counter scheme the draw-site
    names refer to. torch is imported locally -- this module stays
    importable as pure metadata."""
    from kaboodle_tpu_torch.ops import threefry

    return threefry.split(key, len(KEY_LAYOUT))


@dataclasses.dataclass(frozen=True)
class PhaseOp:
    """One composable tick phase (see module docstring for the vocabulary).

    ``stage`` splits the tick at the dispatch boundary: ``prologue`` ops run
    unconditionally before the fused/full branch select (churn, the delivery
    gate, the phase-A stats the predicate itself needs); ``tail`` ops are
    what the dispatch chooses between. ``cut`` is the stage-probe label
    (`make_tick_fn(_cut=...)`) that truncates the full program right after
    this op.
    """

    name: str
    phase: str  # lockstep round letter: "A", "B", "1".."4", "G", or "-"
    doc: str
    stage: str  # "prologue" | "tail"
    reads: frozenset = frozenset()
    writes: frozenset = frozenset()
    inputs: frozenset = frozenset()  # TickInputs planes consumed
    gives: frozenset = frozenset()  # tick-locals produced
    takes: frozenset = frozenset()  # tick-locals consumed
    activity: str = "always"  # human description of the traced gate
    pred_term: str | None = None  # dispatch-pred symbol that excludes it
    mask_rank: int = 1
    span: str = "invariant"  # "live" | "degenerate" | "invariant"
    hybrid: str = "invariant"  # "live" | "sterile" | "invariant"
    sig_term: str | None = None  # activity-signature bit that excludes it
    cut: str | None = None
    # The op's fate under the blocked_topk layout: "row" (O(N) logic
    # unchanged), "block" (re-expressed as segment gather/scatter over the
    # [N, K] blocks), or "absent" (dense-only — the sparse planner prunes
    # it with a reason).
    sparse: str = "absent"

    def __post_init__(self) -> None:
        if self.stage not in ("prologue", "tail"):
            raise ValueError(f"{self.name}: bad stage {self.stage!r}")
        if self.sparse not in SPARSE_FATES:
            raise ValueError(f"{self.name}: bad sparse fate {self.sparse!r}")
        if self.span not in ("live", "degenerate", "invariant"):
            raise ValueError(f"{self.name}: bad span fate {self.span!r}")
        if self.hybrid not in ("live", "sterile", "invariant"):
            raise ValueError(f"{self.name}: bad hybrid fate {self.hybrid!r}")
        if self.mask_rank not in (1, 2):
            raise ValueError(f"{self.name}: bad mask_rank {self.mask_rank!r}")
        unknown = (self.reads | self.writes) - set(FIELDS)
        if unknown:
            raise ValueError(f"{self.name}: unknown state fields {sorted(unknown)}")
        unknown = self.inputs - set(INPUTS)
        if unknown:
            raise ValueError(f"{self.name}: unknown inputs {sorted(unknown)}")


def _op(name, phase, doc, stage, *, reads=(), writes=(), inputs=(), gives=(),
        takes=(), activity="always", pred_term=None, mask_rank=1,
        span="invariant", hybrid=None, sig_term=None, cut=None,
        sparse="absent") -> PhaseOp:
    if hybrid is None:
        # Default: whatever still runs in a strict span also runs in the
        # hybrid one; strict-invariant ops stay excluded unless declared.
        hybrid = "live" if span in ("live", "degenerate") else "invariant"
    return PhaseOp(
        name=name, phase=phase, doc=doc, stage=stage,
        reads=frozenset(reads), writes=frozenset(writes),
        inputs=frozenset(inputs), gives=frozenset(gives),
        takes=frozenset(takes), activity=activity, pred_term=pred_term,
        mask_rank=mask_rank, span=span, hybrid=hybrid, sig_term=sig_term,
        cut=cut, sparse=sparse,
    )


def op_table(
    cfg, faulty: bool = True, telemetry: bool = False, layout: str = "dense"
) -> tuple[PhaseOp, ...]:
    """The tick's op graph for one static build, in execution order.

    Static config flags decide op *presence* (a disabled op is absent from
    the graph, exactly as its code is compiled out of the build): ``faulty``
    gates churn and the [N, N] delivery-gate matrix,
    ``cfg.join_broadcast_enabled`` gates the whole join plane,
    ``cfg.faithful_failed_broadcast`` gates the intended-semantics Failed
    delivery, ``telemetry`` gates the counter reductions.

    ``layout`` selects the plane format.  A ``blocked_topk`` build keeps the
    same op vocabulary (fates per op in each ``sparse=`` declaration), adds
    the ``block_repair`` tail op (the bounded per-tick neighbor-block edit
    pass), and rejects configs needing dense-only planes: the join
    broadcast has no domain in a blocked world, the intended-semantics
    failed broadcast and non-faithful indirect-ack attribution are [N, N]
    re-expressions no blocked kernel implements, and the telemetry counter
    plane is dense-only today.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (expected one of {LAYOUTS})")
    if layout == "blocked_topk":
        if cfg.join_broadcast_enabled:
            raise ValueError(
                "blocked_topk: no broadcast domain — build the config with "
                "join_broadcast_enabled=False (ring-contact gossip boot "
                "replaces the join broadcast)"
            )
        if not cfg.faithful_failed_broadcast:
            raise ValueError(
                "blocked_topk requires faithful_failed_broadcast=True: the "
                "intended-semantics Failed replay is an [N, N, N] dense op"
            )
        if not cfg.faithful_indirect_ack:
            raise ValueError(
                "blocked_topk requires faithful_indirect_ack=True: only the "
                "faithful proxy-attribution (quirk Q11) has a blocked twin"
            )
        if telemetry:
            raise ValueError(
                "blocked_topk has no telemetry counter plane yet — build "
                "with telemetry=False"
            )
    ops: list[PhaseOp] = [
        _op(
            "rng_streams", "-",
            "Counter-keyed PRNG rows: fold (key, tick, STREAM_TICK_*) -> "
            "(proxy, ping, bern, drop) draw keys (phasegraph/rng.py); the "
            "carried key plane is constant — every draw is a pure function "
            "of checkpointable state, so spans leap without consuming a "
            "chain.",
            "prologue", reads=("key", "tick"), gives=("keys",),
            span="live", sparse="row",
        ),
    ]
    if faulty:
        ops.append(_op(
            "churn", "-",
            "Silent kill (Q8) + revive-with-reset: aliveness flips, revived "
            "rows reset to the singleton {self} map.",
            "prologue",
            reads=("alive", "S", "T", "lat", "idv", "identity", "never_b", "tick"),
            writes=("alive", "S", "T", "lat", "idv", "never_b"),
            inputs=("kill", "revive"), gives=("rv",),
            activity="any kill/revive scheduled this tick", sparse="row",
        ))
    ops.append(_op(
        "delivery_gate", "-",
        "ok[s, d]: sender+receiver alive, same partition group, not dropped "
        "(faulty builds materialize the matrix, the drop draw gated on "
        "drop_rate > 0; fault-free builds factor it as alive[s] & alive[d] "
        "so no [N, N] gate exists).",
        "prologue", reads=("alive",),
        inputs=("partition", "drop_rate", "drop_ok") if faulty else (),
        takes=("keys",), gives=("ok",),
        mask_rank=2 if faulty else 1,
    ))
    ops.append(_op(
        "row_stats", "A",
        "Phase-A row statistics on the pre-tick snapshot: membership count, "
        "timed-out-suspect existence, WFIP-timeout existence — one fused "
        "read of (S, T); also the raw material of the dispatch predicate.",
        "prologue", reads=("S", "T", "alive", "tick"),
        gives=("row_count0", "has_timed", "wfip_any", "any_a2"),
        span="invariant", sparse="block",
    ))
    if cfg.join_broadcast_enabled:
        ops.append(_op(
            "join_gate", "A1",
            "maybe_broadcast_join: first call always; afterwards only while "
            "lonely and rebroadcast-interval old.",
            "prologue",
            reads=("alive", "never_b", "last_b", "tick"),
            writes=("never_b", "last_b"),
            takes=("row_count0",), gives=("join_b", "any_join"),
            activity="a Join broadcast fires this tick", sig_term="any_join",
        ))
    ops.append(_op(
        "manual_targets", "A4",
        "Manual pings (ping_addrs): self/out-of-range targets dropped at "
        "the transport (D8).",
        "prologue", reads=("alive",), inputs=("manual_target",),
        gives=("man_tgt",),
        activity="a manual ping is scheduled",
    ))

    # ---- tail: what the fused/full dispatch chooses between ---------------
    ops.append(_op(
        "suspicion", "A2",
        "handle_suspected_peers on the pre-tick snapshot: WFIP timeouts and "
        "no-proxy timeouts remove, the oldest timed-out WaitingForPing "
        "escalates to k indirect-ping proxies.",
        "tail", reads=("S", "T", "alive"), writes=("S", "T", "lat"),
        takes=("keys", "has_timed", "wfip_any"),
        gives=("escalate", "insta_remove", "jstar", "proxies", "any_rem"),
        activity="any_a2: a timed-out suspicion exists", pred_term="any_a2",
        mask_rank=2, span="invariant", sig_term="any_a2", sparse="block",
    ))
    ops.append(_op(
        "probe_draw", "A3",
        "ping_random_peer: uniform among the 5 longest-unheard Known peers; "
        "the target cell arms WaitingForPing(now).",
        "tail", reads=("S", "T", "alive"), writes=("S", "T"),
        takes=("keys",), gives=("ping_tgt", "has_ping"),
        span="live", cut="A", sparse="block",
    ))
    if cfg.join_broadcast_enabled:
        ops.append(_op(
            "join_insert", "B",
            "Join broadcast delivery: every receiver inserts the joiner as "
            "Known(now) with the broadcast identity.",
            "tail", reads=("S", "T", "idv", "identity"),
            writes=("S", "T", "idv"),
            takes=("join_b", "any_join", "ok"), gives=("Jm", "is_new_ro"),
            activity="any_join", pred_term="any_join", mask_rank=2,
            span="invariant", sig_term="any_join",
        ))
    if not cfg.faithful_failed_broadcast:
        ops.append(_op(
            "failed_delivery", "B",
            "Intended-semantics Failed(j) broadcast delivery (Q3 off): "
            "removal wins against lower-origin Joins — O(N^3) matmuls, "
            "gated on a removal existing.",
            "tail", reads=("S", "lat"), writes=("S", "lat"),
            takes=("ok", "any_rem") + (("Jm",) if cfg.join_broadcast_enabled else ()),
            activity="any_rem: a removal happened this tick",
            pred_term="any_a2", mask_rank=2, span="invariant",
            sig_term="any_a2",
        ))
    if cfg.join_broadcast_enabled:
        ops.append(_op(
            "join_replies", "B",
            "Join responses (Bernoulli over the sequentially-growing map) "
            "and the O(N^3) gossip-share union at each joiner — gated on a "
            "reply actually existing.",
            "tail", reads=("S", "T"),
            takes=("keys", "ok", "Jm", "is_new_ro", "row_count0", "any_join"),
            gives=("reply_del", "gossip", "join_records"),
            activity="any_join", pred_term="any_join", mask_rank=2,
            span="invariant", sig_term="any_join",
        ))
    ops.append(_op(
        "call1", "1",
        "Delivery call 1: direct Pings, manual Pings, PingRequests land; "
        "Q1 sender-marks apply with exact (fp, count) deltas.",
        "tail", reads=("S", "T", "lat", "idv", "identity", "alive"),
        writes=("S", "T", "lat", "idv"),
        takes=("ping_tgt", "has_ping", "man_tgt", "ok", "proxies",
               "escalate", "jstar"),
        gives=("mark1", "ok_ping", "ok_man", "del_ack", "del_ack_man",
               "del_pr", "del_pping", "fp1", "n1"),
        span="degenerate", cut="c1", sparse="block",
    ))
    ops.append(_op(
        "call2", "2",
        "Delivery call 2: direct/manual Acks, proxy Pings, join responses "
        "land; gossip-learned peers insert back-dated (Q6).",
        "tail", reads=("S", "T", "lat", "idv", "identity", "alive"),
        writes=("S", "T", "lat", "idv"),
        takes=("ping_tgt", "man_tgt", "del_ack", "del_ack_man", "del_pping",
               "proxies", "escalate", "jstar", "ok")
        + (("reply_del", "gossip", "any_join") if cfg.join_broadcast_enabled else ()),
        gives=("fp2", "n2", "dfp2", "dn2"),
        span="degenerate", cut="c2", sparse="block",
    ))
    ops.append(_op(
        "calls34", "34",
        "Delivery calls 3+4: the suspect's Acks at proxies, coincidence and "
        "regular forwarded Acks at suspectors — every datagram descends "
        "from an escalation this tick.",
        "tail", reads=("S", "T", "lat", "idv", "identity", "alive"),
        writes=("S", "T", "lat", "idv"),
        takes=("escalate", "jstar", "proxies", "del_pr", "del_pping",
               "del_ack", "del_ack_man", "ping_tgt", "man_tgt", "ok"),
        gives=("del_pack", "fwd", "fwd_c", "del_fwd", "del_fwd_c"),
        activity="any escalation this tick", pred_term="any_a2",
        mask_rank=2, span="invariant", sig_term="any_a2", cut="c34",
        sparse="block",
    ))
    ops.append(_op(
        "anti_entropy", "G",
        "take_sync_request: arrival-order candidate priority over phases "
        "0-3, one KnownPeersRequest per peer, request + filtered reply "
        "resolve within the tick; [N, N] work gated on a request delivering.",
        "tail",
        reads=("S", "T", "lat", "idv", "identity", "alive",
               "kpr_partner", "kpr_fp", "kpr_n"),
        writes=("S", "T", "lat", "idv", "kpr_partner", "kpr_fp", "kpr_n"),
        takes=("fp1", "n1", "dfp2", "dn2", "fp2", "n2", "del_ack",
               "del_ack_man", "ping_tgt", "man_tgt", "ok", "rv")
        if faulty else
        ("fp1", "n1", "dfp2", "dn2", "fp2", "n2", "del_ack", "del_ack_man",
         "ping_tgt", "man_tgt", "ok"),
        gives=("partner", "del_kpr", "del_rep", "fp_g", "n_g", "fp_f",
               "n_f", "ae_records"),
        activity="fingerprints disagree somewhere", span="degenerate",
        hybrid="sterile", cut="G", sparse="block",
    ))
    if telemetry:
        ops.append(_op(
            "counters", "-",
            "ProtocolCounters: pure reductions over masks the tick already "
            "computed (pings/acks/ping-reqs sent, suspicions, deaths, joins, "
            "gossip bytes, armed timers) — state trajectory unchanged.",
            "tail",
            reads=("S", "alive"),
            takes=("has_ping", "man_tgt", "ok_ping", "ok_man", "del_pr",
                   "del_pping", "escalate", "insta_remove", "ae_records",
                   "join_records", "wfip_any")
            if cfg.join_broadcast_enabled else
            ("has_ping", "man_tgt", "ok_ping", "ok_man", "del_pr",
             "del_pping", "escalate", "insta_remove", "ae_records",
             "wfip_any"),
            gives=("counters",),
            span="degenerate",
        ))
    if layout == "blocked_topk":
        ops.append(_op(
            "block_repair", "-",
            "Bounded per-tick neighbor-block edits: the tick's insert "
            "candidates (ping sender-marks + gossip shares) fold into empty "
            "slots via rank-matched placement — static [N, C, K] shapes, so "
            "violent churn never recompiles (sparseplane/repair.py).",
            "tail", reads=("S", "T", "alive"), writes=("S", "T"),
            takes=("mark1", "ae_records"),
            activity="any insert candidate this tick", sparse="block",
        ))
    ops.append(_op(
        "finish", "-",
        "Metrics + next-state assembly: fingerprint agreement, mean "
        "membership, the anti-entropy ledger carry, tick+1, the carried key.",
        "tail",
        reads=("alive", "identity", "never_b", "last_b", "tick", "key"),
        writes=("tick", "key"),
        takes=("fp_f", "n_f", "del_kpr", "partner", "fp_g", "n_g")
        + (("counters",) if telemetry else ()),
        gives=("metrics",),
        span="degenerate", sparse="row",
    ))
    return tuple(ops)
