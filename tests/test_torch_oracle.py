"""The port's lockstep oracle: against the JAX oracle, and the port's tick against it.

Three arms, every input made from a numpy seed:

- the port's oracle (``kaboodle_tpu_torch/oracle``) against the JAX
  package's, bit for bit: the engine cases of ``tests/test_oracle.py``
  (outboxes and membership maps), and ``LockstepMesh`` runs under random
  flags and faults in deterministic and random mode (state and timer
  matrices, fingerprints, messages, counters, convergence, every tick);
- the port's dense tick against the port's oracle, tick by tick, on the
  cases of ``tests/test_kernel_parity.py`` (kernel flags on, so on the CPU
  the kernels' plain versions run), compared as ``chip_smoke.py``'s
  ``oracle_parity`` compares them on the card;
- the counter-parity arm of ``tests/test_fuzz_parity.py``: the dense and
  the blocked telemetry ticks' counters equal the oracle's tallies field
  by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    oracle_counter_diff,
    oracle_diff,
    oracle_fault_plan,
    oracle_inputs,
    oracle_tick,
)
from kaboodle_tpu import config as jconfig
from kaboodle_tpu import oracle as joracle
from kaboodle_tpu_torch import config as tconfig
from kaboodle_tpu_torch import oracle as toracle
from kaboodle_tpu_torch.sim import init_state, make_chunked_tick_fn, make_tick_fn
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.telemetry.counters import FIELDS

CPU = "cpu"
N = 12
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)
SIDES = {"jax": (jconfig, joracle), "torch": (tconfig, toracle)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small-N tensor ops run fastest on one thread, and leave the other
    test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the port's oracle against the JAX oracle ---------------------------------


def _engine_cases(side: str) -> list[str]:
    """``tests/test_oracle.py``'s engine cases through one package; every
    outbox and every touched record as its repr (the message classes are
    dataclasses, whose repr names the class and its fields only)."""
    cfgmod, orc = SIDES[side]
    SwimConfig = cfgmod.SwimConfig
    out = []

    def engine(addr=0, cfg=None):  # seeded: random mode draws from random.Random(seed)
        return orc.PeerEngine(addr, 100 + addr, cfg or SwimConfig(), now=0, seed=addr + 1)

    e = engine(0)  # Q1: any datagram clears suspicion
    e.known[7] = dataclasses.replace(e.known[0], state=WAITING_FOR_PING, since=0)
    out.append(repr(e.on_unicast(7, 107, orc.Ping(), now=1).__dict__))
    out.append(repr(e.known[7]))
    for faithful in (True, False):  # Q11 in both modes
        e = engine(0, SwimConfig(faithful_indirect_ack=faithful))
        e.known[5] = dataclasses.replace(e.known[0], state=WAITING_FOR_INDIRECT_PING, since=0)
        e.on_unicast(3, 103, orc.Ack(peer=5, mesh_fingerprint=1, num_peers=3), now=1)
        out.append(repr(sorted(e.known.items())))
    e = engine(0)  # Q5: join share includes self, no age filter
    e.known[1] = dataclasses.replace(e.known[0], since=-100)
    out.append(repr(e.on_broadcast(None, orc.Join(2, 102), now=0).__dict__))
    e = engine(0)  # KnownPeersRequest reply filters
    now = 20
    e.known[1] = dataclasses.replace(e.known[0], state=KNOWN, since=now - 3)
    e.known[2] = dataclasses.replace(e.known[0], state=KNOWN, since=now - 15)
    e.known[3] = dataclasses.replace(e.known[0], state=WAITING_FOR_PING, since=now - 1)
    e.known[4] = dataclasses.replace(e.known[0], state=KNOWN, since=now - 1)
    out.append(repr(e.on_unicast(4, 104, orc.KnownPeersRequest(1, 9), now=now).__dict__))
    e = engine(0)  # Q6: gossip inserts back-dated
    e.on_unicast(1, 101, orc.KnownPeersMsg(((9, 109),)), now=30)
    out.append(repr(e.known[9]))
    out.append(repr(e.on_unicast(2, 102, orc.KnownPeersRequest(0, 1), now=30).__dict__))
    e = engine(0)  # sync request only when behind
    e.known[1] = dataclasses.replace(e.known[0], identity=101)
    fp = e.fingerprint()
    for their_fp, their_n in ((fp, 2), (fp ^ 0xDEAD, 5), (fp ^ 0xBEEF, 1)):
        e.on_unicast(1, 101, orc.Ack(1, their_fp, their_n), now=1)
        out.append(repr(e.take_sync_request()))
    e = engine(2)  # PingRequest relays and records the curious peer
    out.append(repr(e.on_unicast(0, 100, orc.PingRequest(target=7), now=1).__dict__))
    out.append(repr(e.curious))
    out.append(repr(e.on_unicast(7, 107, orc.Ack(7, 42, 3), now=1).__dict__))
    e = engine(0)  # the active phase of a peer with suspects and targets
    for j, (state, since) in enumerate(((KNOWN, 0), (WAITING_FOR_PING, -3),
                                        (WAITING_FOR_INDIRECT_PING, -5), (KNOWN, 1)), 1):
        e.known[j] = orc.PeerRecord(100 + j, state, since)
    out.append(repr(e.active_phase(4).__dict__))
    out.append(repr(sorted(e.known.items())))
    return out


def test_engine_cases_equal_jax():
    assert _engine_cases("torch") == _engine_cases("jax")


def _random_flags(rng, det: bool) -> dict:
    return dict(
        deterministic=det,
        join_broadcast_enabled=bool(rng.integers(2)),
        backdate_gossip_inserts=bool(rng.integers(2)),
        faithful_failed_broadcast=bool(rng.integers(2)),
        faithful_indirect_ack=bool(rng.integers(2)),
        max_share_peers=int(rng.choice([0, 6, 300])),
    )


def _mesh_view(mesh) -> dict:
    return {"state": mesh.state_matrix(), "timer": mesh.timer_matrix(),
            "fp": np.array(mesh.fingerprints(), dtype=np.uint64),
            "messages": mesh.last_tick_messages, "counters": dict(mesh.last_tick_counters),
            "converged": mesh.converged(), "alive": list(mesh.alive)}


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "random"])
@pytest.mark.parametrize("seed", range(6))
def test_lockstep_mesh_equals_jax(seed, det):
    """Random flags and faults, N 8-20, 10 ticks: both oracles agree on
    every matrix, fingerprint, message count and counter, every tick. In
    random mode each peer draws from ``random.Random`` seeded per peer, so
    the streams must be the same too."""
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.integers(8, 20))
    flags = _random_flags(rng, det)
    ring = 0 if flags["join_broadcast_enabled"] else int(rng.integers(1, 3))
    meshes = {side: mods[1].LockstepMesh(n, mods[0].SwimConfig(**flags), seed=seed,
                                         ring_contacts=ring)
              for side, mods in SIDES.items()}
    for t, faults in enumerate(oracle_fault_plan(rng, n, 10)):
        views = {}
        for side, mesh in meshes.items():
            oracle_tick(mesh, faults)
            views[side] = _mesh_view(mesh)
        for k, want in views["jax"].items():
            got = views["torch"][k]
            same = np.array_equal(got, want) if isinstance(want, np.ndarray) else got == want
            assert same, f"{k} differs at tick {t} (seed {seed}, {flags})"


# --- the port's tick against the port's oracle --------------------------------


def _inputs(n, kill=None, revive=None, partition=None, drop_ok=None, manual=None):
    """One tick's plan entry (numpy), ``test_kernel_parity._inputs``'s defaults."""
    return {"kill": np.zeros(n, bool) if kill is None else np.asarray(kill, bool),
            "revive": np.zeros(n, bool) if revive is None else np.asarray(revive, bool),
            "partition": (np.zeros(n, np.int32) if partition is None
                          else np.asarray(partition, np.int32)),
            "drop_ok": np.ones((n, n), bool) if drop_ok is None else np.asarray(drop_ok, bool),
            "manual_target": (np.full(n, -1, np.int32) if manual is None
                              else np.asarray(manual, np.int32))}


def _run_parity(mesh, st, plan, cfg, faulty=True):
    tick = make_tick_fn(cfg, faulty=faulty)
    for t, faults in enumerate(plan):
        oracle_tick(mesh, faults)
        st, m = tick(st, oracle_inputs(len(faults["kill"]), faults, CPU))
        bad = oracle_diff(mesh, st, m)
        assert not bad, f"tick {t} differs in {bad}"
    return st


def _cfg(**kw):
    return tconfig.SwimConfig(deterministic=True, **FLAGS, **kw)


def _churn_plan(n, ticks, kills, revives):
    plan = []
    for i in range(ticks):
        kill, revive = np.zeros(n, bool), np.zeros(n, bool)
        kill[kills.get(i, [])] = True
        revive[revives.get(i, [])] = True
        plan.append(_inputs(n, kill=kill, revive=revive))
    return plan


def _manual_plan(n, ticks, at, targets):
    plan = []
    for i in range(ticks):
        manual = np.full(n, -1, np.int64)
        if i == at:
            for src, dst in targets.items():
                manual[src] = dst
        plan.append(_inputs(n, manual=manual))
    return plan


def _partition_plan():
    part = np.zeros(N, np.int32)
    part[N // 2:] = 1
    plan = []
    for i in range(24):
        kill = np.zeros(N, bool)
        kill[1] = i == 6
        plan.append(_inputs(N, partition=part if 2 <= i < 12 else None, kill=kill))
    return plan


def _indirect_ack_plan():
    dok = np.ones((N, N), bool)
    dok[3, 0] = False
    plan = []
    for i in range(30):
        kill = np.zeros(N, bool)
        kill[8] = i == 6
        plan.append(_inputs(N, kill=kill, drop_ok=dok))
    return plan


def _share_cap_plan(n=24):
    loner = n - 1
    iso = np.ones((n, n), bool)
    iso[loner, :] = False
    iso[:, loner] = False
    iso[loner, loner] = True
    one_edge = iso.copy()
    one_edge[loner, 0] = one_edge[0, loner] = True
    return ([_inputs(n, drop_ok=iso) for _ in range(10)] + [_inputs(n, drop_ok=one_edge)]
            + [_inputs(n) for _ in range(4)])


# name -> (cfg kwargs, init/mesh kwargs, plan builder)
KERNEL_PARITY_CASES = {
    "fresh_boot": ({}, {}, lambda: [_inputs(N) for _ in range(12)]),
    "churn": ({}, {}, lambda: _churn_plan(N, 20, {4: [2, 7]}, {14: [2]})),
    "drop_mask": ({}, {}, lambda: [_inputs(N, drop_ok=r.random((N, N)) > 0.25)
                                   for r in [np.random.default_rng(42)] for _ in range(15)]),
    "partition_heal": ({}, {}, _partition_plan),
    "manual_ping": ({}, {}, lambda: _manual_plan(N, 8, 2, {0: 5, 3: 0})),
    "intended_failed_broadcast": ({"faithful_failed_broadcast": False}, {},
                                  lambda: _churn_plan(N, 22, {3: [5]}, {9: [5]})),
    "int16_timer": ({}, {"timer_dtype": torch.int16},
                    lambda: _churn_plan(N, 20, {4: [2, 7]}, {14: [2]})),
    "gossip_boot": ({"join_broadcast_enabled": False}, {"ring_contacts": 2},
                    lambda: [_inputs(N) for _ in range(24)]),
    "gossip_boot_churn": ({"join_broadcast_enabled": False}, {"ring_contacts": 2},
                          lambda: _churn_plan(N, 20, {6: [4]}, {})),
    "epidemic_boot": ({"join_broadcast_enabled": False, "backdate_gossip_inserts": False},
                      {"ring_contacts": 2}, lambda: [_inputs(N) for _ in range(10)]),
    "share_cap": ({"max_share_peers": 8}, {}, _share_cap_plan),
    "share_cap_inactive": ({"max_share_peers": 16}, {}, lambda: [_inputs(N) for _ in range(6)]),
    "intended_indirect_ack": ({"faithful_indirect_ack": False}, {}, _indirect_ack_plan),
    "manual_self_ping": ({}, {}, lambda: _manual_plan(N, 4, 1, {4: 4})),
    "manual_ping_out_of_range": ({}, {}, lambda: _manual_plan(N, 4, 1, {0: N, 2: N + 7})),
}


@pytest.mark.parametrize("case", list(KERNEL_PARITY_CASES))
def test_dense_tick_equals_oracle(case):
    """The cases of ``tests/test_kernel_parity.py``: state, timers,
    fingerprints, convergence and messages equal to the oracle every tick."""
    cfg_kw, init_kw, build = KERNEL_PARITY_CASES[case]
    plan = build()
    n = len(plan[0]["kill"])
    cfg = _cfg(**cfg_kw)
    mesh = toracle.LockstepMesh(n, cfg, ring_contacts=init_kw.get("ring_contacts", 0))
    st = init_state(n, device=CPU, **init_kw)
    if case == "share_cap":
        # Right after the join tick the loner knows itself plus the 8
        # lowest-index members of responder 0's capped share.
        st = _run_parity(mesh, st, plan[:11], cfg)
        assert set(np.flatnonzero(st.state.numpy()[n - 1] > 0)) == set(range(8)) | {n - 1}
        plan = plan[11:]
    final = _run_parity(mesh, st, plan, cfg)
    assert final.timer.dtype == init_kw.get("timer_dtype", torch.int32)
    if case == "epidemic_boot":
        assert mesh.converged(), "epidemic boot should converge within 10 ticks at N=12"
    if case == "intended_indirect_ack":
        assert final.state.numpy()[0, 3] > 0  # the false positive was cleared


def test_large_n_boot_equals_oracle():
    """N = 256 broadcast boot over 4 ticks with the share cap below N (D5 at
    scale), lean state with int16 timers (the record-hash kernel's path)."""
    n = 256
    cfg = _cfg(max_share_peers=16)
    mesh = toracle.LockstepMesh(n, cfg)
    st = init_state(n, instant_identity=True, timer_dtype=torch.int16, device=CPU)
    _run_parity(mesh, st, [_inputs(n) for _ in range(4)], cfg, faulty=False)
    assert mesh.converged()


@pytest.mark.parametrize("seed", range(3))
def test_telemetry_counters_equal_oracle(seed):
    """The counter-parity arm: the dense and the blocked telemetry ticks'
    ``ProtocolCounters`` equal the oracle's tallies, field by field, on
    random scenarios under random flags; both ticks' states match it too."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(8, 20))
    n += n % 2  # even, so the block n // 2 divides
    flags = _random_flags(rng, True)
    cfg = tconfig.SwimConfig(**flags, **FLAGS)
    ring = int(rng.integers(1, 3)) if not cfg.join_broadcast_enabled else 0
    timer_dtype = torch.int16 if rng.integers(2) else torch.int32
    mesh = toracle.LockstepMesh(n, cfg, seed=seed, ring_contacts=ring)
    sd = sc = init_state(n, seed=seed, ring_contacts=ring, timer_dtype=timer_dtype, device=CPU)
    dense = make_tick_fn(cfg, faulty=True, telemetry=True)
    blocked = make_chunked_tick_fn(cfg, faulty=True, block=n // 2, telemetry=True)
    for t, faults in enumerate(oracle_fault_plan(rng, n, 10)):
        oracle_tick(mesh, faults)
        inp = oracle_inputs(n, faults, CPU)
        sd, out_d = dense(sd, inp)
        sc, out_c = blocked(sc, inp)
        assert set(mesh.last_tick_counters) == set(FIELDS)
        for side, s, out in (("dense", sd, out_d), ("blocked", sc, out_c)):
            assert not oracle_diff(mesh, s, out.metrics), (side, t)
            assert not oracle_counter_diff(mesh, out.counters), (side, t)
