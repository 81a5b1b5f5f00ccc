"""The port's facade (``SimNetwork``/``Kaboodle``) and events against the JAX package's.

One script of operations drives a JAX network and a port network built
from the same seed. After every tick the events each instance received,
``peers()``, ``peer_states()`` (latency within rtol 1e-5, ``None`` where no
sample was taken), ``fingerprint()`` and every state leaf are compared; an
operation that raises must raise the same error on both sides. The JAX
facade's tick is jitted (once per configuration) so the script runs in
seconds; jitting does not change what it computes.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from kaboodle_tpu import api as japi
from kaboodle_tpu import errors as jerrors
from kaboodle_tpu import events as jevents
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.oracle import fingerprint as jfp
from kaboodle_tpu_torch import Kaboodle, KaboodleError, SimNetwork, SwimConfig
from kaboodle_tpu_torch import api, errors, events
from kaboodle_tpu_torch.ops.hashing import membership_fingerprint
from kaboodle_tpu_torch.oracle import fingerprint as tfp
from kaboodle_tpu_torch.sim.state import state_to_numpy

CPU = "cpu"
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)
IDENTITIES = [b"top-left", "top-right", 7, b"bottom-left", b"bottom-right", b"late"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jitted_jax_tick(cfg: JaxSwimConfig):
    from kaboodle_tpu.sim.kernel import make_tick_fn

    return jax.jit(make_tick_fn(cfg, faulty=True))


def _leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


class _Side:
    """One engine's network, its instances and a per-tick record of what
    every instance saw."""

    def __init__(self, net, mk):
        self.net, self.mk, self.nodes, self.subs, self.log = net, mk, [], [], []
        orig = net.tick

        def tick(ticks=1):
            m = None
            for _ in range(ticks):
                m = orig(1)
                self.log.append(self.snapshot())
            return m

        net.tick = tick  # tick_until_converged and discover_next_peer call self.tick()

    def attach(self, identity):
        k = self.mk(self.net, identity)
        self.nodes.append(k)
        self.subs.append((k.discover_peers(), k.discover_departures(),
                          k.discover_fingerprint_changes()))
        return k

    def snapshot(self) -> dict:
        events_ = []
        for qs in self.subs:
            events_.append(tuple(list(q) for q in qs))
            for q in qs:
                q.clear()
        st = self.net.state
        leaves = _leaves(st) if isinstance(self.net, japi.SimNetwork) else state_to_numpy(st)
        return {
            "events": events_,
            "peers": [k.peers() for k in self.nodes],
            "peer_states": [k.peer_states() for k in self.nodes],
            "fingerprint": [k.fingerprint() for k in self.nodes],
            "running": [k.is_running for k in self.nodes],
            "state": leaves,
        }


def _assert_snapshots_equal(want: dict, got: dict, where: str):
    for key in ("events", "peers", "fingerprint", "running"):
        assert got[key] == want[key], f"{where}: {key}"
    for i, (w, g) in enumerate(zip(want["peer_states"], got["peer_states"])):
        assert w.keys() == g.keys(), f"{where}: peer_states keys of {i}"
        for j in w:
            (ws, wt, wl), (gs, gt, gl) = w[j], g[j]
            assert (ws, wt) == (gs, gt), f"{where}: peer_states {i}->{j}"
            assert (wl is None) == (gl is None), f"{where}: latency {i}->{j}"
            if wl is not None:
                np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"{where}: {i}->{j}")
    for k, w in want["state"].items():
        g = got["state"][k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
        elif k == "latency":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{where}: {k}")
        else:
            assert w.dtype == g.dtype, f"{where}: {k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


class _Both:
    """Runs each operation on both sides and compares results and errors."""

    def __init__(self, capacity, jcfg, tcfg, seed):
        jnet = japi.SimNetwork(capacity, cfg=jcfg, seed=seed)
        jnet._tick_fn = _jitted_jax_tick(jcfg)
        self.j = _Side(jnet, japi.Kaboodle)
        self.t = _Side(SimNetwork(capacity, cfg=tcfg, seed=seed, device=CPU), Kaboodle)
        self.ops = 0

    def __call__(self, op):
        """``op(side, net, nodes)`` on both; equal results or equal errors,
        then every tick's record equal."""
        res = {}
        for name, side in (("j", self.j), ("t", self.t)):
            try:
                res[name] = ("ok", op(side, side.net, side.nodes))
            except (jerrors.KaboodleError, errors.KaboodleError) as e:
                res[name] = ("raise", type(e).__name__)
        if res["j"][0] == "ok" and res["j"][1] is not None and hasattr(res["j"][1], "converged"):
            res = {k: (v[0], bool(v[1].converged)) for k, v in res.items()}
        assert res["t"] == res["j"], f"op {self.ops}: {res}"
        assert len(self.t.log) == len(self.j.log)
        for i, (w, g) in enumerate(zip(self.j.log, self.t.log)):
            _assert_snapshots_equal(w, g, f"op {self.ops}, tick {i}")
        self.j.log.clear()
        self.t.log.clear()
        self.ops += 1
        return res["j"]


@pytest.mark.parametrize("det", [False, True])
def test_facade_script_matches_jax(det):
    both = _Both(8, JaxSwimConfig(deterministic=det), SwimConfig(deterministic=det, **FLAGS),
                 seed=3)
    for ident in IDENTITIES[:5]:
        both(lambda s, net, nodes, i=ident: s.attach(i) and None)
    assert both(lambda s, net, nodes: nodes[0].stop()) == ("raise", "InvalidOperation")
    assert both(lambda s, net, nodes: nodes[1].ping_addrs([0])) == ("raise", "InvalidOperation")
    assert both(lambda s, net, nodes: net.tick_until_converged()) == ("raise", "InvalidOperation")
    assert both(lambda s, net, nodes: net.discover_mesh_member()) == ("raise", "InvalidOperation")
    for i in range(5):
        both(lambda s, net, nodes, i=i: nodes[i].start())
    assert both(lambda s, net, nodes: nodes[0].start()) == ("raise", "InvalidOperation")
    both(lambda s, net, nodes: net.tick())
    both(lambda s, net, nodes: net.tick_until_converged(max_ticks=16))
    both(lambda s, net, nodes: net.discover_mesh_member())
    both(lambda s, net, nodes: nodes[0].ping_addrs([3, 0, 7, 2]))
    both(lambda s, net, nodes: net.set_partition(np.arange(8) % 2))
    both(lambda s, net, nodes: net.tick(3))
    both(lambda s, net, nodes: net.set_drop_rate(0.3))
    both(lambda s, net, nodes: net.tick(3))
    both(lambda s, net, nodes: net.heal_partition())
    both(lambda s, net, nodes: net.set_drop_rate(0.0))
    both(lambda s, net, nodes: nodes[2].stop())
    both(lambda s, net, nodes: net.tick(8))
    both(lambda s, net, nodes: nodes[2].start())
    both(lambda s, net, nodes: nodes[1].set_identity(b"renamed"))
    both(lambda s, net, nodes: net.tick(2))
    both(lambda s, net, nodes: s.attach(IDENTITIES[5]) and None)
    both(lambda s, net, nodes: nodes[5].start())
    both(lambda s, net, nodes: nodes[5].discover_next_peer(max_ticks=8))
    both(lambda s, net, nodes: net.tick_until_converged(max_ticks=24))
    both(lambda s, net, nodes: nodes[4].stop())
    both(lambda s, net, nodes: nodes[4].start())  # cancels the pending stop
    both(lambda s, net, nodes: net.tick())
    both(lambda s, net, nodes: net.set_drop_rate(1.0))
    assert both(lambda s, net, nodes: net.tick_until_converged(max_ticks=2)) in (
        ("raise", "ConvergenceTimeout"), ("ok", 1), ("ok", 2))
    for ident in (b"x", b"y"):
        both(lambda s, net, nodes, i=ident: s.attach(i) and None)
    assert both(lambda s, net, nodes: s.attach(b"overflow")) == ("raise", "InvalidOperation")
    assert [k.self_addr() for k in both.t.nodes] == list(range(8))
    assert both.t.nodes[0].interface() == "sim"


def test_set_identity_writes_a_new_identity_tensor():
    """The identity tensor is shared by every state a tick passes it to, so
    set_identity must leave the tensor it replaces untouched."""
    net = SimNetwork(4, device=CPU)
    a = Kaboodle(net, b"a")
    a.start()
    net.tick()
    before = net.state.identity
    kept = before.clone()
    a.set_identity(b"b")
    assert net.state.identity is not before and torch.equal(before, kept)
    assert int(net.state.identity[0]) != int(kept[0])


def test_facade_defaults_to_the_card():
    if torch.cuda.is_available():
        assert SimNetwork(4).state.state.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimNetwork(4)
    assert issubclass(errors.CheckpointError, KaboodleError)
    assert {c.__name__ for c in vars(errors).values() if isinstance(c, type)} == {
        c.__name__ for c in vars(jerrors).values() if isinstance(c, type)}


def _as_tuples(evs):
    return [(type(e).__name__, *dataclasses.astuple(e)) for e in evs]


def test_event_tap_matches_jax():
    """Random membership rows and identity changes through both taps, and
    the cases of tests/test_events.py: initial announce, batching, departure,
    fingerprint dedup, identity re-announce, the empty map (Q10)."""
    rng = np.random.default_rng(4)
    jt, tt = jevents.EventTap(), events.EventTap()
    ids = np.arange(1, 17, dtype=np.uint32)
    prev = np.zeros(16, dtype=bool)
    rows = [rng.random(16) < p for p in (0.5, 0.5, 0.9, 0.0, 0.0, 0.3, 0.3)]
    for step, member in enumerate(rows):
        if step == 6:
            ids = ids.copy()
            ids[np.flatnonzero(member)[:2]] = 99
        want = jt.feed(member, ids)
        fp = int(membership_fingerprint(torch.from_numpy(member[None, :]),
                                        torch.from_numpy(ids.view(np.int32)))[0]) & 0xFFFFFFFF
        got = tt.feed(member, ids, fingerprint=fp if step % 2 else None)
        assert _as_tuples(got) == _as_tuples(want), step
        ja, jr = jevents.membership_diff(prev[None, :], member[None, :])
        ta, tr = events.membership_diff(prev[None, :], member[None, :])
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tr, jr)
        prev = member
    tap = events.EventTap()
    tap.feed(np.eye(8, dtype=bool)[0], ids[:8])
    assert tap.feed(np.zeros(8, dtype=bool), ids[:8]) == [events.PeerDeparted(0)]


def test_mix_fingerprint_matches_device_hash_and_jax():
    rng = np.random.default_rng(2)
    member = rng.random((6, 40)) < 0.5
    ids = rng.integers(0, 2**32, size=40, dtype=np.uint64).astype(np.uint32)
    dev = membership_fingerprint(torch.from_numpy(member),
                                 torch.from_numpy(ids.view(np.int32))).numpy().view(np.uint32)
    for i in range(6):
        rec = {int(j): int(ids[j]) for j in np.flatnonzero(member[i])}
        assert tfp.mix_fingerprint(rec) == jfp.mix_fingerprint(rec) == int(dev[i])
    for x in (0, 1, 0x9E3779B9, 2**32 - 1):
        assert tfp.mix32_py(x) == jfp.mix32_py(x)
        assert tfp.peer_record_hash_py(x, 5) == jfp.peer_record_hash_py(x, 5)
    assert api._identity_word(b"top-left") == japi._identity_word(b"top-left")
    assert api._identity_word("abc") == japi._identity_word("abc")
    assert api._identity_word(-1) == japi._identity_word(-1)
