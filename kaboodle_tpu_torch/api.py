"""The consumer-facing ``Kaboodle`` facade over the simulated mesh.

Mirrors the reference's public API (lib.rs:78-369): lifecycle
(``start``/``stop``), queries (``peers``, ``peer_states``, ``fingerprint``),
manual bootstrap (``ping_addrs``), identity management (``set_identity``), and
the three discovery event streams (``discover_peers``,
``discover_departures``, ``discover_fingerprint_changes``,
``discover_next_peer``).

Where the reference binds one instance per OS process to a UDP socket, here
many instances attach to one :class:`SimNetwork` — the in-memory "LAN" whose
medium is the ``[N, N]`` state tensor and whose clock is the tick kernel. An
instance's "address" is its peer index. Instances advance together:
``SimNetwork.tick()`` steps the whole mesh one protocol period (the lockstep
twin of every reference instance's independent 1 Hz tokio loop) and then
delivers events to each attached instance's streams.

Documented deviations from the reference:

- *Identity payload resolution is host-side*: the kernel propagates identity
  words via traffic (``MeshState.id_view``, refreshed at every Q1 mark — the
  envelope semantics of structs.rs:77-83), but consumer-supplied identity
  *bytes* are kept host-side per network and resolved in ``peers()`` from the
  current instances; the on-device word is their CRC-32. Facade-level
  ``fingerprint()`` hashes the caller's membership against current identity
  words (D-API1: a ``set_identity`` is visible to these *queries* immediately,
  while the kernel's internal convergence metric honors per-row views).
- *Restart keeps the address* (D-API2): the reference re-binds an ephemeral
  port on ``start()`` after ``stop()`` (a new address); a simulated instance
  keeps its index, re-entering with a reset row + Join broadcast — the same
  protocol behavior, minus the address churn.
- ``stop()`` is a silent leave (quirk Q8 — no departure announcement), and
  the instance keeps its membership map while stopped (lib.rs:167-170).

The port's facade runs the port's tick (``make_tick_fn(cfg, faulty=True)``)
on the card unless ``SimNetwork(device=...)`` names another device. Each
tick delivers events from the member rows of the *running* instances only:
their fingerprints are hashed on the device and only those rows are fetched
to the host (a stopped instance receives no events, so the events are the
same as a fetch of the whole plane).
"""

from __future__ import annotations

import collections
import dataclasses
import zlib

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.errors import ConvergenceTimeout, InvalidOperation
from kaboodle_tpu_torch.events import EventTap, FingerprintChanged, PeerDeparted, PeerDiscovered
from kaboodle_tpu_torch.ops.hashing import membership_fingerprint, u32_to_i32
from kaboodle_tpu_torch.oracle.fingerprint import mix_fingerprint
from kaboodle_tpu_torch.sim.kernel import make_tick_fn
from kaboodle_tpu_torch.sim.state import (
    MeshState,
    TickInputs,
    TickMetrics,
    init_state,
    resolve_device,
)
from kaboodle_tpu_torch.spec import STATE_NAMES


def _identity_word(identity) -> int:
    """Consumer identity -> on-device uint32 word (CRC-32 of the bytes)."""
    if isinstance(identity, int):
        return identity & 0xFFFFFFFF
    if isinstance(identity, str):
        identity = identity.encode()
    return zlib.crc32(bytes(identity)) & 0xFFFFFFFF


class SimNetwork:
    """The shared medium: N peer slots, the tick clock, and fault controls.

    All peers start dead; :meth:`Kaboodle.start` revives a slot (the kernel
    resets its row and schedules a Join broadcast, kaboodle.rs:144-152,
    228-251). Fault controls (``set_drop_rate``, ``set_partition``) take
    effect on subsequent ticks — the interactive twin of the declarative
    :class:`kaboodle_tpu_torch.sim.Scenario`. The mesh lives on the card
    unless ``device`` names another.
    """

    def __init__(self, capacity: int, cfg: SwimConfig | None = None, seed: int = 0,
                 device=None):
        self.cfg = cfg or SwimConfig()
        self.capacity = capacity
        self.device = resolve_device(device)
        self.state: MeshState = init_state(
            capacity, seed=seed, alive=np.zeros((capacity,), dtype=bool), device=self.device
        )
        self._tick_fn = make_tick_fn(self.cfg, faulty=True)
        self._instances: dict[int, "Kaboodle"] = {}
        self._next_slot = 0
        # pending per-tick control inputs, drained by tick()
        self._kill = np.zeros(capacity, dtype=bool)
        self._revive = np.zeros(capacity, dtype=bool)
        self._manual: dict[int, collections.deque[int]] = collections.defaultdict(
            collections.deque
        )
        self._partition = np.zeros(capacity, dtype=np.int32)
        self._drop_rate = 0.0
        # Host-side RNG derived from the network seed (probe member choice):
        # keeps sim runs reproducible from (cfg, seed) and never touches the
        # global numpy stream.
        self._rng = np.random.default_rng(seed)
        self.metrics: TickMetrics | None = None  # last tick's metrics

    # ---- slots -------------------------------------------------------------

    def _attach(self, inst: "Kaboodle") -> int:
        if self._next_slot >= self.capacity:
            raise InvalidOperation(f"network is full ({self.capacity} slots)")
        slot = self._next_slot
        self._next_slot += 1
        self._instances[slot] = inst
        return slot

    # ---- fault controls ----------------------------------------------------

    def set_drop_rate(self, rate: float) -> None:
        """Random per-edge message drop probability for subsequent ticks."""
        self._drop_rate = float(rate)

    def set_partition(self, groups) -> None:
        """Partition group ids (int [capacity]); equal ids communicate."""
        self._partition = np.asarray(groups, dtype=np.int32).copy()

    def heal_partition(self) -> None:
        self._partition[:] = 0

    # ---- the clock ---------------------------------------------------------

    def tick(self, ticks: int = 1) -> TickMetrics:
        """Advance the whole mesh ``ticks`` protocol periods and deliver events."""
        for _ in range(ticks):
            n = self.capacity
            manual = np.full(n, -1, dtype=np.int32)
            for slot, q in self._manual.items():
                # Queued pings of a stopped instance are held, not discarded:
                # the kernel would mask them by aliveness anyway (D8).
                inst = self._instances.get(slot)
                if q and inst is not None and inst.is_running:
                    manual[slot] = q.popleft()
            # NB: copies are load-bearing — torch.as_tensor aliases a NumPy
            # buffer on the CPU, and the pending masks are cleared right
            # below; torch.tensor always copies.
            dev = self.device
            inp = TickInputs(
                kill=torch.tensor(self._kill, device=dev),
                revive=torch.tensor(self._revive, device=dev),
                partition=torch.tensor(self._partition, device=dev),
                drop_rate=torch.tensor(self._drop_rate, dtype=torch.float32, device=dev),
                manual_target=torch.tensor(manual, device=dev),
                drop_ok=None,
            )
            self._kill[:] = False
            self._revive[:] = False
            self.state, self.metrics = self._tick_fn(self.state, inp)
            self._deliver_events()
        return self.metrics

    def tick_until_converged(self, max_ticks: int = 64) -> int:
        """Tick until the alive peers agree on the fingerprint; returns ticks
        run. Raises InvalidOperation if nothing is running and
        ConvergenceTimeout if agreement is not reached within ``max_ticks``."""
        if not any(i.is_running for i in self._instances.values()):
            raise InvalidOperation("no running instances")
        for t in range(1, max_ticks + 1):
            m = self.tick()
            if bool(m.converged):
                return t
        raise ConvergenceTimeout(f"no fingerprint agreement within {max_ticks} ticks")

    def discover_mesh_member(self) -> tuple[int, object]:
        """Find one mesh member without joining (discovery.rs:30-89,
        lib.rs:359-368): returns ``(address, identity)`` of a running
        instance.

        The reference broadcasts ``Probe`` with backoff until any member
        replies (reply probability max(1, 100-n^2)%, kaboodle.rs:344-353) and
        returns the first reply — an arbitrary member. The sim's broadcast
        domain is the network object itself, so the probe resolves instantly;
        with nobody running it raises :class:`InvalidOperation` instead of
        backing off forever (deviation: the reference loops indefinitely,
        discovery.rs:51-72, which a synchronous facade cannot)."""
        running = [s for s, i in sorted(self._instances.items()) if i.is_running]
        if not running:
            raise InvalidOperation("no running instances to discover")
        slot = running[0] if self.cfg.deterministic else int(self._rng.choice(running))
        return slot, self._instances[slot]._identity

    def _deliver_events(self) -> None:
        running = [(slot, inst) for slot, inst in self._instances.items() if inst.is_running]
        if not running:
            return
        rows = torch.tensor([slot for slot, _ in running], dtype=torch.int64, device=self.device)
        member_dev = self.state.state[rows] > 0
        # One vectorized device pass for the running rows' fingerprints (it
        # matches mix_fingerprint bit for bit), then one fetch of those rows.
        fps = membership_fingerprint(member_dev, self.state.identity).cpu().numpy().view(np.uint32)
        member = member_dev.cpu().numpy()
        ids = self.state.identity.cpu().numpy().view(np.uint32)
        for r, (slot, inst) in enumerate(running):
            inst._dispatch(inst._tap.feed(member[r], ids, fingerprint=int(fps[r])))


class Kaboodle:
    """One mesh instance — the reference's ``Kaboodle`` struct (lib.rs:78-92).

    ``identity`` is an opaque consumer payload (bytes/str/int), as in the
    reference (README.md:15); it travels as a 32-bit word on device (D-API1).
    """

    def __init__(self, network: SimNetwork, identity=b"") -> None:
        self._net = network
        self._slot = network._attach(self)
        self._identity = identity
        self._running = False
        self._tap = EventTap()
        self._discover_subs: list[collections.deque] = []
        self._depart_subs: list[collections.deque] = []
        self._fp_subs: list[collections.deque] = []
        self.set_identity(identity)

    # ---- lifecycle (lib.rs:136-183) ---------------------------------------

    def start(self) -> None:
        """Join the mesh: reset row, revive, Join broadcast on the next tick."""
        if self._running:
            raise InvalidOperation("already running")
        self._net._revive[self._slot] = True
        self._net._kill[self._slot] = False  # cancel a not-yet-applied stop
        self._running = True

    def stop(self) -> None:
        """Silent leave (Q8). The membership map is kept (lib.rs:167-170)."""
        if not self._running:
            raise InvalidOperation("not running")
        self._net._kill[self._slot] = True
        self._net._revive[self._slot] = False  # cancel a not-yet-applied start
        self._running = False

    @property
    def is_running(self) -> bool:
        return self._running

    # ---- addressing --------------------------------------------------------

    def self_addr(self) -> int:
        """The instance's address: its peer index (lib.rs:339-345 analogue)."""
        return self._slot

    def interface(self) -> str:
        """The 'interface' the instance is bound to (lib.rs analogue)."""
        return "sim"

    # ---- queries (lib.rs:301-354) -----------------------------------------

    def _row(self) -> np.ndarray:
        return self._net.state.state[self._slot].cpu().numpy()

    def peers(self) -> dict[int, object]:
        """Membership map: peer index -> identity payload (lib.rs:339-345).

        Identity payloads are resolved to the attached instance's consumer
        bytes where known; detached slots report their raw identity word."""
        ids = self._net.state.identity.cpu().numpy().view(np.uint32)
        out: dict[int, object] = {}
        for j in np.flatnonzero(self._row() > 0):
            inst = self._net._instances.get(int(j))
            out[int(j)] = inst._identity if inst is not None else int(ids[j])
        return out

    def peer_states(self) -> dict[int, tuple[str, int, float | None]]:
        """peer index -> (state name, last-heard/sent-at tick, latency EWMA)
        (lib.rs:348-354).

        Latency is the per-peer EWMA in ticks the kernel tracks
        (kaboodle.rs:789-817, weight 0.8 newest); ``None`` when no sample has
        been taken yet (the reference's ``Option::None``) or when the network
        runs a ``track_latency=False`` lean state."""
        row = self._row()
        timer = self._net.state.timer[self._slot].cpu().numpy()
        lat_row = self._net.state.latency
        lat = None if lat_row is None else lat_row[self._slot].cpu().numpy()
        return {
            int(j): (
                STATE_NAMES[int(row[j])],
                int(timer[j]),
                None if lat is None or np.isnan(lat[j]) else float(lat[j]),
            )
            for j in np.flatnonzero(row > 0)
        }

    def fingerprint(self) -> int:
        """Current mesh fingerprint of this instance's view (lib.rs:301-304)."""
        ids = self._net.state.identity.cpu().numpy().view(np.uint32)
        return mix_fingerprint(
            {int(j): int(ids[j]) for j in np.flatnonzero(self._row() > 0)}
        )

    # ---- identity (lib.rs:323-336) ----------------------------------------

    def set_identity(self, identity) -> None:
        self._identity = identity
        # A new identity tensor: the current one is shared with earlier
        # states (every tick passes it through), so it is never written.
        ident = self._net.state.identity.clone()
        ident[self._slot] = u32_to_i32(_identity_word(identity))
        self._net.state = dataclasses.replace(self._net.state, identity=ident)

    # ---- manual pings (lib.rs:268-297) ------------------------------------

    def ping_addrs(self, addrs) -> None:
        """Queue manual pings, one per subsequent tick (kaboodle.rs:550-556)."""
        if not self._running:
            raise InvalidOperation("not running")
        for a in addrs:
            self._net._manual[self._slot].append(int(a))

    # ---- event streams (lib.rs:186-263) -----------------------------------

    def discover_peers(self):
        """Subscribe to (peer, identity) discoveries; returns a deque that
        fills as the network ticks (the reference's mpsc channel)."""
        q: collections.deque = collections.deque()
        self._discover_subs.append(q)
        return q

    def discover_departures(self):
        q: collections.deque = collections.deque()
        self._depart_subs.append(q)
        return q

    def discover_fingerprint_changes(self):
        q: collections.deque = collections.deque()
        self._fp_subs.append(q)
        return q

    def discover_next_peer(self, max_ticks: int = 64):
        """Tick the network until this instance discovers a peer; returns
        (peer, identity) or None after ``max_ticks`` (lib.rs:246-260)."""
        if not self._running:
            raise InvalidOperation("not running")
        q = self.discover_peers()
        try:
            for _ in range(max_ticks):
                if q:
                    break
                self._net.tick()
            return q.popleft() if q else None
        finally:
            self._discover_subs.remove(q)

    def _dispatch(self, events) -> None:
        for e in events:
            if isinstance(e, PeerDiscovered):
                for q in self._discover_subs:
                    q.append((e.peer, e.identity))
            elif isinstance(e, PeerDeparted):
                for q in self._depart_subs:
                    q.append(e.peer)
            elif isinstance(e, FingerprintChanged):
                for q in self._fp_subs:
                    q.append(e.fingerprint)
