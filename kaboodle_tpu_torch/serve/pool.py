"""The lane pool: a resident fixed-shape ``[E]`` fleet served lane by lane.

The port of ``kaboodle_tpu/serve/pool.py``. A pool owns one ``FleetState``
whose ensemble axis is reinterpreted as E *lanes*: independent request
slots multiplexed through the one serve step program
(``phasegraph/derive.py::make_serve_step``). Everything a request varies --
seed, drop knob, mode, tick budget -- is data, so the pool's whole
lifecycle (admit, tick, retire, re-seed) calls the same programs forever:

- **re-seed** (:meth:`LanePool.admit`): writes ``init_state(n, seed)`` into
  lane ``e`` in place on the pool's device and bumps the lane's on-device
  generation counter, so lane ``e`` holds exactly the state a standalone
  run of that seed would start from. Bit-exactness of the subsequent
  trajectory is the fleet parity contract (fleet/core.py): the serve step
  advances lanes through the same fleet tick, freezing everything else.
- **generation counters** (int32 ``[E]``, on the device): bumped by every
  re-seed/insert, checkpointed with the fleet (checkpoint.save_fleet), and
  stamped into every harvest event -- a lane's (index, generation) pair
  names one served request's trajectory across spills and restores.
- **N-classes**: requests are bucketed to power-of-two mesh sizes
  (:func:`lane_n_class`), so arbitrary request sizes never mint new
  programs.

The JAX pool caches its jitted programs process-wide with
``functools.lru_cache``; the port keeps the same caches and keys over the
Python callables it builds. A miss of one of them is a program *built*:
:func:`program_builds` counts them (with the leap cache's misses and the
CUDA kernel libraries loaded), which is what the serve plane's
``compiles_steady`` gauge reports after warmup.

Occupancy and per-lane run counters live as numpy vectors fed to (and
fetched from) the step program each round; only the mesh, the drop knob
vector and the generation counters are resident on the device. Entry
points run on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.fleet.core import FleetState, init_fleet
from kaboodle_tpu_torch.sim.runner import state_agreement
from kaboodle_tpu_torch.sim.state import MeshState, init_state, resolve_device

MIN_LANE_N = 8  # smallest served mesh class

# Request "scenario" -> init_state shape kwargs.
# "boot": a fresh mesh that must gossip/broadcast its way to agreement.
# "steady": a converged, already-announced mesh -- the steady-state service
# shape horizon-mode requests (and the warp fast-forward) start from.
SCENARIOS = {
    "boot": {},
    "steady": lambda n: {"ring_contacts": n - 1, "announced": True},
}


def lane_n_class(n: int) -> int:
    """The pow2 mesh-size class serving a request for ``n`` peers.

    One resident pool (= one program family) per class, whatever sizes
    clients ask for. Requests run AT class size -- the class is part of the
    service contract (a request's standalone-equivalent run is the
    class-sized one)."""
    if n < 1:
        raise ValueError("need n >= 1")
    return max(MIN_LANE_N, 1 << (int(n) - 1).bit_length())


def _seed32(seed) -> int:
    """``seed`` as the JAX pool passes it (``jnp.int32(seed)``): a value out
    of the int32 range raises numpy's ``OverflowError``, as there."""
    return int(np.int32(seed))


def _write_lane(mesh: MeshState, lane: int, member: MeshState) -> None:
    """Write ``member``'s leaves into lane ``lane`` of ``mesh``, in place."""
    for f in dataclasses.fields(MeshState):
        leaf = getattr(mesh, f.name)
        if leaf is not None:
            leaf[lane].copy_(getattr(member, f.name))


def make_reseed_fn(n: int, scenario: str = "boot", **state_kwargs):
    """The retire/re-seed program.

    ``reseed(mesh, generation, drop_rate, lane, seed, drop)`` writes a fresh
    ``init_state(n, seed)`` into lane ``lane`` of the stacked mesh, bumps
    that lane's generation counter and sets its drop knob, in place on the
    mesh's device, and returns the three. The written member is
    leaf-for-leaf what the standalone init builds (same kwargs, key
    ``PRNGKey(int32 seed)``), which is what makes mid-flight admission
    bit-exact."""
    shape_kw = SCENARIOS[scenario]
    kw = dict(shape_kw(n) if callable(shape_kw) else shape_kw)
    kw.update(state_kwargs)

    def reseed(mesh, generation, drop_rate, lane, seed, drop):
        lane, seed = int(lane), _seed32(seed)
        fresh = init_state(n, seed=seed, device=mesh.state.device, **kw)
        _write_lane(mesh, lane, fresh)
        generation[lane] += 1
        drop_rate[lane] = float(np.float32(drop))
        return mesh, generation, drop_rate

    return reseed


def make_insert_fn():
    """Lane member write: restore a spilled/checkpointed member.

    Same contract as the reseed program but the member state comes from the
    caller (checkpoint.load) instead of ``init_state`` -- the restore half
    of the lane spill path. Bumps the generation counter too: a restored
    occupancy is a new generation of that lane."""

    def insert(mesh, generation, lane, member):
        lane = int(lane)
        _write_lane(mesh, lane, member)
        generation[lane] += 1
        return mesh, generation

    return insert


@functools.lru_cache(maxsize=None)
def _step_program(cfg, chunk: int, faulty: bool, telemetry: bool):
    """The serve step, shared process-wide: two pools of the same (cfg,
    chunk, faulty, telemetry) signature -- or a pool rebuilt after a
    restore -- reuse one program."""
    from kaboodle_tpu_torch.phasegraph.derive import make_serve_step

    return make_serve_step(cfg, chunk, faulty=faulty, telemetry=telemetry)


@functools.lru_cache(maxsize=None)
def _reseed_program(n: int, scenario: str, state_kwargs_items: tuple):
    return make_reseed_fn(n, scenario=scenario, **dict(state_kwargs_items))


@functools.lru_cache(maxsize=None)
def _insert_program():
    return make_insert_fn()


@functools.lru_cache(maxsize=None)
def _agree_program():
    return state_agreement


@functools.lru_cache(maxsize=None)
def _member_fetch():
    """Lane member gather (the spill path's read side): a private device
    copy of every leaf of lane ``lane``, so later in-place writes to the
    pool never reach it."""

    def fetch(mesh, lane):
        lane = int(lane)
        return dataclasses.replace(mesh, **{
            f.name: getattr(mesh, f.name)[lane].clone()
            for f in dataclasses.fields(MeshState) if getattr(mesh, f.name) is not None
        })

    return fetch


@functools.lru_cache(maxsize=None)
def _fleet_signature(cfg):
    from kaboodle_tpu_torch.warp.horizon import make_signature_fn

    return make_signature_fn(cfg)


_PROGRAM_CACHES = (_step_program, _reseed_program, _insert_program, _agree_program,
                   _member_fetch, _fleet_signature)


def program_builds() -> int:
    """Programs the serving path has built in this process: misses of the
    pool's program caches (the sharded pool's too), of the warp
    ``leap_cache`` and of the sparse
    tick cache (``sparseplane/runner.py``), plus the CUDA kernel libraries
    ``ops/_cuda.py`` has built or loaded. The port's
    counterpart of the JAX package's XLA compile count (the serve plane's
    ``compiles_steady`` gauge is this number's growth after warmup)."""
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.serve import shardpool
    from kaboodle_tpu_torch.sparseplane.runner import sparse_tick_program
    from kaboodle_tpu_torch.warp.runner import leap_cache

    return (sum(c.cache_info().misses for c in _PROGRAM_CACHES + shardpool.PROGRAM_CACHES)
            + leap_cache.misses + sparse_tick_program.cache_info().misses
            + len(_cuda._libs))


def _np_u32(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.int32).view(np.uint32)


class LanePool:
    """E lanes of one N-class: device state + the program set.

    Host-side per-lane run vectors (``active``, ``until_conv``,
    ``remaining``, ``ticks_run``, ``conv_tick`` -- numpy) ride into the
    serve step as inputs and come back as its outputs; the mesh, drop knobs
    and generation counters stay on the device. ``occupied`` is the host
    occupancy map (a lane can be occupied but inactive: parked). The pool
    lives on the card unless ``device`` names another.
    """

    def __init__(
        self,
        n: int,
        lanes: int,
        cfg: SwimConfig | None = None,
        faulty: bool = False,
        telemetry: bool = False,
        chunk: int = 8,
        device=None,
        **state_kwargs,
    ) -> None:
        if n != lane_n_class(n):
            raise ValueError(
                f"pool n={n} is not a pow2 lane class (use lane_n_class)"
            )
        if lanes < 1:
            raise ValueError("need lanes >= 1")
        self.device = resolve_device(device)
        self.n = n
        self.lanes = lanes
        self.cfg = cfg if cfg is not None else SwimConfig(deterministic=True)
        self.faulty = faulty
        self.telemetry = telemetry
        self.chunk = int(chunk)
        self.state_kwargs = dict(state_kwargs)

        fleet = init_fleet(n, lanes, device=self.device, **self.state_kwargs)
        self.mesh = fleet.mesh
        self.drop = fleet.drop_rate
        self.generation = torch.zeros((lanes,), dtype=torch.int32, device=self.device)

        # Host-side per-lane run state (serve-step inputs/outputs).
        self.occupied = np.zeros((lanes,), dtype=bool)
        self.active = np.zeros((lanes,), dtype=bool)
        self.until_conv = np.zeros((lanes,), dtype=bool)
        self.remaining = np.zeros((lanes,), dtype=np.int32)
        self.ticks_run = np.zeros((lanes,), dtype=np.int32)
        self.conv_tick = np.full((lanes,), -1, dtype=np.int32)
        # Accumulated per-lane observability (reset at admission): unicast
        # deliveries always; full ProtocolCounters totals in telemetry mode.
        # Both count densely executed ticks (a leaped span is event-free by
        # construction).
        self.messages = np.zeros((lanes,), dtype=np.int64)
        self.counter_totals: dict[str, np.ndarray] | None = None
        if telemetry:
            from kaboodle_tpu_torch.telemetry.counters import FIELDS

            self.counter_totals = {
                name: np.zeros((lanes,), dtype=np.int64) for name in FIELDS
            }

        # Program set, process-cached: state_kwargs must be hashable
        # (init_state shape knobs -- ints/bools), which the tuple() enforces.
        self._bind_programs(tuple(sorted(self.state_kwargs.items())))

    def _bind_programs(self, kw_items: tuple) -> None:
        """Look up (building on first use) the pool's program set; every
        lifecycle method dispatches through these bindings."""
        self._step = _step_program(
            self.cfg, self.chunk, self.faulty, self.telemetry
        )
        self._reseed = {
            name: _reseed_program(self.n, name, kw_items)
            for name in SCENARIOS
        }
        self._insert = _insert_program()
        self._agree = _agree_program()

    # -- lifecycle ---------------------------------------------------------

    def free_lane(self) -> int | None:
        free = np.flatnonzero(~self.occupied)
        return int(free[0]) if free.size else None

    def occupancy(self) -> tuple[int, int, int]:
        """(occupied, active, lanes) -- the cheap per-pool numbers the
        metrics plane polls every scrape, without building stats()."""
        return int(self.occupied.sum()), int(self.active.sum()), self.lanes

    def admit(
        self,
        lane: int,
        seed: int,
        drop_rate: float = 0.0,
        until_conv: bool = True,
        budget: int = 64,
        scenario: str = "boot",
    ) -> int:
        """Re-seed lane ``lane`` with a request; returns its new generation.

        The retired occupant's state is overwritten in place on the device.
        The lane starts active with a fresh tick budget; its trajectory from
        here is bit-exact with a standalone run of ``init_state(n, seed)``
        under the same knobs."""
        if self.occupied[lane]:
            raise ValueError(f"lane {lane} is occupied")
        if drop_rate and not self.faulty:
            raise ValueError(
                "nonzero drop_rate needs a faulty=True pool (the fault-free "
                "program compiles the knob out, silently ignoring it)"
            )
        self.mesh, self.generation, self.drop = self._reseed[scenario](
            self.mesh, self.generation, self.drop, lane, seed, drop_rate,
        )
        self.occupied[lane] = True
        self.active[lane] = True
        self.until_conv[lane] = bool(until_conv)
        self.remaining[lane] = int(budget)
        self.ticks_run[lane] = 0
        self.conv_tick[lane] = -1
        self.messages[lane] = 0
        if self.counter_totals is not None:
            for col in self.counter_totals.values():
                col[lane] = 0
        return int(self.generation[lane])

    def insert(self, lane: int, member) -> int:
        """Write a restored member state into a free lane (spill return).

        The lane comes back PARKED (occupied, inactive): the caller decides
        whether to resume it with a fresh budget via :meth:`resume`."""
        if self.occupied[lane]:
            raise ValueError(f"lane {lane} is occupied")
        self.mesh, self.generation = self._insert(
            self.mesh, self.generation, lane, member
        )
        self.occupied[lane] = True
        self.active[lane] = False
        return int(self.generation[lane])

    def resume(self, lane: int, until_conv: bool, budget: int) -> None:
        """Re-activate a parked lane with a fresh budget (run counters keep
        accumulating across the park/spill boundary)."""
        if not self.occupied[lane]:
            raise ValueError(f"lane {lane} is free")
        self.active[lane] = True
        self.until_conv[lane] = bool(until_conv)
        self.remaining[lane] = int(budget)

    def park(self, lane: int) -> None:
        self.active[lane] = False

    def run_counters(self, lane: int) -> dict:
        """Lane ``lane``'s host run counters, frozen for a spill. Restoring
        them via :meth:`set_run_counters` is what makes a restore into a
        DIFFERENT lane a true continuation."""
        return {
            "ticks_run": int(self.ticks_run[lane]),
            "conv_tick": int(self.conv_tick[lane]),
            "messages": int(self.messages[lane]),
            "until_conv": bool(self.until_conv[lane]),
            "remaining": int(self.remaining[lane]),
        }

    def set_run_counters(self, lane: int, counters: dict) -> None:
        """Write spilled run counters back into lane ``lane`` (the restore
        half of :meth:`run_counters`)."""
        self.ticks_run[lane] = int(counters["ticks_run"])
        self.conv_tick[lane] = int(counters["conv_tick"])
        self.messages[lane] = int(counters["messages"])
        self.until_conv[lane] = bool(counters["until_conv"])
        self.remaining[lane] = int(counters["remaining"])

    def release(self, lane: int) -> None:
        """Retire a lane: mark it free. The husk state stays resident (and
        frozen -- inactive lanes never advance) until the next re-seed
        overwrites it."""
        self.occupied[lane] = False
        self.active[lane] = False

    def member(self, lane: int):
        """Lane ``lane``'s mesh as a standalone ``MeshState`` on the pool's
        device: a private copy, untouched by later writes to the lane."""
        return _member_fetch()(self.mesh, lane)

    def member_snapshot(self, lane: int):
        """A zero-arg thunk returning lane ``lane``'s member as it is NOW.

        The JAX pool captures the mesh pytree and gathers the lane later on
        the spill worker thread; that is sound there because JAX buffers
        are immutable. This pool writes lanes in place (an admission
        overwrites ``leaf[lane]``), so a deferred gather could read a lane
        the next admission has already re-seeded. The lane is therefore
        cloned here, on the loop thread, on the default stream (queued
        before any later write to it); the thunk hands the clone over, and
        the worker does only the device->host copy and the write."""
        member = self.member(lane)
        return lambda: member

    # -- stepping ----------------------------------------------------------

    def step(self):
        """One serve-step chunk; updates host run vectors.

        Returns the :class:`~kaboodle_tpu_torch.phasegraph.derive.
        ServeStepOut` with numpy leaves (``counters`` as a ``{name:
        int64 [E]}`` dict in telemetry pools, ``gossip_bytes`` unsigned;
        ``done`` is the program's view -- mask with ``occupied & active``
        for harvest decisions)."""
        self.mesh, out = self._step(
            self.mesh, self.drop, self.active, self.until_conv,
            self.remaining, self.ticks_run, self.conv_tick,
        )
        out = _serve_out_to_numpy(out)
        self.remaining = out.remaining.astype(np.int32)
        self.ticks_run = out.ticks_run.astype(np.int32)
        self.conv_tick = out.conv_tick.astype(np.int32)
        self.messages += out.messages.astype(np.int64)
        if self.counter_totals is not None and out.counters is not None:
            for name, col in self.counter_totals.items():
                col += out.counters[name]
        return out

    def counters_row(self, lane: int) -> dict[str, int] | None:
        """Lane ``lane``'s accumulated ProtocolCounters totals (telemetry
        pools only), as a plain dict ready for a manifest record."""
        if self.counter_totals is None:
            return None
        return {k: int(v[lane]) for k, v in self.counter_totals.items()}

    def advance_leaped(self, k_m: np.ndarray) -> None:
        """Account a leap round: per-lane budgets/counters move by ``k_m``
        (the mesh itself was advanced by the masked fleet leap)."""
        k = k_m.astype(np.int32)
        self.remaining = self.remaining - k
        self.ticks_run = self.ticks_run + k

    # -- warp dispatch hooks -----------------------------------------------

    def signature(self):
        """Device ``[E, 4]`` activity signature rows (one fetch by the
        caller); the engine's leap classifier reads these."""
        return _fleet_signature(self.cfg)(self.mesh)

    def leap(self, K: int, k_m: np.ndarray, memo=None) -> tuple[int, bool]:
        """One masked fleet-leap call (bucket ``K``): every lane advances
        its own ``k_m[e] <= K`` ticks; ``k_m[e] == 0`` freezes the lane
        bit-exactly. Host budget accounting is the caller's
        :meth:`advance_leaped` -- this moves only the device mesh.

        With a ``SpanMemo``, the round goes through
        :func:`~kaboodle_tpu_torch.warp.runner.memo_fleet_leap`: per-lane
        span deltas are keyed by (entry-row digest, ``k_m[e]``), so a drain
        one lane already computed replays as a host XOR on every other
        lane, and when ALL leaping lanes hit, the leap is skipped outright.
        Returns ``(memo_hits, dispatched)`` (``(0, True)`` without a
        memo)."""
        from kaboodle_tpu_torch.warp.runner import _get_fleet_leap, memo_fleet_leap

        prog = _get_fleet_leap(self.cfg, K)
        if memo is None:
            self.mesh = prog(self.mesh, torch.as_tensor(np.asarray(k_m), dtype=torch.int32,
                                                        device=self.device))
            return 0, True
        family = repr((self.cfg, "serve"))
        self.mesh, hits, dispatched = memo_fleet_leap(
            family, self.mesh, np.asarray(k_m), memo, prog
        )
        return hits, dispatched

    def agreement(self):
        """End-state agreement rows ``(converged, fp_min, fp_max, n_alive)``
        as numpy (fingerprints uint32) -- the harvest statistics fetch."""
        conv, fp_min, fp_max, n_alive = self._agree(self.mesh)
        return (conv.cpu().numpy(), _np_u32(fp_min), _np_u32(fp_max),
                n_alive.cpu().numpy())

    def fleet_state(self) -> FleetState:
        """The resident as a ``FleetState`` (checkpoint.save_fleet input)."""
        return FleetState(mesh=self.mesh, drop_rate=self.drop)

    def load_fleet_state(self, fleet: FleetState, generation) -> None:
        """Adopt a checkpointed resident (checkpoint.load_fleet output, from
        either package), generation counters included. The leaves are
        copied onto the pool's device: the pool writes lanes in place and
        must not write into the caller's tensors."""
        if fleet.n != self.n or fleet.ensemble != self.lanes:
            raise ValueError(
                f"checkpoint shape [{fleet.ensemble}]xN{fleet.n} != pool "
                f"[{self.lanes}]xN{self.n}"
            )
        self.mesh = dataclasses.replace(fleet.mesh, **{
            f.name: getattr(fleet.mesh, f.name).to(self.device, copy=True)
            for f in dataclasses.fields(MeshState) if getattr(fleet.mesh, f.name) is not None
        })
        self.drop = fleet.drop_rate.to(self.device, dtype=torch.float32, copy=True)
        self.generation = torch.as_tensor(
            np.asarray(generation.cpu() if isinstance(generation, torch.Tensor) else generation,
                       dtype=np.int32), device=self.device).clone()

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> None:
        """Build the pool's whole program set with the JAX pool's
        state-preserving calls: the serve step with every lane inactive
        (the masked loop exits at entry, mesh untouched), each reseed
        scenario on lane 0 (lane 0 is free pre-admission; the husk is
        overwritten), the insert program re-writing lane 0 with its own
        member state, and the gather/agreement fetches. Lane 0's generation
        ends 3 higher (two reseeds, one insert), as in the JAX pool."""
        if self.occupied.any():
            raise ValueError("warm up before admitting requests")
        self.step()
        for name in SCENARIOS:
            self.mesh, self.generation, self.drop = self._reseed[name](
                self.mesh, self.generation, self.drop, 0, 0, 0.0,
            )
        member0 = self.member(0)
        self.mesh, self.generation = self._insert(
            self.mesh, self.generation, 0, member0
        )
        self.agreement()

    def close(self, error: str | None = None) -> None:
        """Release what the pool holds besides its tensors (``ServeEngine.close``
        calls it; ``error`` says why a failing caller closes): nothing, for
        a single-device pool."""

    def stats(self) -> dict:
        return {
            "n": self.n,
            "lanes": self.lanes,
            "occupied": int(self.occupied.sum()),
            "active": int(self.active.sum()),
            "faulty": self.faulty,
            "telemetry": self.telemetry,
            "chunk": self.chunk,
            "generation": self.generation.cpu().numpy().tolist(),
        }


def _serve_out_to_numpy(out):
    """A ``ServeStepOut`` with numpy leaves: the vectors as they are,
    ``counters`` as ``{name: int64 [E]}`` with ``gossip_bytes`` unsigned
    (the JAX package's uint32 values), or ``None``."""
    from kaboodle_tpu_torch.phasegraph.derive import ServeStepOut
    from kaboodle_tpu_torch.telemetry.counters import FIELDS

    counters = None
    if out.counters is not None:
        counters = {}
        for name in FIELDS:
            a = getattr(out.counters, name).cpu().numpy()
            if name == "gossip_bytes":
                a = a.astype(np.int32).view(np.uint32)
            counters[name] = a.astype(np.int64)
    return ServeStepOut(
        remaining=out.remaining.cpu().numpy(), ticks_run=out.ticks_run.cpu().numpy(),
        conv_tick=out.conv_tick.cpu().numpy(), done=out.done.cpu().numpy(),
        messages=out.messages.cpu().numpy(), counters=counters)


@dataclasses.dataclass
class HarvestRow:
    """One finished lane's harvest statistics (host-side, event material)."""

    lane: int
    generation: int
    ticks_run: int
    conv_tick: int
    converged: bool
    fp_min: int
    fp_max: int
    n_alive: int
