"""KB405: the compile-surface budget -- count programs built, gate growth.

The port of the JAX package's ``analysis/ir/surface.py``. Memoization-based
simulators get their speed from a small, stable set of built programs; a
rebuild storm (a spurious cache key, a span-chunking policy that degrades
to one program per span length) is invisible to unit tests -- everything
still passes, just slower. The JAX module counts fresh XLA compilations;
the port builds programs instead of compiling them, so its counter reads
the growth of :func:`~kaboodle_tpu_torch.serve.pool.program_builds`
(misses of the pool's program caches, the sharded pool's included, of the
warp leap cache and of the sparse tick cache, plus the CUDA kernel
libraries built or loaded). This module:

- provides :func:`compile_counter` (the serve drivers' zero-rebuild gates,
  ``compiles_steady == 0``, read it) and :func:`assert_counter_live`;
- defines the scripted dense+warp+fleet+serve+sparse **exercise** -- the
  JAX package's fixed sequence of representative dispatches per
  entry-point family, at its sizes -- and measures how many programs each
  family builds (:func:`measure_surface`);
- loads/writes the committed budget ``kaboodle_tpu_torch/analysis/ir/
  surface.json`` and turns measured-vs-committed deltas into KB405
  findings (:func:`surface_findings`).

A family whose dispatches go through no program cache commits 0 (the
dense tick and the fleet tick: ``make_tick_fn`` builds a closure, not a
cached program); its budget's reason says so. The exercises keep the
kernel flags off, as the JAX exercise does, so the counts are the same on
the card and on the CPU. The committed counts are those of a FRESH process
running the whole script in order (``python -m kaboodle_tpu_torch.analysis
--ir``); in-process callers (tests) use the machinery with their own
exercises and budgets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import pathlib
from typing import Callable, Iterator, Sequence

DEFAULT_SURFACE = "kaboodle_tpu_torch/analysis/ir/surface.json"

# Mesh sizes for the liveness probe's fresh programs: odd, so never a pool's
# class (classes are powers of two), and never the same twice.
_PROBE_N = itertools.count(3, 2)


class CompileCount:
    """Programs built since the block opened; frozen when it closes."""

    def __init__(self) -> None:
        self._base = _builds()
        self._final: int | None = None

    @property
    def count(self) -> int:
        return (_builds() if self._final is None else self._final) - self._base

    def _close(self) -> None:
        self._final = _builds()


def _builds() -> int:
    from kaboodle_tpu_torch.serve.pool import program_builds

    return program_builds()


@contextlib.contextmanager
def compile_counter() -> Iterator[CompileCount]:
    """Count the programs built inside the block (cache hits: zero). Nestable."""
    box = CompileCount()
    try:
        yield box
    finally:
        box._close()


def assert_counter_live() -> None:
    """Fail loudly if the build count does not move when a program is built.

    A probe builds one fresh program (a re-seed program for a mesh size no
    pool serves, so never a cache hit) and must register before any
    zero-recompile measurement is trusted: a dead counter would make every
    such gate pass vacuously."""
    from kaboodle_tpu_torch.serve.pool import _reseed_program

    with compile_counter() as box:
        _reseed_program(next(_PROBE_N), "boot", ())
    if box.count == 0:
        raise RuntimeError(
            "the program-build count did not move when a fresh program was "
            "built: zero-recompile counts would be vacuously 0"
        )


# ---------------------------------------------------------------------------
# the scripted exercise

_EX_N = 32  # exercise mesh size (the program count is N-free)
_EX_E = 4  # fleet ensemble width


@dataclasses.dataclass(frozen=True)
class SurfaceExercise:
    """One entry-point family: a scripted run whose build count is gated.

    ``prep(device)`` builds states/inputs on ``device`` (not counted);
    ``run(ctx)`` dispatches the entry points under the counter."""

    name: str
    prep: Callable[[object], object]
    run: Callable[[object], None]


def _cfg():
    from kaboodle_tpu_torch.config import SwimConfig

    return SwimConfig(deterministic=True)


def _prep_dense(dev):
    import torch

    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick
    from kaboodle_tpu_torch.sim.state import idle_inputs, init_state

    cfg, n = _cfg(), _EX_N
    idle = idle_inputs(n, device=dev)

    def variant(**at):
        (name, (i, v)), = at.items()
        x = getattr(idle, name).clone()
        x[i] = v
        return dataclasses.replace(idle, **{name: x})

    variants = (
        idle, variant(kill=(1, True)), variant(revive=(1, True)),
        variant(manual_target=(0, 3)),
        dataclasses.replace(idle, drop_rate=idle.drop_rate + 0.1),
    )
    return {
        "tick": make_dense_tick(cfg, faulty=True),
        "fast": make_dense_tick(cfg, faulty=False),
        "lean": make_dense_tick(cfg, faulty=False),
        "st": init_state(n, seed=0, device=dev),
        "stf": init_state(n, seed=1, device=dev),
        "stl": init_state(n, seed=2, timer_dtype=torch.int16, track_latency=False,
                          instant_identity=True, device=dev),
        "idle": idle,
        "variants": variants,
    }


def _run_dense(ctx) -> None:
    """The dense tick across its input envelope: idle / kill / revive /
    manual / nonzero drop, the fault-free and the lean builds. The port's
    tick is a closure built once (``make_tick_fn``), not a cached program:
    its dispatches build nothing, so the budget is 0."""
    st = ctx["st"]
    for inp in ctx["variants"]:
        st, _ = ctx["tick"](st, inp)
    stf, stl = ctx["stf"], ctx["stl"]
    for _ in range(2):
        stf, _ = ctx["fast"](stf, ctx["idle"])
    for _ in range(2):
        stl, _ = ctx["lean"](stl, ctx["idle"])


def _prep_warp(dev):
    import torch

    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.fleet.core import FleetState
    from kaboodle_tpu_torch.phasegraph.derive import make_dense_tick
    from kaboodle_tpu_torch.sim.scenario import Scenario
    from kaboodle_tpu_torch.sim.state import idle_inputs, init_state
    from kaboodle_tpu_torch.warp import runner
    from kaboodle_tpu_torch.warp.horizon import decode_signature, make_signature_fn

    # Start from a cold leap cache so the count is the runner's own surface.
    runner.leap_cache.clear()
    n, ticks = _EX_N, 24
    idle = idle_inputs(n, ticks=ticks, device=dev)
    kill = idle.kill.clone()
    kill[8, 1] = True  # one mid-run fault: leap -> drain window -> leap
    inputs = dataclasses.replace(idle, kill=kill)
    # A mid-drain near-quiescent state (two dead peers, every survivor's
    # cell for them armed) under a drain-shaped config, plus a two-member
    # fleet (one converged, one mid-drain). Prep ticking is not counted.
    cfg2 = SwimConfig(deterministic=True, ping_timeout_ticks=64)
    st2 = init_state(n, seed=3, ring_contacts=n - 1, announced=True, device=dev)
    st2, _ = make_dense_tick(cfg2, faulty=True)(
        st2, Scenario(n, 1, seed=0).kill_at(0, [2, 9]).build(device=dev).at(0))
    tick0 = make_dense_tick(cfg2, faulty=False)
    sig = make_signature_fn(cfg2)
    idle1 = idle_inputs(n, device=dev)
    for _ in range(40):
        if decode_signature(sig(st2)).mode == "hybrid":
            break
        st2, _ = tick0(st2, idle1)
    members = [init_state(n, seed=0, ring_contacts=n - 1, announced=True, device=dev), st2]
    fleet = FleetState(
        mesh=dataclasses.replace(members[0], **{
            f.name: torch.stack([getattr(m, f.name) for m in members])
            for f in dataclasses.fields(members[0]) if getattr(members[0], f.name) is not None
        }),
        drop_rate=torch.zeros((2,), dtype=torch.float32, device=dev),
    )
    return {
        "st": init_state(n, seed=0, ring_contacts=n - 1, announced=True, device=dev),
        "inputs": inputs,
        "cfg2": cfg2,
        "drain": st2,
        "fleet": fleet,
    }


def _run_warp(ctx) -> None:
    """The warp runner over a converged mesh and a sparse-fault schedule:
    the bucketed power-of-two leap programs, strict AND hybrid. Two run
    lengths whose span decompositions share chunks (48 = 32+16, 44 = 32+8
    and 4 dense remainder ticks) prove the bucketing bounds the cache; the
    regression this guards is one program per distinct span length. The
    post-kill drain drives the hybrid family, and one per-member fleet warp
    round the masked fleet leap."""
    from kaboodle_tpu_torch.warp.runner import run_fleet_warped, run_warped, simulate_warped

    cfg = _cfg()
    st = ctx["st"]
    run_warped(st, cfg, ticks=48, recheck_every=8)
    run_warped(st, cfg, ticks=44, recheck_every=8)
    simulate_warped(st, ctx["inputs"], cfg, faulty=True, recheck_every=8)
    run_warped(ctx["drain"], ctx["cfg2"], ticks=40, recheck_every=8)
    run_warped(ctx["drain"], ctx["cfg2"], ticks=24, recheck_every=8)
    run_fleet_warped(ctx["fleet"], ctx["cfg2"], ticks=16, recheck_every=8)


def _prep_fleet(dev):
    import torch

    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet

    n, e = _EX_N // 2, _EX_E
    return {
        "fleet": init_fleet(n, e, device=dev),
        "fleet2": init_fleet(n, e, drop_rates=torch.linspace(0.0, 0.2, e), device=dev),
        "inputs": fleet_idle_inputs(n, e, ticks=4, device=dev),
    }


def _run_fleet(ctx) -> None:
    """The ensemble: one fleet tick advances all members, and a second run
    with other per-member knobs reuses it. The fleet tick is a closure built
    per call (``make_tick_fn``), not a cached program: budget 0."""
    from kaboodle_tpu_torch.fleet.core import simulate_fleet

    cfg = _cfg()
    simulate_fleet(ctx["fleet"], ctx["inputs"], cfg, faulty=True)
    simulate_fleet(ctx["fleet2"], ctx["inputs"], cfg, faulty=True)


def _prep_serve(dev):
    from kaboodle_tpu_torch.serve import pool as pool_mod
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.warp import runner

    # The serve engine warms its own leap buckets and signature program;
    # start from cold caches so the count is the serve surface, not what
    # the warp exercise left behind.
    runner.leap_cache.clear()
    pool_mod._fleet_signature.cache_clear()
    return {"pool": pool_mod.LanePool, "engine": ServeEngine, "request": ServeRequest,
            "dev": dev}


def _run_serve(ctx) -> None:
    """The serving surface: a pool (its constructor looks up the program
    set: the step, the boot and steady reseeds, the insert, the agreement),
    the engine's warmup (the member gather, the signature, leap buckets
    8/16), then two admit -> converge -> re-seed cycles through one lane and
    a horizon request that rides the leap. Everything is built by warmup's
    end: growth here is a rebuild after warmup."""
    request = ctx["request"]
    n = _EX_N // 2
    pool = ctx["pool"](n, _EX_E, cfg=_cfg(), chunk=4, device=ctx["dev"])
    engine = ctx["engine"]([pool], warp=True, max_leap=16)
    engine.warmup()
    for seed in (0, 1):
        engine.submit(request(n=n, seed=seed))
        engine.drain()
    engine.submit(request(n=n, seed=2, mode="ticks", ticks=24, scenario="steady"))
    engine.drain()


def _prep_sparse(dev):
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.sparseplane import SparseSpec, init_sparse_state, sparse_idle_inputs

    n = _EX_N
    cfg = SwimConfig(deterministic=True, join_broadcast_enabled=False)
    spec = SparseSpec(k=8, gossip_fanout=2, boot_contacts=2)
    lean = SparseSpec(k=8, gossip_fanout=2, boot_contacts=2, timer_dtype="int16")
    idle = sparse_idle_inputs(n, ticks=4, device=dev)

    def variant(name, t, i):
        x = getattr(idle, name).clone()
        x[t, i] = True
        return dataclasses.replace(idle, **{name: x})

    variants = (
        idle, variant("kill", 1, 2), variant("revive", 2, 2),
        dataclasses.replace(idle, drop_rate=idle.drop_rate + 0.1),
    )
    return {
        "cfg": cfg, "spec": spec, "lean": lean, "dev": dev,
        "st": init_sparse_state(n, spec, seed=0, device=dev),
        "st2": init_sparse_state(n, spec, seed=7, device=dev),
        "stl": init_sparse_state(n, lean, seed=0, device=dev),
        "variants": variants,
    }


def _run_sparse(ctx) -> None:
    """The blocked_topk engine: the sparse tick across its input envelope
    (idle / kill / revive / nonzero drop share one program), the lean int16
    build, and the converge runner twice from different data."""
    from kaboodle_tpu_torch.sparseplane import run_sparse_until_converged, simulate_sparse

    cfg, spec, dev = ctx["cfg"], ctx["spec"], ctx["dev"]
    st = ctx["st"]
    for inp in ctx["variants"]:
        st, _ = simulate_sparse(st, inp, cfg, spec, device=dev)
    simulate_sparse(ctx["stl"], ctx["variants"][0], cfg, ctx["lean"], device=dev)
    run_sparse_until_converged(ctx["st"], cfg, spec, max_ticks=64, device=dev)
    run_sparse_until_converged(ctx["st2"], cfg, spec, max_ticks=64, device=dev)


EXERCISES: tuple[SurfaceExercise, ...] = (
    SurfaceExercise("dense", _prep_dense, _run_dense),
    SurfaceExercise("warp", _prep_warp, _run_warp),
    SurfaceExercise("fleet", _prep_fleet, _run_fleet),
    SurfaceExercise("serve", _prep_serve, _run_serve),
    SurfaceExercise("sparse", _prep_sparse, _run_sparse),
)


def measure_surface(
    exercises: Sequence[SurfaceExercise] | None = None,
    device=None,
) -> dict[str, int]:
    """Run the scripted exercises in order on ``device`` (the card unless
    told otherwise); programs built per family. Prep runs outside the
    counter, so the counts track entry-point programs, not set-up."""
    from kaboodle_tpu_torch.sim.state import resolve_device

    dev = resolve_device(device)
    assert_counter_live()
    out: dict[str, int] = {}
    for ex in exercises if exercises is not None else EXERCISES:
        ctx = ex.prep(dev)
        with compile_counter() as box:
            ex.run(ctx)
        out[ex.name] = box.count
    return out


# ---------------------------------------------------------------------------
# committed budget file


def load_surface(path: pathlib.Path) -> dict[str, tuple[int, str]]:
    """entry -> (programs, reason). Missing file = empty budget; malformed
    entries (no name/count/justification) are hard errors, like the lint
    baseline -- the justification is the point of the file."""
    from kaboodle_tpu_torch.analysis.core import BaselineError

    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise BaselineError(f"{path}: invalid JSON: {e}") from e
    entries = data.get("entries") if isinstance(data, dict) else None
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected an object with an 'entries' list")
    out: dict[str, tuple[int, str]] = {}
    for i, e in enumerate(entries):
        if (
            not isinstance(e, dict)
            or not e.get("entry")
            or not isinstance(e.get("programs"), int)
            or not str(e.get("reason", "")).strip()
        ):
            raise BaselineError(
                f"{path}: entries[{i}] needs 'entry', integer 'programs', and "
                "a non-empty 'reason' justification"
            )
        out[str(e["entry"])] = (int(e["programs"]), str(e["reason"]))
    return out


def write_surface(
    path: pathlib.Path,
    measured: dict[str, int],
    old: dict[str, tuple[int, str]],
) -> None:
    """Regenerate the budget from measured counts, keeping old reasons."""
    payload = {
        "comment": (
            "compile-surface budget: programs built per entry-point family "
            "(misses of the program caches that serve.pool.program_builds "
            "counts) across the scripted dense+warp+fleet+serve+sparse "
            "exercise (fresh process -- `python -m kaboodle_tpu_torch.analysis "
            "--ir`). The gate fails on growth; raising a count requires "
            "editing this file with a justification. Shrink when the measured "
            "count drops."
        ),
        "entries": [
            {
                "entry": name,
                "programs": count,
                "reason": old.get(name, (0, "TODO: justify this budget"))[1],
            }
            for name, count in sorted(measured.items())
        ],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def surface_findings(
    measured: dict[str, int],
    committed: dict[str, tuple[int, str]],
    no_growth: bool = False,
) -> list:
    """Measured-vs-committed deltas as KB405 findings.

    Growth (or a family missing from the file) always fails; shrink fails
    only under ``--no-baseline-growth`` -- the same monotonic-debt contract
    as the lint baseline, so the committed counts can only ratchet down."""
    from kaboodle_tpu_torch.analysis.core import Finding

    out = []
    for name, count in sorted(measured.items()):
        if name not in committed:
            out.append(Finding(
                f"ir://surface.{name}", "KB405", 0,
                f"no committed budget for '{name}' ({count} programs measured) "
                "-- run --write-surface and justify the entry",
                f"surface:{name}:missing",
            ))
            continue
        budget, _reason = committed[name]
        if count > budget:
            out.append(Finding(
                f"ir://surface.{name}", "KB405", 0,
                f"compile surface grew: {count} programs vs committed {budget} "
                "-- a rebuild regression, or raise the budget in "
                f"{DEFAULT_SURFACE} with a justification",
                f"surface:{name}:growth",
            ))
        elif count < budget and no_growth:
            out.append(Finding(
                f"ir://surface.{name}", "KB405", 0,
                f"compile surface shrank: {count} programs vs committed {budget} "
                "-- commit the smaller count (--write-surface)",
                f"surface:{name}:stale",
            ))
    if no_growth:
        for name in sorted(set(committed) - set(measured)):
            out.append(Finding(
                f"ir://surface.{name}", "KB405", 0,
                f"stale surface entry '{name}': family no longer measured "
                f"-- delete it from {DEFAULT_SURFACE}",
                f"surface:{name}:orphan",
            ))
    return out
