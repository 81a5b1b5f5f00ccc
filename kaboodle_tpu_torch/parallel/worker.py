"""One rank of a multi-process run: a table of cases over one process group.

    python -m kaboodle_tpu_torch.parallel.worker <rank> <world> <port> <case-file>

The port's counterpart of ``scripts/multihost_worker.py``. Every process
of the job runs this with its own ``rank``, the same ``world``, ``port``
and case file: they join one group at ``tcp://127.0.0.1:<port>`` (gloo on
the CPU, NCCL on the card, as the case file's ``device`` says), run every
case in order and print one line a case (``<port>`` ``env`` joins through
``torchrun``'s environment instead, ``plain`` calls
``make_multihost_mesh()`` with no arguments and no launcher)::

    KBCASE {"case": name, "rank": r, ...digest...}

The case file is JSON: ``{"device": "cpu", "timeout_s": 120, "cases":
[{"name": ..., "kind": ..., ...}, ...]}``. Each case states its kind and
its inputs (configs as ``SwimConfig`` keyword dicts, ``init_state``
keyword dicts, stacked ``TickInputs`` as ``.npz`` paths); where it names
an ``out`` path, rank 0 writes the whole result there as ``.npz`` (the
state's leaves in the JAX package's layout, the metrics, the counters).
The digests carry a blake2b of every gathered leaf, so the ranks can be
held equal to each other. This module imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel.collectives import gather_rows
from kaboodle_tpu_torch.parallel.mesh import (
    constrain_state,
    gather_state,
    make_multihost_mesh,
    make_sharded_tick,
    mesh_device,
    peer_group,
    run_until_converged_sharded,
    shard_inputs,
    shard_state,
    sharded_convergence_check,
    simulate_sharded,
)
from kaboodle_tpu_torch.sim.runner import _stack
from kaboodle_tpu_torch.sim.state import (
    MeshState,
    TickMetrics,
    idle_inputs,
    init_state,
    inputs_from_numpy,
    metrics_to_numpy,
    state_to_numpy,
)


def _digest(arrays: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(arrays):
        a = arrays[k]
        if a is None:
            continue
        h.update(k.encode() + b"\0" + np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _state_arrays(st: MeshState, prefix: str = "state.") -> dict:
    return {prefix + k: v for k, v in state_to_numpy(st).items() if v is not None}


def _init(case) -> dict:
    """A case's ``init_state`` keywords (a ``timer_dtype`` named as a string)."""
    kw = dict(case.get("init", {}))
    if isinstance(kw.get("timer_dtype"), str):
        kw["timer_dtype"] = getattr(torch, kw["timer_dtype"])
    return kw


def _load_inputs(path: str, device):
    with np.load(path) as z:
        return inputs_from_numpy({k: z[k] for k in z.files}, device=device)


class _MaxOutput(TorchDispatchMode):
    """A dispatch mode that records the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0
        self.op = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.numel() > self.largest:
                self.largest, self.op = leaf.numel(), str(func)
        return out


def _case_simulate(case, mesh, dev) -> dict:
    """A row-sharded run of stacked inputs (``telemetry`` selects the
    telemetry tick); rank 0 writes the whole final state and the metrics."""
    from kaboodle_tpu_torch.telemetry.counters import ProtocolCounters

    cfg = SwimConfig(**case.get("cfg", {}))
    st = shard_state(init_state(case["n"], device=dev, **_init(case)), mesh)
    inp = shard_inputs(_load_inputs(case["inputs"], dev), mesh, stacked=True)
    telemetry = bool(case.get("telemetry", False))
    tick = make_sharded_tick(cfg, mesh, faulty=case.get("faulty", True), telemetry=telemetry)
    mode = _MaxOutput() if case.get("measure_outputs") else None
    metrics, counters, fps = [], [], []
    for t in range(inp.kill.shape[0]):
        with mode if mode is not None else contextlib.nullcontext():
            st, out = tick(st, inp.at(t))
        if telemetry:
            metrics.append(out.metrics)
            counters.append(out.counters)
            fps.append(out.fp)
        else:
            metrics.append(out)
    full = gather_state(st, mesh)
    arrays = _state_arrays(full)
    arrays.update({"metrics." + k: v
                   for k, v in metrics_to_numpy(_stack(TickMetrics, metrics)).items()})
    if telemetry:
        ctr = _stack(ProtocolCounters, counters)
        arrays.update({"counters." + f.name: getattr(ctr, f.name).cpu().numpy()
                       for f in dataclasses.fields(ProtocolCounters)})

        fp = torch.stack([gather_rows(f, peer_group(mesh)) for f in fps])
        arrays["fp"] = fp.cpu().numpy().view(np.uint32)
    digest = {"digest": _digest(arrays),
              "messages": arrays["metrics.messages_delivered"].tolist(),
              "fp_min": arrays["metrics.fingerprint_min"].tolist(),
              "fp_max": arrays["metrics.fingerprint_max"].tolist(),
              "converged": arrays["metrics.converged"].tolist(),
              "final_tick": int(full.tick),
              "rows": int(st.state.shape[-2])}
    if mode is not None:
        digest["largest_output"] = mode.largest
        digest["largest_op"] = mode.op
    return {"arrays": arrays, "digest": digest}


def _case_converge(case, mesh, dev) -> dict:
    """``run_until_converged_sharded`` from an ``init_state``."""

    cfg = SwimConfig(**case.get("cfg", {}))
    st = shard_state(init_state(case["n"], device=dev, **_init(case)), mesh)
    out, ticks, conv = run_until_converged_sharded(st, cfg, mesh, max_ticks=case["max_ticks"])
    check = bool(sharded_convergence_check(out, mesh)[0])
    arrays = _state_arrays(gather_state(out, mesh))
    arrays["ticks"] = np.asarray(ticks)
    arrays["converged"] = np.asarray(conv)
    return {"arrays": arrays, "digest": {"digest": _digest(arrays), "ticks": int(ticks),
                                         "converged": bool(conv), "check": check}}


def _case_divisible(case, mesh, dev) -> dict:
    """``shard_state`` / ``shard_inputs`` of an N the mesh does not divide:
    both must raise ``ValueError`` before any collective."""

    raised = []
    for fn, arg in ((shard_state, init_state(case["n"], device=dev)),
                    (shard_inputs, idle_inputs(case["n"], device=dev))):
        try:
            fn(arg, mesh)
            raised.append(False)
        except ValueError:
            raised.append(True)
    return {"digest": {"raised": raised}}


def _case_constrain(case, mesh, dev) -> dict:
    """``constrain_state`` refuses a whole state where the rank's rows belong
    (and so does the sharded tick), and passes the rank's rows."""

    whole = init_state(case["n"], device=dev)
    try:
        constrain_state(whole, mesh)
        refused = False
    except ValueError:
        refused = True
    constrain_state(shard_state(whole, mesh), mesh)
    return {"digest": {"refused": refused}}


def _warp_start(case, dev):
    """The whole entry state of a warp case: a converged mesh, or a drain
    (``victims`` killed, then dense ticks until the signature classes it
    ``hybrid``), made by the dense tick on every rank alike."""
    from kaboodle_tpu_torch.phasegraph.exec import make_tick_fn
    from kaboodle_tpu_torch.warp import horizon

    cfg = SwimConfig(**case.get("cfg", {}))
    n = case["n"]
    st = init_state(n, device=dev, ring_contacts=n - 1, announced=True, **_init(case))
    if case.get("victims"):
        kill = idle_inputs(n, device=dev)
        kill.kill = kill.kill.clone()
        kill.kill[list(case["victims"])] = True
        st = make_tick_fn(cfg, faulty=True)(st, kill)[0]
        sig, tick, idle = horizon.make_signature_fn(cfg), make_tick_fn(cfg, faulty=False), \
            idle_inputs(n, device=dev)
        while horizon.decode_signature(sig(st)).mode != "hybrid":
            st = tick(st, idle)[0]
    return cfg, st


def _case_warp(case, mesh, dev) -> dict:
    """``run_warped(mesh=)`` (or ``simulate_warped(mesh=)`` over ``inputs``)
    against the row-sharded dense tick over the same ticks; with ``memo`` a
    second, replayed pass too. Rank 0 writes the gathered warped state."""
    from kaboodle_tpu_torch.warp import runner

    cfg, whole = _warp_start(case, dev)
    st = shard_state(whole, mesh)
    led = runner.WarpLedger()
    memo = runner.SpanMemo() if case.get("memo") else None
    if case.get("inputs"):
        inp = shard_inputs(_load_inputs(case["inputs"], dev), mesh, stacked=True)
        ticks = int(inp.kill.shape[0])
        out, dense_ticks, _ = runner.simulate_warped(st, inp, cfg, recheck_every=4, ledger=led,
                                                     memo=memo, mesh=mesh)
        faulty = True
    else:
        ticks = case["ticks"]
        inp = None
        out, ran, conv = runner.run_warped(st, cfg, ticks, recheck_every=4, ledger=led,
                                           memo=memo, mesh=mesh)
        assert ran == ticks
        faulty = False
    tick = make_sharded_tick(cfg, mesh, faulty=faulty)
    ref = st
    idle = idle_inputs(st.state.shape[-2], device=dev)
    for t in range(ticks):
        ref = tick(ref, idle if inp is None else inp.at(t))[0]
    replay_equal = None
    if memo is not None:
        if inp is None:
            again = runner.run_warped(st, cfg, ticks, recheck_every=4, memo=memo, mesh=mesh)[0]
        else:
            again = runner.simulate_warped(st, inp, cfg, recheck_every=4, memo=memo,
                                           mesh=mesh)[0]
        replay_equal = _digest(_state_arrays(gather_state(again, mesh))) == _digest(
            _state_arrays(gather_state(out, mesh)))
    got = _state_arrays(gather_state(out, mesh))
    want = _state_arrays(gather_state(ref, mesh))
    engines = sorted({r["engine"] for r in led.spans})
    return {"arrays": got, "digest": {
        "digest": _digest(got), "equal_sharded_dense": _digest(got) == _digest(want),
        "engines": engines, "per_class": json.loads(json.dumps(led.per_class())),
        "replay_equal": replay_equal,
        "memo_hits": None if memo is None else memo.stats()["hits"]}}


def _case_fleet(case, mesh_unused, dev) -> dict:
    """A sharded fleet over a mesh of every rank: ``simulate_fleet_sharded``
    on the 1-D ensemble mesh (``peer_devices`` 1) or the masked
    ``run_fleet_until_converged_sharded`` (``max_ticks``) on either mesh.
    Rank 0 writes the gathered fleet (and ``conv_tick`` / ``done``)."""
    from kaboodle_tpu_torch.fleet.core import fleet_idle_inputs, init_fleet
    from kaboodle_tpu_torch.fleet.sharding import (
        ENSEMBLE_AXIS,
        gather_fleet,
        make_fleet_mesh,
        run_fleet_until_converged_sharded,
        shard_fleet,
        shard_fleet_inputs,
        simulate_fleet_sharded,
    )

    cfg = SwimConfig(**case.get("cfg", {}))
    fmesh = make_fleet_mesh(peer_devices=case.get("peer_devices", 1), device=dev.type)
    n, e = case["n"], case["ensemble"]
    fleet = shard_fleet(init_fleet(n, e, device=dev, **_init(case)), fmesh)
    arrays = {}
    if case.get("max_ticks"):
        fleet, conv_tick, done = run_fleet_until_converged_sharded(
            fleet, cfg, fmesh, max_ticks=case["max_ticks"], faulty=case.get("faulty", False))
        group = fmesh.get_group(ENSEMBLE_AXIS)
        arrays["conv_tick"] = gather_rows(conv_tick, group).cpu().numpy()
        arrays["done"] = gather_rows(done, group).cpu().numpy()
    else:
        inp = shard_fleet_inputs(fleet_idle_inputs(n, e, ticks=case["ticks"], device=dev),
                                 fmesh, stacked=True)
        fleet, m = simulate_fleet_sharded(fleet, inp, cfg, fmesh, faulty=case.get("faulty", True))
        group = fmesh.get_group(ENSEMBLE_AXIS)
        arrays["converged"] = gather_rows(m.converged, group).cpu().numpy()
    whole = gather_fleet(fleet, fmesh)
    arrays.update(_state_arrays(whole.mesh))
    return {"arrays": arrays, "digest": {"digest": _digest(arrays),
                                         "local_members": int(fleet.mesh.alive.shape[0]),
                                         "local_rows": int(fleet.mesh.state.shape[-2])}}


def _case_fleet_checks(case, mesh, dev) -> dict:
    """The fleet layer's refusals, each raised before any collective: an E
    the ensemble axis does not divide, an N the peer axis does not divide,
    a mesh bigger than the job."""
    from kaboodle_tpu_torch.fleet.core import init_fleet
    from kaboodle_tpu_torch.fleet.sharding import make_fleet_mesh, shard_fleet

    world = dist.get_world_size()
    one_d = make_fleet_mesh(device=dev.type)
    two_d = make_fleet_mesh(world // 2, 2, device=dev.type)
    raised = []
    for fmesh, (n, e) in ((one_d, (16, world + 2)), (two_d, (17, world // 2))):
        fleet = init_fleet(n, e, device=dev)
        try:
            shard_fleet(fleet, fmesh)
            raised.append(False)
        except ValueError:
            raised.append(True)
    try:
        make_fleet_mesh(world - 1, 2, device=dev.type)
        raised.append(False)
    except ValueError:
        raised.append(True)
    return {"digest": {"raised": raised}}


def _case_sweep(case, mesh, dev) -> dict:
    """``fleet/bench.py``'s sweep with ``--shard ensemble`` over every rank."""
    from kaboodle_tpu_torch.fleet.bench import build_parser, run_sweep

    line = run_sweep(build_parser().parse_args([*case["argv"], "--shard", "ensemble",
                                                "--device", dev.type]))
    return {"digest": {"line": {k: v for k, v in line.items() if k != "wall_s"}}}


def _case_checkpoint(case, mesh, dev) -> dict:
    """The sharded checkpoint paths. ``op``: ``load_npz`` (``load(mesh=)`` of
    an archive, each rank its rows), ``save_npz`` (a sharded run saved with
    ``save(mesh=)``), ``save_async`` (the same run through DCP) or
    ``load_dcp`` (``load_orbax(mesh=)`` of a DCP directory, a ``meta``
    template). Rank 0 writes the gathered state it holds."""
    from kaboodle_tpu_torch import checkpoint

    op = case["op"]
    digest = {}
    if op == "load_npz":
        st = checkpoint.load(case["path"], mesh=mesh)
        whole = checkpoint.load(case["path"], device=dev)
        digest["rows_equal"] = _digest(_state_arrays(st)) == _digest(
            _state_arrays(shard_state(whole, mesh)))
        digest["rows"] = int(st.state.shape[-2])
    elif op in ("save_npz", "save_async"):
        cfg = SwimConfig(**case.get("cfg", {}))
        st = shard_state(init_state(case["n"], device=dev, **_init(case)), mesh)
        rows = st.state.shape[-2]
        st, _ = simulate_sharded(st, idle_inputs(rows, ticks=case["ticks"], device=dev), cfg,
                                 mesh, faulty=False)
        if op == "save_npz":
            checkpoint.save(case["path"], st, mesh=mesh)
        else:
            checkpoint.save_async(case["path"], st, mesh=mesh).wait_until_finished()
    else:
        template = init_state(case["n"], device="meta", **_init(case))
        st = checkpoint.load_orbax(case["path"], template, mesh=mesh)
        digest["rows"] = int(st.state.shape[-2])
    arrays = _state_arrays(gather_state(st, mesh))
    digest["digest"] = _digest(arrays)
    return {"arrays": arrays, "digest": digest}


def _host(x) -> np.ndarray:
    """A pool's output as numpy (a torch tensor, or any array-like)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# The leap round's cap on a lane's span: the sharded-pool tests' engine
# ``max_leap`` (tests/test_fedserve.py).
_SCRIPT_MAX_LEAP = 64


def pool_script(pool, ops) -> list:
    """Run an admission schedule on a lane pool (either package's, sharded
    or not): ``["admit", lane, seed, until_conv, budget, scenario]``,
    ``["refused", lane]`` (an admission into an occupied lane, which must
    raise ``ValueError``), ``["step"]`` and ``["leap"]`` -- one masked
    fleet leap round with the serve engine's ``k_m`` (each horizon lane's
    leap budget from the pool's signature rows, capped at
    ``_SCRIPT_MAX_LEAP``), then its accounting. Returns each leap round's
    ``k_m``."""
    from kaboodle_tpu_torch.warp.horizon import decode_signature
    from kaboodle_tpu_torch.warp.runner import MIN_LEAP, _classify, _leap_budget

    rounds = []
    for op in ops:
        if op[0] == "admit":
            _, lane, seed, conv, budget, scenario = op
            pool.admit(lane, seed=seed, drop_rate=0.0, until_conv=conv, budget=budget,
                       scenario=scenario)
        elif op[0] == "refused":
            try:
                pool.admit(op[1], seed=0)
            except ValueError:
                continue
            raise AssertionError(f"an admission into occupied lane {op[1]} was taken")
        elif op[0] == "step":
            pool.step()
        else:
            rows = _host(pool.signature())
            k_m = np.zeros((pool.lanes,), dtype=np.int32)
            horizon = pool.active & ~pool.until_conv & (pool.remaining > 0)
            for e in np.flatnonzero(horizon):
                cls = decode_signature(rows[e])
                mode = _classify(cls, hybrid=True)
                if mode != "dense":
                    k_m[e] = min(_leap_budget(cls, mode, int(pool.remaining[e])),
                                 _SCRIPT_MAX_LEAP)
            K = max(MIN_LEAP, 1 << int(max(int(k_m.max()), 1) - 1).bit_length())
            pool.leap(K, k_m)
            pool.advance_leaped(k_m)
            rounds.append(k_m.tolist())
    return rounds


def pool_arrays(pool, lanes) -> dict:
    """A pool's members (``member.<lane>.<field>``, the JAX package's
    layout), host run vectors, generation counters and counter totals."""
    out = {}
    for lane in lanes:
        m = pool.member(lane)
        for f in dataclasses.fields(m):
            x = getattr(m, f.name)
            if x is not None:
                out[f"member.{lane}.{f.name}"] = (
                    state_to_numpy(m)[f.name] if isinstance(x, torch.Tensor) else np.asarray(x))
    for name in ("ticks_run", "conv_tick", "messages", "remaining"):
        out[name] = np.asarray(getattr(pool, name))
    out["generation"] = _host(pool.generation)
    for name, col in (pool.counter_totals or {}).items():
        out["counters." + name] = np.asarray(col)
    return out


def _case_shardpool(case, mesh_unused, dev) -> dict:
    """A ``ShardedLanePool`` over every rank (a 1-D ensemble mesh, or
    ``peer_devices`` > 1 for the 2-D mesh) driven by :func:`pool_script`
    on rank 0 while the other ranks follow. Rank 0 writes
    :func:`pool_arrays` and the leap rounds' ``k_m`` (``fail``: rank 0
    raises it after the schedule, closing the pool with the error)."""
    from kaboodle_tpu_torch.fleet.sharding import make_fleet_mesh
    from kaboodle_tpu_torch.serve.shardpool import ShardedLanePool, follow

    fmesh = make_fleet_mesh(peer_devices=case.get("peer_devices", 1), device=dev.type)
    pool = ShardedLanePool(case["n"], case["lanes"], cfg=SwimConfig(**case.get("cfg", {})),
                           chunk=case["chunk"], telemetry=case.get("telemetry", False),
                           device_mesh=fmesh, timeout_s=60)
    if dist.get_rank() != 0:
        return {"digest": {"followed": follow(pool)}}
    try:
        rounds = pool_script(pool, case["ops"])
        if case.get("fail"):
            raise RuntimeError(case["fail"])
        arrays = pool_arrays(pool, range(case["lanes"]))
        arrays["k_m"] = np.asarray(rounds, dtype=np.int32).reshape(len(rounds), -1)
        stats = pool.stats()
    except BaseException as e:
        pool.close(error=repr(e))
        raise
    pool.close()
    return {"arrays": arrays, "digest": {"digest": _digest(arrays),
                                         "device_mesh": stats["device_mesh"]}}


def _case_shardpool_spill(case, mesh_unused, dev) -> dict:
    """A ``ShardedLanePool`` through a whole ``ServeEngine`` lifecycle on
    rank 0 (warmup, then under the build counter: submit, drain, park,
    spill, restore, resume), the other ranks following. Rank 0 also loads
    each spill file into a single-device pool and holds it equal to the
    sharded pool's member restored from the same file."""
    import shutil
    import tempfile

    from kaboodle_tpu_torch import checkpoint
    from kaboodle_tpu_torch.analysis.ir.surface import compile_counter
    from kaboodle_tpu_torch.fleet.sharding import make_fleet_mesh
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.shardpool import ShardedLanePool, follow

    n, lanes, chunk = case["n"], case["lanes"], case["chunk"]
    cfg = SwimConfig(**case.get("cfg", {}))
    fmesh = make_fleet_mesh(peer_devices=case.get("peer_devices", 1), device=dev.type)
    pool = ShardedLanePool(n, lanes, cfg=cfg, chunk=chunk, device_mesh=fmesh, timeout_s=60)
    if dist.get_rank() != 0:
        return {"digest": {"followed": follow(pool)}}
    tmp = tempfile.mkdtemp(prefix="kaboodle-shardpool-", dir=case.get("dir"))
    eng = ServeEngine([pool], max_leap=64, spill_after=1, spill_dir=tmp,
                      journal_dir=tmp + "/wal", engine_id="e0")
    try:
        eng.warmup()
        restored = {}
        with compile_counter() as fresh:
            rids = [eng.submit(ServeRequest(n=n, seed=i, mode="converge" if i % 2 == 0
                                            else "ticks", ticks=16, keep=True))
                    for i in range(3)]
            eng.drain()
            for _ in range(40):
                eng.step()
                if all(eng.status(r)["state"] == "spilled" for r in rids):
                    break
            eng.settle_spills()
            states = [eng.status(r)["state"] for r in rids]
            paths = [eng.status(r).get("spill_path") for r in rids]
            for r, path in zip(rids, paths):
                kept = shutil.copy(path, path + ".kept")  # the resumed run spills again
                assert eng.restore(r)
                restored[kept] = state_to_numpy(pool.member(eng.status(r)["lane"]))
                eng.resume(r, mode="ticks", ticks=4)
            eng.drain()
            eng.settle_spills()
        finals = [eng.status(r)["state"] for r in rids]
        stats = pool.stats()
    except BaseException as e:
        pool.close(error=repr(e))
        raise
    eng.close()
    plain_equal = []
    for path, want in restored.items():
        plain = LanePool(n, lanes, cfg=cfg, chunk=chunk, device=dev)
        plain.insert(0, checkpoint.load(path, device=dev))
        got = state_to_numpy(plain.member(0))
        plain_equal.append(all(
            (got[k] is None and want[k] is None)
            or np.array_equal(got[k], want[k], equal_nan=got[k].dtype.kind == "f")
            for k in got))
    return {"digest": {"fresh": fresh.count, "device_mesh": stats["device_mesh"],
                       "spilled": states, "final": finals, "plain_equal": plain_equal}}


def _case_fedload(case, mesh_unused, dev) -> dict:
    """``serve/federation/fedload.py``'s ``main`` on every rank (its sharded
    arm: rank 0 drives, the others follow e0's sharded pool); rank 0's
    report line."""
    import contextlib
    import io

    from kaboodle_tpu_torch.serve.federation import fedload

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fedload.main([*case["argv"], "--device", dev.type])
    lines = buf.getvalue().strip().splitlines()
    return {"digest": {"rc": rc, "line": json.loads(lines[-1]) if lines else None}}


def _case_costscope(case, mesh_unused, dev) -> dict:
    """``costscope``: the static records of registry entries (the sharded
    ones over every rank), each rank's own; with ``out``, rank 0 also
    writes every entry's whole outputs (keys ``<entry>|<path>``). With
    ``icibench`` (a list of sizes) it runs ``costscope/icibench.py``'s sweep
    over every rank instead."""
    from kaboodle_tpu_torch.analysis.ir.registry import output_arrays, select_entries
    from kaboodle_tpu_torch.costscope.extract import measure

    if case.get("icibench"):
        from kaboodle_tpu_torch.costscope.icibench import run_sweep

        return {"digest": {"report": run_sweep(tuple(case["icibench"]), dist.group.WORLD,
                                               repeats=1, check=True)}}
    records, arrays = {}, {}
    for entry in select_entries(case["entries"]):
        records[entry.name], (_, whole), _ = measure(entry, dev)
        arrays.update({f"{entry.name}|{k}": v for k, v in output_arrays(whole).items()})
    return {"arrays": arrays, "digest": {"records": records}}


def _case_analysis(case, mesh_unused, dev) -> dict:
    """``analysis``: registry entries (the sharded ones over every rank)
    traced and read by the IR lane (``analysis/ir/scan.py::read_entry``),
    each rank's own findings and host syncs per call (in all and by site);
    with ``rng``, each entry's key-provenance graph too."""
    from kaboodle_tpu_torch.analysis.ir.registry import select_entries
    from kaboodle_tpu_torch.analysis.ir.scan import read_entry
    from kaboodle_tpu_torch.analysis.rng.provenance import graph_to_dict

    entries = {}
    for entry in select_entries(case["entries"]):
        res = read_entry(entry, dev, rng=bool(case.get("rng")))
        entries[entry.name] = {
            "findings": [dataclasses.asdict(f) for f in res.findings], "syncs": res.syncs,
            "counts": {k: list(v) for k, v in res.counts.items()},
            "graph": graph_to_dict(res.graph) if res.graph is not None else None}
    return {"digest": {"entries": entries}}


KINDS = {
    "simulate": _case_simulate,
    "converge": _case_converge,
    "divisible": _case_divisible,
    "constrain": _case_constrain,
    "warp": _case_warp,
    "fleet": _case_fleet,
    "fleet_checks": _case_fleet_checks,
    "sweep": _case_sweep,
    "checkpoint": _case_checkpoint,
    "shardpool": _case_shardpool,
    "shardpool_spill": _case_shardpool_spill,
    "fedload": _case_fedload,
    "costscope": _case_costscope,
    "analysis": _case_analysis,
}


class Workers:
    """The processes of one job started by :func:`start_workers`."""

    def __init__(self, procs, deadline: float):
        self.procs = procs
        self.deadline = deadline

    def wait(self) -> dict:
        """Wait for every rank (until the deadline), then kill any still
        running -- a rank that died leaves its peers blocked in a collective
        -- and return ``{case: [digest of rank 0, rank 1, ...]}``. Raises
        ``RuntimeError`` with the ranks' output if any failed or timed out."""
        import subprocess
        import time

        outs, failed = [], []
        try:
            for r, p in enumerate(self.procs):
                left = max(1.0, self.deadline - time.monotonic())
                try:
                    out, err = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:  # every rank is killed below
                    failed.append(f"rank {r}: timed out")
                    break
                outs.append(out)
                if p.returncode != 0:
                    failed.append(f"rank {r}: exit {p.returncode}\n{err[-4000:]}")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if failed:
            raise RuntimeError("worker ranks failed:\n" + "\n".join(failed))
        cases: dict = {}
        for out in outs:
            for line in out.splitlines():
                if line.startswith("KBCASE "):
                    d = json.loads(line[len("KBCASE "):])
                    cases.setdefault(d["case"], {})[d["rank"]] = d
        return {k: [v[r] for r in sorted(v)] for k, v in cases.items()}


def start_workers(world: int, spec: dict, case_file: str, timeout_s: float = 120.0,
                  launch: str = "tcp") -> Workers:
    """Start ``world`` ranks of this module on one host over ``spec`` (the
    case file's contents, written to ``case_file``), each with one torch
    thread; return at once. ``Workers.wait`` collects them. ``launch``:
    ``"tcp"`` (an explicit coordinator address), ``"env"`` (``torchrun``'s
    variables, set here) or ``"plain"`` (no launcher: one rank)."""
    import os
    import socket
    import subprocess
    import time
    from pathlib import Path

    with open(case_file, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent.parent)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def rank_env(r):
        if launch != "env":
            return env
        return {**env, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "kaboodle_tpu_torch.parallel.worker", str(r), str(world),
             str(port) if launch == "tcp" else launch, case_file],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
            env=rank_env(r),
        )
        for r in range(world)
    ]
    return Workers(procs, time.monotonic() + timeout_s)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    with open(argv[3]) as f:
        spec = json.load(f)

    timeout_s = float(spec.get("timeout_s", 120))
    if port in ("env", "plain"):  # the zero-argument path
        mesh = make_multihost_mesh(device=spec.get("device"), timeout_s=timeout_s)
    else:
        mesh = make_multihost_mesh(f"127.0.0.1:{port}", world, rank, device=spec.get("device"),
                                   timeout_s=timeout_s)
    dev = mesh_device(mesh)
    torch.set_num_threads(1)
    for case in spec["cases"]:
        res = KINDS[case["kind"]](case, mesh, dev)
        if rank == 0 and case.get("out") and res.get("arrays") is not None:
            np.savez(case["out"], **res["arrays"])
        print("KBCASE " + json.dumps({"case": case["name"], "rank": dist.get_rank(),
                                      "world": dist.get_world_size(), **res["digest"]}),
              flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
