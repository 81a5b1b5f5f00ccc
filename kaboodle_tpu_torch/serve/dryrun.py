"""The serve CI lane: in-process server, toy requests, hard assertions.

The port of ``kaboodle_tpu/serve/dryrun.py``. ``python -m
kaboodle_tpu_torch.serve.server --dryrun [--device cpu]`` boots the full
stack — engine over a 4-lane n=16 pool, asyncio TCP server on an ephemeral
port, client + live stream connection — and drives 8 toy requests through
it (converge and horizon modes, a kept request parked, spilled, restored,
resumed and cancelled), asserting the three service contracts:

1. **no program built after warmup** over the ENTIRE exercise (admissions,
   leap and chunk rounds, harvests, re-seeds, park, spill, restore,
   resume, cancel): the :class:`~kaboodle_tpu_torch.serve.obsplane.
   BuildCounter`, the port's counterpart of the JAX compile counter;
2. **bit-exact service**: every converge-mode request's harvest matches a
   standalone ``run_until_converged`` of the same (seed, scenario) —
   ``conv_tick`` and the fingerprint statistics — and the resumed
   request's member equals the same seed's standalone run of its total
   ticks, leaf for leaf;
3. **streamed = written**: the records seen live on the stream connection
   are exactly the manifest file's after the pre-stream warm record, and
   the file passes the schema gate (``read_manifest(validate=True)``).

Prints a one-line JSON tail. The pool runs on the card unless ``device``
names another.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np

_WAIT_S = 60.0  # outer bound for any single dryrun phase


def _leaves_equal(a, b) -> list[str]:
    """Names of the MeshState leaves that differ (NaN-aware on floats)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(f.name)
            continue
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if x.dtype != y.dtype or not np.array_equal(
                x, y, equal_nan=bool(np.issubdtype(x.dtype, np.floating))):
            bad.append(f.name)
    return bad


async def _exercise(report: dict, device, tmp: str) -> None:
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.client import ServeClient
    from kaboodle_tpu_torch.serve.engine import ServeEngine
    from kaboodle_tpu_torch.serve.obsplane import BuildCounter
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.serve.server import ServeServer
    from kaboodle_tpu_torch.sim.runner import run_until_converged, simulate, state_agreement
    from kaboodle_tpu_torch.sim.state import idle_inputs, init_state
    from kaboodle_tpu_torch.telemetry.manifest import read_manifest

    cfg = SwimConfig(deterministic=True)
    manifest_path = os.path.join(tmp, "manifest.jsonl")
    pool = LanePool(16, 4, cfg=cfg, chunk=8, device=device)
    dev = pool.device
    engine = ServeEngine(
        [pool], warp=True, max_leap=64, spill_after=2, spill_dir=tmp
    )
    server = ServeServer(engine, port=0, manifest_path=manifest_path)
    engine.warmup()
    await server.start()

    client = await ServeClient.connect(port=server.port)
    stream = await client.open_stream()
    streamed: list[dict] = []

    async def pump() -> None:
        async for rec in stream:
            streamed.append(rec)

    pump_task = asyncio.create_task(pump())

    with BuildCounter() as box:
        # 8 toy requests through the 4-lane pool: converge and horizon
        # modes interleaved, so the drain mixes chunk rounds, leap rounds
        # and mid-flight re-seeds of retired lanes.
        rids = []
        for i in range(8):
            horizon = bool(i % 2)
            rids.append(await client.submit(
                16, seed=i,
                mode="ticks" if horizon else "converge",
                ticks=40,
                scenario="steady" if horizon else "boot",
                keep=(i == 0),
            ))
        rows = {}
        for rid in rids:
            rows[rid] = await asyncio.wait_for(client.wait(rid), _WAIT_S)

        # keep=True parked its lane; ride the idle countdown into a spill,
        # then restore + resume + cancel — the whole lifecycle, still
        # under the build counter.
        kept = rids[0]

        async def _await_state(rid: int, state: str) -> dict:
            while True:
                row = await client.status(rid)
                if row["state"] == state:
                    return row
                await asyncio.sleep(0.01)

        spilled = await asyncio.wait_for(_await_state(kept, "spilled"), _WAIT_S)
        assert os.path.exists(spilled["spill_path"]), spilled
        assert await client.restore(kept)
        await client.resume(kept, mode="ticks", ticks=8)
        resumed = await asyncio.wait_for(client.wait(kept), _WAIT_S)
        resumed_member = pool.member(resumed["lane"])
        await client.cancel(kept)
    report["compiles_after_warmup"] = box.count

    # -- contract 2: bit-exact service -------------------------------------
    checked = 0
    for i in range(0, 8, 2):  # the converge-mode requests, seeds 0, 2, 4, 6
        ref_state, ref_ticks, ref_conv = run_until_converged(
            init_state(16, seed=i, device=dev), cfg, max_ticks=40
        )
        _, ref_fp_min, ref_fp_max, ref_alive = state_agreement(ref_state)
        got = rows[rids[i]]["result"]
        want = {"conv_tick": int(ref_ticks), "converged": bool(ref_conv),
                "fp_min": int(ref_fp_min) & 0xFFFFFFFF,
                "fp_max": int(ref_fp_max) & 0xFFFFFFFF, "n_alive": int(ref_alive)}
        assert {k: got[k] for k in want} == want, (i, got, want)
        checked += 1
    total = resumed["result"]["ticks_run"]
    ref_state, _, _ = run_until_converged(init_state(16, seed=0, device=dev), cfg,
                                          max_ticks=40)
    conv_ticks = rows[kept]["result"]["ticks_run"]
    ref_state, _ = simulate(ref_state, idle_inputs(16, ticks=total - conv_ticks, device=dev),
                            cfg, faulty=False)
    # The check fetches both states from the device: run it off the loop.
    diff = await asyncio.to_thread(_leaves_equal, resumed_member, ref_state)
    assert not diff, ("resumed member != standalone", diff)
    report["bitexact_harvests"] = checked
    report["bitexact_resumed_member"] = True

    stats = await client.stats()
    report["rounds"] = stats["round"]
    report["requests"] = stats["requests"]

    await client.shutdown()
    await server.close()
    await asyncio.wait_for(pump_task, _WAIT_S)

    # -- contract 3: streamed == written, schema-clean ----------------------
    written = list(read_manifest(manifest_path, validate=True))
    assert streamed, "stream connection saw no records"
    assert written[0].get("event") == "warm", written[0]
    assert written[1:] == streamed, (len(written), len(streamed))
    kinds: dict[str, int] = {}
    for rec in written:
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
    assert kinds.get("serve_event", 0) >= 8 + 8  # admissions + completions
    assert kinds.get("serve_round", 0) >= 1
    events = {r.get("event") for r in written if r["kind"] == "serve_event"}
    for needed in ("warm", "admitted", "converged", "completed", "spilled",
                   "restored", "resumed", "cancelled"):
        assert needed in events, (needed, sorted(events))
    report["manifest_records"] = len(written)
    report["streamed_records"] = len(streamed)
    report["record_kinds"] = kinds

    assert report["compiles_after_warmup"] == 0, report


def parity_script(device, root: str, n: int = 64, lanes: int = 8, chunk: int = 4) -> dict:
    """A small lifecycle script through one engine on ``device``, its
    outcome as host values, for holding one device against another.

    One ``n``-class pool of ``lanes`` lanes (deterministic config, warp and
    a private span memo on, ``max_leap`` 32): 4 converge boots, 4 ticks-mode
    steady runs of 40 ticks, one kept request parked, spilled, restored and
    resumed for 16 ticks, and one cancel. Spill writes are flushed after
    every round, so their completions fold in at the same round on any
    device. Returns ``{"status", "records", "rounds", "pool",
    "generation", "kept_member"}``: the public rows and every emitted record
    with ``root`` taken out of their paths, the ``serve_round`` records, the
    final pool's leaves and the kept request's member
    (``sim.state.state_to_numpy`` layout)."""
    from kaboodle_tpu_torch.config import SwimConfig
    from kaboodle_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from kaboodle_tpu_torch.serve.pool import LanePool
    from kaboodle_tpu_torch.sim.state import state_to_numpy
    from kaboodle_tpu_torch.warp.runner import SpanMemo

    records: list[dict] = []
    pool = LanePool(n, lanes, cfg=SwimConfig(deterministic=True), chunk=chunk, device=device)
    eng = ServeEngine([pool], warp=True, max_leap=32, warp_memo=SpanMemo(), spill_after=2,
                      spill_dir=root, on_event=records.append)
    eng.warmup()

    def step() -> None:
        eng.step()
        if eng._spiller is not None:
            eng._spiller.flush()

    def until(pred, limit: int = 200) -> None:
        for _ in range(limit):
            if pred():
                return
            step()
        raise AssertionError("parity script stalled")

    for s in range(4):
        eng.submit(ServeRequest(n=n, seed=s))
        eng.submit(ServeRequest(n=n, seed=10 + s, mode="ticks", ticks=40, scenario="steady"))
    keep = eng.submit(ServeRequest(n=n, seed=5, keep=True))
    eng.cancel(eng.submit(ServeRequest(n=n, seed=6)))
    until(lambda: eng.status(keep)["state"] == "spilled")
    assert eng.restore(keep)
    eng.resume(keep, mode="ticks", ticks=16)
    until(lambda: not (eng.busy or eng.spilling))
    kept_member = state_to_numpy(pool.member(eng.status(keep)["lane"]))
    eng.close()
    norm = json.loads(json.dumps({"status": eng.status(), "records": records}).replace(
        root, "<root>"))
    return {
        "status": norm["status"],
        "records": norm["records"],
        "rounds": [r for r in norm["records"] if r["kind"] == "serve_round"],
        "pool": state_to_numpy(pool.mesh),
        "generation": pool.generation.cpu().numpy(),
        "kept_member": kept_member,
    }


def run_dryrun(device=None) -> int:
    """Run the exercise; prints the JSON tail and returns 0 (an assertion
    failure raises). Spill files and the manifest go to a temporary
    directory that is removed afterwards."""
    report: dict = {"dryrun": "serve"}
    tmp = tempfile.mkdtemp(prefix="kaboodle-serve-dryrun-")
    try:
        asyncio.run(_exercise(report, device, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["ok"] = True
    print(json.dumps(report))
    return 0
