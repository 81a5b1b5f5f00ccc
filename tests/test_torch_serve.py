"""The port's serving slice against the JAX package's, on the CPU.

The same inputs (numpy seeds, one request script) go through both
packages: the host modules (N-classes, admission, histograms and the
Prometheus text, manifests, journals, the RNG stream table, the lock-order
sanitizer), the serve step, and the whole engine with warp and the span
memo on -- every request's status row and result, every ``serve_event``
and ``serve_round`` record, the journal and the final pools, bit for bit
(NaN-aware on ``latency``; wall-clock fields and the per-package spill
directories taken out). Across packages: a request spilled by the JAX
engine finishes in the port's engine equal to the JAX continuation, each
package recovers the other's journal to the same table, and a pool saved
by one is adopted by the other. Then the port alone: the TCP dryrun, no
program built after warmup, and the spill snapshot taken before a re-seed
of its lane. The JAX engines are built once per module (module-scoped
fixtures); the whole file takes about a minute on one worker.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import types

import jax
import numpy as np
import pytest
import torch

from kaboodle_tpu import checkpoint as jckpt
from kaboodle_tpu.analysis.conc import sanitizer as jsan
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.phasegraph import rng as jrng
from kaboodle_tpu.serve import admission as jadm
from kaboodle_tpu.serve import engine as jeng
from kaboodle_tpu.serve import journal as jjournal
from kaboodle_tpu.serve import obsplane as jobs
from kaboodle_tpu.serve import pool as jpool
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.telemetry import manifest as jman
from kaboodle_tpu.warp import runner as jrunner
from kaboodle_tpu_torch import checkpoint as tckpt
from kaboodle_tpu_torch.analysis.conc import sanitizer as tsan
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph import derive as tderive
from kaboodle_tpu_torch.phasegraph import rng as trng
from kaboodle_tpu_torch.serve import admission as tadm
from kaboodle_tpu_torch.serve import engine as teng
from kaboodle_tpu_torch.serve import journal as tjournal
from kaboodle_tpu_torch.serve import obsplane as tobs
from kaboodle_tpu_torch.serve import pool as tpool
from kaboodle_tpu_torch.serve.dryrun import run_dryrun
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.telemetry import FIELDS
from kaboodle_tpu_torch.telemetry import manifest as tman
from kaboodle_tpu_torch.warp import runner as trunner

CPU = "cpu"
CHUNK = 4
LANES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(mesh) -> dict:
    return {f.name: None if getattr(mesh, f.name) is None else np.array(getattr(mesh, f.name))
            for f in dataclasses.fields(mesh)}


def _assert_leaves(want: dict, got: dict, where: str) -> None:
    assert set(want) == set(got), where
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {k} {w.dtype} {g.dtype}"
        eq = np.array_equal(w, g, equal_nan=bool(np.issubdtype(w.dtype, np.floating)))
        assert eq, f"{where}: leaf {k} differs"


# ---------------------------------------------------------------- host modules


def test_lane_n_class_table():
    ns = list(range(1, 300)) + [1000, 1024, 1025, 4096, 70_000]
    assert [tpool.lane_n_class(n) for n in ns] == [jpool.lane_n_class(n) for n in ns]
    assert tpool.MIN_LANE_N == jpool.MIN_LANE_N
    assert set(tpool.SCENARIOS) == set(jpool.SCENARIOS)
    with pytest.raises(ValueError, match="n >= 1"):
        tpool.lane_n_class(0)


def _admission_trace(mod) -> list:
    """One fake-clock script through ``TokenBucket`` and
    ``AdmissionController``: every decision, retry-after and snapshot."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    out = []
    bucket = mod.TokenBucket(rate=2.0, burst=3.0, clock=clock)
    rng = np.random.default_rng(5)
    for _ in range(40):
        t[0] += float(rng.choice([0.0, 0.1, 0.25, 0.7]))
        out.append(("take", bucket.try_take(float(rng.choice([1.0, 2.0]))),
                    bucket.retry_after(1.5)))
    ctl = mod.AdmissionController(max_queue=3, quotas={"a": (1.0, 2.0)},
                                  default_quota=(4.0, 1.0), clock=clock)
    for i in range(30):
        t[0] += float(rng.choice([0.0, 0.05, 0.5]))
        tenant = str(rng.choice(["a", "b", "c"]))
        try:
            ctl.check_quota(tenant)
            out.append(("quota", tenant, "ok"))
        except mod.QuotaError as e:
            out.append(("quota", tenant, e.kind, e.retry_after_s, str(e)))
        try:
            ctl.check_queue(i % 5)
            out.append(("queue", i % 5, "ok"))
        except mod.QueueFullError as e:
            out.append(("queue", i % 5, e.kind, e.retry_after_s, str(e)))
    out.append(("snapshot", json.dumps(ctl.snapshot(), sort_keys=True)))
    for bad in (dict(rate=0, burst=1), dict(rate=1, burst=0)):
        with pytest.raises(ValueError):
            mod.TokenBucket(clock=clock, **bad)
    with pytest.raises(ValueError):
        mod.AdmissionController(max_queue=0)
    return out


def test_admission_decisions_match():
    assert _admission_trace(tadm) == _admission_trace(jadm)
    assert issubclass(tadm.QueueFullError, tadm.AdmissionError)
    assert tadm.QuotaError.kind == jadm.QuotaError.kind


def _obs_text(mod) -> tuple:
    rng = np.random.default_rng(11)
    h = mod.Histogram()
    for us in rng.integers(0, 3_000_000, size=500) >> rng.integers(0, 20, size=500):
        h.observe(int(us))
    reg = mod.MetricsRegistry()
    reg.attach_histogram("serve_round_segment_us", h, segment="round")
    reg.histogram("lat_us", pool=16).observe(12)
    for ev in ("admitted", "converged", "admitted"):
        reg.inc("serve_events_total", event=ev)
    reg.inc("serve_ticks_total", value=37, engine="leap")
    reg.set_gauge("serve_queue_depth", 3)
    reg.register_gauge("serve_engine_round", lambda: 41)
    reg.register_multi_gauge("admission_tokens", lambda: {(("tenant", "a"),): 0.5})
    qs = [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    return qs, h.snapshot(), reg.to_prometheus(), json.dumps(reg.collect(), sort_keys=True)


def test_histogram_quantiles_and_prometheus_text():
    assert _obs_text(tobs) == _obs_text(jobs)
    assert tobs.SEGMENTS == jobs.SEGMENTS
    assert (tobs.SEG_POLL, tobs.SEG_ROUND) == (jobs.SEG_POLL, jobs.SEG_ROUND)


_RECORDS = [
    ("run", dict(n=16, fp=np.uint32(7), rows=np.arange(3, dtype=np.int32), ok=np.bool_(True))),
    ("tick", dict(tick=3, messages=np.int32(9))),
    ("tick", dict(tick="x")),
    ("serve_event", dict(event="admitted", lane=2, request_id=0)),
    ("serve_event", dict(event="", lane=2)),
    ("serve_event", dict(event="harvested", lane=None)),
    ("serve_round", dict(round=4, engine="leap")),
    ("serve_round", dict(round=1.5)),
    ("serve_span", dict(span="queued", t0_us=1, dur_us=2, request_id=3)),
    ("serve_span", dict(span="queued", t0_us=1, dur_us=2.0, request_id=3)),
    ("warp_blocked", dict(term="a2", ticks=4, spans=1)),
    ("warp_blocked", dict(term="a2", ticks=4)),
    ("costscope", dict(entry="")),
]


@pytest.mark.parametrize("kind,fields", _RECORDS, ids=[f"{k}{i}" for i, (k, _) in
                                                       enumerate(_RECORDS)])
def test_run_record_and_validate_match(kind, fields):
    want, got = jman.run_record(kind, **fields), tman.run_record(kind, **fields)
    assert json.dumps(got) == json.dumps(want)

    def verdict(mod, rec):
        try:
            mod.validate_record(rec)
            return "ok"
        except ValueError as e:
            return str(e)

    assert verdict(tman, want) == verdict(jman, want)
    for bad in ({"schema": "x", "kind": "run"}, {"schema": tman.MANIFEST_SCHEMA}, [1]):
        assert verdict(tman, bad) == verdict(jman, bad)


def test_run_record_takes_tensors():
    rec = tman.run_record("run", v=torch.tensor([1, 2], dtype=torch.int32), s=torch.tensor(3))
    assert rec["v"] == [1, 2] and rec["s"] == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_one_reads_in_the_other(tmp_path, writer):
    w_mod, r_mod = (jman, tman) if writer == "jax" else (tman, jman)
    path = str(tmp_path / "m.jsonl")
    with w_mod.ManifestWriter(path, stream=True) as w:
        w.write("run", n=16, seed=3)
        w.write_record(w_mod.run_record("serve_event", event="admitted", lane=1))
        w.write("serve_round", round=2, engine="chunk", ticks=8)
        with pytest.raises(ValueError):
            w.write("tick", tick="bad")
    want = list(w_mod.read_manifest(path))
    assert list(r_mod.read_manifest(path, validate=True)) == want
    assert len(want) == 3


def _journal_ops(j) -> None:
    req = {"n": 16, "seed": 3, "mode": "converge", "ticks": 64, "drop_rate": 0.0,
           "scenario": "boot", "keep": True, "tenant": "default", "priority": 1}
    j.append("submitted", 0, req=req)
    j.append("admitted", 0, lane=1, generation=4)
    j.append("harvested", 0, event="converged", result={"ticks_run": 5, "conv_tick": 5})
    j.append("submitted", 1, req=dict(req, seed=4, mode="ticks"))
    j.append("resumed", 1, mode="ticks", ticks=16)
    j.append("spilled", 1, path="/x/lane.npz", saved_run={"ticks_run": 3})
    j.append("submitted", 2, req=dict(req, seed=5))
    j.append("cancelled", 2)
    j.append("adopted", 3, req=req, path="/y.npz", saved_run=None, owner="e9")


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn-tail"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_written_by_one_replays_in_the_other(tmp_path, writer, torn):
    w_mod = jjournal if writer == "jax" else tjournal
    d = str(tmp_path / "wal")
    j = w_mod.ServeJournal(d, owner="e0", compact_every=4)
    _journal_ops(j)
    if j.should_compact():
        table, next_rid = j.replay()
        j.compact(table, next_rid)
    j.append("requeued", 1)
    j.close()
    if torn:
        with open(os.path.join(d, "wal.jsonl"), "a") as f:
            f.write('{"op": "harvested", "rid": 9, "res')
    want = jjournal.replay_journal(d)
    assert tjournal.replay_journal(d) == want
    assert tjournal.journal_owner(d) == jjournal.journal_owner(d) == "e0"
    assert tjournal.read_journal_records(d) == jjournal.read_journal_records(d)
    assert tjournal.JOURNAL_VERSION == jjournal.JOURNAL_VERSION
    assert want[1] == 4
    with pytest.raises(ValueError, match="alien engine"):
        tjournal.ServeJournal(d, owner="e1")


def test_stream_table_matches():
    assert trng.stream_table() == jrng.stream_table()
    assert len(trng.stream_table()) == 10


@pytest.mark.parametrize("mod", [jsan, tsan], ids=["jax", "torch"])
def test_sanitizer_lock_order_violation_raises(mod):
    with mod.enabled(loop_threshold_s=5.0):
        a, b = mod.make_lock("A._lock"), mod.make_lock("B._lock")
        assert isinstance(a, mod.SanitizedLock)
        with a:
            with b:
                pass
        with pytest.raises(mod.LockOrderError, match="lock-order cycle"):
            with b:
                with a:
                    pass
        assert mod.lock_graph() == {"A._lock": ["B._lock"]}
        mod.assert_clean()
        assert mod.report()["order_edges"] == 1
    assert not isinstance(mod.make_lock("C._lock"), mod.SanitizedLock)


# ---------------------------------------------------------------- the serve step

N = 16
STEP_CASES = [
    pytest.param(dict(deterministic=True), False, False, id="det"),
    pytest.param(dict(), False, False, id="random"),
    pytest.param(dict(), True, False, id="random-faulty-drop"),
    pytest.param(dict(deterministic=True), True, True, id="det-faulty-telemetry"),
]


def _step_pool(seed: int):
    """A ``[LANES]`` pool mixing boot, ring and converged members, and the
    per-lane vectors, from one numpy seed."""
    rng = np.random.default_rng(seed)
    members = [jstate.init_state(N, seed=100 + e, ring_contacts=rc, announced=an)
               for e, (rc, an) in enumerate([(0, False), (2, False), (N - 1, True), (4, False)])]
    mesh = {f.name: np.stack([np.asarray(getattr(m, f.name)) for m in members])
            for f in dataclasses.fields(members[0]) if getattr(members[0], f.name) is not None}
    active = rng.random(LANES) < 0.8
    active[:2] = True
    vecs = dict(
        active=active,
        until_conv=rng.random(LANES) < 0.5,
        remaining=rng.integers(0, 9, LANES).astype(np.int32),
        ticks_run=rng.integers(0, 4, LANES).astype(np.int32),
    )
    vecs["conv_tick"] = np.where(rng.random(LANES) < 0.3, vecs["ticks_run"], -1).astype(np.int32)
    drop = rng.uniform(0.0, 0.3, LANES).astype(np.float32)
    return mesh, vecs, drop


@pytest.mark.parametrize("kw,faulty,telemetry", STEP_CASES)
def test_serve_step_matches_jax(kw, faulty, telemetry):
    jcfg, tcfg = JaxSwimConfig(**kw), SwimConfig(**kw)
    jstep = jpool._step_program(jcfg, CHUNK, faulty, telemetry)
    tstep = tderive.make_serve_step(tcfg, CHUNK, faulty=faulty, telemetry=telemetry)
    mesh, vecs, drop = _step_pool(3 if telemetry else 1)
    if not faulty:
        drop = np.zeros_like(drop)
    jmesh = jstate.MeshState(**{k: jax.numpy.asarray(v) for k, v in mesh.items()})
    tmesh = tstate.state_from_numpy(mesh, device=CPU)
    tdrop = torch.as_tensor(drop)
    for step in range(3):
        jmesh, jout = jstep(jmesh, jax.numpy.asarray(drop), *(vecs[k] for k in
                            ("active", "until_conv", "remaining", "ticks_run", "conv_tick")))
        tmesh, tout = tstep(tmesh, tdrop, *(vecs[k] for k in
                            ("active", "until_conv", "remaining", "ticks_run", "conv_tick")))
        where = f"step {step}"
        for name in ("remaining", "ticks_run", "conv_tick", "done", "messages"):
            w, g = np.asarray(getattr(jout, name)), getattr(tout, name).numpy()
            assert w.dtype == g.dtype and np.array_equal(w, g), f"{where}: {name} {w} {g}"
        if telemetry:
            for name in FIELDS:
                w = np.asarray(getattr(jout.counters, name))
                g = getattr(tout.counters, name).numpy()
                if name == "gossip_bytes":
                    g = g.view(np.uint32)
                assert w.dtype == g.dtype and np.array_equal(w, g), f"{where}: counter {name}"
        else:
            assert jout.counters is None and tout.counters is None
        _assert_leaves(_jax_mesh(jmesh), tstate.state_to_numpy(tmesh), where)
        vecs.update(remaining=np.asarray(jout.remaining), ticks_run=np.asarray(jout.ticks_run),
                    conv_tick=np.asarray(jout.conv_tick))
        vecs["active"] = vecs["active"] | (step == 1)  # wake every lane for the last chunk
    assert "serve" in tderive.ENGINES


# ---------------------------------------------------------------- the whole slice


def _mods(port: bool):
    if port:
        return types.SimpleNamespace(
            LanePool=lambda *a, **k: tpool.LanePool(*a, device=CPU, **k), cfg=SwimConfig,
            ServeEngine=teng.ServeEngine, ServeRequest=teng.ServeRequest,
            AdmissionController=tadm.AdmissionController, AdmissionError=tadm.AdmissionError,
            SpanMemo=trunner.SpanMemo, obs=tobs.ObsPlane(trace=False),
            records=tjournal.read_journal_records)
    return types.SimpleNamespace(
        LanePool=jpool.LanePool, cfg=JaxSwimConfig, ServeEngine=jeng.ServeEngine,
        ServeRequest=jeng.ServeRequest, AdmissionController=jadm.AdmissionController,
        AdmissionError=jadm.AdmissionError, SpanMemo=jrunner.SpanMemo, obs=None,
        records=jjournal.read_journal_records)


def _norm(obj, root: str):
    """``obj`` with the engine's own directory taken out of every path."""
    return json.loads(json.dumps(obj).replace(root, "<root>"))


def _pool_host(pool, port: bool) -> dict:
    if port:
        mesh = tstate.state_to_numpy(pool.mesh)
        return {"mesh": mesh, "drop": pool.drop.numpy(), "gen": pool.generation.numpy()}
    return {"mesh": _jax_mesh(pool.mesh), "drop": np.array(pool.drop),
            "gen": np.array(pool.generation)}


def _member_host(pool, lane: int, port: bool) -> dict:
    m = pool.member(lane)
    return tstate.state_to_numpy(m) if port else _jax_mesh(m)


def _run_script(port: bool, root: str) -> dict:
    """One request script through one engine: converge boots and ticks-mode
    steady runs in classes 16 and 32 (warp and span memo on), a quota
    rejection, a full queue and a priority shed, a cancel while queued and
    one while running, a kept request parked -> spilled -> restored ->
    resumed, and a priority preemption of parked lanes. Spill writes are
    flushed after every round, so their completions fold in at the next
    round in both engines."""
    m = _mods(port)
    cfg = m.cfg(deterministic=True)
    pools = [m.LanePool(16, LANES, cfg=cfg, chunk=CHUNK), m.LanePool(32, LANES, cfg=cfg,
                                                                     chunk=CHUNK)]
    t = [0.0]
    adm = m.AdmissionController(max_queue=4, quotas={"metered": (1.0, 1.0)},
                                clock=lambda: t[0])
    records: list[dict] = []
    eng = m.ServeEngine(pools, warp=True, max_leap=32, warp_memo=m.SpanMemo(),
                        spill_after=2, spill_dir=os.path.join(root, "spill"),
                        journal_dir=os.path.join(root, "wal"), admission=adm,
                        on_event=records.append, obs=m.obs)
    os.makedirs(os.path.join(root, "spill"), exist_ok=True)
    eng.warmup()
    out: dict = {"warm_generation": [_pool_host(p, port)["gen"].tolist() for p in pools]}
    rejected = []

    def step():
        eng.step()
        if eng._spiller is not None:
            eng._spiller.flush()

    def drain(limit=200):
        for _ in range(limit):
            if not (eng.busy or eng.spilling):
                return
            step()
        raise AssertionError("script did not drain")

    def submit(**kw):
        try:
            return eng.submit(m.ServeRequest(**kw))
        except m.AdmissionError as e:
            rejected.append((type(e).__name__, e.kind, e.retry_after_s))
            return None

    steady = dict(mode="ticks", ticks=40, scenario="steady")
    submit(n=16, seed=0)
    submit(n=16, seed=1)
    submit(n=32, seed=3)
    submit(n=16, seed=10, **steady)
    submit(n=32, seed=12, **steady)                # queue full, equal priority
    submit(n=32, seed=12, priority=2, **steady)    # sheds the oldest priority-1
    step()
    keep = submit(n=16, seed=5, keep=True, priority=0)
    cancel_queued = submit(n=32, seed=4)
    eng.cancel(cancel_queued)
    submit(n=16, seed=30, tenant="metered")
    submit(n=16, seed=31, tenant="metered")        # quota: one token a second
    t[0] += 1.0
    cancel_running = submit(n=16, seed=11, tenant="metered", **steady)
    step()
    step()
    eng.cancel(cancel_running)
    drain()
    submit(n=16, seed=10, **steady)  # the same span again: replayed from the memo
    drain()
    # The kept request parked at its harvest; idle rounds spill it.
    for _ in range(10):
        if eng.status(keep)["state"] == "spilled":
            break
        step()
    row = eng.status(keep)
    out["spilled_row"] = _norm(row, root)
    out["spill_file"] = os.path.join(root, "kept-first-spill.npz")
    shutil.copy(row["spill_path"], out["spill_file"])  # the path is re-spilled later
    out["spill_saved_run"] = eng._requests[keep]["saved_run"]
    assert eng.restore(keep)
    eng.resume(keep, mode="ticks", ticks=24)
    drain()
    kept = eng.status(keep)
    out["kept_member"] = _member_host(pools[0], kept["lane"], port)
    out["kept_result"] = kept["result"]
    # Priority preemption: class 32 full of parked priority-0 lanes.
    for s in range(20, 20 + LANES):
        submit(n=32, seed=s, keep=True, priority=0)
    for _ in range(20):
        step()
        if all(r["state"] == "parked" for r in eng.status()
               if r["n_class"] == 32 and r["priority"] == 0):
            break
    submit(n=32, seed=40, priority=3, mode="ticks", ticks=16, scenario="steady")
    drain()
    for _ in range(8):  # let the idle keepers spill, one a round
        step()
    out.update(
        status=_norm(eng.status(), root), records=_norm(records, root), rejected=rejected,
        pools=[_pool_host(p, port) for p in pools], stats=eng.stats(),
        journal=_norm([{k: v for k, v in r.items() if k != "ts_us"}
                       for r in m.records(os.path.join(root, "wal"))], root),
        memo=eng.warp_memo.stats(),
    )
    if port:
        out["compiles_steady"] = eng.obs.metrics.collect()["gauges"]["compiles_steady"]
    eng.close()
    out["engine"], out["pools_obj"] = eng, pools
    return out


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_script")
    res = {}
    for name, port in (("jax", False), ("torch", True)):
        d = str(root / name)
        os.makedirs(d)
        res[name] = _run_script(port, d)
        res[name]["root"] = d
    return res


def test_script_results_and_status_rows_match(script):
    want, got = script["jax"], script["torch"]
    assert got["status"] == want["status"]
    assert got["kept_result"] == want["kept_result"]
    assert got["spilled_row"] == want["spilled_row"]
    assert got["rejected"] == want["rejected"]
    assert got["stats"] == want["stats"]
    states = {r["state"] for r in want["status"]}
    assert {"done", "cancelled", "spilled"} <= states
    assert [r[1] for r in want["rejected"]] == ["queue_full", "quota"]


def test_script_records_match(script):
    want, got = script["jax"]["records"], script["torch"]["records"]
    rounds = [r for r in want if r["kind"] == "serve_round"]
    assert [r for r in got if r["kind"] == "serve_round"] == rounds
    assert got == want
    engines = {r["engine"] for r in rounds}
    assert {"chunk", "leap", "leap+memo"} <= engines, engines
    assert sum(r.get("memo_hits", 0) for r in rounds) > 0
    events = {r.get("event") for r in want}
    for needed in ("warm", "admitted", "rejected", "shed", "cancelled", "converged",
                   "completed", "spilled", "restored", "resumed", "preempted"):
        assert needed in events, needed


def test_script_journals_match(script):
    want, got = script["jax"]["journal"], script["torch"]["journal"]
    assert got == want
    assert {r["op"] for r in want} >= {"submitted", "admitted", "harvested", "spilled",
                                       "restored", "resumed", "cancelled", "shed"}


def test_script_final_pools_and_generations_match(script):
    for e, (w, g) in enumerate(zip(script["jax"]["pools"], script["torch"]["pools"])):
        _assert_leaves(w["mesh"], g["mesh"], f"pool {e}")
        assert np.array_equal(w["drop"], g["drop"]) and w["drop"].dtype == g["drop"].dtype
        assert np.array_equal(w["gen"], g["gen"]) and g["gen"].dtype == np.int32
    _assert_leaves(script["jax"]["kept_member"], script["torch"]["kept_member"], "kept member")
    # Warmup bumps lane 0's generation by 3 (two reseeds, one insert).
    assert script["torch"]["warm_generation"] == script["jax"]["warm_generation"]
    assert script["torch"]["warm_generation"][0] == [3, 0, 0, 0]
    assert script["torch"]["memo"]["hits"] == script["jax"]["memo"]["hits"]


def test_no_program_built_after_warmup(script):
    assert script["torch"]["compiles_steady"] == {"": 0.0}


def test_jax_spill_adopted_by_the_port_continues_equal(script, tmp_path):
    """The JAX engine's spill file of the kept request, adopted by a fresh
    port engine, restored and resumed for the same 24 ticks, ends equal to
    the JAX engine's own continuation: result and member."""
    src = script["jax"]
    path = str(tmp_path / "adopted.npz")
    shutil.copy(src["spill_file"], path)
    row = src["spilled_row"]
    req = teng.ServeRequest(n=row["n"], seed=row["seed"], mode=row["mode"], keep=True,
                            priority=0)
    pool = tpool.LanePool(16, 2, cfg=SwimConfig(deterministic=True), chunk=CHUNK, device=CPU)
    eng = teng.ServeEngine([pool], warp=True, max_leap=32, warp_memo=trunner.SpanMemo())
    eng.warmup()
    rid = eng.adopt(req, path, src["spill_saved_run"], owner=None)
    assert eng.status(rid)["state"] == "spilled"
    assert eng.restore(rid)
    eng.resume(rid, mode="ticks", ticks=24)
    eng.drain()
    got = eng.status(rid)
    assert got["result"] == src["kept_result"]
    _assert_leaves(src["kept_member"], _member_host(pool, got["lane"], True), "adopted member")
    eng.close()


def _recover(port: bool, journal_src: str, root: str):
    d = os.path.join(root, "wal")
    shutil.copytree(journal_src, d)
    m = _mods(port)
    cfg = m.cfg(deterministic=True)
    pools = [m.LanePool(16, LANES, cfg=cfg, chunk=CHUNK), m.LanePool(32, LANES, cfg=cfg,
                                                                     chunk=CHUNK)]
    eng = m.ServeEngine(pools, warp=False, journal_dir=d)
    counts = eng.recover()
    status = eng.status()
    nxt = eng._next_rid
    eng.close()
    return counts, status, nxt


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovered_across_packages(script, tmp_path, writer):
    src = os.path.join(script[writer]["root"], "wal")
    want = _recover(False, src, str(tmp_path / "j"))
    got = _recover(True, src, str(tmp_path / "t"))
    assert got == want
    assert want[0]["done"] > 0 and want[0]["spilled"] > 0


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_pool_saved_by_one_is_adopted_by_the_other(script, tmp_path, direction):
    """``LanePool.load_fleet_state`` of a pool written by the other
    package's ``save_fleet``: leaves, drop knobs and generations equal, and
    the next admission and chunk equal too."""
    src = "jax" if direction == "jax-to-torch" else "torch"
    pool = script[src]["pools_obj"][0]
    path = str(tmp_path / "pool.npz")
    if src == "jax":
        jckpt.save_fleet(path, pool.fleet_state(), generation=pool.generation)
        fleet, gen = tckpt.load_fleet(path, device=CPU)
        other = tpool.LanePool(16, LANES, cfg=SwimConfig(deterministic=True), chunk=CHUNK,
                               device=CPU)
    else:
        tckpt.save_fleet(path, pool.fleet_state(), generation=pool.generation)
        fleet, gen = jckpt.load_fleet(path)
        other = jpool.LanePool(16, LANES, cfg=JaxSwimConfig(deterministic=True), chunk=CHUNK)
    other.load_fleet_state(fleet, gen)
    jp, tp = (pool, other) if src == "jax" else (other, pool)
    jt, tt = _pool_host(jp, False), _pool_host(tp, True)
    _assert_leaves(jt["mesh"], tt["mesh"], "adopted pool")
    assert np.array_equal(jt["gen"], tt["gen"]) and np.array_equal(jt["drop"], tt["drop"])
    if src == "torch":
        return  # the port's pool stays as the script left it for the next case
    lane = int(np.flatnonzero(~jp.occupied)[0])
    gens = (jp.admit(lane, seed=77, budget=6), tp.admit(lane, seed=77, budget=6))
    assert gens[0] == gens[1]
    jout, tout = jp.step(), tp.step()
    for name in ("ticks_run", "conv_tick", "remaining", "messages"):  # the admitted lane's
        assert np.asarray(getattr(jout, name))[lane] == getattr(tout, name)[lane], name
    _assert_leaves(_pool_host(jp, False)["mesh"], _pool_host(tp, True)["mesh"], "after a chunk")
    jp.release(lane)


def test_admission_seeds_match_jax_and_standalone_init():
    """``admit`` keys lane e with ``PRNGKey(int32 seed)``: seeds 0, 7 and
    2**31 - 1 give the standalone init's member in both packages, and a
    seed out of the int32 range is refused by both."""
    jp = jpool.LanePool(16, LANES, cfg=JaxSwimConfig(deterministic=True), chunk=CHUNK)
    tp = tpool.LanePool(16, LANES, cfg=SwimConfig(deterministic=True), chunk=CHUNK, device=CPU)
    for lane, seed in enumerate((0, 7, 2**31 - 1)):
        assert jp.admit(lane, seed=seed) == tp.admit(lane, seed=seed) == 1
        want = _member_host(jp, lane, False)
        _assert_leaves(want, _member_host(tp, lane, True), f"seed {seed}")
        _assert_leaves(want, tstate.state_to_numpy(tstate.init_state(16, seed=seed,
                                                                     device=CPU)), "init")
    for pool in (jp, tp):
        with pytest.raises(OverflowError):
            pool.admit(3, seed=2**31)
    with pytest.raises(ValueError, match="faulty=True"):
        tp.admit(3, seed=1, drop_rate=0.25)
    with pytest.raises(ValueError, match="occupied"):
        tp.admit(0, seed=1)


def test_memo_true_adopts_the_process_span_memo():
    pool = tpool.LanePool(16, 1, chunk=CHUNK, device=CPU)
    assert teng.ServeEngine([pool], warp_memo=True).warp_memo is trunner.span_memo
    assert teng.ServeEngine([pool], warp_memo=False).warp_memo is None
    with pytest.raises(ValueError, match="max_leap"):
        teng.ServeEngine([pool], max_leap=4)


# ---------------------------------------------------------------- the port alone


def test_tcp_dryrun_on_the_cpu(capsys):
    assert run_dryrun(device=CPU) == 0
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tail["ok"] and tail["compiles_after_warmup"] == 0
    assert tail["bitexact_harvests"] == 4 and tail["bitexact_resumed_member"]


def test_spill_snapshot_survives_a_reseed_of_its_lane(tmp_path, monkeypatch):
    """Hold the spill worker inside its write, re-seed the spilled lane in
    place (as the next admission would), release the worker: the file, and
    the member restored from it, are the lane as it was when the spill
    began, not the re-seeded one."""
    pool = tpool.LanePool(16, 2, cfg=SwimConfig(deterministic=True), chunk=CHUNK, device=CPU)
    eng = teng.ServeEngine([pool], warp=False, spill_after=1, spill_dir=str(tmp_path))
    eng.warmup()
    rid = eng.submit(teng.ServeRequest(n=16, seed=3, keep=True))
    for _ in range(20):
        if eng.status(rid)["state"] == "parked":
            break
        eng.step()
    lane = eng.status(rid)["lane"]
    want = tstate.state_to_numpy(pool.member(lane))
    entered, release = threading.Event(), threading.Event()
    real_save = tckpt.save

    def held_save(*a, **k):
        entered.set()
        assert release.wait(30)
        return real_save(*a, **k)

    monkeypatch.setattr(tckpt, "save", held_save)
    eng.step()  # the idle round begins the spill: the lane is cloned now
    assert eng.status(rid)["state"] == "spilling"
    assert entered.wait(30)
    pool.release(lane)
    pool.admit(lane, seed=99)  # the in-place write a later admission makes
    reseeded = tstate.state_to_numpy(pool.member(lane))
    assert not np.array_equal(reseeded["key"], want["key"])
    release.set()
    eng._spiller.flush()
    monkeypatch.setattr(tckpt, "save", real_save)
    pool.release(lane)  # the pool's husk is no longer the request's
    eng.step()
    assert eng.status(rid)["state"] == "spilled"
    _assert_leaves(want, tstate.state_to_numpy(tckpt.load(eng.status(rid)["spill_path"],
                                                          device=CPU)), "spill file")
    assert eng.restore(rid)
    _assert_leaves(want, tstate.state_to_numpy(pool.member(eng.status(rid)["lane"])),
                   "restored member")
    eng.close()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert tpool.LanePool(16, 1).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpool.LanePool(16, 2)
    from kaboodle_tpu_torch.serve.server import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--classes", "16", "--lanes", "2"])
