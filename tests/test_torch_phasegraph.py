"""The port's phase graph and planner against the JAX package's.

The metadata (``phasegraph/ops.py``, ``graph.py``, ``plan.py``) is held to
the JAX package's for every plan mode over a grid of configs: every
``PhaseOp`` field of the op table and every ``describe()`` of a plan,
errors included. The JAX package's planner cases (tests/test_phasegraph.py)
run on both packages and must give the same results. The engines built
from the plans are held to them too: the dense tick exposes ``graph`` and
``programs``, its ``_cut`` stage probe equals the JAX package's jitted cut
tick bit for bit at N = 32 (``latency`` to ``rtol=1e-5`` with its NaNs in
place, as in tests/test_torch_tick.py), and each engine refuses a plan it
has no bodies for.
"""

import dataclasses
import importlib
import itertools
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaboodle_tpu.phasegraph as jpg
from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.phasegraph import derive as jderive
from kaboodle_tpu.phasegraph import graph as jgraph
from kaboodle_tpu.phasegraph import ops as jops
from kaboodle_tpu.phasegraph.exec import make_tick_fn as jax_make_tick_fn
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu.sparseplane.state import SparseSpec as JaxSparseSpec
from kaboodle_tpu_torch import phasegraph as tpg
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.phasegraph import blocked, derive, exec as texec, span
from kaboodle_tpu_torch.phasegraph import graph as tgraph
from kaboodle_tpu_torch.phasegraph import ops as tops
from kaboodle_tpu_torch.sim import state as tstate
from kaboodle_tpu_torch.sparseplane import kernel as skernel
from kaboodle_tpu_torch.sparseplane.state import SparseSpec
from kaboodle_tpu_torch.warp import horizon

# The package exports ``plan`` the function, which shadows the module's name.
jplan = importlib.import_module("kaboodle_tpu.phasegraph.plan")
tplan = importlib.import_module("kaboodle_tpu_torch.phasegraph.plan")

CPU = "cpu"
FLAGS = dict(use_pallas_fp=True, use_pallas_oldest_k=True, use_pallas_suspicion=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pkg(cfg_cls, g, o, p, pkg):
    return types.SimpleNamespace(
        SwimConfig=cfg_cls, TickGraph=g.TickGraph, GraphError=g.GraphError,
        build_graph=pkg.build_graph, plan=pkg.plan, PhaseOp=o.PhaseOp, MODES=p.MODES,
        op_table=o.op_table,
    )


JAX = _pkg(JaxSwimConfig, jgraph, jops, jplan, jpg)
PORT = _pkg(SwimConfig, tgraph, tops, tplan, tpg)


def _outcome(fn):
    """``fn()``'s value, or its error as ``(type name, message)``."""
    try:
        return fn()
    except Exception as e:  # the error is the outcome compared
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------- the grid

_GRID_KEYS = ("join_broadcast_enabled", "faithful_failed_broadcast", "faithful_indirect_ack",
              "deterministic", "faulty", "telemetry")
GRID = [dict(zip(_GRID_KEYS, v)) for v in itertools.product((False, True), repeat=6)]


def _split(kw):
    kw = dict(kw)
    build = {k: kw.pop(k) for k in ("faulty", "telemetry")}
    return kw, build


def test_constants_equal_jax():
    for name in ("FIELDS", "INPUTS", "LAYOUTS", "PLANE_LAYOUTS", "BLOCKED_PLANES",
                 "SPARSE_FATES", "KEY_LAYOUT"):
        assert getattr(tops, name) == getattr(jops, name), name
    assert (tops.KEY_PROXY, tops.KEY_PING, tops.KEY_BERN, tops.KEY_DROP, tops.KEY_NEXT) == (
        jops.KEY_PROXY, jops.KEY_PING, jops.KEY_BERN, jops.KEY_DROP, jops.KEY_NEXT)
    assert tplan.MODES == jplan.MODES
    assert tplan._SPARSE_TAIL_GROUPS == jplan._SPARSE_TAIL_GROUPS
    assert tplan._SPARSE_PRUNE_REASONS == jplan._SPARSE_PRUNE_REASONS


@pytest.mark.parametrize("layout", ["dense", "blocked_topk"])
def test_op_tables_equal_jax(layout):
    """Every ``PhaseOp`` field of every op, for every config of the grid
    (and the layout's refusals, message for message)."""
    for kw in GRID:
        cfg_kw, build = _split(kw)

        def table(m):
            return [dataclasses.asdict(op) for op in m.op_table(
                m.SwimConfig(**cfg_kw), layout=layout, **build)]

        assert _outcome(lambda: table(PORT)) == _outcome(lambda: table(JAX)), kw


@pytest.mark.parametrize("layout", ["dense", "blocked_topk"])
@pytest.mark.parametrize("mode", jplan.MODES)
def test_plans_equal_jax(mode, layout):
    """``plan(build_graph(...), mode).describe()`` for every config of the
    grid, the planner's refusals included."""
    for kw in GRID:
        cfg_kw, build = _split(kw)

        def desc(m):
            return m.plan(m.build_graph(m.SwimConfig(**cfg_kw), layout=layout, **build),
                          mode).describe()

        assert _outcome(lambda: desc(PORT)) == _outcome(lambda: desc(JAX)), kw


# ------------------------------------------- the JAX package's planner cases
# Each case runs on one package (a namespace ``m``) and returns what it saw;
# the test runs it on both and the two records must be equal.


def _cfg(m, **kw):
    return m.SwimConfig(deterministic=True, **kw)


def _mk_op(m, name, stage, **kw):
    return m.PhaseOp(
        name=name, stage=stage, phase=kw.get("phase", "-"), doc=kw.get("doc", name),
        reads=frozenset(kw.get("reads", ())), writes=frozenset(kw.get("writes", ())),
        inputs=frozenset(kw.get("inputs", ())), gives=frozenset(kw.get("gives", ())),
        takes=frozenset(kw.get("takes", ())), activity=kw.get("activity", "always"),
        pred_term=kw.get("pred_term"), mask_rank=kw.get("mask_rank", 1),
        span=kw.get("span", "invariant"), cut=kw.get("cut"),
    )


def _raises(m, err, match, fn):
    with pytest.raises(err, match=match) as info:
        fn()
    return (type(info.value).__name__, str(info.value))


def case_default_graph_validates_and_orders(m):
    g = m.build_graph(_cfg(m), faulty=True)
    names = [op.name for op in g.ops]
    assert names.index("rng_streams") < names.index("probe_draw")
    assert names.index("probe_draw") < names.index("call1") < names.index("finish")
    assert max(names.index(o.name) for o in g.prologue) < min(names.index(o.name) for o in g.tail)
    assert set(g.cut_labels) == {"A", "c1", "c2", "c34", "G"}
    return names, g.cut_labels


def case_static_flags_decide_op_presence(m):
    seen = [tuple(o.name for o in m.build_graph(_cfg(m, **kw), **b).ops) for kw, b in (
        ({}, dict(faulty=True)), ({}, dict(faulty=False)),
        (dict(join_broadcast_enabled=False), dict(faulty=True)),
        ({}, dict(faulty=True, telemetry=True)), ({}, {}))]
    assert "churn" in seen[0] and "churn" not in seen[1]
    assert not any(n.startswith("join") for n in seen[2])
    assert "counters" in seen[3] and "counters" not in seen[4]
    return seen


def case_graph_rejects_duplicate_op(m):
    a = _mk_op(m, "a", "prologue", gives=("x",))
    return _raises(m, m.GraphError, "duplicate",
                   lambda: m.TickGraph(ops=(a, a), faulty=False, telemetry=False))


def case_graph_rejects_take_before_give(m):
    a = _mk_op(m, "a", "prologue", takes=("x",))
    return _raises(m, m.GraphError, "before any op gives",
                   lambda: m.TickGraph(ops=(a,), faulty=False, telemetry=False))


def case_graph_rejects_regive_and_late_prologue(m):
    a = _mk_op(m, "a", "prologue", gives=("x",))
    b = _mk_op(m, "b", "prologue", gives=("x",))
    t, c = _mk_op(m, "t", "tail"), _mk_op(m, "c", "prologue")
    return (_raises(m, m.GraphError, "re-gives",
                    lambda: m.TickGraph(ops=(a, b), faulty=False, telemetry=False)),
            _raises(m, m.GraphError, "after the dispatch boundary",
                    lambda: m.TickGraph(ops=(a, t, c), faulty=False, telemetry=False)))


def case_op_rejects_unknown_fields_and_bad_enums(m):
    return (_raises(m, ValueError, "unknown state fields",
                    lambda: _mk_op(m, "x", "tail", reads=("no_such_plane",))),
            _raises(m, ValueError, "bad stage", lambda: _mk_op(m, "x", "middle")),
            _raises(m, ValueError, "bad span fate",
                    lambda: _mk_op(m, "x", "tail", span="sometimes")))


def case_full_plan_is_one_pass_per_op(m):
    g = m.build_graph(_cfg(m), faulty=True)
    prog = m.plan(g, "full")
    assert prog.mode == "full" and len(prog.passes) == len(g.ops)
    assert prog.op_names() == tuple(op.name for op in g.ops)
    assert prog.pruned == () and prog.pred_terms == ()
    return prog.describe()


def case_fused_plan_prunes_rank2_tail_and_derives_predicate(m):
    g = m.build_graph(_cfg(m), faulty=True)
    prog = m.plan(g, "fused")
    pruned = {name for name, _ in prog.pruned}
    assert pruned == {o.name for o in g.tail if o.mask_rank == 2}
    assert {"suspicion", "calls34", "join_insert", "join_replies"} <= pruned
    assert set(prog.pred_terms) == {o.pred_term for o in g.tail if o.mask_rank == 2}
    assert set(prog.pred_terms) == {"any_a2", "any_join"}
    assert [p.name for p in prog.tail] == ["draw", "update"]
    assert "probe_draw" in prog.tail[0].op_names
    assert {"call1", "call2", "anti_entropy", "finish"} <= set(prog.tail[1].op_names)
    return prog.describe()


def case_fused_plan_without_join_plane_shrinks_predicate(m):
    prog = m.plan(m.build_graph(_cfg(m, join_broadcast_enabled=False), faulty=True), "fused")
    assert set(prog.pred_terms) == {"any_a2"}
    return prog.pred_terms


def case_fused_plan_rejects_unexcludable_rank2_op(m):
    g = m.build_graph(_cfg(m), faulty=False)
    bad = _mk_op(m, "rogue", "tail", mask_rank=2)
    return _raises(m, m.GraphError, "neither fold nor be excluded", lambda: m.plan(
        m.TickGraph(ops=g.ops + (bad,), faulty=False, telemetry=False), "fused"))


def case_span_plan_requires_fault_free_graph(m):
    err = _raises(m, m.GraphError, "fault-free",
                  lambda: m.plan(m.build_graph(_cfg(m), faulty=True), "span"))
    prog = m.plan(m.build_graph(_cfg(m), faulty=False), "span")
    pruned = {name for name, _ in prog.pruned}
    assert "suspicion" in pruned and "calls34" in pruned
    live = {n for p in prog.tail for n in p.op_names}
    assert "probe_draw" in live and "finish" in live
    return err, prog.describe()


def case_blocked_plan_shares_full_pass_structure(m):
    g = m.build_graph(_cfg(m), faulty=True)
    full, blk = m.plan(g, "full"), m.plan(g, "blocked")
    assert blk.mode == "blocked" and blk.op_names() == full.op_names()
    assert [p.name for p in blk.passes] == [p.name for p in full.passes]
    return blk.describe()


def case_plan_rejects_unknown_mode(m):
    err = _raises(m, ValueError, "unknown plan mode",
                  lambda: m.plan(m.build_graph(_cfg(m), faulty=True), "turbo"))
    assert set(m.MODES) == {"full", "fused", "span", "blocked", "hybrid", "sparse"}
    return err, m.MODES


def case_describe_is_jsonable_and_names_passes(m):
    prog = m.plan(m.build_graph(_cfg(m), faulty=True), "fused")
    desc = json.loads(json.dumps(prog.describe()))
    stages = {p["name"]: p["stage"] for p in desc["passes"]}
    assert desc["mode"] == "fused" and stages["draw"] == stages["update"] == "tail"
    assert {p["op"] for p in desc["pruned"]} == {n for n, _ in prog.pruned}
    assert prog.pass_of("call1") == "update"
    return desc, _raises(m, KeyError, "suspicion", lambda: prog.pass_of("suspicion"))


PLANNER_CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", PLANNER_CASES, ids=lambda c: c.__name__[5:])
def test_planner_case_equals_jax(case):
    assert len(PLANNER_CASES) == 14
    assert case(PORT) == case(JAX)


# ---------------------------------------------------------- split_tick_keys


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 - 1])
def test_split_tick_keys_equals_jax_random_split(seed):
    """Bit for bit against ``jax.random.split(key, 5)`` with
    ``jax_threefry_partitionable`` pinned True (the scheme the port's
    threefry reproduces); as int words and as ``[E]`` tensor words."""
    with jax.threefry_partitionable(True):
        keys = [jax.random.PRNGKey(seed), jax.random.fold_in(jax.random.PRNGKey(seed), 3)]
        want = np.stack([np.asarray(jops.split_tick_keys(k)) for k in keys])  # [E, 5, 2]
    words = np.asarray(keys).astype(np.int64)
    for e in range(len(keys)):
        got = tops.split_tick_keys((int(words[e, 0]), int(words[e, 1])))
        assert np.array_equal(np.asarray(got, dtype=np.int64), want[e].astype(np.int64))
    got = tops.split_tick_keys((torch.as_tensor(words[:, 0]), torch.as_tensor(words[:, 1])))
    got = np.stack([np.stack([w0.numpy(), w1.numpy()], -1) for w0, w1 in got], 1)
    assert np.array_equal(got, want.astype(np.int64))


# ------------------------------------------------ the engines built from it


def test_tick_fn_exposes_its_graph_and_programs():
    tick = texec.make_tick_fn(SwimConfig(deterministic=True), faulty=True)
    jtick = jax_make_tick_fn(JaxSwimConfig(deterministic=True), faulty=True)
    assert {op.name for op in tick.graph.ops} >= {"probe_draw", "call1", "finish"}
    assert set(tick.programs) == {"full", "fused"}
    assert [p.name for p in tick.programs["fused"].tail] == ["draw", "update"]
    assert [dataclasses.asdict(o) for o in tick.graph.ops] == [
        dataclasses.asdict(o) for o in jtick.graph.ops]
    for mode in ("full", "fused"):
        assert tick.programs[mode].describe() == jtick.programs[mode].describe()


@pytest.mark.parametrize("faulty", [True, False])
def test_sparse_tick_exposes_its_graph_and_programs(faulty):
    tick = derive.make_sparse_tick(SwimConfig(join_broadcast_enabled=False),
                                   SparseSpec(k=8), faulty=faulty)
    jtick = jderive.make_sparse_tick(JaxSwimConfig(join_broadcast_enabled=False),
                                     JaxSparseSpec(k=8), faulty=faulty)
    assert tick.graph.layout == "blocked_topk"
    assert tick.programs["sparse"].describe() == jtick.programs["sparse"].describe()
    assert tick.passes == derive.SPARSE_PASSES


def test_fused_predicate_and_hybrid_terms_read_the_plan():
    for kw in GRID:
        cfg_kw, build = _split(kw)
        cfg = SwimConfig(**cfg_kw)
        want = jpg.plan(jpg.build_graph(JaxSwimConfig(**cfg_kw), faulty=build["faulty"]),
                        "fused").pred_terms
        assert texec.dispatch_pred_terms(cfg) == tuple(want)
        want = jpg.plan(jpg.build_graph(JaxSwimConfig(**cfg_kw), faulty=False),
                        "hybrid").pred_terms
        assert horizon.hybrid_pred_terms(cfg) == tuple(want)


def test_planner_modules_import_neither_jax_nor_torch():
    code = textwrap.dedent("""
        import sys
        for blocked in ("jax", "jaxlib", "kaboodle_tpu", "torch"):
            sys.modules[blocked] = None
        from kaboodle_tpu_torch.phasegraph import build_graph, plan
        from kaboodle_tpu_torch.phasegraph import graph, ops
        from kaboodle_tpu_torch.config import SwimConfig
        print(plan(build_graph(SwimConfig()), "fused").pred_terms)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(Path(__file__).parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "('any_a2', 'any_join')"


# ------------------------------------------------------------------- _cut

CUT_N = 32


@pytest.fixture(scope="module")
def cut_case():
    """A mid-run state at N = 32 (the port's ticks from a converged mesh,
    peer 5 cut off by a partition for two ticks so its pings time out) and
    the probed tick's inputs: the partition healed and peer 9 killed, so
    suspicion escalates and calls 3-4 deliver. Plus one jitted JAX tick per
    cut label, and the uncut full program."""
    n = CUT_N
    st = tstate.init_state(n, seed=5, ring_contacts=n - 1, announced=True, device=CPU)
    part = torch.zeros(n, dtype=torch.int32)
    part[5] = 1
    cut_off = dataclasses.replace(tstate.idle_inputs(n, device=CPU), partition=part)
    tick = texec.make_tick_fn(SwimConfig())
    for _ in range(2):
        st, _ = tick(st, cut_off)
    kill = torch.zeros(n, dtype=torch.bool)
    kill[9] = True
    inp = dataclasses.replace(tstate.idle_inputs(n, device=CPU), kill=kill)
    jst = jstate.MeshState(**{k: None if v is None else jnp.asarray(v)
                              for k, v in tstate.state_to_numpy(st).items()})
    jinp = jstate.TickInputs(**{f.name: None if getattr(inp, f.name) is None
                                else jnp.asarray(getattr(inp, f.name).numpy())
                                for f in dataclasses.fields(inp)})
    jticks = {cut: jax.jit(jax_make_tick_fn(JaxSwimConfig(), faulty=True, _cut=cut,
                                            program=None if cut else "full"))
              for cut in (*tick.graph.cut_labels, None)}
    return st, inp, jst, jinp, jticks


def _leaves(obj) -> dict:
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same(want: dict, got: dict, where: str):
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            assert w is None and g is None, f"{where}: {k}"
            continue
        assert w.dtype == g.dtype and w.shape == g.shape, f"{where}: {k} {w.dtype} {g.dtype}"
        if k == "latency":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{where}: {k}")
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("flags", [False, True], ids=["plain", "kernel_flags"])
@pytest.mark.parametrize("cut", ["A", "c1", "c2", "c34", "G", None])
def test_cut_tick_equals_jax(cut_case, cut, flags):
    """Each cut label (and the uncut full program) on the port equals the
    JAX package's jitted cut tick: the partial state, ``tick + 1`` and the
    zeroed metrics."""
    st, inp, jst, jinp, jticks = cut_case
    cfg = SwimConfig(**FLAGS) if flags else SwimConfig()
    tick = texec.make_tick_fn(cfg, faulty=True, _cut=cut, program=None if cut else "full")
    got_st, got_m = tick(st, inp)
    want_st, want_m = jticks[cut](jst, jinp)
    _assert_same(_leaves(want_st), tstate.state_to_numpy(got_st), f"cut {cut} state")
    _assert_same(_leaves(want_m), tstate.metrics_to_numpy(got_m), f"cut {cut} metrics")
    if cut is not None:  # the truncated tick did work, and stopped short of the full one
        assert int(got_st.tick) == int(st.tick) + 1
        assert not bool(got_m.converged) and int(got_m.messages_delivered) == 0


def test_cuts_split_the_tick_into_stages(cut_case):
    """Successive cuts change the state step by step: A arms the pings, the
    calls answer them, calls 3-4 refresh the proxies' timers."""
    st, inp, *_ = cut_case
    timer_moves = [
        int((texec.make_tick_fn(SwimConfig(), _cut=c)(st, inp)[0].timer != st.timer).sum())
        for c in ("A", "c1", "c2", "c34")]
    assert timer_moves == sorted(timer_moves) and timer_moves[2] < timer_moves[3]


@pytest.mark.parametrize("kw", [
    dict(_cut="B"), dict(_cut="c1", telemetry=True), dict(_cut="c1", program="fused"),
    dict(_cut="bogus", program="bogus"), dict(program="bogus"),
], ids=["unknown", "telemetry", "fused", "label_first", "program"])
def test_cut_errors_equal_jax(kw):
    def build(make, cfg):
        make(cfg, faulty=True, **kw)

    want = _outcome(lambda: build(jax_make_tick_fn, JaxSwimConfig()))
    assert want[0] == "raised"
    assert _outcome(lambda: build(texec.make_tick_fn, SwimConfig())) == want


def test_cut_refuses_the_row_sharded_tick():
    with pytest.raises(ValueError, match="row-sharded tick has no cut"):
        texec.make_tick_fn(SwimConfig(), group=object(), _cut="A")


# ----------------------------------- each engine refuses a plan it cannot run

_ROGUE = tops.PhaseOp(name="rogue", phase="-", doc="rogue", stage="tail")


def _add_to_tail(prog, pass_name, op=_ROGUE):
    tail = tuple(dataclasses.replace(p, ops=p.ops + (op,)) if p.name == pass_name else p
                 for p in prog.tail)
    return dataclasses.replace(prog, tail=tail)


def _doctor(module, monkeypatch, mode, doctor):
    real = module.plan

    def fake(graph, m):
        prog = real(graph, m)
        return doctor(prog) if m == mode else prog

    monkeypatch.setattr(module, "plan", fake)


@pytest.mark.parametrize("engine", [
    "fused_update", "fused_pred", "full", "blocked", "span", "hybrid", "sparse", "signature",
])
def test_engines_refuse_a_plan_they_do_not_implement(engine, monkeypatch):
    cfg = SwimConfig(deterministic=True, max_share_peers=7)  # a config no cache has seen
    if engine == "fused_update":
        _doctor(texec, monkeypatch, "fused", lambda p: _add_to_tail(p, "update"))
        with pytest.raises(NotImplementedError, match="does not fold"):
            texec.make_tick_fn(cfg)
    elif engine == "fused_pred":
        _doctor(texec, monkeypatch, "fused",
                lambda p: dataclasses.replace(p, pred_terms=p.pred_terms + ("any_rogue",)))
        with pytest.raises(NotImplementedError, match="unknown dispatch pred terms"):
            texec.make_tick_fn(cfg)
    elif engine == "full":
        _doctor(texec, monkeypatch, "full", lambda p: _add_to_tail(p, "finish"))
        with pytest.raises(NotImplementedError, match="full plan runs ops without bodies"):
            texec.make_tick_fn(cfg)
    elif engine == "blocked":
        _doctor(blocked, monkeypatch, "blocked", lambda p: _add_to_tail(p, "finish"))
        with pytest.raises(NotImplementedError, match="without blocked bodies"):
            blocked.make_chunked_tick_fn(cfg)
    elif engine in ("span", "hybrid"):
        _doctor(span, monkeypatch, engine, lambda p: _add_to_tail(p, "refresh"))
        with pytest.raises(NotImplementedError, match="leap implementation"):
            span.make_leap_fn(cfg, 4, hybrid=engine == "hybrid")
    elif engine == "sparse":
        _doctor(skernel, monkeypatch, "sparse", lambda p: dataclasses.replace(
            p, tail=p.tail + (tplan.Pass("rogue", (_ROGUE,)),)))
        with pytest.raises(AssertionError, match="sparse plan/kernel drift"):
            skernel.make_sparse_tick_fn(SwimConfig(join_broadcast_enabled=False),
                                        SparseSpec(k=8))
    else:
        _doctor(horizon, monkeypatch, "hybrid",
                lambda p: dataclasses.replace(p, pred_terms=p.pred_terms + ("any_rogue",)))
        with pytest.raises(NotImplementedError, match="does not measure"):
            horizon.make_signature_fn(cfg)
