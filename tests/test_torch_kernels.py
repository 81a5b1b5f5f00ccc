"""The port's fused kernels: plain versions against the JAX package, bit for bit.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
are held against these on the card by chip_smoke.py and
tests/test_torch_cuda.py). Here each plain version is held against the
Pallas function in interpret mode (N = 128, 256, the shapes that kernel
takes) and against the JAX tick's jnp formulation at N = 200, with
negative timers (Q6 back-dating), timers at the dtype's max and dead rows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kaboodle_tpu.ops import hashing as jhash
from kaboodle_tpu.ops.fused_fp import fused_fp_count as pallas_fp
from kaboodle_tpu.ops.fused_oldest_k import fused_oldest_k as pallas_oldest_k
from kaboodle_tpu.ops.fused_suspicion import fused_suspicion as pallas_suspicion
from kaboodle_tpu.ops.sampling import _stable_k_smallest_iter
from kaboodle_tpu.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING
from kaboodle_tpu_torch.ops import _cuda
from kaboodle_tpu_torch.ops.fused_fp import fused_fp_count
from kaboodle_tpu_torch.ops.fused_oldest_k import fused_oldest_k
from kaboodle_tpu_torch.ops.fused_suspicion import fused_suspicion


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small-N tensor ops run fastest on one thread, and leave the other
    test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(n, timer_dtype, seed):
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 4, (n, n)).astype(np.int8)
    timer = rng.integers(-12, 30, (n, n)).astype(timer_dtype)
    timer[rng.random((n, n)) < 0.05] = np.iinfo(timer_dtype).max
    alive = rng.random(n) < 0.8
    idv = rng.integers(0, 2**32, (n, n), dtype=np.uint64).astype(np.uint32)
    return state, timer, alive, idv


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy())


def _jnp_fp(state, ident):
    """The JAX tick's fp_count jnp branch (exec.py:428-434)."""
    member = jnp.asarray(state) > 0
    if ident.ndim == 2:
        fp = jhash.membership_fingerprint(member, jnp.asarray(ident))
    else:
        fp = jnp.sum(jnp.where(member, jnp.asarray(ident)[None, :], jnp.uint32(0)),
                     axis=-1, dtype=jnp.uint32)
    return np.asarray(fp), np.asarray(jnp.sum(member, axis=-1, dtype=jnp.int32))


def _jnp_suspicion(state, timer, alive, thr):
    """The JAX tick's jnp phase-A stats (exec.py:391-403, :734-742)."""
    S, T, al = jnp.asarray(state), jnp.asarray(timer), jnp.asarray(alive)
    n = S.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    aged = al[:, None] & (T.astype(jnp.int32) <= thr)
    timed = aged & (S == WAITING_FOR_PING)
    has_timed = jnp.any(timed, axis=-1)
    tsel = jnp.where(timed, T, jnp.iinfo(T.dtype).max)
    min_t = jnp.min(tsel, axis=-1)
    jstar = jnp.min(jnp.where(timed & (T == min_t[:, None]), idx[None, :],
                              jnp.iinfo(jnp.int32).max), axis=-1)
    jstar = jnp.where(has_timed, jstar, -1)
    has_cand = jnp.any((S == KNOWN) & (idx[None, :] != idx[:, None]), axis=-1)
    wfip = jnp.any(aged & (S == WAITING_FOR_INDIRECT_PING), axis=-1)
    count = jnp.sum(S > 0, axis=-1, dtype=jnp.int32)
    return [np.asarray(x) for x in (count, jstar, has_timed, has_cand, wfip)]


def _jnp_oldest_k(state, timer, alive, k):
    """The jnp eligibility + iter formulation (exec.py:807-811)."""
    n = state.shape[0]
    eye = np.eye(n, dtype=bool)
    elig = jnp.asarray(alive[:, None] & (state == KNOWN) & ~eye)
    tmax = jnp.asarray(np.iinfo(timer.dtype).max, dtype=timer.dtype)
    idx, valid = _stable_k_smallest_iter(jnp.where(elig, jnp.asarray(timer), tmax), k, tmax)
    return np.asarray(idx), np.asarray(valid)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("views", [True, False])
def test_fp_plain_matches_pallas(n, views):
    state, _, _, idv = _case(n, np.int32, n)
    ident = idv if views else idv[0]
    fp, cnt = fused_fp_count(_t(state), _u32(ident))
    want_fp, want_cnt = pallas_fp(jnp.asarray(state), jnp.asarray(ident), interpret=True)
    np.testing.assert_array_equal(fp.numpy().view(np.uint32), np.asarray(want_fp))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


@pytest.mark.parametrize("views", [True, False])
def test_fp_plain_matches_jnp_any_n(views):
    state, _, _, idv = _case(200, np.int32, 1)
    ident = idv if views else idv[0]
    fp, cnt = fused_fp_count(_t(state), _u32(ident))
    want_fp, want_cnt = _jnp_fp(state, ident)
    np.testing.assert_array_equal(fp.numpy().view(np.uint32), want_fp)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
def test_suspicion_plain_matches_pallas(n, timer_dtype):
    state, timer, alive, _ = _case(n, timer_dtype, 7 + n)
    got = fused_suspicion(_t(state), _t(timer), _t(alive), 9)
    want = pallas_suspicion(jnp.asarray(state), jnp.asarray(timer), jnp.asarray(alive), 9,
                            interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("thr", [-3, 9])
def test_suspicion_plain_matches_jnp_any_n(timer_dtype, thr):
    state, timer, alive, _ = _case(200, timer_dtype, 2)
    got = fused_suspicion(_t(state), _t(timer), _t(alive), thr)
    for g, w in zip(got, _jnp_suspicion(state, timer, alive, thr)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
def test_oldest_k_plain_matches_pallas(n, timer_dtype):
    state, timer, alive, _ = _case(n, timer_dtype, 11 + n)
    for k in (1, 5) + ((9, 16) if n == 128 else ()):  # k above 8 once, at the smaller n
        gi, gv = fused_oldest_k(_t(state), _t(timer), _t(alive), k)
        wi, wv = pallas_oldest_k(jnp.asarray(state), jnp.asarray(timer), jnp.asarray(alive), k,
                                 interpret=True)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
def test_oldest_k_plain_matches_jnp_any_n(timer_dtype):
    state, timer, alive, _ = _case(200, timer_dtype, 3)
    state[5, :] = KNOWN  # a full row with ties and sentinel timers
    timer[5, :40] = 0
    for k in (1, 5, 8, 9, 16, 200):  # 200 > any row's eligible count
        gi, gv = fused_oldest_k(_t(state), _t(timer), _t(alive), k)
        wi, wv = _jnp_oldest_k(state, timer, alive, k)
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(np.where(gv, gi, -1), np.where(wv, wi, -1))
        assert (gi.numpy()[~gv.numpy()] == 199).all()  # empty slots hold n - 1


def _edge_rows(n, timer_dtype, alive_mode, seed):
    """Rows at the row kernels' edges (the card tests build the same): ties
    at one timer, timers at 9 and at the dtype's extremes, WaitingForPing
    at one timer in two far columns, the diagonal as the only Known cell;
    all rows alive, none, or a mix."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(timer_dtype)
    vals = np.array([info.min, info.min + 1, -1, 0, 1, 8, 9, 10, info.max - 1, info.max])
    state = rng.integers(0, 4, (n, n)).astype(np.int8)
    timer = rng.choice(vals, (n, n)).astype(timer_dtype)
    alive = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
             "mixed": rng.random(n) < 0.5}[alive_mode]
    if n > 0:
        state[0], timer[0] = WAITING_FOR_PING, 9
    if n > 1:
        state[1] = WAITING_FOR_PING
        timer[1] = info.max
        timer[1, n // 2 + n % 2::3] = info.min
    if n > 2:
        state[2] = 0
        state[2, 2] = KNOWN
    if n > 3:
        state[3], timer[3] = WAITING_FOR_INDIRECT_PING, 9
    if n > 4:
        state[4] = np.where(state[4] == WAITING_FOR_PING, 0, state[4])
        timer[4] = np.where(state[4] > 0, info.min, timer[4])
        for j in (n // 3, n - 1):
            state[4, j], timer[4, j] = WAITING_FOR_PING, -1
    return state, timer, alive


def _edge_thresholds(timer_dtype):
    info = np.iinfo(timer_dtype)
    above = [info.max + 1] if info.max < np.iinfo(np.int32).max else []
    return [info.min - 1] * (info.min > np.iinfo(np.int32).min) + [info.min, 9, info.max] + above


@pytest.mark.parametrize("n", [1, 33, 128])
@pytest.mark.parametrize("timer_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("alive_mode", ["all", "none", "mixed"])
def test_plain_kernels_match_jax_on_edge_rows(n, timer_dtype, alive_mode):
    """The kernels' yardsticks on edge rows against the JAX tick's jnp
    formulation (every threshold) and, at N = 128 with mixed rows, the
    Pallas functions in interpret mode."""
    state, timer, alive = _edge_rows(n, timer_dtype, alive_mode, n)
    for thr in _edge_thresholds(timer_dtype):
        got = fused_suspicion(_t(state), _t(timer), _t(alive), thr)
        for g, w in zip(got, _jnp_suspicion(state, timer, alive, thr)):
            np.testing.assert_array_equal(g.numpy(), w)
    idv = (timer.astype(np.int64) * 40503).astype(np.uint32)
    for ident in (idv, idv[min(1, n - 1)]):
        fp, cnt = fused_fp_count(_t(state), _u32(ident))
        want_fp, want_cnt = _jnp_fp(state, ident)
        np.testing.assert_array_equal(fp.numpy().view(np.uint32), want_fp)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    if n == 128 and alive_mode == "mixed":
        got = fused_suspicion(_t(state), _t(timer), _t(alive), 9)
        want = pallas_suspicion(jnp.asarray(state), jnp.asarray(timer), jnp.asarray(alive), 9,
                                interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        fp, cnt = fused_fp_count(_t(state), _u32(idv))
        want_fp, want_cnt = pallas_fp(jnp.asarray(state), jnp.asarray(idv), interpret=True)
        np.testing.assert_array_equal(fp.numpy().view(np.uint32), np.asarray(want_fp))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    state, timer, alive, idv = _case(64, np.int16, 4)
    before = dict(_cuda.launches)
    fused_fp_count(_t(state), _u32(idv))
    fused_suspicion(_t(state), _t(timer), _t(alive), 0)
    fused_oldest_k(_t(state), _t(timer), _t(alive), 5)
    assert _cuda.launches == before  # the plain versions launch nothing
    with pytest.raises(ValueError):
        fused_fp_count(_t(state).to(torch.int32), _u32(idv))
    with pytest.raises(ValueError):
        fused_suspicion(_t(state), _t(timer).to(torch.int64), _t(alive), 0)
    with pytest.raises(ValueError):
        fused_oldest_k(_t(state)[:, :32], _t(timer), _t(alive), 5)
    with pytest.raises(ValueError):
        fused_oldest_k(_t(state).to("meta"), _t(timer).to("meta"), _t(alive).to("meta"), 5)
