"""Multi-process mesh proof for the port: the sharded tick over a real 2-process cluster.

The port's twin of tests/test_multihost.py: two OS processes, joined by
``make_multihost_mesh`` (a ``tcp://`` coordinator, gloo collectives), run
the row-sharded tick over the same schedule; their trajectory digests must
equal each other's, the port's single-process dense run and the JAX
package's single-process run. The zero-argument path is proven too: under
``torchrun``'s environment (set here, as ``torchrun`` sets it) and on a
plain host, where it gives a one-rank group. Every group of ranks is
started once, at once, by a module fixture, with a hard wall limit that
kills them.
"""

import numpy as np
import pytest
import torch

from kaboodle_tpu.config import SwimConfig as JaxSwimConfig
from kaboodle_tpu.sim import runner as jrunner
from kaboodle_tpu.sim import state as jstate
from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.parallel.worker import start_workers
from kaboodle_tpu_torch.sim import runner
from kaboodle_tpu_torch.sim.state import idle_inputs, init_state, metrics_to_numpy

_N, _TICKS = 64, 8
INIT = dict(seed=3, track_latency=False, instant_identity=True)
CFG = dict(deterministic=True)
LAUNCHES = {"tcp": 2, "env": 2, "plain": 1}


@pytest.fixture(scope="module")
def digests(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    np.savez(tmp / "idle.npz", **{k: v.numpy() for k, v in
                                  vars(idle_inputs(_N, ticks=_TICKS, device="cpu")).items()
                                  if v is not None})
    case = dict(name="mh", kind="simulate", n=_N, cfg=CFG, init=INIT,
                inputs=str(tmp / "idle.npz"), faulty=False)
    jobs = {launch: start_workers(world, {"device": "cpu", "timeout_s": 60, "cases": [case]},
                                  str(tmp / f"{launch}.json"), timeout_s=90, launch=launch)
            for launch, world in LAUNCHES.items()}
    return {launch: job.wait()["mh"] for launch, job in jobs.items()}


def _reference():
    st = init_state(_N, device="cpu", **INIT)
    _, m = runner.simulate(st, idle_inputs(_N, ticks=_TICKS, device="cpu"), SwimConfig(**CFG),
                           faulty=False)
    return metrics_to_numpy(m)


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_processes_agree_with_each_other(digests, launch):
    ranks = digests[launch]
    assert [d["rank"] for d in ranks] == list(range(LAUNCHES[launch]))
    assert all(d["world"] == LAUNCHES[launch] for d in ranks)
    assert all(d["rows"] == _N // LAUNCHES[launch] for d in ranks)
    assert len({d["digest"] for d in ranks}) == 1
    assert len({tuple(d["messages"]) for d in ranks}) == 1


@pytest.mark.parametrize("launch", list(LAUNCHES))
def test_matches_the_single_process_runs(digests, launch):
    """The cluster's trajectory equals the port's dense run and the JAX
    package's single-process run (its unsharded path: the stronger pin)."""
    got = digests[launch][0]
    jst = jstate.init_state(_N, **INIT)
    _, jm = jrunner.simulate(jst, jstate.idle_inputs(_N, ticks=_TICKS),
                             JaxSwimConfig(**CFG), faulty=False)
    for want in (_reference(), {f: np.asarray(getattr(jm, f)) for f in (
            "messages_delivered", "fingerprint_min", "fingerprint_max", "converged")}):
        assert got["messages"] == want["messages_delivered"].tolist()
        assert got["fp_min"] == want["fingerprint_min"].tolist()
        assert got["fp_max"] == want["fingerprint_max"].tolist()
        assert got["converged"] == want["converged"].tolist()
    assert got["final_tick"] == _TICKS


def test_every_launch_ran_the_same_trajectory(digests):
    """One schedule, three launches (2 ranks by address, 2 by torchrun's
    environment, 1 plain): the gathered final states are the same bits."""
    assert len({ranks[0]["digest"] for ranks in digests.values()}) == 1
    assert not torch.distributed.is_initialized()  # the groups lived only in the workers
