"""A run with the timed path broken underneath comes out not correct.

The harness runs as on the card (set-up, window, reference, comparison),
with the port wrapped so that its tick commits one fault a simulation can
have: a tick that returns its state unchanged; a tick that leaves half of
the peers (the batch of rows) out, keeping their rows as they were; an
answer altered where it is produced (one cell of the state plane, or one
metric). There is no exchange between chips in a one-chip cell."""

import dataclasses

import pytest
import torch

from portbench import spec
from portbench.tests.conftest import run_small

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _unchanged(st, new, m):
    return dataclasses.replace(new, **{f: getattr(st, f) for f in ("state", "timer")}), m


def _half_rows(st, new, m):
    h = st.state.shape[0] // 2
    keep = {}
    for f in ("state", "timer", "latency", "id_view"):
        a, b = getattr(new, f), getattr(st, f)
        if a is not None:
            keep[f] = torch.cat([a[:h], b[h:]])
    return dataclasses.replace(new, **keep), m


def _altered_cell(st, new, m):
    s = new.state.clone()
    s[1, 2] = 3 - s[1, 2] if s[1, 2] else 1
    return dataclasses.replace(new, state=s), m


def _altered_metric(st, new, m):
    return new, dataclasses.replace(m, messages_delivered=m.messages_delivered + 1)


FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows, "altered_cell": _altered_cell,
          "altered_metric": _altered_metric}


def broken(fault):
    """A factory of the cell's engine's ``Program`` with ``fault`` in its tick."""

    def factory(config, traffic, device):
        class Broken(spec.engine(config["engine"]["tick"]).Program):
            def tick(self, st, inputs, t):
                new, m = super().tick(st, inputs, t)
                return FAULTS[fault](st, new, m)

            def boot(self, st):
                # A boot's ticks are the program's own loop: break its last step.
                new, ticks, conv, m0 = super().boot(st)
                if fault == "altered_metric":
                    return new, ticks + 1, conv, m0
                out, _ = FAULTS[fault](st, new, None)
                return out, ticks, conv, m0

        return Broken(config, traffic, device)

    return factory


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    result, shown = run_small(workload, broken(fault))
    assert not result["correct"], shown
