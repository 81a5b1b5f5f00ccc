"""The whole-plane engine: every pass over the full ``[N, N]`` planes.

The port's tick is ``phasegraph/exec.py::make_tick_fn`` (the faulty build
where the mix has churn, partitions or drops); a boot is ``converge_loop``
over the fault-free build. The reference's is ``reference/dense.py``.
"""

from __future__ import annotations

from portbench.program import ProgramBase
from portbench.reference.dense import make_tick
from portbench.refprog import ReferenceBase


class Program(ProgramBase):
    def build(self, cfg, engine: dict, traffic: dict):
        from kaboodle_tpu_torch.phasegraph.exec import make_tick_fn

        faulty = bool(traffic.get("faulty", False))
        return make_tick_fn(cfg, faulty=faulty), None, make_tick_fn(cfg, faulty=False)


class Reference(ReferenceBase):
    def build(self, proto: dict, engine: dict, traffic: dict):
        faulty = bool(traffic.get("faulty", False))
        return (make_tick(proto, faulty=faulty, fdt=self.fdt), None,
                make_tick(proto, faulty=False, fdt=self.fdt))
