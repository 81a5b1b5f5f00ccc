"""The row-blocked engine: each ``[N, N]`` pass a loop over ``[block, N]`` row blocks.

The port's tick is ``phasegraph/blocked.py::make_chunked_tick_fn`` at the
configuration's ``block`` (random drop on where the mix drops); a boot is
its closed-form union tick 0, then ``converge_loop`` over the fault-free
build. The reference's is ``reference/blocked.py``.
"""

from __future__ import annotations

from portbench.program import ProgramBase
from portbench.reference.blocked import make_blocked_tick
from portbench.refprog import ReferenceBase


class Program(ProgramBase):
    def build(self, cfg, engine: dict, traffic: dict):
        from kaboodle_tpu_torch.phasegraph.blocked import make_chunked_tick_fn

        faulty, block = bool(traffic.get("faulty", False)), engine["block"]
        return (make_chunked_tick_fn(cfg, faulty=faulty, block=block, drop="drop" in traffic),
                make_chunked_tick_fn(cfg, faulty=False, block=block, boot_union=True),
                make_chunked_tick_fn(cfg, faulty=False, block=block))


class Reference(ReferenceBase):
    def build(self, proto: dict, engine: dict, traffic: dict):
        faulty, block = bool(traffic.get("faulty", False)), engine["block"]
        return (make_blocked_tick(proto, block, faulty=faulty, drop="drop" in traffic,
                                  fdt=self.fdt),
                make_blocked_tick(proto, block, faulty=False, boot_union=True, fdt=self.fdt),
                make_blocked_tick(proto, block, faulty=False, fdt=self.fdt))
