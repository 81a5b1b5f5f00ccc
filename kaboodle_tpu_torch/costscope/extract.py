"""Static cost plane: run each registry entry once under a dispatch counter.

The port of ``kaboodle_tpu/costscope/extract.py``. The JAX module compiles
each entry on XLA's CPU backend and reads ``cost_analysis()`` and
``memory_analysis()``. PyTorch has no whole-program compiler, so this
module counts by dispatch: it runs the entry once (after one warm-up call
that fills the process caches) under a ``TorchDispatchMode`` that sees
every aten op, and derives the JAX record's fields from what the ops
touch. The record is defined on the CPU path and needs no card; on the
card the same counter gives the same record (``chip_smoke.py``'s
``costscope`` phase holds the two equal). The conventions:

- ``flops``: ``torch.utils.flop_counter``'s formula for the ops it knows
  (``mm``, ``bmm``, ...), plus one per output element of every other
  arithmetic op (pointwise-tagged ops and reductions);
- ``bytes_accessed``: the bytes of every tensor an op takes plus every
  tensor it returns (numel x element size), summed over the ops. View
  ops, allocation-only ops (``empty*``) and ops with no tensor result
  (``item()``) count nothing;
- a copy from the card to the host (``.cpu()``, ``.tolist()`` of a card
  tensor) is not part of the record: the CPU path has no such op. A host
  scalar written into a card tensor counts as the same write does on the
  CPU;
- ``argument_bytes`` / ``output_bytes``: the bytes of the entry's
  flattened argument and output tensors;
- ``peak_bytes``: the high-water mark of live storage bytes, arguments
  included. A storage lives from the op that first touches it (the
  arguments' from the start) to the op that last touches it (the
  arguments' and outputs' to the end); the counter holds every storage it
  has seen, so no address is reused while it is open;
- ``temp_bytes``: ``peak - argument - output``, clamped at 0;
  ``generated_code_bytes``: 0 (no generated code);
- units: a hand kernel's wrapper and ``phasegraph/exec.py::_bool_matmul``
  are one unit each (``ops/_cuda.py::cost_unit``): their tensor arguments
  and outputs, the operations their decorator states (one a scanned cell
  for a kernel, ``2·M·K·N`` for the product), nothing of what runs inside.
  Otherwise the CPU record would count the kernels' plain versions and
  the CPU's int32 product instead of the card's int8 one, and a ctypes
  launch is invisible to a dispatch mode anyway;
- ``ici_bytes`` / ``collectives``: the collectives the entry made
  (``parallel/collectives.py::record_collectives``, audited by
  ``costscope/collectives.py``); 0 and ``{}`` for a one-device entry.

The sharded entries need a process group: :func:`extract_entries` runs
them in one gloo job of :data:`MESH_DEVICES` ranks
(``parallel/worker.py``'s ``costscope`` case), and rank 0's record is the
entry's. The numbers are trace-scale (``TRACE_N = 32``): they gate shape
regressions (a doubled dtype, a materialised ``[N, N]`` temp, a new
collective), not production footprints. A record is deterministic: two
extractions give the same dict.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

MESH_DEVICES = 8

_aten = torch.ops.aten
# Ops that allocate or only hand back their input: they move no bytes.
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
             _aten.new_empty_strided, _aten.lift_fresh, _aten.resize_, _aten.set_}
# Copies, skipped where they bring a card tensor to the host.
_COPIES = {_aten._to_copy, _aten.copy_, _aten._copy_from, _aten._copy_from_and_resize}
# Reductions: one operation an output element, as pointwise ops.
_REDUCTIONS = {_aten.sum, _aten.prod, _aten.amin, _aten.amax, _aten.min, _aten.max,
               _aten.any, _aten.all, _aten.argmin, _aten.argmax, _aten.mean, _aten.cumsum,
               _aten.cumprod, _aten.count_nonzero, _aten.scatter_reduce, _aten.scatter_add,
               _aten.index_add, _aten.sort, _aten.topk}


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor in ``obj`` (dataclasses, sequences, dicts), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CostCounter(TorchDispatchMode):
    """Count the aten ops run while open (module docstring's conventions).

    ``by_op`` keeps ``[calls, bytes, flops]`` per op name (units under
    ``unit:<wrapper>``), to name the op where two records differ."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.by_op: dict[str, list[int]] = collections.defaultdict(lambda: [0, 0, 0])
        self._depth = 0  # > 0 inside a unit: its ops are not counted
        self._storages: dict[int, Any] = {}  # id -> storage, held so ids stay unique
        self._first: dict[int, int] = {}
        self._last: dict[int, int] = {}
        self._events = 0

    def _touch(self, ts) -> None:
        for t in ts:
            s = t.untyped_storage()
            if s.nbytes() == 0:
                continue
            key = id(s)
            if key not in self._storages:
                self._storages[key] = s
                self._first[key] = self._events
            self._last[key] = self._events
        self._events += 1

    def _count(self, name: str, ins, outs, flops: int, moves: bool) -> None:
        nbytes = _nbytes(ins) + _nbytes(outs) if moves else 0
        self.flops += flops
        self.bytes_accessed += nbytes
        row = self.by_op[name]
        row[0] += 1
        row[1] += nbytes
        row[2] += flops
        self._touch(ins + outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        packet = func._overloadpacket
        if (packet in _COPIES and any(t.device.type == "cpu" for t in outs)
                and any(t.device.type != "cpu" for t in ins)):
            return out
        moves = bool(outs) and not func.is_view and packet not in _NO_BYTES
        flops = 0
        if moves:
            from torch.utils.flop_counter import flop_registry

            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            elif torch.Tag.pointwise in func.tags or packet in _REDUCTIONS:
                flops = sum(t.numel() for t in outs)
        self._count(str(packet), ins, outs, flops, moves)
        return out

    def unit(self, fn, args, kwargs, flops: int):
        """Run ``fn`` as one unit (``ops/_cuda.py::cost_unit``)."""
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        if not self._depth:
            self._count(f"unit:{fn.__name__}", _tensors(args) + _tensors(kwargs),
                        _tensors(out), flops, True)
        return out

    def peak_bytes(self, args, out) -> int:
        """High-water mark of live storage bytes (module docstring)."""
        held = {id(t.untyped_storage()) for t in _tensors(args)}
        kept = held | {id(t.untyped_storage()) for t in _tensors(out)}
        end = self._events
        delta = [0] * (end + 2)
        untouched = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                     for t in _tensors(args) if id(t.untyped_storage()) not in self._storages}
        base = sum(untouched.values())  # arguments' storages the entry never touched
        for key, s in self._storages.items():
            born = 0 if key in held else self._first[key]
            dies = end if key in kept else self._last[key]
            delta[born] += s.nbytes()
            delta[dies + 1] -= s.nbytes()
        peak = live = 0
        for d in delta:
            live += d
            peak = max(peak, live)
        return base + peak


def _count_run(fn, args):
    """Run ``fn(*args)`` under a counter; ``(counter, out, collective log)``."""
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.parallel.collectives import record_collectives

    counter = CostCounter()
    with record_collectives() as log, counter:
        _cuda.counter = counter
        try:
            out = fn(*args)
        finally:
            _cuda.counter = None
    return counter, out, log


def measure(entry, device=None) -> tuple[dict[str, Any], Any, dict]:
    """One entry's static record: ``(record, (out, whole), by_op)``.

    A warm-up call from a fresh build fills the process caches first, so
    the counted call is the same whichever entry ran before; then a fresh
    build (the programs may write their arguments in place) runs counted.
    ``whole`` is the output brought whole onto this rank (``out`` itself
    unless sharded); ``by_op`` is the counter's per-op table."""
    from kaboodle_tpu_torch.costscope.collectives import collective_audit

    fn, args = entry.build(device)
    fn(*args)
    fn, args = entry.build(device)
    counter, out, log = _count_run(fn, args)
    audit = collective_audit(log)
    arg_b, out_b = _nbytes(_tensors(args)), _nbytes(_tensors(out))
    peak = counter.peak_bytes(args, out)
    record = {
        "flops": int(counter.flops),
        "bytes_accessed": int(counter.bytes_accessed),
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": max(peak - arg_b - out_b, 0),
        "generated_code_bytes": 0,
        "peak_bytes": int(peak),
        "ici_bytes": int(audit["ici_bytes"]),
        "collectives": audit["counts"],
        "sharded": bool(entry.sharded),
    }
    gather = getattr(fn, "gather", None)
    whole = out if gather is None else gather(out, args)
    return record, (out, whole), {k: list(v) for k, v in sorted(counter.by_op.items())}


def cost_record(entry, device=None) -> dict[str, Any]:
    """The static record of one entry (see :func:`measure`)."""
    return measure(entry, device)[0]


def run_sharded(names: list[str], world: int = MESH_DEVICES, out: str | None = None,
                timeout_s: float = 300.0) -> dict[str, dict[str, Any]]:
    """Records of sharded entries from one gloo job of ``world`` ranks (rank
    0's); with ``out``, rank 0 also writes every entry's whole outputs
    there (``.npz``, keys ``<entry>|<path>``)."""
    import tempfile
    from pathlib import Path

    from kaboodle_tpu_torch.parallel.worker import start_workers

    with tempfile.TemporaryDirectory() as tmp:
        case = {"name": "costscope", "kind": "costscope", "entries": list(names)}
        if out:
            case["out"] = out
        spec = {"device": "cpu", "timeout_s": timeout_s, "cases": [case]}
        digests = start_workers(world, spec, str(Path(tmp) / "cases.json"),
                                timeout_s=timeout_s).wait()
    return digests["costscope"][0]["records"]


def extract_entries(names: list[str] | None = None) -> dict[str, dict[str, Any]]:
    """Walk the registry (or a named subset) on the CPU and extract every
    record; the sharded entries in one gloo job. Unknown names raise
    ``KeyError``; a failing entry raises rather than shrink the surface."""
    from kaboodle_tpu_torch.analysis.ir.registry import ENTRY_POINTS, select_entries

    entries = select_entries(names) if names else ENTRY_POINTS
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {e.name: cost_record(e, "cpu") for e in entries if not e.sharded}
    finally:
        torch.set_num_threads(threads)
    sharded = [e.name for e in entries if e.sharded]
    if sharded:
        out.update(run_sharded(sharded))
    return {e.name: out[e.name] for e in entries}
