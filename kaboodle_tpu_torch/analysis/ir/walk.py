"""The dispatch trace that takes the jaxpr's place: every aten op one call makes.

The port of ``kaboodle_tpu/analysis/ir/walk.py``. PyTorch builds no
program, so the IR and rng lanes read what one call of an entry point
*does*: :func:`trace_entry` runs it under :class:`TraceMode`, a
``TorchDispatchMode`` that sees every aten op (as ``costscope/extract.py``
does), and records each as an :class:`Op` -- its name, the dtypes and
shapes it takes and returns, which outputs alias which inputs, and the
nearest user frame that asked for it (:func:`source_of`: the file's
basename and function; the line only for display, so baseline keys stay
line-free, as the JAX keys do). Beside the ops it records:

- host copies made from Python (``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()``), on either device, so the
  CPU and the card record the same events (on the CPU these dispatch no op);
- every call into ``parallel/collectives.py`` with the row block it hands
  over (KB404);
- a hand kernel's wrapper as one opaque unit (``ops/_cuda.py::cost_unit``):
  otherwise the CPU trace would see the plain version's ops and the card's
  none, a ctypes launch being invisible to a dispatch mode.

Where the JAX trace sees both branches of every ``lax.cond``, an eager
call takes one. So a trace is three runs of the entry, each from a fresh
build: the call as it is (``force=None``; its counts are the per-call
numbers), then every device gate read as true and every one read as false
(``force=True``/``False``: the ``_local_scalar_dense`` of a one-element
bool tensor, which every ``if``/``bool()`` on a device value reaches,
answers the forced value). The port's gated phases are identities when
their gate is false, so each forced run is a run the engine can make; with
both arms of every gate taken, the findings do not depend on the state the
entry is called on. :func:`terminal_consumers` follows a value through
view and reshape ops to what finally uses it (KB401's widening
allowlist).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import sys
import weakref
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kaboodle_tpu_torch.costscope.extract import _tensors

_aten = torch.ops.aten
_TORCH_DIR = os.path.dirname(torch.__file__)
_STDLIB_DIR = os.path.dirname(os.__file__)
_ANALYSIS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The scanner's own modules: never a user frame.
_SCANNER = {
    os.path.join(_ANALYSIS_DIR, "ir", "walk.py"),
    os.path.join(_ANALYSIS_DIR, "ir", "scan.py"),
    os.path.join(_ANALYSIS_DIR, "rng", "provenance.py"),
    os.path.join(_ANALYSIS_DIR, "rng", "scan.py"),
}
_THREEFRY = os.path.join(os.path.dirname(_ANALYSIS_DIR), "ops", "threefry.py")

# Ops whose output size depends on the data: each is a host sync on the card.
DATA_DEPENDENT = {
    "aten.nonzero", "aten.masked_select", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.argwhere",
}
# Ops that move a value without computing on it and return a copy (JAX's
# TRANSPARENT_PRIMS' copy and rev); the views among them (reshape,
# transpose, squeeze, slice, broadcast) are told by their aliases.
TRANSPARENT = {"aten.clone", "aten._unsafe_view", "aten.flip", "aten.lift_fresh"}


@dataclasses.dataclass(frozen=True)
class Source:
    """Nearest user frame of an op: file basename, function, line."""

    file: str  # basename, "<unknown>" when attribution failed
    func: str
    line: int  # 0 when unknown

    def render(self) -> str:
        return self.file if not self.line else f"{self.file}:{self.line}"

    @property
    def where(self) -> str:
        """The line-free location that baseline keys embed."""
        return f"{self.file}:{self.func}"


_UNKNOWN = Source("<unknown>", "?", 0)


def _user_frame(frame) -> Any:
    """The nearest frame that is not torch, the standard library, the
    scanner, or the counter RNG's internals."""
    while frame is not None:
        fn = frame.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_STDLIB_DIR) or fn in _SCANNER
                or fn == _THREEFRY or fn.startswith("<")):
            return frame
        frame = frame.f_back
    return None


def source_of(frame=None) -> Source:
    """The :class:`Source` of the nearest user frame above ``frame``
    (the caller's, by default)."""
    f = _user_frame(frame if frame is not None else sys._getframe(1))
    if f is None:
        return _UNKNOWN
    func = f.f_code.co_qualname.replace(".<locals>", "")
    return Source(os.path.basename(f.f_code.co_filename), func, f.f_lineno)


def call_stack(frame) -> tuple:
    """``(file, line)`` of every user frame from ``frame`` up to the scanner:
    the identity of a call site (a loop's iterations share it)."""
    out = []
    while frame is not None and frame.f_code.co_filename not in _SCANNER:
        fn = frame.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_STDLIB_DIR) or fn == _THREEFRY):
            out.append((os.path.basename(fn), frame.f_lineno))
        frame = frame.f_back
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """One tensor an op took or returned: its trace id, dtype and shape."""

    tid: int
    dtype: str
    shape: tuple


@dataclasses.dataclass
class Op:
    """One aten op (or one kernel unit, ``unit:<wrapper>``) of a trace."""

    name: str
    ins: list
    outs: list
    aliases: list  # (out position, in position) pairs where the output is a view of the input
    src: Source
    scalar: bool = False  # a ``_local_scalar_dense`` (``.item()``/``bool()``/``int()``)
    h2d: bool = False  # a copy from the host to the card


@dataclasses.dataclass
class Collective:
    """One call into ``parallel/collectives.py`` with a process group."""

    helper: str
    group_size: int
    blocks: list  # (row length, row dim, dtype, shape) of each row block handed over
    n: int | None  # the peer count a helper is told (``scatter_min``), else None
    src: Source


@dataclasses.dataclass
class Trace:
    """One run of one entry point."""

    entry: str
    force: bool | None
    ops: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)  # (kind, Source)
    collectives: list = dataclasses.field(default_factory=list)
    n_peers: int | None = None
    n_members: int | None = None  # members of an ensemble state this rank holds
    world: int | None = None  # ranks of the process's group (None: no group)
    rng: Any = None  # the run's provenance recorder (analysis/rng/provenance.py)


class TraceMode(TorchDispatchMode):
    """Record every aten op of the entry's call into ``trace`` (module
    docstring); ``force`` answers the one-element bool scalar reads; tensors
    derived from the entry's arguments are *live* (:meth:`is_live`), the
    taint the rng lane roots keys by."""

    def __init__(self, trace: Trace, args):
        super().__init__()
        self.trace = trace
        self._ids: dict[int, tuple] = {}  # id(tensor) -> (weakref, tid, live)
        self._next = 0
        self._depth = 0  # > 0 inside a kernel unit: its ops are not recorded
        for t in _tensors(args):
            self._ref(t, live=True)

    # -- tensor identity --

    def _ref(self, t: torch.Tensor, live: bool = False) -> tuple:
        key = id(t)
        hit = self._ids.get(key)
        if hit is not None and hit[0]() is t:
            if live and not hit[2]:
                hit = (hit[0], hit[1], True)
                self._ids[key] = hit
            return hit
        ids = self._ids

        def gone(_ref, key=key):
            cur = ids.get(key)
            if cur is not None and cur[0] is _ref:
                del ids[key]

        hit = (weakref.ref(t, gone), self._next, live)
        self._next += 1
        self._ids[key] = hit
        return hit

    def is_live(self, t: torch.Tensor) -> bool:
        hit = self._ids.get(id(t))
        return bool(hit is not None and hit[0]() is t and hit[2])

    def _refs(self, ts, live: bool = False) -> list:
        return [TensorRef(self._ref(t, live)[1], str(t.dtype).replace("torch.", ""),
                          tuple(t.shape)) for t in ts]

    # -- dispatch --

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        name = str(func._overloadpacket)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        live = any(self.is_live(t) for t in ins)
        scalar = func is _aten._local_scalar_dense.default
        if (scalar and self.trace.force is not None and ins and ins[0].dtype == torch.bool
                and ins[0].numel() == 1):
            out = bool(self.trace.force)
        aliases = []
        if func.is_view and ins and outs:
            aliases = [(0, 0)]
        else:
            in_ids = {id(t): i for i, t in enumerate(ins)}
            aliases = [(o, in_ids[id(t)]) for o, t in enumerate(outs) if id(t) in in_ids]
        h2d = (func is _aten._to_copy.default and bool(ins) and bool(outs)
               and ins[0].device.type == "cpu" and outs[0].device.type != "cpu")
        self.trace.ops.append(Op(name, self._refs(ins), self._refs(outs, live), aliases,
                                 source_of(sys._getframe(1)), scalar, h2d))
        return out

    def unit(self, fn, args, kwargs, flops: int):
        """Run ``fn`` as one opaque unit (``ops/_cuda.py::cost_unit``)."""
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        if not self._depth:
            ins = _tensors(args) + _tensors(kwargs)
            live = any(self.is_live(t) for t in ins)
            self.trace.ops.append(Op(f"unit:{fn.__name__}", self._refs(ins),
                                     self._refs(_tensors(out), live), [],
                                     source_of(sys._getframe(2))))
        return out


# -- Python-level hooks --------------------------------------------------------

_HOST_METHODS = ("cpu", "numpy", "tolist")
# Unpatched methods, for the scanner's own host reads.
ORIG = {name: getattr(torch.Tensor, name) for name in (*_HOST_METHODS, "to")}


def _is_cpu_target(args, kwargs) -> bool:
    """``.to("cpu")``: the string spelled at the call. A ``torch.device``
    argument is the caller's own device (a no-op on the CPU run), so it is
    not counted on either device."""
    return any(isinstance(a, str) and a.split(":")[0] == "cpu"
               for a in (*args, kwargs.get("device")))


# The collective helpers of parallel/collectives.py, with the row block
# each hands over: (its argument, the row dim: a number or the argument that
# names it); None for a helper whose tensors are replicated.
_COLLECTIVES = {
    "gather_rows": ("x", "dim"), "gather_many": ("xs", "nb"), "transpose": ("plane", -2),
    "ring_or_matmul": ("m", -2), "ring_take_rows": ("plane", -2), "take_cells": ("plane", -2),
    "scatter_or_rows": ("dst", -2), "fingerprint_agreement": ("alive", -1),
    "scatter_min": None, "global_any": None, "member_any": None, "reduce_sum": None,
    "reduce_min": None, "reduce_max": None, "reduce_sum_many": None,
}


@contextlib.contextmanager
def _patched(trace: Trace) -> Iterator[None]:
    """Install the Python-level hooks: host copies, collectives, kernel units."""
    from kaboodle_tpu_torch.ops import _cuda
    from kaboodle_tpu_torch.parallel import collectives as C

    saved_t = {name: torch.Tensor.__dict__.get(name) for name in (*_HOST_METHODS, "to")}
    saved_c = {name: getattr(C, name) for name in _COLLECTIVES}
    saved_sync = torch.cuda.synchronize
    depth = [0]

    def host(kind):
        def wrapped(self, *args, **kwargs):
            if kind != "to" or _is_cpu_target(args, kwargs):
                trace.host.append((".to(\"cpu\")" if kind == "to" else f".{kind}()",
                                   source_of(sys._getframe(1))))
            return ORIG[kind](self, *args, **kwargs)
        return wrapped

    def coll(name, fn):
        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            if depth[0] == 0 and a["group"] is not None:
                blocks = []
                if _COLLECTIVES[name] is not None:
                    arg, dim = _COLLECTIVES[name]
                    dim = a[dim] if isinstance(dim, str) else dim
                    for x in (a[arg] if arg == "xs" else [a[arg]]):
                        blocks.append((int(x.shape[dim]), int(dim),
                                       str(x.dtype).replace("torch.", ""), tuple(x.shape)))
                trace.collectives.append(Collective(name, C.size(a["group"]), blocks,
                                                    a.get("n"), source_of(sys._getframe(1))))
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return wrapped

    def sync(*args, **kwargs):
        trace.host.append(("torch.cuda.synchronize()", source_of(sys._getframe(1))))
        return saved_sync(*args, **kwargs)

    try:
        for name in (*_HOST_METHODS, "to"):
            setattr(torch.Tensor, name, host(name))
        for name, fn in saved_c.items():
            setattr(C, name, coll(name, fn))
        torch.cuda.synchronize = sync
        yield
    finally:
        torch.cuda.synchronize = saved_sync
        for name, fn in saved_c.items():
            setattr(C, name, fn)
        for name, fn in saved_t.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        _cuda.counter = None


def _state_sizes(args) -> tuple:
    """``(peers, members)`` of an entry's state: the whole column axis of
    its first ``state`` plane, and the leading member axis of an ensemble
    (``[E, B, N]``; None for one mesh)."""
    for a in args:
        st = getattr(a, "state", None)
        if isinstance(st, torch.Tensor) and st.dim() >= 2:
            return int(st.shape[-1]), (int(st.shape[0]) if st.dim() == 3 else None)
    return None, None


def run_traced(name: str, fn, args, force: bool | None = None, rng: bool = False) -> Trace:
    """One recorded call ``fn(*args)`` (module docstring); with ``rng``, the
    counter-RNG calls are recorded too (``trace.rng``)."""
    from kaboodle_tpu_torch.ops import _cuda

    import torch.distributed as dist

    peers, members = _state_sizes(args)
    world = dist.get_world_size() if dist.is_initialized() else None
    trace = Trace(name, force, n_peers=peers, n_members=members, world=world)
    mode = TraceMode(trace, args)
    rec = None
    if rng:
        from kaboodle_tpu_torch.analysis.rng.provenance import Recorder

        rec = trace.rng = Recorder(name, mode, run=force)
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(trace))
        if rec is not None:
            stack.enter_context(rec.installed())
        stack.enter_context(mode)
        _cuda.counter = mode
        fn(*args)
    return trace


def trace_entry(entry, device=None, rng: bool = False) -> list[Trace]:
    """The three recorded runs of one registry entry (module docstring),
    each from a fresh build after one warm-up call that fills the process
    caches (lazily built tables are then not charged to the call)."""
    fn, args = entry.build(device)
    fn(*args)
    runs = []
    for force in (None, True, False):
        fn, args = entry.build(device)
        runs.append(run_traced(entry.name, fn, args, force=force, rng=rng))
    return runs


# ---------------------------------------------------------------------------
# consumer analysis (KB401 lean-widening allowlist)


def terminal_consumers(ops: list, start: int, tid: int, _depth: int = 0) -> set[str]:
    """Op names that ultimately consume tensor ``tid`` after op ``start``:
    transparent ops (views, reshapes, copies) are followed to their own
    consumers. A value no later op reads reports ``"<output>"`` (it
    escapes the call, as JAX's ``"<jaxpr-output>"``)."""
    if _depth > 16:
        return {"<depth-limit>"}
    out: set[str] = set()
    for j in range(start + 1, len(ops)):
        op = ops[j]
        if not any(r.tid == tid for r in op.ins):
            continue
        if (op.aliases or op.name in TRANSPARENT) and op.outs:
            for r in op.outs:
                out |= terminal_consumers(ops, j, r.tid, _depth + 1)
        else:
            out.add(op.name.replace("aten.", ""))
    return out or {"<output>"}


def nbytes(ref: TensorRef) -> int:
    size = 1
    for d in ref.shape:
        size *= int(d)
    return size * getattr(torch, ref.dtype).itemsize
