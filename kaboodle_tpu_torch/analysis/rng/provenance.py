"""Key-provenance graphs recorded at the port's counter-RNG calls (keyscope).

The port of ``kaboodle_tpu/analysis/rng/provenance.py``. The JAX walker
reads the threefry lifecycle off a jaxpr (``random_seed``, ``random_split``,
``random_fold_in``, ``random_bits``). The port draws only through its own
counter RNG, ``ops/threefry.py`` (``prng_key``, ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``gumbel_order_bits``, ``draw_chunks``), which
``phasegraph/rng.py`` composes into its stream keys. While a traced run is
open (``analysis/ir/walk.py::run_traced``) :class:`Recorder` replaces those
module attributes with recording twins; nothing in the production path
changes or pays for it. It rebuilds JAX's graph:

- **roots** -- ``counter_seed`` (``prng_key`` of a seed derived from the
  entry's arguments: ``stream_key(seed, cursor, ...)``, ``tick_stream_key``
  on the carried key), ``carried_key`` (a key that comes from the
  arguments with no recorded derivation), and their resume-impure twins
  ``const_seed`` / ``const_key`` (key material made inside the call: a
  literal at the call site, or a tensor not derived from the arguments);
- **edges** -- ``split`` / ``row`` / ``fold``. A fold's constant is shown
  when it is a constant of the program, as a jaxpr literal is: a literal
  at the call site, a tensor not derived from the arguments (the batched
  stream ids), or the stream fold of a counter key (the fold on
  ``root -> fold[counter]``: the ``STREAM_*`` id); a tick, a cursor or a
  loop index is data, ``fold[?]``;
- **sinks** -- one per logical draw. A key is identified by its words'
  values (the port passes keys as word pairs through views and slices a
  jaxpr would show as ``random_wrap``/``slice``). A draw split into row
  chunks (``threefry.draw_chunks``) or made in a Python loop over row
  blocks or ticks (the jaxpr's one scan body) is one sink: sinks are
  identified by their call site (the stack of user frames), key descriptor
  and logical shape, so the N = 32 registry and a full-width tick give the
  same list.

``Sink`` and ``ProvenanceGraph`` keep JAX's fields and ``descr()``
strings (``counter_seed/fold[?]/fold[9]``). A sink's ``path`` names the
run it came from (``analysis/ir/walk.py``: as-is, gates forced true,
gates forced false): sinks of different runs are mutually exclusive, as
the branches of a ``lax.cond`` are. Rules (KB601-KB605) live in
:mod:`kaboodle_tpu_torch.analysis.rng.rules`; this module only builds the
graph.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import inspect
import linecache
import math
import sys
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import _disable_current_modes

from kaboodle_tpu_torch.analysis.ir.walk import ORIG, Source, call_stack, source_of

ROOT_KINDS = frozenset({"carried_key", "counter_seed", "const_key", "const_seed"})
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(eq=False)
class Node:
    """One key in the provenance DAG (identity-hashed).

    ``descr()`` is the canonical, engine-portable name of the derivation
    chain, as in the JAX package: KB602 groups folds and KB604 compares
    engines on descriptors, never on node identity."""

    kind: str  # ROOT_KINDS | "split" | "row" | "fold"
    parents: tuple = ()
    taint: frozenset = frozenset()  # {0} when derived from the entry's arguments
    looped: bool = False
    m: int | None = None  # split width
    row: int | None = None  # row index within the parent split
    const: Any = None  # fold constant (None = data, "?")
    src: Source | None = None
    _descr: str | None = dataclasses.field(default=None, repr=False)

    def descr(self) -> str:
        if self._descr is None:
            self._descr = self._render()
        return self._descr

    def _render(self) -> str:
        if self.kind in ROOT_KINDS:
            return self.kind
        p = self.parents[0].descr() if self.parents else "?"
        if self.kind == "split":
            return f"{p}/split{self.m}"
        if self.kind == "row":
            return f"{p}[{self.row}]"
        if self.kind == "fold":
            c = "?" if self.const is None else self.const
            return f"{p}/fold[{c}]"
        return f"{p}/{self.kind}"

    def roots(self) -> frozenset:
        """Root *kinds* reachable upward from this node."""
        out, stack, seen = set(), [self], set()
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if n.kind in ROOT_KINDS:
                out.add(n.kind)
            stack.extend(n.parents)
        return frozenset(out)

    def layout_row(self) -> int | None:
        """Row index of the nearest split-row ancestor (self included)."""
        n = self
        seen: set[int] = set()
        while n is not None and id(n) not in seen:
            seen.add(id(n))
            if n.kind == "row":
                return n.row
            n = n.parents[0] if n.parents else None
        return None


@dataclasses.dataclass(eq=False)
class Sink:
    """One logical draw and the key node feeding it."""

    node: Node
    shape: tuple
    bit_width: int
    nbytes: int
    source: Source
    path: tuple  # ((run label, 0),): the run that drew it
    looped: bool  # the same key drawn again at the same site (a loop)

    def descr(self) -> str:
        return self.node.descr()


@dataclasses.dataclass(eq=False)
class ProvenanceGraph:
    """Everything keyscope's rules need about one entry."""

    entry: str
    sinks: list = dataclasses.field(default_factory=list)
    folds: list = dataclasses.field(default_factory=list)  # every fold Node, one per site
    roots: list = dataclasses.field(default_factory=list)  # every root Node
    # Per-run sinks, one per site and key (KB601 compares within a run).
    run_sinks: list = dataclasses.field(default_factory=list)

    def sink_descrs(self) -> tuple:
        """Sorted multiset of sink descriptors -- the KB604 fingerprint."""
        return tuple(sorted(s.descr() for s in self.sinks))


# -- call-site literals ---------------------------------------------------------


def _call_arg_literal(frame, pos: int, kw: str) -> bool:
    """Is argument ``pos`` (or keyword ``kw``) of the call ``frame`` is
    executing a literal in the source (``prng_key(0)``, ``fold_in(k, 3)``)?"""
    try:
        p = inspect.getframeinfo(frame, context=0).positions
        lines = linecache.getlines(frame.f_code.co_filename)
        if p.lineno == p.end_lineno:
            seg = lines[p.lineno - 1][p.col_offset:p.end_col_offset]
        else:
            seg = (lines[p.lineno - 1][p.col_offset:] + "".join(lines[p.lineno:p.end_lineno - 1])
                   + lines[p.end_lineno - 1][:p.end_col_offset])
        call = ast.parse(seg.strip(), mode="eval").body
        if not isinstance(call, ast.Call):
            return False
        args = {k.arg: k.value for k in call.keywords}
        node = call.args[pos] if pos < len(call.args) else args.get(kw)
        if node is None:
            return False
        ast.literal_eval(node)
        return True
    except Exception:
        return False


def _words(x) -> tuple:
    """A key word's values (an int, or a tensor's elements), unsigned. Read
    with the trace's dispatch mode off: the scanner's reads are not ops of
    the entry."""
    if isinstance(x, torch.Tensor):
        with _disable_current_modes():
            return tuple(int(v) & _M32 for v in ORIG["tolist"](x.detach().reshape(-1)))
    return (int(x) & _M32,)


def _batch(key) -> tuple:
    w = key[0]
    return tuple(w.shape) if isinstance(w, torch.Tensor) else ()


# -- the recorder -----------------------------------------------------------------


class Recorder:
    """Record one traced run's key provenance (module docstring). ``mode``
    is the run's ``TraceMode`` (its :meth:`is_live` taint); ``run`` the
    run's force label."""

    def __init__(self, entry: str, mode, run=None):
        self.entry = entry
        self.mode = mode
        self.run = run
        self.roots: list[Node] = []
        self._by_value: dict[tuple, Node] = {}
        self._folds: dict[tuple, Node] = {}  # (site, parent descr, const) -> Node
        self._sinks: dict[tuple, Sink] = {}  # (site, node id, shape) -> Sink
        self._calls: dict[tuple, int] = {}  # (site, node id) -> draw call token
        self._parts: dict[int, tuple] = {}  # id(part) -> (part, parent key, shape, site, token)
        self._tokens = 0
        self._depth = 0

    # -- liveness --

    def _live_word(self, x, frame, pos: int, kw: str) -> bool:
        if isinstance(x, torch.Tensor):
            return self.mode.is_live(x)
        return not _call_arg_literal(frame, pos, kw)

    def _live_key(self, key, frame, pos: int, kw: str) -> bool:
        if isinstance(key, tuple) and any(isinstance(w, torch.Tensor) for w in key):
            return any(self.mode.is_live(w) for w in key if isinstance(w, torch.Tensor))
        return not _call_arg_literal(frame, pos, kw)

    # -- nodes --

    def _value(self, key) -> tuple:
        return (_words(key[0]), _words(key[1]))

    def _root(self, kind: str, live: bool, src: Source) -> Node:
        n = Node(kind, (), frozenset({0}) if live else frozenset(), src=src)
        self.roots.append(n)
        return n

    def node_of(self, key, frame, pos: int = 0, kw: str = "key") -> Node:
        """The node of ``key``'s value; a key with no recorded derivation
        enters here, as a ``carried_key`` (or ``const_key``) root."""
        v = self._value(key)
        n = self._by_value.get(v)
        if n is None:
            live = self._live_key(key, frame, pos, kw)
            n = self._root("carried_key" if live else "const_key", live, source_of(frame))
            self._by_value[v] = n
        return n

    def _register(self, key, node: Node) -> None:
        self._by_value[self._value(key)] = node

    def _fold(self, parent: Node, const, site, src: Source) -> Node:
        # A constant fold on one parent is one node (JAX canonicalises it);
        # a data fold (a tick, a loop index) never is.
        key = (site, parent.descr(), const, id(parent) if const is not None else self._token())
        n = self._folds.get(key)
        if n is None:
            n = Node("fold", (parent,), parent.taint, looped=parent.looped, const=const, src=src)
            self._folds[key] = n
        return n

    # -- sinks --

    def _sink(self, node: Node, shape: tuple, site, src: Source, token: int) -> None:
        shape = tuple(int(d) for d in shape)
        key = (site, id(node), shape)
        s = self._sinks.get(key)
        if s is None:
            self._sinks[key] = Sink(node, shape, 32, 4 * math.prod(shape), src,
                                    (("run", str(self.run)),), False)
        prev = self._calls.setdefault((site, id(node)), token)
        if prev != token:
            self._sinks[key].looped = True

    def _token(self) -> int:
        self._tokens += 1
        return self._tokens

    # -- the recording twins of ops/threefry.py --

    def _twins(self, tf) -> dict:
        orig = {name: getattr(tf, name) for name in (
            "prng_key", "fold_in", "split", "random_bits", "uniform", "gumbel_order_bits",
            "draw_chunks")}
        rec = self

        @contextlib.contextmanager
        def inner():
            rec._depth += 1
            try:
                yield
            finally:
                rec._depth -= 1

        def prng_key(seed):
            with inner():
                out = orig["prng_key"](seed)
            if rec._depth == 0:
                frame = sys._getframe(1)
                live = rec._live_word(seed, frame, 0, "seed")
                rec._register(out, rec._root("counter_seed" if live else "const_seed", live,
                                             source_of(frame)))
            return out

        def fold_in(key, data):
            with inner():
                out = orig["fold_in"](key, data)
            if rec._depth:
                return out
            frame = sys._getframe(1)
            site, src = call_stack(frame), source_of(frame)
            parent = rec.node_of(key, frame)
            if isinstance(data, torch.Tensor):
                consts = None if rec.mode.is_live(data) else _words(data)
            elif _call_arg_literal(frame, 1, "data") or (
                    parent.kind == "fold" and parent.const is None and parent.parents
                    and parent.parents[0].kind in ROOT_KINDS):
                consts = _words(data)
            else:
                consts = None
            ow0 = out[0]
            cols = isinstance(ow0, torch.Tensor) and isinstance(data, torch.Tensor) \
                and data.dim() == 1 and ow0.dim() >= 1 and ow0.shape[-1] == data.shape[0] \
                and data.shape[0] > 1 and not (isinstance(key[0], torch.Tensor)
                                               and key[0].shape[-1:] == data.shape)
            if cols:  # a batched fold: one key per column
                for i in range(data.shape[0]):
                    c = None if consts is None else consts[i]
                    with _disable_current_modes():
                        col = (out[0][..., i], out[1][..., i])
                    rec._register(col, rec._fold(parent, c, site, src))
            else:
                c = None if consts is None or len(set(consts)) != 1 else consts[0]
                rec._register(out, rec._fold(parent, c, site, src))
            return out

        def split(key, num=2):
            with inner():
                out = orig["split"](key, num)
            if rec._depth == 0:
                frame = sys._getframe(1)
                parent = rec.node_of(key, frame)
                sp = Node("split", (parent,), parent.taint, m=int(num), src=source_of(frame))
                for i, row in enumerate(out):
                    rec._register(row, Node("row", (sp,), sp.taint, row=i))
            return out

        def draw(name, shape_of):
            def fn(key, shape, *args, **kwargs):
                if rec._depth == 0:
                    frame = sys._getframe(1)
                    part = rec._parts.get(id(key))
                    if part is not None and part[0] is key:
                        _, parent_key, full, site, token = part
                        node = rec.node_of(parent_key, frame)
                    else:
                        site, token = call_stack(frame), rec._token()
                        node = rec.node_of(key, frame)
                        full = _batch(key) + shape_of(shape)
                    rec._sink(node, full, site, source_of(frame), token)
                with inner():
                    return orig[name](key, shape, *args, **kwargs)
            return fn

        def draw_chunks(key, n_rows, n_cols, row0=0):
            frame = sys._getframe(1)
            site, token = call_stack(frame), rec._token()
            full = _batch(key) + (int(n_rows), int(n_cols))
            for part, at, rows in orig["draw_chunks"](key, n_rows, n_cols, row0):
                if rec._depth == 0:
                    rec._parts[id(part)] = (part, key, full, site, token)
                yield part, at, rows

        return {
            "prng_key": prng_key, "fold_in": fold_in, "split": split,
            "random_bits": draw("random_bits", tuple),
            "uniform": draw("uniform", tuple),
            "gumbel_order_bits": draw("gumbel_order_bits", tuple),
            "draw_chunks": draw_chunks,
        }

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        """Replace the counter RNG's module attributes for the block."""
        from kaboodle_tpu_torch.ops import threefry as tf

        twins = self._twins(tf)
        saved = {name: getattr(tf, name) for name in twins}
        try:
            for name, fn in twins.items():
                setattr(tf, name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(tf, name, fn)

    # -- results --

    def sinks(self) -> list:
        """``(site, sink)`` of every draw, one per site, key node and shape."""
        return [(site, s) for (site, _, _), s in self._sinks.items()]

    def folds(self) -> list:
        return [(site, n) for (site, *_), n in self._folds.items()]


def build_graph(entry: str, recorders) -> ProvenanceGraph:
    """Merge the runs' recorders of one entry into its graph: sinks and
    folds one per call site (and descriptor and shape) across runs, and
    each run's own sinks for KB601."""
    g = ProvenanceGraph(entry)
    seen_sinks, seen_folds = set(), set()
    for rec in recorders:
        for site, s in rec.sinks():
            g.run_sinks.append(s)
            k = (site, s.descr(), s.shape)
            if k not in seen_sinks:
                seen_sinks.add(k)
                g.sinks.append(s)
        for site, n in rec.folds():
            k = (site, n.parents[0].descr(), n.const)
            if k not in seen_folds:
                seen_folds.add(k)
                g.folds.append(n)
        g.roots.extend(rec.roots)
    return g


# -- transport (the sharded entries come back from worker processes) --------------


def graph_to_dict(g: ProvenanceGraph) -> dict:
    """A JSON-able copy of ``g`` (nodes by index)."""
    nodes: dict[int, int] = {}
    table: list[dict] = []

    def idx(n: Node) -> int:
        if id(n) not in nodes:
            parents = [idx(p) for p in n.parents]
            nodes[id(n)] = len(table)
            table.append({"kind": n.kind, "parents": parents, "taint": sorted(n.taint),
                          "looped": n.looped, "m": n.m, "row": n.row, "const": n.const,
                          "src": None if n.src is None else dataclasses.astuple(n.src)})
        return nodes[id(n)]

    def sink(s: Sink) -> dict:
        return {"node": idx(s.node), "shape": list(s.shape), "bit_width": s.bit_width,
                "nbytes": s.nbytes, "source": dataclasses.astuple(s.source),
                "path": [list(p) for p in s.path], "looped": s.looped}

    out = {"entry": g.entry, "sinks": [sink(s) for s in g.sinks],
           "run_sinks": [sink(s) for s in g.run_sinks],
           "folds": [idx(n) for n in g.folds], "roots": [idx(n) for n in g.roots]}
    out["nodes"] = table
    return out


def graph_from_dict(d: dict) -> ProvenanceGraph:
    nodes: list[Node] = []
    for r in d["nodes"]:
        nodes.append(Node(r["kind"], tuple(nodes[p] for p in r["parents"]),
                          frozenset(r["taint"]), r["looped"], r["m"], r["row"], r["const"],
                          None if r["src"] is None else Source(*r["src"])))

    def sink(r: dict) -> Sink:
        return Sink(nodes[r["node"]], tuple(r["shape"]), r["bit_width"], r["nbytes"],
                    Source(*r["source"]), tuple(tuple(p) for p in r["path"]), r["looped"])

    return ProvenanceGraph(d["entry"], [sink(r) for r in d["sinks"]],
                           [nodes[i] for i in d["folds"]], [nodes[i] for i in d["roots"]],
                           [sink(r) for r in d["run_sinks"]])
