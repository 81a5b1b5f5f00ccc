"""Syntactic per-tick ("hot") reachability and device-value taint for KB2xx/KB3xx.

The port of ``kaboodle_tpu/analysis/reach.py``. The JAX rules look inside
jit-traced code; the port has no jit, so its hazards live in the code that
runs once per tick on the device's tensors -- a Python ``if`` on a card
tensor, an ``int()``, an ``.item()`` or a ``.cpu()`` there is a host sync on
every tick. "Hot" is decided per module from syntax, without importing
torch:

Seeds (a function is hot if any of these hold):

- defined inside an engine builder (:data:`ENGINE_BUILDERS`): the tick,
  leap and span closures that ``make_tick_fn``, ``make_chunked_tick_fn``,
  ``make_leap_fn``, ``make_fleet_tick_fn``, ``make_sparse_tick_fn``,
  ``warp/horizon.py``'s ``make_*_fn`` and ``phasegraph/derive.py``'s
  ``make_*`` engines return (the builder itself runs once, on the host);
- marked ``# graftlint: traced`` on its ``def`` line (the JAX package's
  pragma word, so a reader finds the counterpart): the escape hatch for a
  per-tick function called from another module;
- defined inside, or called by name from, an already-hot function
  (transitive closure over module-local names).

Tainted parameters: every parameter of a seed, minus the names that are
static by contract (:data:`STATIC_PARAMS`: ``cfg``, the build flags, the
Python ints of a shape or a row offset), parameters annotated as a Python
scalar type, and parameters with a default other than ``None``. Inside a hot function taint then propagates forward
through assignments, with the structural exemptions that keep idiomatic
code clean:

- reads that are static on a tensor (``.shape``, ``.dtype``, ``.ndim``,
  ``.size``, ``.device``, ``.numel()``, ``.dim()``, ...) cut the taint --
  ``n = st.state.shape[-1]`` is a Python int;
- ``x is None`` / ``x is not None`` is a structural test, not a value
  branch; ``isinstance``/``len``/``type``/``hasattr`` calls and comparisons
  with a string likewise;
- the result of a coercion (``bool(x)``, ``int(x)``, ``x.item()``,
  ``x.tolist()``) is a host value: the sync is the coercion (KB202's
  finding), not each later use of the Python value.

This is deliberately an approximation, as the JAX pass is: no
cross-module reachability, no lambda bodies, loops do not re-run the taint
pass. False negatives are acceptable; false positives are engineered
against, because a gate that cries wolf gets noqa'd into uselessness.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch

from kaboodle_tpu_torch.analysis.core import Module

# (path suffix, builder name pattern): the functions defined inside these
# builders are the per-tick code of the port's engines.
ENGINE_BUILDERS = (
    ("phasegraph/exec.py", "make_tick_fn"),
    ("phasegraph/blocked.py", "make_chunked_tick_fn"),
    ("phasegraph/span.py", "make_leap_fn"),
    ("fleet/core.py", "make_fleet_tick_fn"),
    ("sparseplane/kernel.py", "make_sparse_tick_fn"),
    ("warp/horizon.py", "make_*_fn"),
    ("phasegraph/derive.py", "make_*"),
)

# Attribute reads (and zero-argument methods) that are host values on a
# tensor or a state dataclass: the shape, not the data.
STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "itemsize", "names", "device", "is_cuda",
    "numel", "dim", "element_size", "n", "layout",
}

# Calls whose result is static whatever their arguments.
STATIC_CALLS = {"isinstance", "len", "type", "hasattr", "callable", "id", "getattr"}
# Calls that bring a device value to the host (KB202): their result is a
# host value.
HOST_COERCIONS = {"bool", "int", "float", "complex"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}

# Parameters that are static by contract in the port's engines: the
# config and its flags, the build switches and the Python ints of shapes,
# row offsets and spans.
STATIC_PARAMS = {
    "cfg", "spec", "faulty", "telemetry", "deterministic", "det", "program", "group",
    "mesh", "block", "row0", "n", "nr", "k", "k_max", "chunk", "method", "drop",
    "boot_union", "masked", "hybrid", "device", "dev", "dtype", "nb", "batch", "steps",
    "timeout", "shape", "dim", "name", "self", "cls",
}
_SCALAR_ANNOTATIONS = {"int", "bool", "str", "float", "SwimConfig", "SparseSpec"}

TRACED_PRAGMA = "graftlint: traced"


@dataclasses.dataclass
class FuncInfo:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    traced: bool = False
    # Whether traced_params carries the parameter list. Seeds and nested
    # defs of hot functions get their params (minus the static ones);
    # functions merely *called by name* from hot code run per tick but
    # receive unknown arguments, so they are hot with NO tainted params:
    # their bodies still see the taint-free checks (print, host copies)
    # but never a spurious branch finding.
    params_full: bool = False
    traced_params: set[str] = dataclasses.field(default_factory=set)


def _param_names(node) -> list[str]:
    a = node.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)] + (
        [a.vararg.arg] if a.vararg else []
    ) + ([a.kwarg.arg] if a.kwarg else [])


def _static_params(node) -> set[str]:
    """Parameters static by contract: by name, annotated as a Python scalar,
    or given a default other than ``None`` (a host value bound at ``def``)."""
    a = node.args
    params = (*a.posonlyargs, *a.args)
    defaults = dict(zip([p.arg for p in params][len(params) - len(a.defaults):], a.defaults))
    defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    out = set()
    for p in (*params, *a.kwonlyargs):
        ann = p.annotation
        name = ann.id if isinstance(ann, ast.Name) else (
            ann.value if isinstance(ann, ast.Constant) and isinstance(ann.value, str) else None)
        d = defaults.get(p.arg)
        if (p.arg in STATIC_PARAMS or name in _SCALAR_ANNOTATIONS
                or (d is not None and not (isinstance(d, ast.Constant) and d.value is None))):
            out.add(p.arg)
    return out


class ReachInfo:
    """Per-module map: function node -> FuncInfo with hot flags."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.by_node: dict[ast.AST, FuncInfo] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        self._collect(mod.tree, "")
        self._seed()
        self._closure()

    def _collect(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                info = FuncInfo(child, qual)
                self.by_node[child] = info
                self.by_name.setdefault(child.name, []).append(info)
                self._collect(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                self._collect(child, f"{prefix}{child.name}.")
            else:
                self._collect(child, prefix)

    def _mark(self, info: FuncInfo, full: bool = True) -> None:
        info.traced = True
        if full and not info.params_full:
            info.params_full = True
            static = _static_params(info.node)
            info.traced_params = {p for p in _param_names(info.node) if p not in static}

    def _builders(self) -> list[FuncInfo]:
        path = self.mod.path
        pats = [pat for suffix, pat in ENGINE_BUILDERS if path.endswith(suffix)]
        return [i for i in self.by_node.values()
                if "." not in i.qualname and any(fnmatch.fnmatchcase(i.qualname, p) for p in pats)]

    def _seed(self) -> None:
        mod = self.mod
        for info in self.by_node.values():
            node = info.node
            line = mod.lines[node.lineno - 1] if node.lineno <= len(mod.lines) else ""
            if TRACED_PRAGMA in line:
                self._mark(info)
        for builder in self._builders():
            for sub in ast.walk(builder.node):
                if sub is not builder.node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._mark(self.by_node[sub])

    def _closure(self) -> None:
        """Nested defs of hot fns (full params) + local fns *called* from
        hot fns (hot, but no tainted params -- see FuncInfo)."""
        changed = True
        while changed:
            changed = False
            for info in list(self.by_node.values()):
                if not info.traced:
                    continue
                for sub in ast.walk(info.node):
                    if sub is info.node:
                        continue
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        target = self.by_node.get(sub)
                        if target is not None and not (target.traced and target.params_full):
                            self._mark(target, full=True)
                            changed = True
                    elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        cands = self.by_name.get(sub.func.id, [])
                        target = cands[0] if len(cands) == 1 else None
                        if target is not None and not target.traced:
                            self._mark(target, full=False)
                            changed = True

    def traced_functions(self) -> list[FuncInfo]:
        return [i for i in self.by_node.values() if i.traced]


# ---------------------------------------------------------------------------
# taint


def expr_tainted(e: ast.AST, tainted: set[str]) -> bool:
    """Does ``e``'s value depend on a tainted name (a device value)?

    Prunes static reads and structural tests -- see module docstring."""
    if isinstance(e, ast.Name):
        return e.id in tainted
    if isinstance(e, ast.Attribute):
        return False if e.attr in STATIC_ATTRS else expr_tainted(e.value, tainted)
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Name) and e.func.id in STATIC_CALLS:
        return False
    # A coercion's result is a host value: the sync is the coercion itself
    # (KB202's finding), not every later use of the Python value.
    if isinstance(e, ast.Call) and (
            (isinstance(e.func, ast.Name) and e.func.id in HOST_COERCIONS)
            or (isinstance(e.func, ast.Attribute) and e.func.attr in HOST_METHODS)):
        return False
    if isinstance(e, ast.Compare):
        if (
            all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops)
            and all(isinstance(c, ast.Constant) and c.value is None for c in e.comparators)
        ):
            return False
        if any(isinstance(c, ast.Constant) and isinstance(c.value, str)
               for c in (e.left, *e.comparators)):
            return False  # a comparison with a string: host values only
        return expr_tainted(e.left, tainted) or any(
            expr_tainted(c, tainted) for c in e.comparators
        )
    if isinstance(e, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
        return False
    return any(expr_tainted(c, tainted) for c in ast.iter_child_nodes(e))


def _assign_targets(t: ast.AST) -> list[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out: list[str] = []
        for e in t.elts:
            out.extend(_assign_targets(e))
        return out
    if isinstance(t, ast.Starred):
        return _assign_targets(t.value)
    return []


def shallow_exprs(stmt: ast.stmt) -> list[ast.expr]:
    """The expressions belonging directly to ``stmt`` -- not the ones inside
    its nested statement blocks (those get their own visit)."""
    out: list[ast.expr] = []
    for name, value in ast.iter_fields(stmt):
        if name in ("body", "orelse", "finalbody", "handlers", "decorator_list"):
            continue
        if isinstance(value, ast.expr):
            out.append(value)
        elif isinstance(value, list):
            out.extend(v for v in value if isinstance(v, ast.expr))
        elif isinstance(value, ast.withitem):
            out.append(value.context_expr)
    for item in getattr(stmt, "items", []) or []:
        if isinstance(item, ast.withitem):
            out.append(item.context_expr)
    return out


def walk_with_taint(info: FuncInfo, visit) -> None:
    """Forward walk of a hot function's own body (nested defs skipped --
    they are separate hot entries) maintaining the tainted-name set.
    ``visit(stmt, tainted)`` is called per statement, pre-propagation."""
    tainted = set(info.traced_params)

    def do(stmts) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            visit(s, tainted)
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and getattr(
                s, "value", None
            ) is not None:
                if expr_tainted(s.value, tainted):
                    targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                    for t in targets:
                        tainted.update(_assign_targets(t))
            elif isinstance(s, ast.For):
                if expr_tainted(s.iter, tainted):
                    tainted.update(_assign_targets(s.target))
            for field in ("body", "orelse", "finalbody"):
                do(getattr(s, field, []) or [])
            for h in getattr(s, "handlers", []) or []:
                do(h.body)

    do(info.node.body)
