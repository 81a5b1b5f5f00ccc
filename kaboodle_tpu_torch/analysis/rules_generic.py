"""KB1xx -- generic Python rules.

The port of ``kaboodle_tpu/analysis/rules_generic.py``, rule for rule: the
same ``IMPLICIT`` names, ``SHADOW_RISK`` set, messages and symbols, so the
two lanes give the same KB101-KB104 findings on any source. KB101/KB102
catch the module-level ``NameError`` class and dead-import drift;
KB103/KB104 are the two classic foot-guns cheap enough to gate on with no
dependency.
"""

from __future__ import annotations

import ast
import builtins

from kaboodle_tpu_torch.analysis.core import Finding, Module, rule

IMPLICIT = {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__class__", "__annotations__",
}

BUILTINS = frozenset(dir(builtins))

# Builtins whose shadowing has actually caused grief in numeric codebases —
# not every builtin (shadowing `license` or `copyright` harms nobody).
SHADOW_RISK = frozenset({
    "abs", "all", "any", "bin", "bool", "bytes", "chr", "compile", "complex",
    "dict", "dir", "eval", "exec", "filter", "float", "format", "hash", "hex",
    "id", "input", "int", "iter", "len", "list", "map", "max", "min", "next",
    "object", "oct", "open", "ord", "pow", "print", "range", "repr", "round",
    "set", "slice", "sorted", "str", "sum", "tuple", "type", "vars", "zip",
})


def _collect_defined(tree: ast.AST) -> tuple[set, dict]:
    """All names bound anywhere (any scope), plus import bindings -> lineno.

    Scope approximation (the JAX package's): a name defined in
    *any* scope counts as defined everywhere in the module. That misses
    scope-escape bugs but has no false positives on idiomatic code — the
    right trade for a ``-D warnings`` style gate.
    """
    defined = set(BUILTINS) | IMPLICIT
    imports: dict[str, tuple[int, bool]] = {}  # name -> (lineno, is_future)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                defined.add(name)
                imports.setdefault(name, (node.lineno, False))
        elif isinstance(node, ast.ImportFrom):
            future = node.module == "__future__"
            for a in node.names:
                if a.name == "*":
                    continue
                name = a.asname or a.name
                defined.add(name)
                imports.setdefault(name, (node.lineno, future))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            defined.add(node.id)
        elif isinstance(node, ast.arg):
            defined.add(node.arg)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            defined.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            defined.update(node.names)
        elif isinstance(node, (ast.MatchAs, ast.MatchStar)) and node.name:
            defined.add(node.name)
        elif isinstance(node, ast.MatchMapping) and node.rest:
            defined.add(node.rest)
    return defined, imports


def _collect_used(tree: ast.AST) -> tuple[set, list]:
    """Names loaded anywhere + every (lineno, name) load for KB101."""
    used = set()
    loads = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
            loads.append((node.lineno, node.id))
    # __all__ re-export strings count as uses (package __init__ pattern).
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
            )
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    used.add(elt.value)
    return used, loads


@rule(
    "KB101",
    "undefined name",
    """
A loaded name is bound nowhere in the module (any scope) and is not a
builtin. This is the exact failure class that broke HEAD in round 2: a
module-level reference to a deleted/renamed function that no test imported
until CI did. Names bound in *any* scope count as defined everywhere
(no-false-positive approximation); suppress a deliberate late-bound name
with `# noqa: KB101`.
""",
)
def check_undefined_names(mod: Module) -> list[Finding]:
    defined, _ = _collect_defined(mod.tree)
    _, loads = _collect_used(mod.tree)
    return [
        Finding(mod.path, "KB101", lineno, f"undefined name '{name}'", name)
        for lineno, name in loads
        if name not in defined
    ]


@rule(
    "KB102",
    "unused import",
    """
An imported name is never loaded in the module (``__all__`` strings count
as loads; ``from __future__`` and ``_`` are exempt). Dead imports are the
most common dead-code drift and can hide real costs — importing a torch
extension pulls a backend. Suppress an intentional re-export or
side-effect import with `# noqa: KB102`.
""",
)
def check_unused_imports(mod: Module) -> list[Finding]:
    _, imports = _collect_defined(mod.tree)
    used, _ = _collect_used(mod.tree)
    out = []
    for name, (lineno, future) in imports.items():
        if future or name == "_" or name in used:
            continue
        out.append(Finding(mod.path, "KB102", lineno, f"unused import '{name}'", name))
    return out


@rule(
    "KB103",
    "mutable default argument",
    """
A function parameter defaults to a mutable literal (``[]``, ``{}``,
``set()``, ``list()``, ``dict()``). The default is evaluated once at def
time and shared across calls — state leaks between invocations. Use
``None`` + an in-body default. Suppress a deliberate shared-cache default
with `# noqa: KB103`.
""",
)
def check_mutable_defaults(mod: Module) -> list[Finding]:
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        name = getattr(node, "name", "<lambda>")
        for d in [*node.args.defaults, *node.args.kw_defaults]:
            if d is None:
                continue
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set")
                and not d.args
                and not d.keywords
            )
            if mutable:
                out.append(
                    Finding(
                        mod.path, "KB103", d.lineno,
                        f"mutable default argument in '{name}'", name,
                    )
                )
    return out


@rule(
    "KB104",
    "shadowed builtin",
    """
A binding (assignment, parameter, def/class name) reuses a builtin name
from the high-risk set (``id``, ``type``, ``sum``, ``bytes``, ``hash``,
``next``, ...). Later code in the same module that means the builtin gets
the shadow instead — in tensor code this typically surfaces as a
confusing TypeError far from the binding. Rename, or suppress
a deliberate local with `# noqa: KB104`.
""",
)
def check_shadowed_builtins(mod: Module) -> list[Finding]:
    out = []

    def flag(name: str, lineno: int) -> None:
        if name in SHADOW_RISK:
            out.append(
                Finding(
                    mod.path, "KB104", lineno, f"'{name}' shadows a builtin", name
                )
            )

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            flag(node.name, node.lineno)
        elif isinstance(node, ast.arg):
            flag(node.arg, node.lineno)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            flag(node.id, node.lineno)
    return out
