"""KB2xx -- the JAX tracer rules, with the meaning each has in eager PyTorch.

The port of ``kaboodle_tpu/analysis/rules_jax.py``; the module keeps its
name so the rule ids keep their home. Under jit these hazards are trace
errors; in eager PyTorch they are silent host syncs, paid on every tick:

- KB201: a Python ``if``/``while``/``assert``/``and``/``or``/ternary on a
  device value in per-tick code -- an implicit ``bool()``;
- KB202: ``int()``/``float()``/``bool()``/``.item()``/``.tolist()`` of a
  device value there;
- KB203: ``print`` in per-tick code;
- KB204: a counter-RNG key drawn twice (runs in *every* function, as the
  JAX rule does: a key reused in host code corrupts statistics just as
  surely);
- KB205: documented; the port donates no buffer, so nothing runs.

KB201-KB203 run only inside the functions ``reach.py`` marks hot.
"""

from __future__ import annotations

import ast

from kaboodle_tpu_torch.analysis.core import Finding, Module, rule
from kaboodle_tpu_torch.analysis.reach import (
    HOST_COERCIONS,
    FuncInfo,
    _assign_targets,
    expr_tainted,
    shallow_exprs,
    walk_with_taint,
)

_COERCERS = HOST_COERCIONS
_ITEM_ATTRS = {"item", "tolist"}

# The port's counter RNG (ops/threefry.py, phasegraph/rng.py): the calls
# that derive a key, and the calls that draw from one. Matched on the last
# two components of the resolved dotted name (``threefry.uniform``,
# ``rng.stream_key``, ``sampling.bernoulli_matrix``).
_KEY_PRODUCERS = {
    ("threefry", "prng_key"), ("threefry", "fold_in"), ("threefry", "split"),
    ("rng", "stream_key"), ("rng", "stream_keys"), ("rng", "tick_stream_key"),
    ("rng", "tick_draw_keys"), ("rng", "state_draw_keys"),
}
_KEY_CONSUMERS = {
    ("threefry", "random_bits"), ("threefry", "uniform"), ("threefry", "gumbel_order_bits"),
    ("threefry", "draw_chunks"), ("rng", "stream_uniform"),
    ("sampling", "choose_one_of_oldest_k"), ("sampling", "choose_among_candidates"),
    ("sampling", "choose_k_members"), ("sampling", "bernoulli_matrix"),
}


def _tail(mod: Module, func: ast.AST) -> tuple[str, str] | None:
    d = mod.dotted(func)
    if not d or "." not in d:
        return None
    parts = d.split(".")
    return parts[-2], parts[-1]


def _finding(mod, rule_id, node, msg, symbol):
    return Finding(mod.path, rule_id, node.lineno, msg, symbol)


def _tainted_names(test: ast.AST, tainted: set[str]) -> list[str]:
    return sorted({n.id for n in ast.walk(test) if isinstance(n, ast.Name) and n.id in tainted})


# ---------------------------------------------------------------------------
# KB201 -- Python control flow on device values


@rule(
    "KB201",
    "Python branch on a device value",
    """
Inside per-tick code (``reach.py``), a Python `if`/`while`/`assert`, an
`and`/`or` operand or a ternary whose condition depends on a device value.
Each is an implicit `bool()`: the host waits for the card's stream and
fetches the value, once per tick (under jit it would be a
TracerBoolConversionError). Structural tests (`x is None`, `.shape`/
`.dtype`/`.device` reads) are host values and exempt. A gate that saves
more work than its sync costs belongs in the baseline with that reason, or
under `# noqa: KB201`; `torch.where` keeps a select on the device.
""",
)
def check_traced_branch(mod: Module) -> list[Finding]:
    out: list[Finding] = []

    def visit_factory(info: FuncInfo):
        def flag(node, kind, test, tainted):
            names = _tainted_names(test, tainted)
            out.append(_finding(
                mod, "KB201", node,
                f"Python `{kind}` on a device value inside per-tick '{info.qualname}' "
                "-- an implicit bool() sync; torch.where keeps it on the device",
                f"{info.qualname}.{kind}({','.join(names)})",
            ))

        def visit(stmt, tainted):
            if isinstance(stmt, (ast.If, ast.While)):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                if expr_tainted(stmt.test, tainted):
                    flag(stmt, kind, stmt.test, tainted)
            elif isinstance(stmt, ast.Assert) and expr_tainted(stmt.test, tainted):
                flag(stmt, "assert", stmt.test, tainted)
            for expr in shallow_exprs(stmt):
                for node in ast.walk(expr):
                    if isinstance(node, ast.IfExp) and expr_tainted(node.test, tainted):
                        flag(node, "ternary", node.test, tainted)
                    elif isinstance(node, ast.BoolOp) and any(
                            expr_tainted(v, tainted) for v in node.values[:-1]):
                        kind = "and" if isinstance(node.op, ast.And) else "or"
                        flag(node, kind, ast.Tuple(node.values[:-1]), tainted)

        return visit

    for info in mod.reach.traced_functions():
        walk_with_taint(info, visit_factory(info))
    return out


# ---------------------------------------------------------------------------
# KB202 -- host coercions of device values


@rule(
    "KB202",
    "host coercion of a device value",
    """
Inside per-tick code, `float()`/`int()`/`bool()`/`complex()`, `.item()`,
`.tolist()`, or a host `numpy` call applied to a device value. Each one is
a device->host fetch that waits for the stream, once per tick (under jit a
TracerArrayConversionError). Keep the computation on the device, or hoist
the coercion out of the tick. Static reads (`int(x.shape[0])`) are exempt.
""",
)
def check_tracer_coercion(mod: Module) -> list[Finding]:
    out: list[Finding] = []

    def visit_factory(info: FuncInfo):
        def visit(stmt, tainted):
            for expr in shallow_exprs(stmt):
                for node in ast.walk(expr):
                    if not isinstance(node, ast.Call):
                        continue
                    args = [*node.args, *(kw.value for kw in node.keywords)]
                    hit = None
                    if (
                        isinstance(node.func, ast.Name)
                        and node.func.id in _COERCERS
                        and any(expr_tainted(a, tainted) for a in args)
                    ):
                        hit = f"{node.func.id}()"
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _ITEM_ATTRS
                        and expr_tainted(node.func.value, tainted)
                    ):
                        hit = f".{node.func.attr}()"
                    else:
                        d = mod.dotted(node.func)
                        if d and d.startswith("numpy.") and any(
                                expr_tainted(a, tainted) for a in args):
                            hit = d.replace("numpy.", "np.") + "()"
                    if hit:
                        out.append(_finding(
                            mod, "KB202", node,
                            f"{hit} on a device value inside per-tick '{info.qualname}'",
                            f"{info.qualname}.{hit}",
                        ))

        return visit

    for info in mod.reach.traced_functions():
        walk_with_taint(info, visit_factory(info))
    return out


# ---------------------------------------------------------------------------
# KB203 -- print in per-tick code


@rule(
    "KB203",
    "print() inside per-tick code",
    """
A bare `print` inside per-tick code runs once per tick on the host, and a
printed device value is a fetch. Record through the telemetry counters
(`telemetry/`) or move the print out of the tick. A deliberate diagnostic
can be suppressed with `# noqa: KB203`.
""",
)
def check_print_in_jit(mod: Module) -> list[Finding]:
    out: list[Finding] = []
    for info in mod.reach.traced_functions():

        def visit(stmt, tainted, info=info):
            for expr in shallow_exprs(stmt):
                for node in ast.walk(expr):
                    if (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "print"
                    ):
                        out.append(_finding(
                            mod, "KB203", node,
                            f"print() inside per-tick '{info.qualname}'",
                            f"{info.qualname}.print",
                        ))

        walk_with_taint(info, visit)
    return out


# ---------------------------------------------------------------------------
# KB204 -- counter-RNG key reuse


class _PathWalker:
    """Statement walk tracking a branch path: two events conflict only when
    one path is a prefix of the other (same execution path) -- uses in
    sibling `if`/`else` arms never execute together and don't conflict."""

    def __init__(self):
        self.path: tuple = ()

    def compatible(self, a: tuple, b: tuple) -> bool:
        return a[: len(b)] == b or b[: len(a)] == a

    def walk(self, stmts, on_stmt):
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            on_stmt(s)
            branches = [("body", s.body)] if hasattr(s, "body") else []
            if getattr(s, "orelse", None):
                branches.append(("orelse", s.orelse))
            if getattr(s, "finalbody", None):
                branches.append(("finalbody", s.finalbody))
            for h in getattr(s, "handlers", []) or []:
                branches.append((("handler", id(h)), h.body))
            for label, body in branches:
                if not isinstance(body, list):
                    continue
                base = self.path
                excl = isinstance(s, ast.If) or (
                    isinstance(label, tuple) and label[0] == "handler"
                )
                self.path = base + ((id(s), label),) if excl else base
                self.walk(body, on_stmt)
                self.path = base


@rule(
    "KB204",
    "counter-RNG key reused",
    """
The same key name is passed to two drawing calls on one execution path
with no re-derivation in between. The draws are then bit-equal -- the
classic silent statistics bug. Key provenance is tracked syntactically:
names bound from `threefry.prng_key/fold_in/split` or
`rng.stream_key/stream_keys/tick_stream_key/tick_draw_keys/
state_draw_keys` (and those inherited from the enclosing function) count
as keys; passing one to a draw (`threefry.random_bits/uniform/
gumbel_order_bits/draw_chunks`, `rng.stream_uniform`, the `sampling`
draws) consumes it. Parity tests that *want* identical draws are the
legitimate exception -- baseline them with that justification.
""",
)
def check_key_reuse(mod: Module) -> list[Finding]:
    out: list[Finding] = []

    def scan(func_node, qualname: str, inherited: frozenset[str]) -> None:
        keys: set[str] = set(inherited)
        uses: dict[str, list[tuple]] = {}
        flagged: set[tuple[str, int]] = set()
        pw = _PathWalker()

        def handle_call(node: ast.Call) -> None:
            if _tail(mod, node.func) not in _KEY_CONSUMERS:
                return
            for a in [*node.args, *(kw.value for kw in node.keywords)]:
                if isinstance(a, ast.Name) and a.id in keys:
                    prior = uses.setdefault(a.id, [])
                    if any(pw.compatible(p, pw.path) for p in prior):
                        if (a.id, node.lineno) not in flagged:
                            flagged.add((a.id, node.lineno))
                            out.append(_finding(
                                mod, "KB204", node,
                                f"key '{a.id}' drawn again without a re-derivation "
                                f"in '{qualname}'",
                                f"{qualname}.{a.id}",
                            ))
                    prior.append(pw.path)

        def on_stmt(s: ast.stmt) -> None:
            for expr in shallow_exprs(s):
                for node in ast.walk(expr):
                    if isinstance(node, ast.Call):
                        handle_call(node)
            if isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                produced = isinstance(s.value, ast.Call) and (
                    _tail(mod, s.value.func) in _KEY_PRODUCERS
                )
                for t in targets:
                    for name in _assign_targets(t):
                        uses.pop(name, None)
                        if produced:
                            keys.add(name)
                        else:
                            keys.discard(name)

        pw.walk(func_node.body, on_stmt)
        for child in ast.iter_child_nodes(func_node):
            _scan_nested(child, qualname, frozenset(keys))

    def _scan_nested(node, prefix, inherited):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(node, f"{prefix}.{node.name}", inherited)
            return
        for child in ast.iter_child_nodes(node):
            _scan_nested(child, prefix, inherited)

    scan(mod.tree, "<module>", frozenset())
    return out


# ---------------------------------------------------------------------------
# KB205 -- use after donation


def _no_donation(mod: Module) -> list[Finding]:
    """The port donates no buffer: nothing to check."""
    return []


rule(
    "KB205",
    "donated argument used after donation",
    """
In the JAX package: a buffer passed at a donated position of a
`jax.jit(..., donate_argnums=...)` function is read again afterwards
(donation hands the buffer to XLA, which deletes it).

In the port: no counterpart. PyTorch has no donation; the port's engines
never update their arguments in place (a phase's result is a new tensor),
so the rule is documented here and never fires.
""",
)(_no_donation)
