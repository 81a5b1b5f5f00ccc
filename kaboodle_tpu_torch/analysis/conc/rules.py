"""KB5xx — graftconc static rules, scoped to the serve concurrency surface.

The port of ``kaboodle_tpu/analysis/conc/rules.py`` over the port's serve
plane: the same six rules, pragmas and ``--explain`` texts, with the names
of device work made torch's (KB501's device fetches, KB503's taint and
materializers).

The scope (:data:`CONC_SCOPE`) is the code where three execution contexts
meet: the asyncio event loop (server/engine round dispatch), the spill
writer thread, and the durable-write path (journal/checkpoint files). The
rules encode the contracts those files document in prose:

- KB501: nothing blocking runs on the event loop. ``async def`` bodies are
  the seeds; ``# conc: event-loop`` on a ``def`` line marks functions the
  loop calls from *another* module (the per-module analogue of graftlint's
  ``# graftlint: traced`` pragma). Reachability closes over module-local
  calls — plain names and ``self.method()`` within one class — but NOT
  through executor offloads (``asyncio.to_thread`` / ``run_in_executor`` /
  ``Thread(target=...)`` arguments run off-loop by construction).
- KB502: a field annotated ``# guarded_by: <lock>`` is only touched inside
  ``with self.<lock>:``. Guardedness is inferred interprocedurally: a
  private helper whose every intra-class call site holds the lock is
  lock-held inside too, and ``# guarded_by`` on a ``def`` line asserts the
  lock at entry (and at every call site).
- KB503: device values (what a ``torch.`` call returns) must be
  materialized (``.cpu()`` / ``.numpy()`` / ``.item()`` / ``.tolist()`` /
  ``np.asarray``) before crossing a thread boundary.
- KB504: durable writes follow tmp-write -> flush -> fsync ->
  ``os.replace``; serve-side ``checkpoint.save`` calls must say
  ``atomic=True``.
- KB505: the static lock-acquisition-order graph has no cycles.
- KB506: no unbounded ``Queue()``/``deque()`` in serve scope.

Approximation stance mirrors ``reach.py``: per-module, no lambda bodies,
false negatives acceptable, false positives engineered against — a
concurrency gate that cries wolf gets noqa'd into uselessness.
"""

from __future__ import annotations

import ast
import re

from kaboodle_tpu_torch.analysis.core import Finding, Module, rule

# Paths the KB5xx rules fire in: the serve plane's three execution contexts
# plus the durable-write helpers they call and the sanitizer itself
# (dogfooding: the lock-order checker's own lock discipline is checked).
CONC_SCOPE = (
    "kaboodle_tpu_torch/serve/",
    "kaboodle_tpu_torch/checkpoint.py",
    "kaboodle_tpu_torch/telemetry/manifest.py",
    "kaboodle_tpu_torch/analysis/conc/sanitizer.py",
)

EVENT_LOOP_PRAGMA = "conc: event-loop"
_GUARDED_BY_RE = re.compile(r"#\s*guarded_by:\s*(?:self\.)?(?P<lock>[A-Za-z_]\w*)")

# Blocking callables by resolved dotted name (KB501). torch.as_tensor and
# friends do NOT match: a host->device copy is queued on the stream, the
# device->host fetch (and a device-wide synchronize) is the stall.
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep()",
    "os.fsync": "os.fsync()",
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "numpy.asarray": "np.asarray()",
    "numpy.array": "np.array()",
    "kaboodle_tpu_torch.checkpoint.save": "checkpoint.save()",
    "kaboodle_tpu_torch.checkpoint.load": "checkpoint.load()",
}
# Method calls that block: a lock, and the tensor methods that fetch from
# the device (each waits for every kernel queued before it).
_BLOCKING_ATTRS = {
    "block_until_ready": ".block_until_ready()",
    "acquire": ".acquire()",
    "item": ".item()",
    "cpu": ".cpu()",
    "numpy": ".numpy()",
    "tolist": ".tolist()",
}

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}

_UNBOUNDED = {
    # dotted ctor -> the keyword that bounds it (None: never boundable)
    "queue.Queue": "maxsize",
    "queue.LifoQueue": "maxsize",
    "queue.PriorityQueue": "maxsize",
    "queue.SimpleQueue": None,
    "asyncio.Queue": "maxsize",
    "collections.deque": "maxlen",
}

# Materializers that cut KB503 device taint: the value that crosses the
# thread boundary afterwards is host memory (or a Python scalar).
_MATERIALIZERS = {"numpy.asarray", "numpy.array", "float", "int", "bool"}
_MATERIALIZER_ATTRS = ("cpu", "numpy", "item", "tolist")


def _in_scope(mod: Module) -> bool:
    return any(s in mod.path for s in CONC_SCOPE)


def _def_line(mod: Module, node: ast.AST) -> str:
    return mod.lines[node.lineno - 1] if 0 < node.lineno <= len(mod.lines) else ""


def _classes(mod: Module) -> list[ast.ClassDef]:
    return [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]


def _methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef | ast.AsyncFunctionDef]:
    return {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _self_attr(e: ast.AST) -> str | None:
    """``self.X`` -> ``"X"`` (the with-lock / guarded-field shape)."""
    if (
        isinstance(e, ast.Attribute)
        and isinstance(e.value, ast.Name)
        and e.value.id == "self"
    ):
        return e.attr
    return None


def _scan_calls(fn: ast.AST):
    """Call nodes in ``fn``'s own body — nested defs/lambdas are skipped
    (they only run when called; local calls to them are resolved at their
    call sites, and offload targets never run on this context at all)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# KB501 — blocking calls on the event loop


@rule(
    "KB501",
    "blocking call reachable from the event loop",
    """
A blocking call — `os.fsync`, file `open()`, `time.sleep`, `Lock.acquire`,
`torch.cuda.synchronize()`, a device->host fetch (`.item()`, `.cpu()`,
`.numpy()`, `.tolist()`, `np.asarray`), or `checkpoint.save/load` — inside an `async def` body (or a function marked
`# conc: event-loop`, the cross-module escape hatch: the asyncio server
dispatches `ServeEngine.step`/`submit`/... inline on the loop), reached
through module-local calls. One such call stalls EVERY connection and the
whole round loop: the serve plane's p99 latency is exactly the longest
synchronous segment anything schedules on the loop. Offload it
(`await asyncio.to_thread(...)`, `run_in_executor`, or the SpillManager's
writer thread — offload arguments are exempt by construction), or justify
the stall in `kaboodle_tpu_torch/analysis/conc/baseline.json` /
`# noqa: KB501` with a reason.
""",
)
def check_loop_blocking(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    reach = mod.reach

    # class membership, for resolving `self.m()` calls within one class
    method_class: dict[ast.AST, ast.ClassDef] = {}
    for cls in _classes(mod):
        for m in _methods(cls).values():
            method_class[m] = cls

    seeds: list[ast.AST] = []
    for node in reach.by_node:
        if isinstance(node, ast.AsyncFunctionDef) or EVENT_LOOP_PRAGMA in _def_line(
            mod, node
        ):
            seeds.append(node)

    # worklist closure over module-local calls; `via` keeps the seed each
    # function was reached from, for the message
    via: dict[ast.AST, ast.AST] = {s: s for s in seeds}
    work = list(seeds)
    while work:
        fn = work.pop()
        for call in _scan_calls(fn):
            target = None
            if isinstance(call.func, ast.Name):
                cands = reach.by_name.get(call.func.id, [])
                target = cands[0].node if len(cands) == 1 else None
            else:
                attr = _self_attr(call.func)
                cls = method_class.get(fn)
                if attr and cls is not None:
                    target = _methods(cls).get(attr)
            if target is not None and target not in via:
                via[target] = via[fn]
                work.append(target)

    out: list[Finding] = []
    for fn in via:
        info = reach.by_node.get(fn)
        qual = info.qualname if info else getattr(fn, "name", "<fn>")
        seed_info = reach.by_node.get(via[fn])
        seed = seed_info.qualname if seed_info else qual
        for call in _scan_calls(fn):
            d = mod.dotted(call.func)
            hit = _BLOCKING_DOTTED.get(d or "")
            if hit is None and d == "open":
                hit = "open()"
            if hit is None and isinstance(call.func, ast.Attribute):
                hit = _BLOCKING_ATTRS.get(call.func.attr)
            if hit is None:
                continue
            where = f"'{qual}'" + (
                f" (reachable from event-loop '{seed}')" if fn is not via[fn] else ""
            )
            out.append(
                Finding(
                    mod.path, "KB501", call.lineno,
                    f"blocking {hit} on the event loop in {where}",
                    f"{qual}.{hit}",
                )
            )
    return out


# ---------------------------------------------------------------------------
# KB502 — guarded_by lock discipline


@rule(
    "KB502",
    "guarded_by field accessed outside its lock",
    """
A field annotated `# guarded_by: <lock>` (on its assignment in the class
body) was read or written outside a `with self.<lock>:` region. The
annotation is the cross-thread contract — e.g. SpillManager's `_cache` is
touched by both the round loop and the writer thread — and this rule makes
it checkable. Guardedness is interprocedural within the class: a helper
whose EVERY intra-class call site holds the lock counts as lock-held, and
`# guarded_by: <lock>` on a `def` line (methods and properties) asserts
the lock is held at entry — its body passes, and every intra-class call/
access site must hold the lock. `__init__` is exempt: construction is
single-threaded and the lock may not exist yet. Fix by widening the `with`
region, or drop the annotation if the field is genuinely single-threaded.
""",
)
def check_guarded_by(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    out: list[Finding] = []
    for cls in _classes(mod):
        methods = _methods(cls)
        guarded_fields: dict[str, str] = {}
        for n in ast.walk(cls):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                m = _GUARDED_BY_RE.search(_def_line(mod, n))
                if not m:
                    continue
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    field = _self_attr(t)
                    if field:
                        guarded_fields[field] = m.group("lock")
        guarded_defs: dict[str, str] = {}
        for name, fn in methods.items():
            m = _GUARDED_BY_RE.search(_def_line(mod, fn))
            if m:
                guarded_defs[name] = m.group("lock")
        if not guarded_fields and not guarded_defs:
            continue

        # entry_held[m]: locks provably held whenever m runs. Grows
        # monotonically from {} (plus any `# guarded_by` def pragma), so
        # the fixed point terminates.
        entry_held: dict[str, set[str]] = {
            name: ({guarded_defs[name]} if name in guarded_defs else set())
            for name in methods
        }

        def walk(name: str):
            """(field_accesses, method_refs): each is (node, lineno, held)."""
            accesses: list[tuple[str, int, set[str]]] = []
            refs: list[tuple[str, int, set[str]]] = []

            def visit_expr(e: ast.AST, held: frozenset) -> None:
                for n in ast.walk(e):
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    attr = _self_attr(n)
                    if attr is None:
                        continue
                    if attr in guarded_fields:
                        accesses.append((attr, n.lineno, set(held)))
                    if attr in methods:
                        refs.append((attr, n.lineno, set(held)))

            def do(stmts, held: frozenset) -> None:
                for s in stmts:
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                        # closures escape the region: conservatively unheld
                        for sub in (
                            s.body if not isinstance(s, ast.ClassDef) else []
                        ):
                            do([sub], frozenset())
                        continue
                    if isinstance(s, (ast.With, ast.AsyncWith)):
                        inner = set(held)
                        for item in s.items:
                            visit_expr(item.context_expr, held)
                            lock = _self_attr(item.context_expr)
                            if lock is None and isinstance(
                                item.context_expr, ast.Name
                            ):
                                lock = item.context_expr.id
                            if lock:
                                inner.add(lock)
                        do(s.body, frozenset(inner))
                        continue
                    for fname, value in ast.iter_fields(s):
                        if fname in ("body", "orelse", "finalbody", "handlers"):
                            continue
                        if isinstance(value, ast.AST):
                            visit_expr(value, held)
                        elif isinstance(value, list):
                            for v in value:
                                if isinstance(v, ast.expr):
                                    visit_expr(v, held)
                    for fname in ("body", "orelse", "finalbody"):
                        do(getattr(s, fname, []) or [], held)
                    for h in getattr(s, "handlers", []) or []:
                        do(h.body, held)

            do(methods[name].body, frozenset(entry_held[name]))
            return accesses, refs

        # fixed point over intra-class call sites
        for _ in range(len(methods) + 1):
            site_held: dict[str, list[set[str]]] = {}
            for name in methods:
                _, refs = walk(name)
                if name == "__init__":
                    continue  # ctor refs (e.g. Thread(target=self._run)) are pre-sharing
                for ref, _line, held in refs:
                    site_held.setdefault(ref, []).append(held)
            changed = False
            for name in methods:
                sites = site_held.get(name)
                inferred = (
                    set.intersection(*sites) if sites else set()
                ) | ({guarded_defs[name]} if name in guarded_defs else set())
                if inferred - entry_held[name]:
                    entry_held[name] |= inferred
                    changed = True
            if not changed:
                break

        for name in methods:
            if name == "__init__":
                continue  # single-threaded construction; lock may not exist yet
            accesses, refs = walk(name)
            for field, lineno, held in accesses:
                lock = guarded_fields[field]
                if lock not in held:
                    out.append(
                        Finding(
                            mod.path, "KB502", lineno,
                            f"'{cls.name}.{field}' (guarded_by: {lock}) accessed "
                            f"in '{name}' without 'with self.{lock}'",
                            f"{cls.name}.{name}.{field}",
                        )
                    )
            for ref, lineno, held in refs:
                lock = guarded_defs.get(ref)
                if lock and lock not in held and lock not in entry_held[name]:
                    out.append(
                        Finding(
                            mod.path, "KB502", lineno,
                            f"'{cls.name}.{ref}' (guarded_by: {lock}) called "
                            f"from '{name}' without 'with self.{lock}'",
                            f"{cls.name}.{name}.{ref}",
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# KB503 — device values crossing thread boundaries


def _device_tainted(mod: Module, e: ast.AST, tainted: set[str]) -> bool:
    if isinstance(e, ast.Name):
        return e.id in tainted
    if isinstance(e, ast.Call):
        d = mod.dotted(e.func)
        if d in _MATERIALIZERS:
            return False
        if isinstance(e.func, ast.Attribute) and e.func.attr in _MATERIALIZER_ATTRS:
            return False
        if d and (d == "torch" or d.startswith("torch.")):
            return True
    return any(_device_tainted(mod, c, tainted) for c in ast.iter_child_nodes(e))


@rule(
    "KB503",
    "device value crossing a thread boundary unmaterialized",
    """
A value produced by a `torch.` call is handed to another thread —
`queue.put(...)`, `Thread(target=..., args=...)`, `run_in_executor`/
`to_thread` arguments — without materialization. A CUDA tensor is a handle
to (possibly still-being-written) device memory: the consuming thread's
first use forces the transfer at an uncontrolled point, on a stream the
producer may still be writing, two threads can race the same buffer, and
the spill protocol's 'the host tree IS the request' durability contract
silently becomes 'a device pointer is'. Materialize first (`.cpu()`,
`.numpy()`, `.item()`, `.tolist()`, `np.asarray`) or hand over a zero-arg
thunk so the WORKER executes the fetch (the SpillManager `member_snapshot`
pattern).
""",
)
def check_device_cross_thread(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    out: list[Finding] = []
    reach = mod.reach

    for node, info in reach.by_node.items():
        tainted: set[str] = set()

        def handoff(args: list[ast.expr], call: ast.Call, what: str, qual: str):
            for a in args:
                if _device_tainted(mod, a, tainted):
                    out.append(
                        Finding(
                            mod.path, "KB503", call.lineno,
                            f"unmaterialized device value into {what} in "
                            f"'{qual}' — .cpu()/np.asarray it first",
                            f"{qual}.{what}",
                        )
                    )
                    return

        # linear walk in source order: assignments taint, handoffs check
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and _device_tainted(mod, n.value, tainted):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
            elif isinstance(n, ast.Call):
                d = mod.dotted(n.func)
                attr = n.func.attr if isinstance(n.func, ast.Attribute) else None
                if attr in ("put", "put_nowait"):
                    handoff(list(n.args), n, f"{attr}()", info.qualname)
                elif d == "threading.Thread":
                    for kw in n.keywords:
                        if kw.arg == "args":
                            handoff([kw.value], n, "Thread(args=...)", info.qualname)
                elif d == "asyncio.to_thread" or attr == "run_in_executor":
                    handoff(list(n.args)[1:], n, f"{attr or 'to_thread'}()",
                            info.qualname)
    return out


# ---------------------------------------------------------------------------
# KB504 — durable-write protocol


@rule(
    "KB504",
    "durable write missing the flush->fsync->replace protocol",
    """
A function calls `os.replace` (the atomic-publish step) without `os.fsync`
+ `.flush()` on the temp file first, or a serve-side `checkpoint.save`
omits `atomic=True`. The protocol — write tmp, flush Python buffers, fsync
to the platter, `os.replace` into place — is what makes a crash leave
either the old complete file or the new complete file. Skip the fsync and
the rename can land BEFORE the data blocks: a power cut then publishes a
hole, and recovery (journal replay, spill restore) trips over a truncated
archive it was promised could not exist. `journal._write_json_atomic` and
`checkpoint._savez_atomic` are the canonical implementations.
""",
)
def check_durable_protocol(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    out: list[Finding] = []
    for node, info in mod.reach.by_node.items():
        calls = list(_scan_calls(node))
        replaces = [c for c in calls if mod.dotted(c.func) == "os.replace"]
        if replaces:
            has_fsync = any(mod.dotted(c.func) == "os.fsync" for c in calls)
            has_flush = any(
                isinstance(c.func, ast.Attribute) and c.func.attr == "flush"
                for c in calls
            )
            if not (has_fsync and has_flush):
                missing = "os.fsync" if not has_fsync else ".flush()"
                out.append(
                    Finding(
                        mod.path, "KB504", replaces[0].lineno,
                        f"os.replace in '{info.qualname}' without {missing} "
                        "before it — torn durable write on crash",
                        f"{info.qualname}.os.replace",
                    )
                )
        if "kaboodle_tpu_torch/serve/" in mod.path:
            for c in calls:
                d = mod.dotted(c.func)
                if d != "kaboodle_tpu_torch.checkpoint.save":
                    continue
                atomic = any(
                    kw.arg == "atomic"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in c.keywords
                )
                if not atomic:
                    out.append(
                        Finding(
                            mod.path, "KB504", c.lineno,
                            f"checkpoint.save without atomic=True in "
                            f"'{info.qualname}' — a crash mid-spill leaves a "
                            "truncated archive",
                            f"{info.qualname}.checkpoint.save",
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# KB505 — static lock-order graph


@rule(
    "KB505",
    "lock-acquisition-order cycle",
    """
Two code paths acquire the same locks in opposite orders (`with a: with
b:` somewhere, `with b: with a:` somewhere else) — the classic ABBA
deadlock: each thread holds one lock and waits forever on the other, and
it only manifests under exactly the interleaving chaos tests don't hit.
The graph is built per module from `with` nesting, closed over
module-local calls (a helper that takes lock B, called under lock A, adds
the edge A->B). Fix by picking ONE acquisition order and sticking to it;
the runtime sanitizer (analysis/conc/sanitizer.py) asserts the same
invariant on the DYNAMIC graph under chaos.
""",
)
def check_lock_order(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    reach = mod.reach
    method_class: dict[ast.AST, ast.ClassDef] = {}
    for cls in _classes(mod):
        for m in _methods(cls).values():
            method_class[m] = cls

    def lock_label(e: ast.AST, fn: ast.AST) -> str | None:
        attr = _self_attr(e)
        if attr is not None:
            cls = method_class.get(fn)
            return f"{cls.name}.{attr}" if cls is not None else f"self.{attr}"
        if isinstance(e, ast.Name):
            return e.id
        return None

    # per function: direct nesting edges, own acquisitions, call sites under
    # held locks (resolved module-locally, same rules as KB501)
    acquires: dict[ast.AST, set[str]] = {}
    callees: dict[ast.AST, set[ast.AST]] = {}
    edges: dict[tuple[str, str], int] = {}
    deferred: list[tuple[set[str], ast.AST]] = []

    def resolve(call: ast.Call, fn: ast.AST) -> ast.AST | None:
        if isinstance(call.func, ast.Name):
            cands = reach.by_name.get(call.func.id, [])
            return cands[0].node if len(cands) == 1 else None
        attr = _self_attr(call.func)
        cls = method_class.get(fn)
        if attr and cls is not None:
            return _methods(cls).get(attr)
        return None

    for fn in reach.by_node:
        acquires[fn] = set()
        callees[fn] = set()

        def do(stmts, held: tuple, fn=fn) -> None:
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(s, (ast.With, ast.AsyncWith)):
                    inner = list(held)
                    for item in s.items:
                        lock = lock_label(item.context_expr, fn)
                        if lock:
                            for h in inner:
                                edges[(h, lock)] = min(
                                    edges.get((h, lock), s.lineno), s.lineno
                                )
                            acquires[fn].add(lock)
                            inner.append(lock)
                    do(s.body, tuple(inner))
                    continue
                for e in ast.iter_child_nodes(s):
                    if isinstance(e, (ast.stmt, ast.FunctionDef)):
                        continue
                    for c in ast.walk(e):
                        if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                            continue
                        if isinstance(c, ast.Call):
                            target = resolve(c, fn)
                            if target is not None:
                                callees[fn].add(target)
                                if held:
                                    deferred.append((set(held), target))
                for f in ("body", "orelse", "finalbody"):
                    do(getattr(s, f, []) or [], held)
                for h in getattr(s, "handlers", []) or []:
                    do(h.body, held)

        do(fn.body, ())

    # transitive acquisitions, then the call-under-lock edges
    changed = True
    while changed:
        changed = False
        for fn in acquires:
            for cal in callees[fn]:
                extra = acquires.get(cal, set()) - acquires[fn]
                if extra:
                    acquires[fn] |= extra
                    changed = True
    for held, target in deferred:
        for h in held:
            for lock in acquires.get(target, set()):
                if h != lock:
                    edges.setdefault((h, lock), 0)

    # cycle detection (iterative DFS over the small lock graph)
    graph: dict[str, set[str]] = {}
    for (a, b), _line in edges.items():
        if a == b:
            continue
        graph.setdefault(a, set()).add(b)
    out: list[Finding] = []
    seen_cycles: set[frozenset] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cyc = "->".join(path + [start])
                        line = min(
                            (edges.get((a, b), 1) or 1)
                            for a, b in zip(path, path[1:] + [start])
                        )
                        out.append(
                            Finding(
                                mod.path, "KB505", max(line, 1),
                                f"lock-order cycle {cyc}: ABBA deadlock "
                                "under the wrong interleaving",
                                f"cycle:{'->'.join(sorted(set(path)))}",
                            )
                        )
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return out


# ---------------------------------------------------------------------------
# KB506 — unbounded queues


@rule(
    "KB506",
    "unbounded Queue/deque in serve scope",
    """
`queue.Queue()` / `asyncio.Queue()` / `collections.deque()` constructed
without `maxsize=`/`maxlen=` in the serve plane. An unbounded queue is
admission control with the sign flipped: under overload it converts
backpressure into unbounded host memory growth and silently unbounded
latency (the admission-control design, `serve/admission.py`, exists
precisely to bound these). `queue.SimpleQueue` cannot be bounded at all — use `queue.Queue`.
Give it a bound, or `# noqa: KB506` with the invariant that bounds it
externally (e.g. a drain-every-round contract against a bounded feeder).
""",
)
def check_unbounded_queue(mod: Module) -> list[Finding]:
    if not _in_scope(mod):
        return []
    out: list[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = mod.dotted(node.func)
        if d not in _UNBOUNDED:
            continue
        bound_kw = _UNBOUNDED[d]
        bounded = bound_kw is not None and (
            any(kw.arg == bound_kw for kw in node.keywords)
            or (d == "collections.deque" and len(node.args) >= 2)
            or (d != "collections.deque" and len(node.args) >= 1)
        )
        if not bounded:
            ctor = d.rsplit(".", 1)[-1]
            out.append(
                Finding(
                    mod.path, "KB506", node.lineno,
                    f"unbounded {d}() in serve scope — overload turns into "
                    "host memory growth, not backpressure",
                    f"{ctor}",
                )
            )
    return out
