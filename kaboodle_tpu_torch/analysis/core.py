"""graftconc core: findings, the rule registry, noqa and baseline plumbing.

The port of the parts of ``kaboodle_tpu/analysis/core.py`` that the
concurrency lane (KB501-KB506, ``analysis/conc/rules.py``) uses.
Dependency-free by construction (``ast`` + stdlib only): the analyzer never
imports torch, so the lane runs at parse speed and needs no device.

Vocabulary:

- A **rule** has a stable id (``KB5xx``), a one-line title, and an
  ``--explain`` text that says what it catches, why it matters here, and
  how to suppress it.
- A **finding** is one diagnostic. Its ``key`` (path :: rule :: symbol --
  deliberately *no line number*, so baselines survive unrelated edits) is
  what the baseline file matches against.
- ``# noqa`` on the offending line suppresses findings there: bare ``noqa``
  (or a foreign-linter code list like ``# noqa: E731``) suppresses
  everything on the line, while ``# noqa: KB503`` suppresses only the
  named rules.
- The **baseline** (``analysis/conc/baseline.json``) holds pre-existing,
  justified findings so the gate fails on *new* debt only; every entry
  must carry a non-empty ``reason``. ``--no-baseline-growth`` also fails
  on stale entries, so the file can only shrink.

The JAX package's AST, IR and rng lanes check jit tracing, which the port
does not do: their rules and its ``reach.py`` tracer analysis are not
ported. :class:`FunctionIndex` keeps the one part of ``reach.py`` the conc
rules read: every function of a module by node and by name, with its
qualified name.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Callable, Iterable

# ---------------------------------------------------------------------------
# findings + rules


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``symbol`` is a stable context (enclosing function
    qualname plus the offending name), so ``key`` survives line shifts."""

    path: str
    rule: str
    line: int
    message: str
    symbol: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str  # noqa: KB104 — dataclass field, not a scope binding that can leak
    title: str
    explain: str
    check: Callable[["Module"], list[Finding]]


REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, title: str, explain: str):
    """Register ``check(module) -> [Finding]`` under a stable rule id."""

    def deco(fn):
        REGISTRY[rule_id] = Rule(rule_id, title, explain.strip(), fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# per-file model

_NOQA_RE = re.compile(r"#\s*noqa(?:\s*:\s*(?P<codes>[A-Za-z0-9_,\s]+))?", re.I)
_ALL = frozenset({"*"})


def noqa_codes(line: str) -> frozenset[str]:
    """Rule ids suppressed by a source line; {'*'} means everything.

    Foreign-linter code lists (``# noqa: E402``) suppress everything too,
    as in the JAX package's checker."""
    m = _NOQA_RE.search(line)
    if not m:
        return frozenset()
    codes = m.group("codes")
    if not codes:
        return _ALL
    kb = frozenset(c.strip().upper() for c in codes.split(",") if c.strip().upper().startswith("KB"))
    return kb or _ALL


@dataclasses.dataclass
class FuncInfo:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str


class FunctionIndex:
    """Every ``def`` of a module: ``by_node`` (node -> FuncInfo) and
    ``by_name`` (bare name -> [FuncInfo]), qualnames dotted through the
    enclosing classes and functions."""

    def __init__(self, tree: ast.AST):
        self.by_node: dict[ast.AST, FuncInfo] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        self._collect(tree, "")

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


class Module:
    """Parsed source handed to every rule, with shared per-file analyses.

    ``path`` is kept verbatim (repo-relative in normal runs): rules use it
    for scoping and findings/baseline keys embed it."""

    def __init__(self, path: str, source: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, path)
        self.import_aliases = self._collect_import_aliases(self.tree)
        self._reach = None

    @staticmethod
    def _collect_import_aliases(tree: ast.AST) -> dict[str, str]:
        """local name -> dotted module/object path, for every import."""
        aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name != "*":
                        aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> str | None:
        """Dotted path of a Name/Attribute chain with the leading alias
        resolved through the imports: ``np.asarray`` -> ``numpy.asarray``."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.import_aliases.get(node.id, node.id)
        parts.append(base)
        return ".".join(reversed(parts))

    @property
    def reach(self) -> FunctionIndex:
        if self._reach is None:
            self._reach = FunctionIndex(self.tree)
        return self._reach

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        if not (0 < lineno <= len(self.lines)):
            return False
        codes = noqa_codes(self.lines[lineno - 1])
        return "*" in codes or rule_id in codes


# ---------------------------------------------------------------------------
# running


def analyze_module(mod: Module, rules: Iterable[Rule] | None = None) -> list[Finding]:
    """All non-noqa'd findings for one parsed module, sorted by position."""
    out: list[Finding] = []
    for r in rules if rules is not None else REGISTRY.values():
        for f in r.check(mod):
            if not mod.suppressed(f.rule, f.line):
                out.append(f)
    return sorted(out, key=lambda f: (f.line, f.rule, f.symbol))


def analyze_source(source: str, path: str = "module.py") -> list[Finding]:
    """Findings for a source string (fixtures). ``path`` takes part in
    rule scoping exactly as a real file path would."""
    _load_rules()
    return analyze_module(Module(path, source))


def analyze_path(path: pathlib.Path, rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Findings for one file; unparseable source yields a single KB100."""
    _load_rules()
    name = str(path)
    try:
        mod = Module(name, path.read_text())
    except SyntaxError as e:
        return [Finding(name, "KB100", e.lineno or 1, f"syntax error: {e.msg}", "<syntax>")]
    return analyze_module(mod, rules)


def iter_python_files(targets: list[str]) -> list[pathlib.Path]:
    files: list[pathlib.Path] = []
    for t in targets:
        p = pathlib.Path(t)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    return files


def _load_rules() -> None:
    """Import the rule modules (idempotent) so REGISTRY is populated: the
    conc rules KB501-KB506 and the documentation of KB405 and KB601-KB605."""
    from kaboodle_tpu_torch.analysis import rules_ir, rules_rng  # noqa: F401
    from kaboodle_tpu_torch.analysis.conc import rules as rules_conc  # noqa: F401


# ---------------------------------------------------------------------------
# baseline


class BaselineError(ValueError):
    """Malformed baseline file (bad JSON, missing key/reason)."""


def load_baseline(path: pathlib.Path) -> dict[str, str]:
    """key -> reason. A missing file is an empty baseline; a malformed one
    (or any entry without a non-empty justification) is a hard error --
    the justification is the point of the file."""
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise BaselineError(f"{path}: invalid JSON: {e}") from e
    entries = data.get("entries") if isinstance(data, dict) else None
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected an object with an 'entries' list")
    out: dict[str, str] = {}
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not e.get("key") or not str(e.get("reason", "")).strip():
            raise BaselineError(
                f"{path}: entries[{i}] needs a 'key' and a non-empty 'reason' justification"
            )
        out[str(e["key"])] = str(e["reason"])
    return out


def write_baseline(path: pathlib.Path, findings: list[Finding], old: dict[str, str]) -> None:
    """Regenerate the baseline from current findings, keeping old reasons."""
    keys = sorted({f.key for f in findings})
    payload = {
        "comment": (
            "graftconc baseline: pre-existing, justified findings. Entries may "
            "only be removed (fix the finding, delete the entry); the "
            "--no-baseline-growth gate fails on stale or new entries."
        ),
        "entries": [
            {"key": k, "reason": old.get(k, "TODO: justify this exemption")} for k in keys
        ],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")
