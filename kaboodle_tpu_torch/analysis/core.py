"""graftlint core: findings, the rule registry, noqa and baseline plumbing.

The port of ``kaboodle_tpu/analysis/core.py``, shared by every lane of
``python -m kaboodle_tpu_torch.analysis``. Dependency-free by construction
(``ast`` + stdlib only): the AST lanes never import torch -- rules that
reason about per-tick code do so syntactically (``reach.py``) -- so they
run at parse speed and need no device.

Vocabulary:

- A **rule** has a stable id (``KB1xx`` generic, ``KB2xx`` the torch
  meanings of the JAX tracer rules, ``KB3xx`` hot-path, ``KB4xx`` the IR
  lane over the dispatch trace, ``KB5xx`` concurrency, ``KB6xx`` key
  provenance), a one-line title, and an ``--explain`` text that says what
  it catches, why it matters here, and how to suppress it.
- A **finding** is one diagnostic. Its ``key`` (path :: rule :: symbol --
  deliberately *no line number*, so baselines survive unrelated edits) is
  what the baseline file matches against.
- ``# noqa`` on the offending line suppresses findings there: bare ``noqa``
  (or a foreign-linter code list like ``# noqa: E731``) suppresses
  everything on the line, while ``# noqa: KB203`` suppresses only the
  named rules.
- A **baseline** holds pre-existing, justified findings so the gate fails
  on *new* debt only; every entry must carry a non-empty ``reason``.
  ``--no-baseline-growth`` also fails on stale entries, so the file can
  only shrink. Each lane has its own, inside the port:
  ``analysis/baseline.json`` (AST), ``analysis/ir/baseline.json``,
  ``analysis/rng/baseline.json`` and ``analysis/conc/baseline.json``.
  The AST and IR baselines also record each entry's ``count`` (how often
  the finding occurs; KB402: the syncs per call), and a count that rises
  fails the lane (:func:`count_findings`).
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
    def reach(self):
        """The module's functions and which of them are hot (``reach.py``)."""
        if self._reach is None:
            from kaboodle_tpu_torch.analysis import reach

            self._reach = reach.ReachInfo(self)
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
    """Import the rule modules (idempotent) so REGISTRY is populated.

    rules_ir and rules_rng register the KB4xx/KB6xx documentation with
    no-op source checks (their passes run over the dispatch trace behind
    ``--ir``/``--rng``); the conc rules (KB5xx) register here too, and the
    CLI runs them only in the ``--conc`` lane."""
    from kaboodle_tpu_torch.analysis import (  # noqa: F401
        rules_generic,
        rules_hotpath,
        rules_ir,
        rules_jax,
        rules_rng,
    )
    from kaboodle_tpu_torch.analysis.conc import rules as rules_conc  # noqa: F401


# ---------------------------------------------------------------------------
# baseline

DEFAULT_BASELINE = "kaboodle_tpu_torch/analysis/baseline.json"


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


def load_counts(path: pathlib.Path) -> dict[str, tuple[int, ...]]:
    """key -> the ``count`` recorded beside it (how many times the finding
    occurs: a list of ints, one per run the lane makes); entries without
    one are absent. Call after :func:`load_baseline` has validated the file."""
    if not path.exists():
        return {}
    out: dict[str, tuple[int, ...]] = {}
    for e in json.loads(path.read_text())["entries"]:
        if "count" not in e:
            continue
        c = e["count"]
        if not (isinstance(c, list) and c and all(isinstance(x, int) for x in c)):
            raise BaselineError(f"{path}: entry {e['key']!r}: 'count' must be a list of ints")
        out[str(e["key"])] = tuple(c)
    return out


def count_findings(measured: dict[str, tuple[int, ...]], recorded: dict[str, tuple[int, ...]],
                   baseline: dict[str, str], no_growth: bool) -> list[Finding]:
    """The counts of baselined findings against those recorded beside them.

    A key is line-free, so a second host sync in a function that already
    has a baselined one makes no new key: only its count rises. A rise (or
    a baselined key with no recorded count) is a finding that no baseline
    entry suppresses; a fall fails under ``no_growth``, so the counts, like
    the entries, only shrink."""
    out = []
    for key, got in sorted(measured.items()):
        if key not in baseline:
            continue  # a finding of its own already
        path, rule, symbol = key.split("::", 2)
        want = recorded.get(key)
        if want is None:
            tag, msg = "count-missing", "has no recorded count"
        elif len(got) != len(want) or any(g > w for g, w in zip(got, want)):
            tag, msg = "count-rose", f"rose to {list(got)} from the recorded {list(want)}"
        elif got != want and no_growth:
            tag, msg = "count-fell", f"fell to {list(got)} from the recorded {list(want)}"
        else:
            continue
        out.append(Finding(path, rule, 0, f"{symbol}: the baselined finding's count {msg} "
                           "-- rewrite the baseline (--write-baseline) once it is justified",
                           f"{symbol}:{tag}"))
    return out


def write_baseline(path: pathlib.Path, findings: list[Finding], old: dict[str, str],
                   counts: dict[str, tuple[int, ...]] | None = None) -> None:
    """Regenerate the baseline from current findings, keeping old reasons and
    the file's comment; ``counts`` are recorded beside their keys."""
    keys = sorted({f.key for f in findings})
    comment = (
        "baseline: pre-existing, justified findings. Entries may "
        "only be removed (fix the finding, delete the entry); the "
        "--no-baseline-growth gate fails on stale or new entries."
    )
    if path.exists():
        comment = json.loads(path.read_text()).get("comment", comment)
    counts = counts or {}
    payload = {
        "comment": comment,
        "entries": [
            {"key": k, "reason": old.get(k, "TODO: justify this exemption"),
             **({"count": list(counts[k])} if k in counts else {})} for k in keys
        ],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")
