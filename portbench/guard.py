"""No JAX in a run: the modules a run loaded and the reference's imports.

Names are compared by their top-level part (before the first dot), whole:
the port, ``kaboodle_tpu_torch``, begins with the JAX package's name, so a
prefix test would be wrong.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "kaboodle_tpu"))
REFERENCE_FORBIDDEN = FORBIDDEN | {"kaboodle_tpu_torch"}
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if top(m) in FORBIDDEN})


def imports_of(path: Path) -> set[str]:
    """Top-level names a source file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out


def reference_forbidden(ref_dir: Path = REFERENCE_DIR) -> dict[str, list[str]]:
    """Per reference file, the forbidden top-level names it imports."""
    out = {}
    for p in sorted(ref_dir.glob("*.py")):
        bad = sorted(imports_of(p) & REFERENCE_FORBIDDEN)
        if bad:
            out[p.name] = bad
    return out
