"""analysis -- the port's copies of the JAX package's analysis helpers.

Ported: the graftconc lane, both halves -- the static KB501-KB506 rules
over the port's serve plane (``analysis/conc/rules.py`` on ``core.py``,
run by ``python -m kaboodle_tpu_torch.analysis --conc``, gated on
``analysis/conc/baseline.json``) and the runtime concurrency sanitizer
(``analysis/conc/sanitizer.py``; the serve engine and spill writer take
their locks from it) -- and the compile counter of
``analysis/ir/surface.py`` (here a count of programs built, which the
serve drivers' zero-rebuild gates read). The lanes that read JAX programs
(graftlint's AST rules, graftscan, keyscope, costscope) check jit tracing
and XLA costs and have no counterpart here.
"""

from kaboodle_tpu_torch.analysis.core import analyze_source

__all__ = ["analyze_source"]
