"""analysis -- the port's copies of the JAX package's analysis helpers.

Ported: the graftconc lane, both halves -- the static KB501-KB506 rules
over the port's serve plane (``analysis/conc/rules.py`` on ``core.py``,
run by ``python -m kaboodle_tpu_torch.analysis --conc``, gated on
``analysis/conc/baseline.json``) and the runtime concurrency sanitizer
(``analysis/conc/sanitizer.py``; the serve engine and spill writer take
their locks from it); the compile-surface lane of
``analysis/ir/surface.py`` (KB405, ``--ir``: a count of programs built,
which the serve drivers' zero-rebuild gates read too, gated per family on
``analysis/ir/surface.json``); and the ``STREAM_*`` register of
``analysis/rng/rules.py`` (KB602's registry half, ``--rng``); and the
entry-point registry ``analysis/ir/registry.py`` that ``costscope``
(``kaboodle_tpu_torch/costscope/``) walks. What reads JAX programs
(graftlint's AST rules, graftscan's KB401-KB404, keyscope's traced
checks) checks jit tracing and has no counterpart here.
"""

from kaboodle_tpu_torch.analysis.core import analyze_source

__all__ = ["analyze_source"]
