"""analysis -- the port's copies of the JAX package's analysis helpers.

Ported: the runtime concurrency sanitizer (``analysis/conc/sanitizer.py``;
the serve engine and spill writer take their locks from it) and the
compile counter of ``analysis/ir/surface.py`` (here a count of programs
built, which the serve drivers' zero-rebuild gates read). The static lint
lanes (graftlint, graftscan, costscope, keyscope, the KB5xx rules) read
JAX programs and have no counterpart here.
"""
