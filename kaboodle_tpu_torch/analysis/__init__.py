"""analysis -- the port's copies of the JAX package's analysis helpers.

Only the runtime concurrency sanitizer (``analysis/conc/sanitizer.py``)
is ported: the serve engine and spill writer take their locks from it.
The static lint lanes (graftlint, graftscan, costscope, keyscope, the
KB5xx rules) read JAX programs and have no counterpart here.
"""
