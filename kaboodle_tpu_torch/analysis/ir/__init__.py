"""analysis.ir -- the compile-surface lane (KB405, ``surface.py``): the
program-build counter of the serving path and the per-family budget; and
the entry-point registry costscope walks (``registry.py``)."""
