"""analysis -- the port's static and traced analysis lanes (graftlint and kin).

The port of ``kaboodle_tpu/analysis``; ``python -m
kaboodle_tpu_torch.analysis [--ir|--conc|--rng|--all]`` (``cli.py``) runs
every lane the JAX package has, each with the torch meaning of its rules
and its own debt file inside the port:

- **AST lane** (graftlint, the default): KB101-KB104 (``rules_generic.py``,
  rule for rule the JAX lane's), KB201-KB204 (``rules_jax.py``: a Python
  branch or a coercion on a device value, ``print``, a counter-RNG key
  drawn twice; KB205 is documented, the port donates no buffer) and
  KB301/KB302 (``rules_hotpath.py``: host copies in per-tick code,
  dtype-less constructors) over the per-tick code ``reach.py`` finds in the
  engine builders. Pure ``ast``: it imports no torch. Debt file
  ``analysis/baseline.json``.
- **IR lane** (graftscan, ``--ir``): KB401-KB404 (``analysis/ir/passes.py``)
  over the dispatch trace of every entry of ``analysis/ir/registry.py``
  (``analysis/ir/walk.py``: each aten op one call makes, the hand kernels
  as opaque units), and KB405, the compile-surface budget
  (``analysis/ir/surface.py``). Debt file ``analysis/ir/baseline.json``.
- **rng lane** (keyscope, ``--rng``): KB601-KB605 over the key provenance
  recorded at the counter-RNG calls of the same trace
  (``analysis/rng/provenance.py``), KB602's ``STREAM_*`` register
  (``analysis/rng/rules.py``) and the leap report ``analysis/rng/leap.json``
  (the JAX schema). Debt file ``analysis/rng/baseline.json``.
- **conc lane** (graftconc, ``--conc``): KB501-KB506 over the serve plane
  (``analysis/conc/rules.py``) and the runtime concurrency sanitizer the
  serve engine and spill writer take their locks from
  (``analysis/conc/sanitizer.py``). Debt file ``analysis/conc/baseline.json``.

The entry-point registry (``analysis/ir/registry.py``) is also what
``costscope`` walks.
"""

from kaboodle_tpu_torch.analysis.core import analyze_source

__all__ = ["analyze_source"]
