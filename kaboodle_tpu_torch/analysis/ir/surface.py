"""The compile counter: programs the serving path builds inside a block.

The port of ``compile_counter`` and ``assert_counter_live`` of the JAX
package's ``analysis/ir/surface.py``. The JAX counter listens for fresh XLA
compilations; the port builds programs instead of compiling them, so its
counter reads the growth of :func:`~kaboodle_tpu_torch.serve.pool.program_builds`
(misses of the pool's program caches, of the warp leap cache and of the
sparse tick cache, plus the CUDA kernel libraries built or loaded). The
drivers' zero-recompile gates (``compiles_steady == 0``) read it. The rest
of the JAX module measures XLA programs and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Iterator

# Mesh sizes for the liveness probe's fresh programs: odd, so never a pool's
# class (classes are powers of two), and never the same twice.
_PROBE_N = itertools.count(3, 2)


class CompileCount:
    """Programs built since the block opened; frozen when it closes."""

    def __init__(self) -> None:
        self._base = _builds()
        self._final: int | None = None

    @property
    def count(self) -> int:
        return (_builds() if self._final is None else self._final) - self._base

    def _close(self) -> None:
        self._final = _builds()


def _builds() -> int:
    from kaboodle_tpu_torch.serve.pool import program_builds

    return program_builds()


@contextlib.contextmanager
def compile_counter() -> Iterator[CompileCount]:
    """Count the programs built inside the block (cache hits: zero). Nestable."""
    box = CompileCount()
    try:
        yield box
    finally:
        box._close()


def assert_counter_live() -> None:
    """Fail loudly if the build count does not move when a program is built.

    A probe builds one fresh program (a re-seed program for a mesh size no
    pool serves, so never a cache hit) and must register before any
    zero-recompile measurement is trusted: a dead counter would make every
    such gate pass vacuously."""
    from kaboodle_tpu_torch.serve.pool import _reseed_program

    with compile_counter() as box:
        _reseed_program(next(_PROBE_N), "boot", ())
    if box.count == 0:
        raise RuntimeError(
            "the program-build count did not move when a fresh program was "
            "built: zero-recompile counts would be vacuously 0"
        )
