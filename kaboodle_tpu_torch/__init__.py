"""kaboodle_tpu_torch: the SWIM simulator of kaboodle_tpu, ported to PyTorch and CUDA.

The JAX package ``kaboodle_tpu`` is the reference; this package imports
nothing of it and no JAX. Module names mirror the JAX package. The dense
tick (``sim``) runs on an NVIDIA Hopper card, with the JAX package's three
Pallas kernels rewritten as hand CUDA kernels (``csrc/``, built by
``ops/_cuda.py`` at first use). Entry points run on the card unless the
caller passes ``device="cpu"``.

Public API mirrors the reference's ``Kaboodle`` facade (lib.rs:78-369):
see :class:`kaboodle_tpu_torch.api.Kaboodle` and ``SimNetwork``.
"""

from kaboodle_tpu_torch.config import SwimConfig
from kaboodle_tpu_torch.errors import KaboodleError

__all__ = ["SwimConfig", "KaboodleError", "Kaboodle", "SimNetwork"]


def __getattr__(name):
    # Lazy: the facade pulls in the sim stack; plain `import kaboodle_tpu_torch`
    # (for config/spec constants) should not.
    if name in ("Kaboodle", "SimNetwork"):
        from kaboodle_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(name)
