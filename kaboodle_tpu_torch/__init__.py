"""kaboodle_tpu_torch: the SWIM simulator of kaboodle_tpu, ported to PyTorch and CUDA.

The JAX package ``kaboodle_tpu`` is the reference; this package imports
nothing of it and no JAX. Module names mirror the JAX package. The dense
tick (``sim``) runs on an NVIDIA Hopper card, with the JAX package's three
Pallas kernels rewritten as hand CUDA kernels (``csrc/``, built by
``ops/_cuda.py`` at first use). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
