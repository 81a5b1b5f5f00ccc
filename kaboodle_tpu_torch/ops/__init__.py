"""Hashes, the threefry RNG, sampling primitives and the fused kernels."""
