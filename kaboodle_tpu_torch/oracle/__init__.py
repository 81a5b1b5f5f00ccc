"""Host-side reference functions: the fingerprints, computed in pure Python.

Only the fingerprint functions are ported (``oracle/fingerprint.py``); the
lockstep oracle engine of the JAX package is not part of the port yet.
"""
