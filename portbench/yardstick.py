"""The card's peaks and the hand kernels' operations and bytes, frozen here.

Peaks of one NVIDIA H100 SXM (data sheet): 3.35 TB/s of HBM; 32-bit integer
operations at 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, the boost clock
behind the data sheet's 67 TFLOP/s float32 rate (Hopper whitepaper).

The bytes and operations of a launch of each hand kernel at ``b`` rows of
an ``n``-wide mesh with ``live`` alive rows and a ``tb``-byte timer are
counted from the kernel's definition: each input byte read once, each
output byte written once, and only what these inputs need (a dead row's
timers are never read). Operations per cell are ``(alive row, dead row)``:
fp with identity views two mix32 (8 ops each) + 2 xors + the test, the
masked add and the count add = 21; fp over record hashes 3; suspicion 5 on
every cell plus 5 on an alive row; oldest-k 6 on an alive row, none on a
dead one.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 64 * 132 * SM_CLOCK_HZ

OPS_PER_CELL = {"fused_fp_idv": (21, 21), "fused_fp_hash": (3, 3),
                "fused_suspicion": (10, 5), "fused_oldest_k": (6, 0)}

# The device kernel's name (as the profiler gives it) of each hand kernel.
KERNEL_SYMBOLS = {"fused_fp": "fused_fp_kernel",
                  "fused_suspicion": "fused_suspicion_kernel",
                  "fused_oldest_k": "fused_oldest_k_kernel"}


def kernel_bytes(name: str, b: int, n: int, live: int, tb: int, k: int = 5) -> int:
    """Bytes a launch of ``name`` needs at its shape."""
    if name == "fused_fp_idv":
        return b * n * 5 + 8 * b
    if name == "fused_fp_hash":
        return b * n + 4 * n + 8 * b
    if name == "fused_suspicion":
        return b * n + live * n * tb + b + 11 * b
    if name == "fused_oldest_k":
        return live * n * (1 + tb) + b + 5 * b * k
    raise KeyError(name)


def kernel_ops(name: str, b: int, n: int, live: int) -> int:
    """32-bit integer operations a launch of ``name`` needs at its shape."""
    per_live, per_dead = OPS_PER_CELL[name]
    return (live * per_live + (b - live) * per_dead) * n


def bound_s(name: str, b: int, n: int, live: int, tb: int, k: int = 5) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the int32 rate."""
    return max(kernel_bytes(name, b, n, live, tb, k) / HBM_BYTES_PER_S,
               kernel_ops(name, b, n, live) / INT32_OPS_PER_S)
