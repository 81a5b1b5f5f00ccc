"""Fused oldest-k ping-target candidates: a CUDA kernel and its plain version.

Per row i: the k lexicographically smallest ``(timer, j)`` over the cells
``alive[i] & state == KNOWN & j != i & timer != max(timer dtype)``, as
``(idx int32 [N, k], valid bool [N, k])``, with ``idx`` = n - 1 in a slot
with no candidate. A timer at its dtype's max is the ineligibility
sentinel of the jnp formulation (ops/sampling.py), so it is never a
candidate here either.

The kernel (``csrc/fused_oldest_k.cu``) replaces the Pallas kernel
``kaboodle_tpu/ops/fused_oldest_k.py::fused_oldest_k`` (pallas_call at
fused_oldest_k.py:119); its bound and design are in the source's head
comment. It takes any ``k >= 1``, and rows ``row0 .. row0 + B - 1`` of a
row-sharded mesh (``[B, N]`` planes, ``[B]`` alive; ``row0`` places the
diagonal that ``j != i`` excludes). The wrapper takes the plain version
only for CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from kaboodle_tpu_torch.ops import _cuda
from kaboodle_tpu_torch.spec import KNOWN

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_oldest_k_plain(state, timer, alive, k: int, row0: int = 0):
    """The plain PyTorch version: k rounds of (timer, j) lex-min over the row."""
    n = state.shape[-1]
    b = state.shape[0]
    T = timer.to(torch.int32)
    col = torch.arange(n, dtype=torch.int32, device=state.device)
    ridx = col[row0:row0 + b]  # the rows' own peer indices
    tmax = torch.iinfo(timer.dtype).max
    elig = alive[:, None] & (state == KNOWN) & (col[None, :] != ridx[:, None]) & (T != tmax)
    i32 = torch.iinfo(torch.int32)
    prev_t = torch.full((b,), i32.min, dtype=torch.int32, device=state.device)
    prev_i = torch.full((b,), -1, dtype=torch.int32, device=state.device)
    out_i, out_v = [], []
    for _ in range(k):
        after = (T > prev_t[:, None]) | ((T == prev_t[:, None]) & (col[None, :] > prev_i[:, None]))
        cand = elig & after
        t_r = torch.where(cand, T, i32.max).amin(dim=-1)
        i_r = torch.where(cand & (T == t_r[:, None]), col[None, :], n).amin(dim=-1)
        out_i.append(i_r.clamp(max=n - 1))
        out_v.append(t_r != i32.max)
        prev_t, prev_i = t_r, i_r
    return torch.stack(out_i, dim=-1).to(torch.int32), torch.stack(out_v, dim=-1)


@_cuda.cost_unit(_cuda.cell_flops)
def fused_oldest_k(state: torch.Tensor, timer: torch.Tensor, alive: torch.Tensor, k: int,
                   row0: int = 0):
    """The k oldest eligible candidates per row (see the module docstring).

    ``state`` int8 ``[B, N]``, ``timer`` int16/int32 ``[B, N]``: rows
    ``row0 .. row0 + B - 1`` of the mesh (all of it with the defaults);
    ``alive`` bool ``[B]``. Returns ``(idx int32 [B, k], valid bool [B, k])``."""
    n = state.shape[-1]
    b = state.shape[0]
    row0 = int(row0)
    _cuda.require(state.dtype == torch.int8 and state.dim() == 2, "state: int8 [B, N]")
    _cuda.require(0 < b and 0 <= row0 and row0 + b <= n, "rows row0 .. row0 + B inside N")
    _cuda.require(timer.dtype in (torch.int16, torch.int32) and timer.shape == (b, n),
                  "timer: int16/int32 [B, N]")
    _cuda.require(alive.dtype == torch.bool and alive.shape == (b,), "alive: bool [B]")
    _cuda.require(timer.device == state.device == alive.device, "inputs on one device")
    _cuda.require(k >= 1, "k >= 1")
    _cuda.require(all(x.is_contiguous() for x in (state, timer, alive)), "contiguous inputs")
    if state.device.type == "cpu":
        return fused_oldest_k_plain(state, timer, alive, k, row0)
    _cuda.require(state.device.type == "cuda", f"unsupported device {state.device}")
    lib = _cuda.library("fused_oldest_k", kb_fused_oldest_k=_ARGTYPES)
    dev = state.device
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    valid = torch.empty((b, k), dtype=torch.bool, device=dev)
    rc = lib.kb_fused_oldest_k(
        state.data_ptr(), timer.data_ptr(), timer.element_size(), alive.data_ptr(), k,
        idx.data_ptr(), valid.data_ptr(), b, row0, n, _cuda.vec_ok(n, state, timer),
        _cuda.stream_handle(dev),
    )
    _cuda.check(lib, rc, "fused_oldest_k")
    _cuda.launches["fused_oldest_k"] += 1
    return idx, valid
