"""Fused phase-A row statistics: a CUDA kernel and its plain version.

Per row i, with ``thr = t - ping_timeout_ticks``:

  count[i]          = |{j : state[i,j] > 0}|                  (lonely test, A1)
  jstar[i]          = the oldest aged WaitingForPing cell, ties to the lower
                      j, on alive rows; -1 when none           (A2 escalation)
  has_timed[i]      = jstar[i] exists                          (A2 suspicion)
  has_cand[i]       = some Known cell j != i                   (A2 proxy pool)
  has_timed_wfip[i] = some aged WaitingForIndirectPing cell on an alive row

The kernel (``csrc/fused_suspicion.cu``) replaces the Pallas kernel
``kaboodle_tpu/ops/fused_suspicion.py::fused_suspicion`` (pallas_call at
fused_suspicion.py:119); its bound and design are in the source's head
comment. The rows may be a rank's rows ``row0 .. row0 + B - 1`` of a
row-sharded mesh (``[B, N]`` planes, ``[B]`` alive); ``row0`` places the
diagonal that ``has_cand`` excludes. The wrapper takes the plain version
only for CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from kaboodle_tpu_torch.ops import _cuda
from kaboodle_tpu_torch.spec import KNOWN, WAITING_FOR_INDIRECT_PING, WAITING_FOR_PING

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
)


def fused_suspicion_plain(state, timer, alive, thr: int, row0: int = 0):
    """The plain PyTorch version (same outputs as :func:`fused_suspicion`)."""
    n = state.shape[-1]
    T = timer.to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=state.device)
    ridx = idx[row0:row0 + state.shape[0]]  # the rows' own peer indices
    count = (state > 0).sum(dim=-1, dtype=torch.int32)
    aged = alive[:, None] & (T <= thr)
    timed = aged & (state == WAITING_FOR_PING)
    i32max = torch.iinfo(torch.int32).max
    t_min = torch.where(timed, T, i32max).amin(dim=-1)
    jstar = torch.where(timed & (T == t_min[:, None]), idx[None, :], n).amin(dim=-1)
    has_timed = timed.any(dim=-1)
    jstar = torch.where(has_timed, jstar, -1).to(torch.int32)
    has_cand = ((state == KNOWN) & (idx[None, :] != ridx[:, None])).any(dim=-1)
    wfip = (aged & (state == WAITING_FOR_INDIRECT_PING)).any(dim=-1)
    return count, jstar, has_timed, has_cand, wfip


@_cuda.cost_unit(_cuda.cell_flops)
def fused_suspicion(state: torch.Tensor, timer: torch.Tensor, alive: torch.Tensor, thr: int,
                    row0: int = 0):
    """Phase-A row stats of ``(state, timer)`` in one pass.

    ``state`` int8 ``[B, N]``, ``timer`` int16/int32 ``[B, N]``: rows
    ``row0 .. row0 + B - 1`` of the mesh (all of it with the defaults
    ``B == N``, ``row0 == 0``); ``alive`` bool ``[B]``, ``thr`` the int
    ``t - ping_timeout_ticks``. Returns ``(count int32, jstar int32,
    has_timed bool, has_cand bool, has_timed_wfip bool)``, each ``[B]``."""
    n = state.shape[-1]
    b = state.shape[0]
    row0 = int(row0)
    _cuda.require(state.dtype == torch.int8 and state.dim() == 2, "state: int8 [B, N]")
    _cuda.require(0 < b and 0 <= row0 and row0 + b <= n, "rows row0 .. row0 + B inside N")
    _cuda.require(timer.dtype in (torch.int16, torch.int32) and timer.shape == (b, n),
                  "timer: int16/int32 [B, N]")
    _cuda.require(alive.dtype == torch.bool and alive.shape == (b,), "alive: bool [B]")
    _cuda.require(timer.device == state.device == alive.device, "inputs on one device")
    _cuda.require(all(x.is_contiguous() for x in (state, timer, alive)), "contiguous inputs")
    thr = int(thr)
    if state.device.type == "cpu":
        return fused_suspicion_plain(state, timer, alive, thr, row0)
    _cuda.require(state.device.type == "cuda", f"unsupported device {state.device}")
    lib = _cuda.library("fused_suspicion", kb_fused_suspicion=_ARGTYPES)
    dev = state.device
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    jstar = torch.empty((b,), dtype=torch.int32, device=dev)
    flags = torch.empty((3, b), dtype=torch.bool, device=dev)
    rc = lib.kb_fused_suspicion(
        state.data_ptr(), timer.data_ptr(), timer.element_size(), alive.data_ptr(), thr,
        count.data_ptr(), jstar.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
        flags[2].data_ptr(), b, row0, n, _cuda.vec_ok(n, state, timer),
        _cuda.stream_handle(dev),
    )
    _cuda.check(lib, rc, "fused_suspicion")
    _cuda.launches["fused_suspicion"] += 1
    return count, jstar, flags[0], flags[1], flags[2]
