"""Fused membership fingerprint + count: a CUDA kernel and its plain version.

    fp[i]    = sum_{j : state[i,j] > 0} h(i, j)  (mod 2^32)
    count[i] = |{j : state[i,j] > 0}|

``h`` is the record hash of ``(j, id_view[i, j])`` (identity-view mode,
``identity`` ``[N, N]``) or the precomputed ``rec_hash[j]`` (hash mode,
``identity`` ``[N]``). The kernel (``csrc/fused_fp.cu``) replaces the
Pallas kernel ``kaboodle_tpu/ops/fused_fp.py::fused_fp_count`` (its two
``pallas_call`` sites, fused_fp.py:129 and :139); what bounds it and how
its design answers that is in the source's head comment.

The rows may be a rank's rows of a row-sharded mesh: ``state`` ``[B, N]``
with identity views ``[B, N]`` or the whole ``[N]`` record-hash vector (a
row's sum needs no row index). ``fused_fp_count`` takes the plain version
only for CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from kaboodle_tpu_torch.ops import _cuda
from kaboodle_tpu_torch.ops.hashing import peer_record_hash, wrap_sum

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_fp_count_plain(state: torch.Tensor, identity: torch.Tensor):
    """The plain PyTorch version: ``(fp int32 bits [B], count int32 [B])``
    of ``state`` ``[B, N]``.

    Also over a leading ensemble axis: ``state`` ``[E, B, N]`` with
    identity views ``[E, B, N]`` or record hashes ``[E, N]`` gives ``[E, B]``
    pairs (the kernel takes one mesh)."""
    member = state > 0
    n = state.shape[-1]
    if identity.shape == state.shape:
        pid = torch.arange(n, dtype=torch.int64, device=state.device)[None, :]
        h = peer_record_hash(pid, identity)
    else:
        h = identity[..., None, :]
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    fp = wrap_sum(torch.where(member, h, zero))
    return fp, member.sum(dim=-1, dtype=torch.int32)


@_cuda.cost_unit(_cuda.cell_flops)
def fused_fp_count(state: torch.Tensor, identity: torch.Tensor):
    """Row fingerprints + membership counts of ``state`` in one pass.

    ``state`` int8 ``[B, N]`` (a mesh's rows, ``B == N`` for all of it);
    ``identity`` int32 bits of the uint32 ``[B, N]`` identity views or of the
    ``[N]`` record hashes. Returns ``(fp int32 bits [B], count int32 [B])``."""
    n = state.shape[-1]
    b = state.shape[0]
    _cuda.require(state.dtype == torch.int8 and state.dim() == 2 and 0 < b <= n,
                  "state: int8 [B, N]")
    _cuda.require(identity.dtype == torch.int32 and identity.shape in ((b, n), (n,)),
                  "identity: int32 [B, N] or [N]")
    _cuda.require(identity.device == state.device, "state and identity on one device")
    _cuda.require(state.is_contiguous() and identity.is_contiguous(), "contiguous inputs")
    if state.device.type == "cpu":
        return fused_fp_count_plain(state, identity)
    _cuda.require(state.device.type == "cuda", f"unsupported device {state.device}")
    lib = _cuda.library("fused_fp", kb_fused_fp=_ARGTYPES)
    fp = torch.empty((b,), dtype=torch.int32, device=state.device)
    cnt = torch.empty((b,), dtype=torch.int32, device=state.device)
    idv = identity.dim() == 2
    rc = lib.kb_fused_fp(
        state.data_ptr(), identity.data_ptr(), fp.data_ptr(), cnt.data_ptr(),
        b, n, int(idv), _cuda.vec_ok(n, state, identity), _cuda.stream_handle(state.device),
    )
    _cuda.check(lib, rc, "fused_fp")
    _cuda.launches["fused_fp_idv" if idv else "fused_fp_hash"] += 1
    return fp, cnt
