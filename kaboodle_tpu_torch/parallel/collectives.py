"""The collectives of the row-sharded tick: what GSPMD inserts for the JAX package.

The JAX package shards the peer axis by placing every row-indexed array
with ``P('peers', ...)`` and letting XLA's partitioner insert the
collectives (``kaboodle_tpu/parallel/mesh.py``). The port has no
partitioner, so the tick names each cross-row read and routes it through
one of these helpers. A rank owns rows ``[r*N/R, (r+1)*N/R)`` of every
``[N, N]`` plane and ``[N]`` vector; ``[..., B, N]`` / ``[..., B]`` below
are those rows (``B = N/R``), behind any leading ensemble axis.

Every helper takes a ``ProcessGroup`` or ``None``. With ``None`` it is the
identity (or the plain dense operation), so the tick built with no group
is the dense tick, unchanged. With a group it exchanges, and it does so
whatever the group's size: a one-rank group still calls every collective
(the card runs one rank, and the path is the same).

- :func:`gather_rows`: all-gather ``[..., B, *]`` row blocks into ``[..., N, *]``;
- :func:`global_any`, :func:`member_any`: predicates over every rank's rows
  (all-reduce MAX), so that every rank takes the same branch;
- :func:`reduce_sum`, :func:`reduce_min`, :func:`reduce_max`: all-reduces;
- :func:`transpose`: the rank's rows of a plane's transpose (all-to-all of
  ``[B, B]`` blocks);
- :func:`ring_or_matmul`: ``(A @ M) > 0`` with ``M`` row-sharded, over a ring
  of ``M``'s row blocks;
- :func:`ring_take_rows`: whole rows of a row-sharded plane at global row
  indices, over the same ring;
- :func:`take_cells`: cells ``plane[s, d]`` at global ``(s, d)`` pairs;
- :func:`scatter_or_rows`: ``dst[rows, cols] |= val`` with every rank's
  updates, applied where they land in this rank's rows;
- :func:`scatter_min`: a scatter-min into an ``[N]`` vector from every rank.

Every rank must reach the same helpers in the same order: a helper inside
a branch that only some ranks take leaves the others waiting. The tick's
gates are all :func:`global_any` for that reason.

Every ``dist`` call of this module goes through :func:`_note` first: inside
:func:`record_collectives` each call is logged under HLO's name for its
kind (``all-gather``, ``all-reduce``, ``all-to-all``, and
``collective-permute`` for a ring step), with the bytes it carries on the
wire, for ``costscope/collectives.py``. Outside it nothing is logged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from kaboodle_tpu_torch.ops import hashing

INF = torch.iinfo(torch.int32).max


def size(group) -> int:
    """Ranks of ``group`` (1 with no group)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group`` (0 with no group)."""
    return 0 if group is None else dist.get_rank(group)


def row_range(n: int, group) -> tuple[int, int]:
    """``(row0, B)``: the first row and the row count this rank owns of ``n``."""
    r = size(group)
    if n % r:
        raise ValueError(f"N={n} not divisible by mesh size {r}")
    b = n // r
    return rank(group) * b, b


# What gloo and NCCL both reduce and move; anything else (bool, int16
# timers) travels as its bytes.
_WIRE_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64, torch.float32,
                torch.float64)


# The open logs of record_collectives (innermost last).
_logs: list[list] = []


@contextlib.contextmanager
def record_collectives():
    """Log every collective this module makes while open: yields a list
    that gets one dict a call, ``{"kind", "group_size", "result_bytes",
    "sent_bytes"}`` (``sent_bytes``: the bytes of the send splits that go
    to other ranks, for the two all-to-all kinds; None for the others)."""
    log: list = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _note(kind: str, group, result_bytes: int, sent_bytes: int | None = None) -> None:
    if _logs:
        row = {"kind": kind, "group_size": size(group), "result_bytes": int(result_bytes),
               "sent_bytes": None if sent_bytes is None else int(sent_bytes)}
        for log in _logs:
            log.append(row)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor a collective carries, contiguous: bool and int16 as their
    bytes (uint8; an int16 row's last dim doubles, each value's two bytes
    adjacent, so a gather or a row split keeps every value whole)."""
    x = x.contiguous()
    return x if x.dtype in _WIRE_DTYPES else x.view(torch.uint8)


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype in _WIRE_DTYPES else x.view(dtype)


def gather_rows(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather the rank's row block along ``dim`` into the whole axis."""
    if group is None:
        return x
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(size(group))]
    _note("all-gather", group, _nbytes(w) * len(parts))
    dist.all_gather(parts, w, group=group)
    return _unwire(torch.cat(parts, dim=dim), x.dtype)


def gather_many(xs, group, nb: int = 0) -> list[torch.Tensor]:
    """:func:`gather_rows` of several row-indexed tensors in one collective.

    Each ``x`` is ``[*batch, B]`` or ``[*batch, B, k]`` (``nb`` batch dims)
    of an integer or bool dtype; they travel as one int32 ``[*batch, B, m]``
    block and come back ``[*batch, N]`` / ``[*batch, N, k]`` in their own
    dtypes."""
    if group is None:
        return list(xs)
    cols = [x.unsqueeze(-1) if x.dim() == nb + 1 else x for x in xs]
    widths = [c.shape[-1] for c in cols]
    block = torch.cat([c.to(torch.int32) for c in cols], dim=-1)
    full = gather_rows(block, group, dim=-2)
    out, at = [], 0
    for x, w in zip(xs, widths):
        part = full[..., at:at + w]
        at += w
        if x.dim() == nb + 1:
            part = part[..., 0]
        out.append(part.to(x.dtype))
    return out


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    w = _wire(x.clone())
    _note("all-reduce", group, _nbytes(w))
    dist.all_reduce(w, op=op, group=group)
    return _unwire(w, x.dtype)


def global_any(x: torch.Tensor, group) -> torch.Tensor:
    """``x.any()`` over every rank's rows: a 0-d bool tensor, equal on all ranks."""
    local = x.any()
    if group is None:
        return local
    return _all_reduce(local.to(torch.int32).view(1), group, dist.ReduceOp.MAX)[0] > 0


def member_any(x: torch.Tensor, group, nb: int) -> torch.Tensor:
    """``x.any()`` per member over every rank's rows (``[*batch]`` bool)."""
    local = x.flatten(nb).any(dim=-1)
    if group is None:
        return local
    return _all_reduce(local.to(torch.int32), group, dist.ReduceOp.MAX) > 0


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.SUM)


def reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MIN)


def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def reduce_sum_many(xs, group) -> list[torch.Tensor]:
    """:func:`reduce_sum` of several integer tensors in one all-reduce (int64
    on the wire, each back in its own dtype and shape)."""
    if group is None:
        return list(xs)
    flat = torch.cat([x.reshape(-1).to(torch.int64) for x in xs])
    flat = _all_reduce(flat, group, dist.ReduceOp.SUM)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
        at += x.numel()
    return out


def fingerprint_agreement(alive: torch.Tensor, fp: torch.Tensor, group):
    """``ops.hashing.fingerprint_agreement`` over every rank's rows.

    The minimum and maximum are of the unsigned words, widened to int64
    before the all-reduce so that the order is the unsigned one."""
    if group is None:
        return hashing.fingerprint_agreement(alive, fp)
    u = hashing.as_u32(fp)
    fp_min = reduce_min(torch.where(alive, u, hashing.MASK32).amin(dim=-1), group)
    fp_max = reduce_max(torch.where(alive, u, 0).amax(dim=-1), group)
    n_alive = reduce_sum(alive.sum(dim=-1, dtype=torch.int32), group)
    converged = (fp_min == fp_max) & (n_alive > 0)
    return converged, hashing.wrap32(fp_min), hashing.wrap32(fp_max), n_alive


def transpose(plane: torch.Tensor, group) -> torch.Tensor:
    """The rank's rows of the transpose of a row-sharded ``[..., N, N]`` plane.

    ``plane`` is ``[*batch, B, N]``. Rank i sends rank j the ``[B, B]``
    block of its rows at j's columns (one all-to-all); j transposes each
    block it receives into its rows at i's columns. No group: the plane's
    own transpose."""
    if group is None:
        return plane.transpose(-1, -2)
    r = size(group)
    *batch, b, n = plane.shape
    w = _wire(plane)
    send = w.view(*batch, b, r, b).movedim(-2, 0).contiguous()  # [R, *batch, B, B]
    recv = torch.empty_like(send)
    _note("all-to-all", group, _nbytes(send), _nbytes(send) - _nbytes(send[rank(group)]))
    dist.all_to_all_single(recv, send, group=group)
    # recv[i][.., a, c] = M[row0_i + a, row0_r + c] = M^T[row0_r + c, row0_i + a]
    out = recv.movedim(0, -2).transpose(-1, -3)  # [*batch, c, i, a]
    return _unwire(out.reshape(*batch, b, n), plane.dtype)


def ring(block: torch.Tensor, group):
    """Yield ``(owner, owner's block)`` for every rank's ``block`` (any
    shape), passing the blocks one step around the ring between yields
    (each step an all-to-all that sends the whole block to the next rank
    and receives the previous one's). The caller must consume every step
    on every rank."""
    if group is None:
        yield 0, block
        return
    r, me = size(group), rank(group)
    cur = _wire(block)
    for step in range(r):
        yield (me - step) % r, _unwire(cur, block.dtype)
        if step < r - 1:
            nxt = torch.empty_like(cur)
            rows = cur.shape[0]
            send_split = [rows if j == (me + 1) % r else 0 for j in range(r)]
            recv_split = [rows if j == (me - 1) % r else 0 for j in range(r)]
            _note("collective-permute", group, _nbytes(cur), _nbytes(cur))
            dist.all_to_all_single(nxt, cur, recv_split, send_split, group=group)
            cur = nxt


def ring_or_matmul(a: torch.Tensor, m: torch.Tensor, group, matmul) -> torch.Tensor:
    """``(a @ M) > 0`` where ``a`` is ``[*batch, B, N]`` (the rank's rows,
    all of the contraction axis) and ``M`` is row-sharded (``m`` its
    ``[*batch, B, N]`` rows). ``matmul`` is the boolean OR-matmul of two
    operands; an OR of ``> 0`` over the row blocks of ``M`` is ``> 0`` of
    the whole sum, so the result is bit-exact. No group: ``matmul(a, m)``."""
    if group is None:
        return matmul(a, m)
    b = m.shape[-2]
    acc = None
    for owner, blk in ring(m, group):
        part = matmul(a[..., owner * b:(owner + 1) * b], blk)
        acc = part if acc is None else acc | part
    return acc


def ring_take_rows(plane: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """``[*batch, B, N]`` rows of a row-sharded plane at global row indices
    ``idx`` (``[*batch, B]``; -1 gives a row of zeros), over the ring."""
    from kaboodle_tpu_torch.phasegraph.exec import _take_rows

    if group is None:
        return _take_rows(plane, idx)
    b = plane.shape[-2]
    out = torch.zeros_like(plane)
    for owner, blk in ring(plane, group):
        local = idx.long() - owner * b
        sel = (local >= 0) & (local < b)
        out = torch.where(sel[..., None], _take_rows(blk, local.clamp(0, b - 1)), out)
    return out


def take_cells(plane: torch.Tensor, s: torch.Tensor, d: torch.Tensor, group, nb: int = 0):
    """``plane[s, d]`` of a row-sharded bool plane at global row indices
    ``s`` and columns ``d`` (``[*batch, B, k]`` each, this rank's queries;
    -1 safe, clipped). Every rank's queries are gathered, each rank answers
    those whose row it owns, and an all-reduce MAX brings every answer home."""
    from kaboodle_tpu_torch.phasegraph.exec import _take_cell

    if group is None:
        return _take_cell(plane, s, d)
    b = plane.shape[-2]
    row0 = rank(group) * b
    sg, dg = gather_many([s, d], group, nb)
    local = sg.long() - row0
    mine = (local >= 0) & (local < b)
    ans = _take_cell(plane, local.clamp(0, b - 1), dg) & mine
    ans = reduce_max(ans.to(torch.int32), group)
    return ans[..., row0:row0 + b, :] > 0


def scatter_or_rows(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                    val: torch.Tensor, group, nb: int = 0) -> torch.Tensor:
    """``dst[rows, cols] |= val`` per member, where the updates come from every
    rank's rows: ``rows``/``cols``/``val`` are this rank's ``[*batch, B, k]``
    (``rows`` may broadcast) and ``rows`` are global. Updates are filtered on
    ``val`` first, then kept where their row is this rank's: a ``-1`` index
    that the dense scatter clips to row 0 never reaches rank 0 here."""
    from kaboodle_tpu_torch.phasegraph.exec import _scatter_or

    if group is None:
        return _scatter_or(dst, rows, cols, val)
    b = dst.shape[-2]
    row0 = rank(group) * b
    rows = rows.expand(val.shape)
    rg, cg, vg = gather_many([rows, cols.expand(val.shape), val], group, nb)
    local = rg.long() - row0
    keep = vg & (local >= 0) & (local < b)
    return _scatter_or(dst, local.clamp(0, b - 1), cg, keep)


def scatter_min(n: int, idx: torch.Tensor, val: torch.Tensor, group) -> torch.Tensor:
    """An ``[*batch, N]`` int32 vector at INF scatter-min'ed by every rank's
    ``(idx, val)`` pairs (``[*batch, M]``, -1 indices clipped as the dense
    tick clips them), returned as this rank's ``[*batch, B]`` slice."""
    batch = tuple(idx.shape[:-1])
    full = torch.full((*batch, n), INF, dtype=torch.int32, device=idx.device).scatter_reduce(
        -1, idx.clamp(min=0).long(), val, reduce="amin", include_self=True,
    )
    if group is None:
        return full
    full = reduce_min(full, group)
    row0, b = row_range(n, group)
    return full[..., row0:row0 + b]
