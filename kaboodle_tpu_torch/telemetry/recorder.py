"""Flight recorder: a fixed-shape ring of the last K ticks, on the device.

Every recorded tick writes one slot (counters + convergence digest + the
per-member fingerprint vector) at ``head % K``. The slot index is computed
on the device and the write is an in-place ``index_copy_`` into the ring's
own buffers: the ring is an observer, not part of the state trajectory, so
writing it in place changes no tensor a tick reads, and recording costs no
host sync. :func:`recorder_rows` fetches the ring to the host once and
returns the last K ticks' protocol counters and per-member fingerprint
digests in chronological order -- what the tail of a run was doing, without
rerunning it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kaboodle_tpu_torch.sim.state import resolve_device
from kaboodle_tpu_torch.telemetry.counters import (
    FIELDS,
    ProtocolCounters,
    TickTelemetry,
    counters_table,
)


@dataclasses.dataclass
class FlightRecorder:
    """Ring of the last K recorded ticks (module docstring).

    ``head`` counts records ever written; slot ``head % K`` is written
    next. ``tick`` holds the simulated tick index per slot (-1 = empty).
    uint32 words (``fp_min``, ``fp_max``, ``fp``, ``gossip_bytes``) are
    int32 tensors holding their bits."""

    tick: torch.Tensor  # int32 [K], -1 where never written
    converged: torch.Tensor  # bool [K]
    fp_min: torch.Tensor  # int32 bits of uint32 [K]
    fp_max: torch.Tensor  # int32 bits of uint32 [K]
    counters: ProtocolCounters  # int32 leaves [K]
    fp: torch.Tensor  # int32 bits of uint32 [K, N] per-member digests
    head: torch.Tensor  # int32 []

    @property
    def capacity(self) -> int:
        return self.tick.shape[0]


def init_recorder(k: int, n: int, device=None) -> FlightRecorder:
    """Empty K-slot recorder for an N-peer mesh, on the card unless
    ``device`` names another."""
    if k < 1:
        raise ValueError("need recorder capacity k >= 1")
    dev = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return FlightRecorder(
        tick=torch.full((k,), -1, dtype=torch.int32, device=dev),
        converged=z(k, dtype=torch.bool),
        fp_min=z(k),
        fp_max=z(k),
        counters=ProtocolCounters(**{f: z(k) for f in FIELDS}),
        fp=z(k, n),
        head=z(),
    )


def record_tick(rec: FlightRecorder, tick, out: TickTelemetry) -> FlightRecorder:
    """Write one tick's telemetry into the ring, in place; returns ``rec``.

    ``tick`` is the simulated tick index (a 0-d tensor or an int)."""
    slot = (rec.head.to(torch.int64) % rec.capacity).reshape(1)

    def put(buf, val):
        val = torch.as_tensor(val, device=buf.device).to(buf.dtype)
        buf.index_copy_(0, slot, val.reshape((1,) + tuple(buf.shape[1:])))

    put(rec.tick, tick)
    put(rec.converged, out.metrics.converged)
    put(rec.fp_min, out.metrics.fingerprint_min)
    put(rec.fp_max, out.metrics.fingerprint_max)
    for f in FIELDS:
        put(getattr(rec.counters, f), getattr(out.counters, f))
    put(rec.fp, out.fp)
    rec.head.add_(1)
    return rec


def recorder_rows(rec: FlightRecorder) -> dict:
    """ONE host fetch: the ring's valid slots in chronological order.

    Returns ``{"table": structured ndarray (tick, counters..., converged,
    fp_min, fp_max), "fp": uint32 [rows, N]}`` -- oldest first, at most K
    rows (fewer when the run was shorter than the ring); the JAX package's
    layout, uint32 words as uint32."""
    k = rec.capacity
    cols = [rec.tick, rec.converged, rec.fp_min, rec.fp_max]
    cols += [getattr(rec.counters, f) for f in FIELDS]
    cols += [rec.head.reshape(1).expand(k)]
    packed = torch.cat([torch.stack([c.to(torch.int32) for c in cols], dim=1), rec.fp], dim=1)
    host = packed.cpu().numpy()  # the one fetch: [K, 5 + len(FIELDS) + N] int32
    head = int(host[0, 4 + len(FIELDS)])
    rows = min(head, k)
    order = [(head - rows + i) % k for i in range(rows)]
    h = host[order]
    counters = ProtocolCounters(**{f: h[:, 4 + i] for i, f in enumerate(FIELDS)})
    table = counters_table(counters)
    merged = np.zeros(
        rows,
        dtype=table.dtype.descr
        + [("converged", bool), ("fp_min", np.uint32), ("fp_max", np.uint32)],
    )
    for name in FIELDS:
        merged[name] = table[name]
    merged["tick"] = h[:, 0]
    merged["converged"] = h[:, 1].astype(bool)
    merged["fp_min"] = h[:, 2].view(np.uint32)
    merged["fp_max"] = h[:, 3].view(np.uint32)
    return {"table": merged, "fp": np.ascontiguousarray(h[:, 5 + len(FIELDS):]).view(np.uint32)}
