"""Reading a traced stretch of the window: device intervals, launches, host ops.

``torch.profiler``'s raw Kineto events are read once, and only what the
per-layer readers need is kept (no trace file is written):

- device operations (kernels, memcpys, memsets; GPU-side annotations left
  out) with their start, duration and launch correlation id;
- the host runtime calls that launched them, which place each device
  operation inside the unit (``record_function("portbench.unit")``) and the
  host op (such as ``aten::_int_mm``) that launched it;
- the host ops of the thread that drove the units, which name what the
  host was doing in each idle gap of the device.

The traced window runs from the start of the first traced unit on the host
to the later of the last unit's end and the last device operation's end.
``busy_s`` is the union of the device intervals inside it.
"""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns
    dur: int  # ns
    corr: int


@dataclasses.dataclass
class Trace:
    units: list  # (start, end) ns of each traced unit on the host, in order
    device_ops: list  # DeviceOp
    launch_at: dict  # correlation id -> host ns of the launching runtime call
    host_ops: list  # (start, end, name) of the driving thread's ops, sorted by start
    window: tuple  # (start, end) ns

    def __post_init__(self):
        self.unit_starts = [u[0] for u in self.units]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def device_total_s(self) -> float:
        return sum(op.dur for op in self.device_ops) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(op.start, w0), min(op.start + op.dur, w1)) for op in self.device_ops)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def unit_of(self, op: DeviceOp) -> int | None:
        """The traced unit whose host range launched ``op``."""
        at = self.launch_at.get(op.corr)
        if at is None:
            return None
        k = bisect.bisect_right(self.unit_starts, at) - 1
        return k if k >= 0 and at <= self.units[k][1] else None

    def time_under(self, host_op: str) -> float:
        """Device seconds of the operations launched inside host op ``host_op``."""
        spans = sorted((s, e) for s, e, name in self.host_ops if name == host_op)
        starts = [s for s, _ in spans]
        total = 0
        for op in self.device_ops:
            at = self.launch_at.get(op.corr)
            if at is None:
                continue
            k = bisect.bisect_right(starts, at) - 1
            if k >= 0 and at <= spans[k][1]:
                total += op.dur
        return total * 1e-9

    def idle_gaps(self) -> list:
        """``(label, seconds)`` of every idle gap of the device in the window,
        labelled by the innermost host op open at its middle."""
        gaps, prev = [], self.window[0]
        for a, b in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
        out, stack, i = [], [], 0
        ops = self.host_ops
        for m, dur in mids:
            while i < len(ops) and ops[i][0] <= m:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            out.append((stack[-1][2] if stack else "host (no op)", dur * 1e-9))
        return out


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is handed: the traced stretch and what
    the harness knows of it."""

    trace: Trace
    unit: str  # "tick" or "run"
    config: dict
    alive: list  # alive rows at each traced unit (tick mode), from the mix
    launches: dict  # hand-kernel launches over the stretch, by the program's counter


def read(prof, unit_name: str = "portbench.unit") -> Trace:
    """A ``Trace`` from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    units, device_ops, launch_at, cpu = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name == unit_name:
                continue
            device_ops.append(DeviceOp(name, start, dur, e.correlation_id()))
            continue
        if name == unit_name:
            units.append((start, start + dur, e.start_thread_id()))
            continue
        if name.startswith("cuda") or name.startswith("cu"):
            launch_at[e.correlation_id()] = start
        cpu.append((start, start + dur, name, e.start_thread_id()))
    units.sort()
    tid = units[0][2] if units else None
    host_ops = sorted((s, t, n) for s, t, n, th in cpu if th == tid)
    w0 = units[0][0] if units else min((op.start for op in device_ops), default=0)
    w1 = max([u[1] for u in units] + [op.start + op.dur for op in device_ops] + [w0])
    return Trace(units=[(s, t) for s, t, _ in units], device_ops=device_ops,
                 launch_at=launch_at, host_ops=host_ops, window=(w0, w1))


def short_name(name: str, width: int = 160) -> str:
    """A device op's name cut to ``width`` characters (templated kernels run long)."""
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time, by name, and the idle time by what
    the host was doing, each as ``[name, seconds]``."""
    by_op, by_gap = {}, {}
    for op in tr.device_ops:
        k = short_name(op.name)
        by_op[k] = by_op.get(k, 0) + op.dur * 1e-9
    for label, s in tr.idle_gaps():
        k = short_name(label)
        by_gap[k] = by_gap.get(k, 0) + s
    return {"device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]]}
