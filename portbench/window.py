"""One run of one cell: set-up, the measured window, and what the window produced.

Set-up makes the mix's inputs from the seed, the start mesh (a fresh one,
or one booted to agreement) and runs the mix's warm-up ticks or runs, so
every shape the window uses has been launched once. The window then steps
whole units (ticks, or boot runs) until ``seconds`` have passed on the host
clock at a unit boundary. After each unit a CUDA event is recorded: the
device timeline gives every tick's duration with no synchronize added; the
window ends in one synchronize. With ``trace``, ``torch.profiler`` covers
the first ``trace_units`` units of the window, each inside a
``record_function("portbench.unit")`` range.

Each unit's outputs are kept for the comparison with the reference: every
tick's metrics (device scalars, fetched once after the window), a summary
of every finished run's final mesh (``summary``), the boot behind a
converged start, and the mesh at the window's end.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import traffic as traffic_mod
from portbench.program import fields

INT_METRICS = ("messages_delivered", "converged", "fingerprint_min", "fingerprint_max")
FLOAT_METRICS = ("agree_fraction", "mean_membership")


def summary(st) -> dict:
    """A small record of a mesh that the reference's can be held to: every
    ``[N]`` vector whole, each integer plane's 64-bit wrapped sum of its
    bytes read as int64 words, the latency plane's NaN count and float64
    sum of the rest (equal planes give equal records)."""
    out = {}
    for name, x in fields(st).items():
        if x.dim() < 2:
            out[name] = x.clone()
        elif x.is_floating_point():
            nan = torch.isnan(x)
            out[name + ".nan"] = nan.sum()
            out[name + ".sum"] = torch.where(nan, 0, x).sum(dtype=torch.float64)
        else:
            c = x.contiguous().reshape(-1)
            if (c.numel() * c.element_size()) % 8 == 0:
                out[name] = c.view(torch.int64).sum()
            else:
                out[name] = c.to(torch.int64).sum()
    return out


def to_host(d: dict) -> dict:
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


def metrics_host(rows: list) -> dict:
    """Per-tick metrics (dataclasses of device scalars) -> field -> host tensor [T]."""
    if not rows:
        return {}
    names = INT_METRICS + FLOAT_METRICS
    return {k: torch.stack([getattr(m, k).reshape(()) for m in rows]).cpu() for k in names}


@dataclasses.dataclass
class Produced:
    """What one side (the program, or the control in its place) produced."""

    mode: str  # "tick" or "run"
    boot: dict | None = None  # the converged start's boot: ticks, conv, m0, summary
    tick_pos: list = dataclasses.field(default_factory=list)  # (run, i) of each tick
    tick_metrics: dict = dataclasses.field(default_factory=dict)
    runs: list = dataclasses.field(default_factory=list)  # finished runs' records
    end_state: object = None  # the mesh at the window's end
    end_index: int = 0  # ticks of its run behind it (tick mode)


class Session:
    """Set-up and window of one cell on one side (``adapter``)."""

    def __init__(self, cell, seed: int, adapter, device, trace: bool = False, counter=None):
        self.cell, self.seed, self.adapter = cell, seed, adapter
        self.counter = counter  # (reset, read) of the program's launch counter, or None
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.trace = trace
        self.mode = "run" if self.traffic.get("until_converged") else "tick"
        self.sched = traffic_mod.schedule(self.traffic, cell.config["n"], seed)
        self.out = Produced(mode=self.mode)
        self._metric_rows = []
        self._state = None
        self._start = None
        self._run, self._i = 0, 0
        self.exhausted = False
        self.prof = None
        self.trace_pos = []
        self.window_from = (0, 0)
        self.launches = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- set-up -------------------------------------------------------------
    def setup(self) -> None:
        if self.sched is not None:
            self.inputs = self.adapter.inputs(self.sched)
        if self.traffic["start"] == "converged":
            st, ticks, conv, m0 = self.adapter.boot(self.adapter.fresh(self.seed))
            self.out.boot = {"ticks": ticks, "converged": conv, "summary": summary(st),
                             "m0": None if m0 is None else fields(m0)}
            self._start = st
        for _ in range(int(self.traffic.get("warm_ticks", 0))):
            self.step()
        for _ in range(int(self.traffic.get("warm_runs", 0))):
            self.step()
        self._sync()

    # ---- units --------------------------------------------------------------
    def step(self) -> None:
        """One unit: a tick of the current run, or a whole boot run."""
        if self.mode == "run":
            self.out.end_state = None  # the last boot's mesh is not held through the next
            st, ticks, conv, m0 = self.adapter.boot(self.adapter.fresh(self.seed))
            self.out.runs.append({"run": self._run, "ticks": ticks, "converged": conv,
                                  "m0": None if m0 is None else fields(m0),
                                  "summary": summary(st)})
            self.out.end_state = st
            self._run += 1
            return
        if self._state is None:
            self.out.end_state = None  # the last run's mesh is not held through this one
            self._state = self._start if self._start is not None else self.adapter.fresh(self.seed)
            if not self.traffic.get("repeat", True):
                self._start = None  # a run that is not repeated frees its start
        st, m = self.adapter.tick(self._state, self.inputs, self._i)
        self._metric_rows.append(m)
        self.out.tick_pos.append((self._run, self._i))
        self._i += 1
        self._state = st
        self.out.end_state, self.out.end_index = st, self._i
        if self._i == self.sched.ticks:
            self.out.runs.append({"run": self._run, "summary": summary(st)})
            self._run, self._i, self._state = self._run + 1, 0, None
            if not self.traffic.get("repeat", True):
                self.exhausted = True

    # ---- the window -----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Step whole units for ``seconds``; returns the window's timings."""
        cuda = self.device.type == "cuda"
        self._sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        events = []

        def mark():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

        trace_units = int(self.traffic.get("trace_units", 1)) if self.trace else 0
        if trace_units:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            self.prof = profile(activities=acts)
            if self.counter:
                self.counter[0]()
            self.prof.start()
        self.window_from = (len(self.out.tick_pos), len(self.out.runs))
        units = 0
        t0 = time.perf_counter()
        mark()
        while True:
            if units < trace_units:
                self.trace_pos.append((self._run, self._i))
                with record_function("portbench.unit"):
                    self.step()
                if units + 1 == trace_units:
                    self._stop_trace()
            else:
                self.step()
            mark()
            units += 1
            if self.exhausted or time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        if trace_units and units < trace_units:
            self._stop_trace()
        unit_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])] if cuda else []
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        return {"units": units, "window_s": t1 - t0, "unit_ms": unit_ms, "peak_bytes": peak,
                "trace_pos": self.trace_pos, "launches": self.launches}

    def _stop_trace(self) -> None:
        self._sync()
        self.prof.stop()
        if self.counter:
            self.launches = self.counter[1]()

    def finish(self) -> Produced:
        """Fetch the kept outputs to the host; keep only the window-end mesh."""
        self.out.tick_metrics = metrics_host(self._metric_rows)
        self._metric_rows = []
        for r in self.out.runs:
            r["summary"] = to_host(r["summary"])
            if r.get("m0") is not None:
                r["m0"] = to_host(r["m0"])
        if self.out.boot is not None:
            self.out.boot["summary"] = to_host(self.out.boot["summary"])
            if self.out.boot["m0"] is not None:
                self.out.boot["m0"] = to_host(self.out.boot["m0"])
        self._state = self._start = None
        self.inputs = None
        return self.out
