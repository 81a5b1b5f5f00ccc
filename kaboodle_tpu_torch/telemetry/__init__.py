"""The telemetry plane of the tick: protocol counters and the flight recorder.

- **Counters** (:mod:`telemetry.counters`): the ``telemetry=True`` build of
  the tick (``phasegraph/exec.py``) returns a :class:`ProtocolCounters` of
  per-tick protocol reductions beside its metrics, as pure derived values:
  the state trajectory is bit-identical with telemetry on or off.
- **Flight recorder** (:mod:`telemetry.recorder`): a fixed-shape ring on
  the device holding the last K ticks' counters and per-member fingerprint
  digests, fetched to the host once by :func:`recorder_rows`.

- **Profiler labels and trace export** (:mod:`telemetry.trace`):
  ``host_span`` and ``op_scope``, ``kaboodle:`` ranges of
  ``torch.profiler.record_function``; the Chrome-trace writers of the
  tick timeline, the phase passes, the serve spans and the journal.

- **Run manifests** (:mod:`telemetry.manifest`): the JAX package's JSONL
  record schema (``kaboodle-telemetry/1``), writer, reader and validation;
  :mod:`telemetry.summary` summarizes, gates (``--check``), reports
  (``--serve-report``) and exports (``--trace``) them.
"""

from kaboodle_tpu_torch.telemetry.counters import (
    FIELDS,
    RECORD_BYTES,
    ProtocolCounters,
    TickTelemetry,
    add_counters,
    counters_table,
    counters_totals,
    leap_counters,
    scale_counters,
    zero_counters,
)
from kaboodle_tpu_torch.telemetry.recorder import (
    FlightRecorder,
    init_recorder,
    record_tick,
    recorder_rows,
)

__all__ = [
    "FIELDS",
    "RECORD_BYTES",
    "ProtocolCounters",
    "TickTelemetry",
    "add_counters",
    "counters_table",
    "counters_totals",
    "leap_counters",
    "scale_counters",
    "zero_counters",
    "FlightRecorder",
    "init_recorder",
    "record_tick",
    "recorder_rows",
]
