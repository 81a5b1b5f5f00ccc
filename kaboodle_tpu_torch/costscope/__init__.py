"""costscope -- the cost observatory of the port.

The port of ``kaboodle_tpu/costscope/``. Four planes, all riding the
entry-point registry (``analysis/ir/registry.py``), so every engine the
port dispatches is covered:

- static cost plane (``extract``): per-entry flops, bytes accessed and
  argument / output / temp / peak bytes, counted by dispatch on the CPU
  path and gated against the committed ``costscope/baseline.json`` with
  graftlint-style shrink-only semantics (``baseline``);
- collective-bytes audit (``collectives``): the bytes each entry sends to
  other ranks, per call and per collective, logged by
  ``parallel/collectives.py``;
- roofline report (``roofline``): each entry against the NVIDIA H100's
  HBM and link floors, and the per-tick walls a ``--walls`` file gives;
- collective microbench (``icibench``): the two collectives the
  row-sharded tick pays (the fingerprint-agreement all-reduce and the
  gossip union's ring), timed standalone.

The gate and the report need no card: the static plane is defined on the
CPU path. ``python -m kaboodle_tpu_torch costscope --help`` lists the
modes (``cli.py``).
"""

from kaboodle_tpu_torch.costscope.baseline import (  # noqa: F401
    DEFAULT_BASELINE,
    gate_measurements,
    load_baseline,
    write_baseline,
)
from kaboodle_tpu_torch.costscope.collectives import collective_audit  # noqa: F401
from kaboodle_tpu_torch.costscope.extract import (  # noqa: F401
    cost_record,
    extract_entries,
)
