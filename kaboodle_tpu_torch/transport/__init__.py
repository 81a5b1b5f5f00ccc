"""Real-network transport: wire-format interop with reference instances.

Three layers (all reference-faithful at the wire, SURVEY.md §2.3):

- :mod:`kaboodle_tpu_torch.transport.codec` — pure-Python bincode-compatible codec.
- :mod:`kaboodle_tpu_torch.transport.native` — ctypes bindings to the C++ engine
  (native/src): UDP broadcast/multicast transport + the real-time SWIM
  protocol loop in a background thread.
- :mod:`kaboodle_tpu_torch.transport.real` — the consumer facade + standalone probe.
"""

from kaboodle_tpu_torch.transport.real import RealKaboodle, discover_mesh_member

__all__ = ["RealKaboodle", "discover_mesh_member"]
