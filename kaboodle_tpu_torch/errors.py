"""Error types mirroring the reference's ``KaboodleError`` enum (errors.rs:8-24).

Python exceptions replace the Rust enum; variants map one-to-one. ``IoError``
wraps OS-level failures from the real transport (the simulator cannot produce
them), and the two interface errors only arise in the interop path
(networking.rs:12-23, 68-119). The port keeps its own copy of the JAX
package's classes, so an ``except`` over one package's names does not
catch the other's.
"""

from __future__ import annotations


class KaboodleError(Exception):
    """Base class for all framework errors (errors.rs:8)."""


class InvalidOperation(KaboodleError):
    """Operation not valid in the current lifecycle state — e.g. starting a
    running instance or stopping a stopped one (errors.rs:10-11)."""


class IoError(KaboodleError):
    """Wrapped OS/transport error (errors.rs:13-14)."""


class NoAvailableInterfaces(KaboodleError):
    """No usable non-loopback network interface (errors.rs:16-17)."""


class UnableToFindInterfaceNumber(KaboodleError):
    """Interface index lookup failed for IPv6 multicast join (errors.rs:19-20)."""


class StoppingFailed(KaboodleError):
    """The protocol loop did not acknowledge cancellation (errors.rs:22-23)."""


class ConvergenceTimeout(KaboodleError):
    """Simulator-specific (no reference equivalent): a bounded convergence
    drive ended without fingerprint agreement."""


class CheckpointError(KaboodleError):
    """A checkpoint file could not be read back as a kaboodle checkpoint —
    missing, truncated, not a zip/npz at all, wrong marker, or missing
    entries. Raised instead of the raw ``zipfile``/``KeyError``/``OSError``
    so callers (the serve restore path above all) can degrade a single
    request instead of tearing down the host loop."""
