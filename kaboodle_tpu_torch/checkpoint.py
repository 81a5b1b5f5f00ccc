"""Checkpoint / resume of simulator state, in the JAX package's ``.npz`` schema.

A checkpoint is one ``.npz`` with one entry per ``MeshState`` field plus a
format version (``__version__``) and, optionally, a writer stamp
(``__owner__``). The entries are the JAX package's leaf layout
(``sim/state.py::state_to_numpy``): uint32 fields as uint32, the timer in
its own dtype (int16 timers stay int16), optional fields (``latency``,
``id_view``) absent when the state has none. So an archive written by
``kaboodle_tpu.checkpoint.save`` resumes here bit-identically, and one
written here resumes in the JAX package. Every array round-trips exactly,
the PRNG key included, so a resumed run is indistinguishable from an
uninterrupted one.

A fleet checkpoint (``save_fleet`` / ``load_fleet``) holds the stacked
``MeshState`` fields under ``mesh.``-prefixed names, the per-member
``drop_rate``, optionally the serve pool's per-lane ``generation``
counters, the version and a ``__fleet__`` marker: the JAX package's fleet
schema, in both directions too.

A sparse checkpoint (``save_sparse`` / ``load_sparse``) holds the
``SparseState`` planes under ``sparse.``-prefixed names -- ``seed`` and
``cursor`` as the JAX package's uint32 scalars -- the version and a
``__sparse__`` marker: the JAX package's sparse schema, in both directions.

Every failure to read an archive back -- missing, truncated, not a zip,
a corrupt member, a wrong version or owner, missing fields -- raises
:class:`~kaboodle_tpu_torch.errors.CheckpointError`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import zipfile

import numpy as np

import torch

from kaboodle_tpu_torch.errors import CheckpointError
from kaboodle_tpu_torch.sim.state import (
    MeshState,
    fleet_from_numpy,
    fleet_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

_FORMAT_VERSION = 1


def _optional_fields() -> set[str]:
    """MeshState fields that may be ``None`` (default-None dataclass fields)."""
    return {f.name for f in dataclasses.fields(MeshState) if f.default is None}


@contextlib.contextmanager
def _open_npz(path):
    """``np.load`` with the failure modes of a long-running service -- file
    missing, truncated mid-write, not a zip, a zip with a corrupt member --
    raised as :class:`CheckpointError`."""
    try:
        z = np.load(path)
    except FileNotFoundError as e:
        raise CheckpointError(f"checkpoint missing: {path}") from e
    except (zipfile.BadZipFile, OSError, EOFError, ValueError) as e:
        raise CheckpointError(f"checkpoint unreadable ({e}): {path}") from e
    try:
        with z:
            yield z
    except CheckpointError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, KeyError, ValueError) as e:
        # A member that decompresses short or fails its CRC surfaces here,
        # on the array read, not at open time.
        raise CheckpointError(f"checkpoint corrupt ({e}): {path}") from e


def _savez_atomic(path, arrays: dict) -> None:
    """fsync-then-rename npz write: a reader sees either the complete
    previous file or the complete new one, never a truncated archive."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path, state: MeshState, atomic: bool = False, owner: str | None = None) -> None:
    """Write ``state`` to ``path`` (.npz), fetching its tensors to the host.

    Fields that are ``None`` are absent from the archive. ``atomic=True``
    writes through a same-directory temp file with fsync-then-rename.
    ``owner`` stamps a writer identity into the archive, which
    ``load(expect_owner=...)`` enforces."""
    arrays = {name: a for name, a in state_to_numpy(state).items() if a is not None}
    arrays["__version__"] = np.int32(_FORMAT_VERSION)
    if owner is not None:
        arrays["__owner__"] = np.frombuffer(owner.encode("utf-8"), dtype=np.uint8)
    if atomic:
        _savez_atomic(path, arrays)
    else:
        np.savez(path, **arrays)


def checkpoint_owner(path) -> str | None:
    """The writer identity stamped by ``save(owner=...)``, or ``None``."""
    with _open_npz(path) as z:
        if "__owner__" not in z.files:
            return None
        return bytes(np.asarray(z["__owner__"])).decode("utf-8")


def load(path, expect_owner: str | None = None, device=None) -> MeshState:
    """Read a checkpoint onto the card, or onto ``device`` when given.

    Optional fields absent from the archive restore as ``None``.
    ``expect_owner`` enforces the writer stamp: a mismatching or missing
    stamp raises. Every failure raises :class:`CheckpointError`."""
    with _open_npz(path) as z:
        if "__version__" not in z.files:
            raise CheckpointError(f"not a kaboodle checkpoint (no version entry): {path}")
        version = int(z["__version__"])
        if version != _FORMAT_VERSION:
            raise CheckpointError(f"unsupported checkpoint version {version}")
        if expect_owner is not None:
            if "__owner__" not in z.files:
                raise CheckpointError(
                    f"checkpoint has no owner stamp (expected {expect_owner!r}): {path}"
                )
            got = bytes(np.asarray(z["__owner__"])).decode("utf-8")
            if got != expect_owner:
                raise CheckpointError(
                    f"checkpoint owned by alien engine {got!r} (expected "
                    f"{expect_owner!r}): {path}"
                )
        fields = {f.name for f in dataclasses.fields(MeshState)}
        missing = fields - set(z.files) - _optional_fields()
        if missing:
            raise CheckpointError(f"checkpoint missing fields: {sorted(missing)}")
        leaves = {name: z[name] for name in fields if name in z.files}
    return state_from_numpy(leaves, device=device)


def save_fleet(path, fleet, generation=None, atomic: bool = False) -> None:
    """Write a ``FleetState`` to ``path`` (.npz), fetching it to the host.

    One entry per stacked ``MeshState`` field (``mesh.`` prefixed), the
    per-member ``drop_rate`` and, when given, the per-lane ``generation``
    counters (int32), so a restored serve pool keeps its (lane, generation)
    names. Fields that are ``None`` are absent; ``atomic=True`` as in
    :func:`save`."""
    host = fleet_to_numpy(fleet)
    arrays = {"mesh." + name: a for name, a in host["mesh"].items() if a is not None}
    arrays["drop_rate"] = host["drop_rate"]
    if generation is not None:
        if isinstance(generation, torch.Tensor):
            generation = generation.detach().cpu().numpy()
        arrays["generation"] = np.asarray(generation, dtype=np.int32)
    arrays["__version__"] = np.int32(_FORMAT_VERSION)
    arrays["__fleet__"] = np.int32(1)
    if atomic:
        _savez_atomic(path, arrays)
    else:
        np.savez(path, **arrays)


def load_fleet(path, device=None):
    """Read a fleet checkpoint onto the card, or onto ``device`` when given.

    Returns ``(fleet, generation)``; ``generation`` (int32 ``[E]``) is
    ``None`` when the archive has no lane counters. Round-trips bit-exactly.
    Every failure raises :class:`CheckpointError`, a single-mesh archive
    included."""
    with _open_npz(path) as z:
        if "__version__" not in z.files:
            raise CheckpointError(f"not a kaboodle checkpoint (no version entry): {path}")
        version = int(z["__version__"])
        if version != _FORMAT_VERSION:
            raise CheckpointError(f"unsupported checkpoint version {version}")
        if "__fleet__" not in z.files:
            raise CheckpointError("not a fleet checkpoint (single-mesh? use checkpoint.load)")
        fields = {f.name for f in dataclasses.fields(MeshState)}
        present = {name[len("mesh."):] for name in z.files if name.startswith("mesh.")}
        missing = fields - present - _optional_fields()
        if missing:
            raise CheckpointError(f"checkpoint missing fields: {sorted(missing)}")
        if "drop_rate" not in z.files:
            raise CheckpointError("fleet checkpoint missing drop_rate")
        mesh = {name: z["mesh." + name] for name in fields & present}
        drop_rate = z["drop_rate"]
        generation = z["generation"] if "generation" in z.files else None
    fleet = fleet_from_numpy({"mesh": mesh, "drop_rate": drop_rate}, device=device)
    if generation is not None:
        generation = torch.as_tensor(np.array(generation), device=fleet.mesh.device)
    return fleet, generation


def save_sparse(path, state, atomic: bool = False) -> None:
    """Write a ``SparseState`` (blocked-sparse mesh) to ``path`` (.npz).

    One entry per plane (``sparse.`` prefixed), the counter-RNG ``(seed,
    cursor)`` pair included, so a restored mesh makes the draws an
    uninterrupted run would have made. The ``__sparse__`` marker keeps the
    three checkpoint families from cross-restoring; ``atomic=True`` as in
    :func:`save`."""
    from kaboodle_tpu_torch.sparseplane.state import sparse_state_to_numpy

    arrays = {"sparse." + name: a for name, a in sparse_state_to_numpy(state).items()}
    arrays["__version__"] = np.int32(_FORMAT_VERSION)
    arrays["__sparse__"] = np.int32(1)
    if atomic:
        _savez_atomic(path, arrays)
    else:
        np.savez(path, **arrays)


def load_sparse(path, device=None):
    """Read a sparse checkpoint onto the card, or onto ``device`` when given.

    Returns a ``SparseState``; round-trips bit-exactly. Every failure
    raises :class:`CheckpointError`, a dense or fleet archive included."""
    from kaboodle_tpu_torch.sparseplane.state import SparseState, sparse_state_from_numpy

    with _open_npz(path) as z:
        if "__version__" not in z.files:
            raise CheckpointError(f"not a kaboodle checkpoint (no version entry): {path}")
        version = int(z["__version__"])
        if version != _FORMAT_VERSION:
            raise CheckpointError(f"unsupported checkpoint version {version}")
        if "__sparse__" not in z.files:
            raise CheckpointError("not a sparse checkpoint (dense mesh? use checkpoint.load)")
        fields = {f.name for f in dataclasses.fields(SparseState)}
        present = {name[len("sparse."):] for name in z.files if name.startswith("sparse.")}
        missing = fields - present
        if missing:
            raise CheckpointError(f"checkpoint missing fields: {sorted(missing)}")
        leaves = {name: z["sparse." + name] for name in fields}
    return sparse_state_from_numpy(leaves, device=device)
