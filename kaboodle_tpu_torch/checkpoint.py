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

A row-sharded state (``parallel/``) saves through the same schema:
``save(mesh=)`` gathers every rank's rows and rank 0 writes the archive,
and ``load(mesh=)`` keeps each rank's rows of any archive, the JAX
package's included. ``save_async`` / ``load_orbax`` keep the JAX
package's names for the background save, but the format is
``torch.distributed.checkpoint``'s (DCP), not orbax's (a JAX library):
each rank writes its rows as the local shard of a ``Shard(0)`` DTensor,
and a load onto a mesh of another size reshards.

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


def save(path, state: MeshState, atomic: bool = False, owner: str | None = None,
         mesh=None) -> None:
    """Write ``state`` to ``path`` (.npz), fetching its tensors to the host.

    Fields that are ``None`` are absent from the archive. ``atomic=True``
    writes through a same-directory temp file with fsync-then-rename.
    ``owner`` stamps a writer identity into the archive, which
    ``load(expect_owner=...)`` enforces. With ``mesh``, ``state`` is the
    rank's rows: every rank must call this; the rows are gathered and rank
    0 writes the whole state in the same schema."""
    if mesh is not None:
        import torch.distributed as dist

        from kaboodle_tpu_torch.parallel.mesh import gather_state

        state = gather_state(state, mesh)
        if dist.get_rank() != 0:
            return
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


def load(path, expect_owner: str | None = None, device=None, mesh=None) -> MeshState:
    """Read a checkpoint onto the card, or onto ``device`` when given.

    Optional fields absent from the archive restore as ``None``.
    ``expect_owner`` enforces the writer stamp: a mismatching or missing
    stamp raises. Every failure raises :class:`CheckpointError`. With
    ``mesh``, each rank keeps its rows (``parallel.shard_state``'s layout)
    on its own device; only those rows leave the host."""
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
    if mesh is not None:
        from kaboodle_tpu_torch.parallel.mesh import shard_state

        return shard_state(state_from_numpy(leaves, device="cpu"), mesh)
    return state_from_numpy(leaves, device=device)


# The process group each mesh's background saves coordinate over: one of
# their own, so that a save's collectives, run on a background thread,
# never interleave with the tick's on the mesh's group.
_CKPT_GROUPS: dict = {}


def _dcp_group(mesh):
    import torch.distributed as dist

    key = id(mesh)
    if key not in _CKPT_GROUPS:
        _CKPT_GROUPS[key] = dist.new_group(backend="gloo")
    return _CKPT_GROUPS[key]


def _dcp_state_dict(state: MeshState, mesh, copy: bool) -> dict:
    """DCP's view of a state: with ``mesh`` each row-sharded leaf is the
    rank's rows as the local shard of a ``Shard(0)`` DTensor (a container
    only: no op runs on it), ``tick`` and ``key`` plain replicated tensors.
    ``copy`` gives every leaf storage of its own (the save's stager copies
    whole storages and refuses a rank's rows viewed into a larger one);
    a load fills the state's own tensors in place."""
    from torch.distributed.tensor import DTensor

    from kaboodle_tpu_torch.parallel.mesh import state_specs

    specs = state_specs(state)
    out = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if x is None:
            continue
        spec = getattr(specs, f.name)
        if copy:
            x = x.clone(memory_format=torch.contiguous_format)
        if mesh is not None and spec[0].is_shard():
            out[f.name] = DTensor.from_local(x.contiguous(), device_mesh=mesh,
                                             placements=spec, run_check=False)
        else:
            out[f.name] = x
    return out


class AsyncSave:
    """A background save in flight (``save_async``'s handle)."""

    def __init__(self, future):
        self._future = future

    def wait_until_finished(self) -> None:
        """Join the write: the checkpoint is complete on return (raises the
        save's error, if it failed)."""
        self._future.result()


def save_async(path, state: MeshState, mesh=None) -> AsyncSave:
    """Checkpoint ``state`` in the background with ``torch.distributed.checkpoint``.

    The tensors are staged to the host before this returns, so the tick
    loop may run on meanwhile; ``wait_until_finished()`` on the returned
    handle joins the write (do so before reading it back). With ``mesh``,
    ``state`` is the rank's rows and every rank must call this: each writes
    its rows, coordinated over a gloo group of the checkpoint's own. The
    format is DCP's (a directory), read back by :func:`load_orbax`."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    sd = _dcp_state_dict(state, mesh, copy=True)
    if mesh is None and not dist.is_initialized():
        fut = dcp.async_save(sd, checkpoint_id=os.fspath(path), no_dist=True)
    else:
        fut = dcp.async_save(sd, checkpoint_id=os.fspath(path), process_group=_dcp_group(mesh))
    return AsyncSave(fut)


def load_orbax(path, template: MeshState, mesh=None, device=None) -> MeshState:
    """Restore a checkpoint written by :func:`save_async`.

    ``template`` gives the fields, whole shapes and dtypes -- a fresh
    ``init_state`` with the same options works, on the ``meta`` device too
    (only shapes and dtypes are read). With ``mesh`` each rank restores its
    rows straight into its row-sharded layout (the ``shard_state``
    placement), whatever the mesh size of the save: DCP reshards. Without,
    the whole state onto ``device`` (the card unless it names another)."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from kaboodle_tpu_torch.parallel import collectives as C
    from kaboodle_tpu_torch.sim.state import resolve_device

    if mesh is not None:
        from kaboodle_tpu_torch.parallel.mesh import mesh_device, peer_group, state_specs

        dev = mesh_device(mesh)
        _, rows = C.row_range(template.n, peer_group(mesh))
        specs = state_specs(template)
    else:
        dev = resolve_device(device)
    empty = {}
    for f in dataclasses.fields(template):
        x = getattr(template, f.name)
        if x is None:
            empty[f.name] = None
            continue
        shape = list(x.shape)
        if mesh is not None and getattr(specs, f.name)[0].is_shard():
            shape[0] = rows
        empty[f.name] = torch.empty(shape, dtype=x.dtype, device=dev)
    local = MeshState(**empty)
    sd = _dcp_state_dict(local, mesh, copy=False)
    if mesh is None and not dist.is_initialized():
        dcp.load(sd, checkpoint_id=os.fspath(path), no_dist=True)
    else:
        dcp.load(sd, checkpoint_id=os.fspath(path), process_group=_dcp_group(mesh))
    return local


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
