"""Meshes for the training launcher (ported from ``repro.launch.mesh``).

Functions (not module-level constants), so importing this module never
touches the process group.  The production meshes are 2-D parameter meshes
(``sharding.Mesh``: FSDP over "data", tensor and expert parallelism over
"model"); the debug mesh is the data mesh (``core.distributed``) unless a
model axis is asked for.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import DataMesh, make_data_mesh
from repro_torch.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16×16 = 256 ranks per pod; multi_pod prepends a pod axis (2×16×16 = 512).

    Uses the first prod(shape) ranks of the initialised process group (e.g.
    ``torchrun``'s, one process a device), each computing on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have} — start {need} processes "
            "(one a device, e.g. under torchrun) and initialise their process group first")
    return make_mesh(shape, axes, device=device)


def make_debug_mesh(n_data: int | None = None, n_model: int = 1, *,
                    device="cuda") -> DataMesh | Mesh:
    """Tiny mesh over the ranks that exist (tests).  With ``n_model == 1``
    the data mesh: one rank, or the ranks of an initialised process group
    (e.g. ``torchrun``'s), ``n_data`` of them when given
    (``core.distributed.make_data_mesh``).  With ``n_model > 1`` the 2-D
    ("data", "model") mesh of ``n_data`` × ``n_model`` ranks of the
    initialised process group."""
    if n_model == 1:
        return make_data_mesh(n_data, device=device)
    n_data = 1 if n_data is None else n_data
    need = n_data * n_model
    have = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if have < need:
        raise RuntimeError(f"mesh ({n_data}, {n_model}) needs {need} ranks, found {have}")
    return make_mesh((n_data, n_model), ("data", "model"), device=device)
