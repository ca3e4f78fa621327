"""Meshes for the training launcher (ported from ``repro.launch.mesh``).

The port has the data mesh alone (``core.distributed``).  The reference's
production meshes shard the parameters over a 2-D ("data", "model") mesh
(FSDP and tensor parallelism); in PyTorch that is DTensor work of its own,
ROADMAP queue 1's "2-D parameter mesh", and they raise until it lands.
"""
from __future__ import annotations

from repro_torch.core.distributed import DataMesh, make_data_mesh

PARAMETER_MESH = 'ROADMAP queue 1, "2-D parameter mesh"'


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16×16 (or 2×16×16) mesh: not ported, raises."""
    shape = "2×16×16 (pod, data, model)" if multi_pod else "16×16 (data, model)"
    raise NotImplementedError(
        f"the {shape} production mesh shards the parameters over a 2-D mesh, which "
        f"is not ported to the PyTorch package yet ({PARAMETER_MESH})")


def make_debug_mesh(n_data: int | None = None, n_model: int = 1, *,
                    device="cuda") -> DataMesh:
    """The data mesh: one rank, or the ranks of an initialised process group
    (e.g. ``torchrun``'s), ``n_data`` of them when given
    (``core.distributed.make_data_mesh``).  ``n_model > 1`` raises."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: a model axis shards the parameters, which is not "
            f"ported to the PyTorch package yet ({PARAMETER_MESH})")
    return make_data_mesh(n_data, device=device)
