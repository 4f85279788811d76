"""Meshes for the port's multi-device paths.

Counterpart of ``repro/launch/mesh.py``.  :func:`make_test_mesh` is the
reference's ``(data, model)`` test mesh over the initialised world;
:func:`production_mesh_shape` gives the reference's production shapes,
(data 16, model 16) and (pod 2, data 16, model 16), as abstract meshes:
the shapes the sharding rules are checked on.  They are the reference's
TPU meshes and claim no devices here.
"""
from __future__ import annotations

from repro_torch.sharding.context import AbstractMesh, Mesh, make_mesh


def production_mesh_shape(multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_test_mesh(world: int | None = None, device: str = "cuda") -> Mesh:
    """(data, model) over the initialised world of ``world`` ranks (its
    size when None): model 2 when the world is even, else 1."""
    import torch.distributed as dist
    n = world or dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    return make_mesh((n // model, model), ("data", "model"), device)
