"""Meshes on ``torch.distributed`` and the mesh context.

Counterpart of ``repro/sharding/context.py``.  The reference is one
program over a ``jax.sharding.Mesh`` (``shard_map`` blocks run on every
device's shard); the port is one process a rank, each running its own
shard, so ``shard_map`` has no counterpart here.  What stays:

  * :class:`Mesh` -- a named mesh over the initialised world
    (``init_device_mesh``), with the reference's ``axis_names`` and
    ``shape[name]``, and the process group of an axis (or of several,
    flattened major first) for c10d collectives;
  * :class:`AbstractMesh` -- axis names and sizes, no process group, as
    JAX's ``AbstractMesh``: what the sharding rules take without a world;
  * :func:`mesh_context` / :func:`current_mesh` -- the mesh that model
    and step code read, without a handle in every signature.  Under a
    mesh with data axes, a batch is this rank's shard of the global batch
    over them (``rules.batch_spec``): the MoE router and the training
    loss all-reduce over those axes (``rules.data_group``).

The backend follows the device: ``nccl`` for a CUDA mesh, ``gloo`` for a
CPU mesh.  :func:`make_mesh` raises when the world was initialised with
the other one; nothing falls back from one to the other.
"""
from __future__ import annotations

import contextlib
import math

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

_CURRENT_MESH = None


class AbstractMesh:
    """Axis names and sizes without devices, for the sharding rules:
    ``AbstractMesh((16, 16), ("data", "model"))``."""

    def __init__(self, shape: tuple, axis_names: tuple) -> None:
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             f"in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A named mesh over the initialised world: one rank a device.
    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``;
    :meth:`group` gives an axis's process group and :meth:`coordinate`
    this rank's index along axes."""

    def __init__(self, device_mesh) -> None:
        names = device_mesh.mesh_dim_names
        super().__init__(tuple(device_mesh.mesh.shape), names)
        self.device_mesh = device_mesh
        self._groups: dict = {}

    def coordinate(self, axes) -> int:
        """This rank's index along ``axes`` (a name, or a tuple of names
        flattened major first, as JAX orders ("pod", "data"))."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx

    def group(self, axes):
        """The process group of the ranks that differ only along ``axes``
        (a name or a tuple of names): the group a collective over those
        axes runs in.  Groups over several axes are made on first use;
        every rank must ask for them in the same order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            import torch.distributed as dist
            ranks = self.device_mesh.mesh.permute(
                *[self.axis_names.index(a) for a in self.axis_names
                  if a not in axes],
                *[self.axis_names.index(a) for a in axes])
            ranks = ranks.reshape(-1, math.prod(self.shape[a] for a in axes))
            mine = None
            for row in ranks.tolist():      # every rank makes every group
                g = dist.new_group(ranks=row)
                if dist.get_rank() in row:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


class SubMesh(AbstractMesh):
    """Some axes of a :class:`Mesh`, with its groups and coordinates along
    them: a step that must not reduce over the others (a batch every data
    rank holds whole under tensor parallelism)."""

    def __init__(self, mesh: Mesh, axes: tuple) -> None:
        super().__init__(tuple(mesh.shape[a] for a in axes), axes)
        self.mesh = mesh

    def group(self, axes):
        return self.mesh.group(axes)

    def coordinate(self, axes) -> int:
        return self.mesh.coordinate(axes)


def make_mesh(shape: tuple, axis_names: tuple, device: str = "cuda") -> Mesh:
    """A :class:`Mesh` of ``shape`` over the initialised world (its size
    the world's), ranks laid out row-major as ``jax.make_mesh`` lays out
    devices.  ``device`` "cuda" needs an ``nccl`` world, "cpu" a ``gloo``
    one; anything else raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device).type
    if dev not in BACKENDS:
        raise ValueError(f"no collective backend for device {device!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    backend = dist.get_backend()
    if backend != BACKENDS[dev]:
        raise RuntimeError(f"a {dev} mesh runs on {BACKENDS[dev]}, but the "
                           f"world was initialised with {backend}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} does not cover the world of "
                         f"{dist.get_world_size()}")
    return Mesh(init_device_mesh(dev, tuple(shape),
                                 mesh_dim_names=tuple(axis_names)))


@contextlib.contextmanager
def mesh_context(mesh):
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def current_mesh():
    return _CURRENT_MESH
