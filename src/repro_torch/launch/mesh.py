"""Device meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  A mesh is a ``DeviceMesh`` whose
dims carry the reference's axis names (``pod``, ``data``, ``model``); one
process runs per device, so the caller starts the process group first
(``torch.distributed.init_process_group`` with its own address, world size
and rank).  ``make_production_mesh`` is a function, so importing this
module touches no process group.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: needs a process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the process group, in
    row-major order (the elastic rescale path builds shrunk meshes; a rank
    outside the mesh gets no coordinate).  Every rank of the group calls
    it, since it creates the mesh's sub-groups."""
    n = math.prod(shape)
    return DeviceMesh(device_type, torch.arange(n).view(shape),
                      mesh_dim_names=tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a ``(names, shape)``
    stand-in (the sharding rules read nothing else of a mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    names, shape = mesh
    return dict(zip(names, shape))
