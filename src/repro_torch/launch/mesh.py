"""Mesh construction on the current process group (port of
``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module touches no
process group.  Each returns a ``torch.distributed.device_mesh.DeviceMesh``
with named axes over the ranks of the default process group, row-major;
every rank must call it (making a mesh makes its groups, collectively).
The device type follows the group's backend: ``cuda`` under NCCL, ``cpu``
under gloo.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["PRODUCTION_SHAPES", "make_production_mesh", "make_local_mesh"]

#: ``multi_pod`` -> (shape, axis names): JAX's 16x16 single pod (256 chips)
#: and 2x16x16 over two pods (512 chips)
PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _world() -> int:
    """The default process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed process group: call init_process_group first")

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(math.prod(shape)).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` with ``multi_pod``.
    A process group of another size raises a ``ValueError`` naming the size
    it needs."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    need, world = math.prod(shape), _world()
    if world != need:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}production mesh {shape} over {names} needs "
                         f"a process group of {need} ranks; this one has {world}")
    return _mesh(shape, names)


def make_local_mesh():
    """``(1, world)`` over ``("data", "model")``: every rank of the process
    group on the model axis (tests, examples, one host)."""
    world = _world()
    return _mesh((1, world), ("data", "model"))

