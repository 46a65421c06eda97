"""Mesh construction over an initialized torch.distributed process
group. FUNCTIONS (not module-level constants) so importing never
touches the process group.

Nothing on a machine tells a program of its cluster: the caller runs
`torch.distributed.init_process_group` itself (its backend, address,
world size and rank), then builds the mesh here."""

from __future__ import annotations

import math

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """Assignment mesh: 16x16 single pod (256 ranks) or 2x16x16 (512)."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES)


def make_mesh(shape, axes):
    """A `DeviceMesh` of `shape` named `axes` over every rank of the
    initialized process group, rank r at row-major position r. Its
    device type follows the group's backend: "cuda" for nccl, "cpu" for
    gloo (whose groups take CUDA tensors too). Raises unless the world
    size is prod(shape)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
