"""Device meshes over the process group (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Both return a
``torch.distributed.device_mesh.DeviceMesh`` with axes ("data", "model"),
or ("pod", "data", "model") for two pods, over the ranks of the default
process group.  The device is ``cuda`` (backend ``nccl``) unless the
caller asks for ``cpu`` (``gloo``); nothing falls back from one to the
other.  Over a dry run's ``fake`` group the mesh is only described: it
needs no device.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import DEFAULT_DEVICE, resolve_device

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def world_size() -> int:
    """Ranks of the default process group, or of the one that
    `init_process_group` would join: ``WORLD_SIZE`` from ``torchrun``,
    else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def init_process_group(device_type: str | None = None) -> int:
    """Join the default process group if it is not up yet: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set, else a one-rank group of this process
    alone.  On cuda the process's card is ``LOCAL_RANK``.  Returns the
    world size."""
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(BACKEND[dev.type])
        else:
            dist.init_process_group(BACKEND[dev.type], store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple, device_type: str | None):
    n = world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs "
                         f"{math.prod(shape)} devices, have {n}")
    if dist.is_initialized() and dist.get_backend() == "fake":
        # a dry run's group of fake ranks (`launch.dryrun`): its tensors
        # are fake, so no device is touched and none need be present
        dev = torch.device(device_type or DEFAULT_DEVICE)
    else:
        dev = resolve_device(device_type)
        init_process_group(dev.type)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Needs a
    default process group of exactly that many ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str | None = None):
    """A data x model mesh over the process group, which must have data x
    model ranks; with none yet and data x model = 1 this process makes its
    own one-rank group."""
    return _mesh((data, model), ("data", "model"), device_type)


__all__ = ["BACKEND", "world_size", "init_process_group",
           "make_production_mesh", "make_host_mesh"]
