"""Device meshes over ``torch.distributed`` (single-pod 16x16, multi-pod
2x16x16, and a small mesh over whatever ranks the process group holds).

The counterpart of ``repro.launch.mesh``: the same shapes and the same axis
names, as `torch.distributed.device_mesh.DeviceMesh`es.  Functions, not
module-level constants: importing this module touches no process group.
A mesh is built over the default process group, which the caller
initializes (`torch.distributed.init_process_group` with its address,
world size and rank); the ranks are laid out row-major over the mesh's
shape, as ``jax.make_mesh`` lays out devices.

The device type is the card's (``"cuda"``) unless the caller passes
``"cpu"``; asking for the card without one raises.  On the card each rank
first makes its own card the current one (`local_card`): the shards of
`core.sharded` and the collectives' operands live there.
"""
from __future__ import annotations

import os

from ..kernels import registry as _registry


def local_card(device_count: int) -> int:
    """This process's card among the host's ``device_count``: torchrun's
    ``LOCAL_RANK``, else the rank modulo the cards (one rank a card)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    import torch.distributed as dist

    return dist.get_rank() % device_count


def _init_mesh(device_type, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    dev = _registry.resolve_device("cuda" if device_type is None
                                   else device_type)
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(local_card(torch.cuda.device_count()))
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production mesh: (16, 16) over ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(device_type, shape, axes)


def make_host_mesh(data: int | None = None, model: int = 1, device_type=None):
    """A small (data, model) mesh over the process group's ranks (tests,
    one host); ``data`` defaults to the world size over ``model``."""
    import torch.distributed as dist

    if data is None:
        data = dist.get_world_size() // model
    return _init_mesh(device_type, (data, model), ("data", "model"))


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)
