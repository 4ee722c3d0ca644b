"""Device meshes for the port (counterpart of ``repro.launch.mesh``).

The production meshes are H100 nodes: one node is ``(1, 8)`` over
``("data", "model")``, its eight cards on one NVLink/NVSwitch baseboard;
two nodes are ``(2, 1, 8)`` over ``("pod", "data", "model")``, the ``pod``
axis crossing the network between the nodes: the meshes of
``core.cluster``'s ``h100_node_config`` / ``h100_multi_node_config``.

Every function here builds a :class:`torch.distributed.DeviceMesh` over the
default process group, which the caller initialises (``torchrun`` and
``nccl`` on the cards, ``gloo`` for CPU processes); a mesh whose size
differs from the group's raises.  :func:`fake_process_group` is the one
entry point to PyTorch's fake process group (every collective a no-op, any
world size in one process), on which :func:`abstract_mesh` builds the
device-free mesh of the dry run and the sharding tests, the counterpart of
``jax.sharding.AbstractMesh``.  Importing this module imports no torch,
initialises no group and touches no device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple

def production_layout(multi_node: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of one H100 node or of two: the mesh of
    ``core.cluster``'s ``h100_node_config`` or ``h100_multi_node_config``."""
    from repro_torch.core.cluster import (h100_multi_node_config,
                                          h100_node_config)

    cc = h100_multi_node_config() if multi_node else h100_node_config()
    return tuple(cc.mesh_shape), tuple(cc.mesh_axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A mesh of ``shape`` over ``axes`` on the default process group, whose
    world size must be the mesh's.  ``device_type="cuda"`` raises without
    CUDA: nothing falls back to the CPU."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one (torchrun and "
                           "nccl, gloo, or fake_process_group) before "
                           "building a mesh")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a cuda mesh needs GPUs")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_node: bool = False,
                         device_type: str = "cuda"):
    """One H100 node's mesh, or two nodes' (``multi_node``)."""
    return make_mesh(*production_layout(multi_node), device_type)


def make_host_mesh(device: str = "cuda"):
    """Every rank of the default group as a one-axis ``"data"`` mesh on
    ``device``'s type (the tests, and the card's one-rank mesh)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one before "
                           "make_host_mesh")
    return make_mesh((dist.get_world_size(),), ("data",),
                     str(device).split(":")[0])


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """The default process group as PyTorch's fake group of ``world_size``
    ranks, this process being ``rank``; destroyed on exit.  A process has
    one default group, so this raises when one is already initialised."""
    import torch.distributed as dist
    # the private module registers the "fake" backend when imported; it is
    # present, with FakeStore, in torch 2.11 and 2.13
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake group cannot replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A device-free CPU mesh of ``shape`` over ``axes`` on the fake group
    (inside ``with fake_process_group(prod(shape)):``)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("abstract_mesh needs the fake process group: call "
                           "it inside fake_process_group(world_size)")
    return make_mesh(shape, axes, "cpu")
