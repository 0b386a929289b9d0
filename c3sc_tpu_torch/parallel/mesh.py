"""Device meshes over ``torch.distributed`` — port of ``c3sc_tpu/parallel/mesh.py``.

JAX runs one program over a mesh of devices. PyTorch's idiom is SPMD: one
process per device, each running the same program on its own block, and
collectives between them. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one device a rank: NCCL on CUDA, gloo on the CPU.

Besides ``make_mesh``, this module holds the collectives the sharded paths
share: the size and coordinate of a rank along a named axis, a block of
rows by coordinate, a MIN over an axis and a gather of row blocks along an
axis. An axis the mesh does not have is an axis of size 1 with no
collective; an axis of size 1 that the mesh has still runs its collective.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from c3sc_tpu_torch.device import resolve_device


def _group_device(device=None) -> torch.device:
    """The device a rank of the existing process group computes on: CUDA
    under NCCL, the CPU under gloo. ``device`` given must agree."""
    nccl = "nccl" in str(dist.get_backend())
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    device = torch.device(device)
    if (device.type == "cuda") != nccl:
        raise ValueError(f"the process group runs {dist.get_backend()!r}; it cannot run a mesh "
                         f"of {device.type} devices")
    return device


def _start_world_of_one(device: torch.device) -> None:
    """A process group of this process alone (JAX's single-process mesh over
    its local devices): NCCL on a CUDA device, gloo on the CPU. On the card a
    NCCL that fails to start raises; nothing falls back to gloo."""
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        torch.cuda.set_device(index)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", index))
    elif device.type == "cpu":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise ValueError(f"no process-group backend for {device.type} devices")


def make_mesh(axes: tuple[str, ...] = ("fibers", "ctrl"), shape: tuple[int, ...] | None = None,
              device=None):
    """A ``DeviceMesh`` over the ranks of the process group, one device a rank.

    Default 2D layout: ``'fibers'`` (data-parallel over Bellman fiber/node
    batches and rollout scenarios) x ``'ctrl'`` (parallel over control-
    candidate blocks, reduced with a MIN). With ``shape=None`` all ranks go
    to ``'fibers'``.

    ``device`` takes the place of JAX's ``devices=``: a rank owns one device,
    so the mesh's devices are the ranks'. With no process group, one is
    started for this process alone on ``device`` (None: the default CUDA
    device, under NCCL; ``"cpu"``: gloo); with one, ``device`` (None: the
    group's) must be of the kind its backend runs.
    """
    axes = tuple(axes)
    if dist.is_initialized():
        device = _group_device(device)
    else:
        device = resolve_device(device)
        _start_world_of_one(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name the axes {axes}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != #devices {n}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` whose collectives run on
    ``device``'s kind."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (make_mesh), got {type(mesh).__name__}")
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh cannot shard tensors on {device}")


def axis_size(mesh, name: str) -> int:
    """The ranks along axis ``name`` (1 where the mesh has no such axis)."""
    return mesh.size(mesh.mesh_dim_names.index(name)) if name in mesh.mesh_dim_names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis ``name`` (0 where there is none)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def block(mesh, name: str, n: int, what: str) -> tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n`` split evenly along axis
    ``name``; ``n`` must divide by the axis size."""
    size = axis_size(mesh, name)
    if n % size:
        raise ValueError(f"{what}: {n} does not divide by the {size} ranks of mesh axis {name!r}")
    m = n // size
    lo = axis_index(mesh, name) * m
    return lo, lo + m


def min_over(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """The elementwise MIN of ``x`` over the ranks along axis ``name``, in
    place (``x`` is returned)."""
    if name in mesh.mesh_dim_names:
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=mesh.get_group(name))
    return x


def gather_rows(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """The ranks' blocks ``x [m, ...]`` along axis ``name`` stacked in their
    coordinates' order: ``[size * m, ...]`` on every rank of the axis."""
    if name not in mesh.mesh_dim_names:
        return x
    size = axis_size(mesh, name)
    src = x.contiguous()
    if src.dtype == torch.bool:       # gathered as bytes
        return gather_rows(src.view(torch.uint8), mesh, name).view(torch.bool)
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=mesh.get_group(name))
    return out
