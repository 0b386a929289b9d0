"""Multi-process start — port of ``c3sc_tpu/parallel/distributed.py``.

JAX starts one process per host and sees every device of the slice. The
port runs one process per device (SPMD): launch the same program once per
GPU, for example with ``torchrun --nproc-per-node N``, call
``initialize_distributed()`` in each, then build the mesh with
``global_mesh``. On the CPU the ranks are processes under gloo
(``device="cpu"``).

Sharding only embarrassingly parallel axes (fiber/node batches, rollout
scenarios, candidate blocks) and keeping TT cores replicated keeps the
traffic between ranks to the MIN reductions and the gathers of results.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from c3sc_tpu_torch.device import resolve_device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device=None) -> None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator_address`` (``"host:port"``,
    reached as ``tcp://host:port``).

    The backend follows ``device`` (None: the default CUDA device): NCCL on
    CUDA, where each rank first takes the card ``process_id % #cards``, and
    gloo on the CPU. A NCCL that fails to start raises.

    Without an address the rank, world size and meeting point are read from
    the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). It does nothing when a group is
    already initialized, or on a single process given none of these
    (``make_mesh`` then starts a world of one).
    """
    if dist.is_initialized():
        return
    init_method = None
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        init_method = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif num_processes in (None, 1):
        return
    else:
        raise ValueError(f"{num_processes} processes need a coordinator_address")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group("nccl", init_method=init_method, world_size=num_processes,
                                rank=process_id,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, world_size=num_processes,
                                rank=process_id)
    else:
        raise ValueError(f"no process-group backend for {device.type} devices")


def global_mesh(axes=("fibers", "ctrl"), ctrl: int = 1):
    """Mesh over ALL ranks (call after ``initialize_distributed``): ``ctrl``
    ranks on the ``'ctrl'`` axis, the rest on ``'fibers'``. With no group,
    ``make_mesh``'s world of one on the default device."""
    from c3sc_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % ctrl:
        raise ValueError(f"ctrl={ctrl} does not divide the {n} ranks")
    if len(axes) == 1:
        if ctrl != 1:
            raise ValueError("ctrl > 1 needs a 'ctrl' mesh axis")
        shape = (n,)
    else:
        shape = (n // ctrl, ctrl) + (1,) * (len(axes) - 2)
    return make_mesh(axes=axes, shape=shape)
