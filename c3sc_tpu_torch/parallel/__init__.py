"""Multi-device parallelism: device meshes over ``torch.distributed`` and the
sharded Bellman backup and rollout — port of ``c3sc_tpu/parallel``.

One process per device (SPMD). On one card the mesh is a world of one rank
under NCCL; on several cards launch one process per GPU (``torchrun``) and
call ``distributed.initialize_distributed()``; on the CPU the ranks are
processes under gloo (``device="cpu"``). ``solvers.fused.make_fused_vi``
takes a mesh (``mesh=``) and shards its fiber block; ``multi_solve`` runs
batches of independent fused solves, the batch split over a mesh axis.
"""

from c3sc_tpu_torch.parallel.mesh import make_mesh
from c3sc_tpu_torch.parallel.sharded import make_sharded_bellman, make_sharded_rollout

__all__ = ["make_mesh", "make_sharded_bellman", "make_sharded_rollout"]
