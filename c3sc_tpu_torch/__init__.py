"""c3sc_tpu_torch — the PyTorch/CUDA port of ``c3sc_tpu``.

A second package beside the JAX one, which stays the reference. Module
layout and function names follow ``c3sc_tpu`` so each counterpart is easy
to find; inside, the code is PyTorch: plain functions on batched tensors
(model callables broadcast over leading axes instead of being vmapped), an
explicit ``device`` and explicit ``torch.Generator``s. Everything computes
in float32. Entry points run on the CUDA device (``default_device()``)
unless the caller passes ``device="cpu"``; functions that take tensors
follow their inputs.

Ported (every module of the JAX package; its persistent compile cache has
no counterpart):
  grids.py            tensor-product grids (uniform and non-uniform)
  models/             ControlProblem + the six systems (LQ, pendulum, Dubins, glider,
                      the 6D and 7D quadcopters)
  ops/mca.py          Kushner–Dupuis stencil
  ops/dense_backup.py whole-grid Bellman sweep (CUDA kernel csrc/dense_backup.cu,
                      uniform and non-uniform grids)
  ops/interp.py       multilinear interpolation
  ops/tt.py           padded tensor trains: evaluation, add, mult, dot, integrate,
                      round, refine, save/load
  ops/cross.py        TT cross with maxvol (tt_cross) and its index sets (CrossState)
  ops/argmin.py       batched continuous inner minimisation (PGD, L-BFGS)
  ops/quadrature.py   Gauss and Clenshaw–Curtis rules
  ops/funcs.py        univariate function classes (C3 lib_funcs) and GenericFunction
  ops/qmarray.py      quasimatrices: QR, LU, maxvol
  ops/ft.py           function trains with polynomial cores (PolyFT)
  solvers/dense.py    dense_vi (modified policy iteration), dense_policy
  solvers/fused.py    make_fused_vi, fused_tt_vi (checkpoint and resume),
                      fused_tt_vi_refined
  solvers/multilevel.py  coarse-to-fine warm starts of the fused solver
  solvers/ttvi.py     the TT Bellman backup, its chunked kernel, tt_vi
  solvers/dmrg.py     two-site DMRG cross
  solvers/ttpi.py     TT policy iteration
  solvers/pials.py    policy iteration with ALS least-squares evaluation
  solvers/polish.py   two-site polish, level and mode corrections
  solvers/twogrid.py  coarse-grid correction
  solvers/gating.py   measured accept/reject of correction stages
  solvers/local_patch.py  the local dense patch (kernel K1) and the two-level composite
  sim/                implicit policy, batched rollouts, MPC on tt_vi, fused MPC,
                      tracking, iLQR and receding-horizon MPC
  utils/              checkpoints (the JAX package's files), metrics, NaN checks
  native.py           the native maxvol and the .c3tt serializer (native/)
  control.py          the C3Control builder (c3control_* methods)
  cli.py              the registry CLI (python -m c3sc_tpu_torch.cli), examples/
  convert.py          numpy carriers of state from the JAX package
  device.py           the default device of every ``device=None``; constants kept on it
  seeds.py            the seeds of sub-solves (an int, or one seed a sub-solve)
  parallel/           device meshes over torch.distributed (NCCL on CUDA, gloo on
                      the CPU), the sharded backup and rollout, batched solves

This package never imports ``jax`` or ``c3sc_tpu``.
"""

import torch as _torch

# Full-f32 matmuls and convolutions, as the JAX package pins
# ``jax_default_matmul_precision="highest"``: without this the candidate
# drift contraction of ops/mca.py would silently run in TF32 on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from c3sc_tpu_torch.device import default_device  # noqa: E402
from c3sc_tpu_torch.grids import Grid  # noqa: E402
from c3sc_tpu_torch.models.base import Boundary, ControlProblem, Obstacle  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Grid", "ControlProblem", "Boundary", "Obstacle", "default_device", "__version__"]
