"""c3sc_tpu_torch — the PyTorch/CUDA port of ``c3sc_tpu``.

A second package beside the JAX one, which stays the reference. Module
layout and function names follow ``c3sc_tpu`` so each counterpart is easy
to find; inside, the code is PyTorch: plain functions on batched tensors
(model callables broadcast over leading axes instead of being vmapped), an
explicit ``device`` and explicit ``torch.Generator``s. Everything computes
in float32. Entry points run on the CUDA device (``default_device()``)
unless the caller passes ``device="cpu"``; functions that take tensors
follow their inputs.

Ported so far (the dense Bellman path):
  grids.py            tensor-product grids (uniform and non-uniform)
  models/             ControlProblem + quadcopter, pendulum, LQ
  ops/mca.py          Kushner–Dupuis stencil
  ops/dense_backup.py whole-grid Bellman sweep (CUDA kernel csrc/dense_backup.cu)
  ops/interp.py       multilinear interpolation
  solvers/dense.py    dense_vi (modified policy iteration), dense_policy
  sim/                implicit policy, batched rollouts
  convert.py          numpy carriers of state from the JAX package
  device.py           the default device of every ``device=None``

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
