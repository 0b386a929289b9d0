"""Solvers ported so far: the dense-grid oracle."""

from c3sc_tpu_torch.solvers.dense import DenseSolution, dense_policy, dense_vi

__all__ = ["DenseSolution", "dense_vi", "dense_policy"]
