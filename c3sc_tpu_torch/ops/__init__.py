"""Numerical operators: MCA stencil, dense Bellman sweep (kernel K1),
multilinear interpolation, tensor-train algebra, cross approximation, control
argmin, and the C3 function layer (quadrature, univariate function classes,
quasimatrices, polynomial-core function trains)."""

from c3sc_tpu_torch.ops.mca import node_terminal, transition, transition_batch

__all__ = ["transition", "transition_batch", "node_terminal"]
