"""Numerical operators: MCA stencil, dense Bellman sweep (kernel K1),
multilinear interpolation."""
