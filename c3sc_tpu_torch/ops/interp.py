"""Multilinear interpolation on tensor-product grids — port of
``c3sc_tpu/ops/interp.py``: on-grid values + hat-function (lerp)
interpolation between nodes, with periodic wrap. The closed-loop simulator
uses it for off-grid value queries against a dense value table.
"""

from __future__ import annotations

import torch

from c3sc_tpu_torch.grids import Grid


def multilinear_interp(grid: Grid, values, x):
    """Interpolate dense `values` [*grid.shape] at points x [..., d].

    2^d-corner multilinear interpolation; periodic dims wrap the upper cell
    onto node 0; bounded dims clamp at the box edge. All corners are formed
    at once as a trailing axis of 2^d, in the JAX package's corner order
    (``itertools.product((0, 1), repeat=d)``) and weight-product order.
    """
    cell, w = grid.state_to_cell(grid.wrap_state(x))        # [..., d]
    w = w.to(values.dtype)
    batch = x.shape[:-1]
    weight = torch.ones((*batch, 1), dtype=values.dtype, device=values.device)
    index = torch.zeros((*batch, 1), dtype=torch.int64, device=values.device)
    stride = 1
    strides = []
    for n in reversed(grid.shape):
        strides.append(stride)
        stride *= n
    strides.reverse()
    for k, n in enumerate(grid.shape):
        lo = cell[..., k]
        hi = lo + 1
        hi = torch.remainder(hi, n) if grid.periodic[k] else torch.clamp(hi, 0, n - 1)
        wk = w[..., k, None]
        # corner bit k becomes the next (faster) corner axis
        weight = torch.stack([weight * (1.0 - wk), weight * wk], dim=-1).flatten(-2)
        index = torch.stack([index + (lo * strides[k])[..., None],
                             index + (hi * strides[k])[..., None]], dim=-1).flatten(-2)
    return torch.sum(weight * values.reshape(-1)[index], dim=-1)
