"""Problem specification for continuous-time stochastic optimal control.

Port of ``c3sc_tpu/models/base.py``. The controlled diffusion is

    dx = f(x, u) dt + L(x, u) dw,   x in X subset R^dx, u in U = [ulb, uub]

with discounted cost

    J(x) = E[ ∫_0^tau e^{-beta t} g(x_t, u_t) dt + e^{-beta tau} psi(x_tau) ]

where tau is the exit time through an absorbing boundary / obstacle.

Where the JAX package writes unbatched callables and vmaps them, every
callable here takes tensors batched over leading axes that broadcast
against each other: ``drift(x [..., dx], u [..., du]) -> [..., dx]``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from c3sc_tpu_torch.device import const_tensor
from c3sc_tpu_torch.grids import Grid

Tensor = torch.Tensor


class Boundary(enum.IntEnum):
    """Per-dimension external boundary regime."""

    ABSORB = 0   # exit: value at the boundary node is the exit cost psi(x)
    REFLECT = 1  # outward transition mass sticks at the node (projection)
    PERIODIC = 2  # wraps (angles)


@dataclasses.dataclass(frozen=True)
class Obstacle:
    """Internal absorbing hyper-rectangle with its own exit cost."""

    lb: tuple[float, ...]
    ub: tuple[float, ...]
    cost: float  # value assigned on absorption into the obstacle

    def contains(self, x: Tensor) -> Tensor:
        """Boolean mask [...] of states inside the (closed) rectangle."""
        lb = const_tensor(self.lb, x.dtype, x.device)
        ub = const_tensor(self.ub, x.dtype, x.device)
        return torch.all((x >= lb) & (x <= ub), dim=-1)


@dataclasses.dataclass(frozen=True)
class ControlProblem:
    """Complete SOC problem definition.

    All callables take batched tensors whose leading axes broadcast:
      drift(x, u) -> [..., dx];  diff(x, u) -> [..., dx, dw];
      stage_cost(x, u) -> [...];  boundary_cost(x) -> [...] (the batch
      shape of x, also for a constant exit cost).
    """

    dx: int
    du: int
    dw: int
    lb: tuple[float, ...]
    ub: tuple[float, ...]
    boundary: tuple[Boundary, ...]
    ulb: tuple[float, ...]
    uub: tuple[float, ...]
    drift: Callable[[Tensor, Tensor], Tensor]
    diff: Callable[[Tensor, Tensor], Tensor]
    stage_cost: Callable[[Tensor, Tensor], Tensor]
    boundary_cost: Callable[[Tensor], Tensor]
    beta: float = 0.0
    obstacles: tuple[Obstacle, ...] = ()
    name: str = "problem"
    # provable value-function range (lo, hi)
    value_bounds: tuple | None = None
    # ---- optional structure declarations (kernel K1 needs all five) ----
    # control-affine drift: drift(x, u) == drift_f0(x) + drift_G(x) @ u
    drift_f0: Optional[Callable[[Tensor], Tensor]] = None   # x -> [..., dx]
    drift_G: Optional[Callable[[Tensor], Tensor]] = None    # x -> [..., dx, du]
    # control-independent diffusion: sigma2_x(x) == diag(L L^T)(x, .)
    sigma2_x: Optional[Callable[[Tensor], Tensor]] = None   # x -> [..., dx]
    # separable stage cost: g(x, u) = cost_q(x) + cost_r(u)
    cost_q: Optional[Callable[[Tensor], Tensor]] = None     # x -> [...]
    cost_r: Optional[Callable[[Tensor], Tensor]] = None     # u -> [...]

    @property
    def structured(self) -> bool:
        """True when all five structure declarations are set."""
        return None not in (self.drift_f0, self.drift_G, self.sigma2_x,
                            self.cost_q, self.cost_r)

    def sigma2_diag(self, x: Tensor, u: Tensor) -> Tensor:
        """diag(L L^T)(x, u) — the per-dim diffusion variances [..., dx]."""
        L = self.diff(x, u)
        return torch.sum(L * L, dim=-1)

    def in_obstacle(self, x: Tensor) -> Tensor:
        """Mask [...] — inside any obstacle."""
        mask = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for ob in self.obstacles:
            mask = mask | ob.contains(x)
        return mask

    def obstacle_cost(self, x: Tensor) -> Tensor:
        """Exit cost for obstacle absorption, [...] (0 outside obstacles)."""
        cost = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for ob in self.obstacles:
            cost = torch.where(ob.contains(x), torch.full_like(cost, ob.cost), cost)
        return cost

    def default_grid(self, n: int | tuple[int, ...]) -> Grid:
        if isinstance(n, int):
            n = (n,) * self.dx
        periodic = tuple(b == Boundary.PERIODIC for b in self.boundary)
        return Grid.create(self.lb, self.ub, n, periodic)

    def control_candidates(self, n: int | tuple[int, ...]) -> np.ndarray:
        """Tensor-product brute-force control candidate set [N, du] (numpy)."""
        if isinstance(n, int):
            n = (n,) * self.du
        axes = [np.linspace(self.ulb[k], self.uub[k], n[k]) for k in range(self.du)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=-1)


def batch_shape(x: Tensor, u: Tensor) -> torch.Size:
    """Broadcast batch shape of a state batch and a control batch."""
    return torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
