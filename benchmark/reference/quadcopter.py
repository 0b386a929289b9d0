"""The planar 6D quadcopter, written out in plain PyTorch for the benchmark's
reference: a frozen copy of the published model (Gorodetsky, Karaman,
Marzouk, IJRR 2018) at the constants a configuration file gives, with no
code of the program under test.

State (x, z, th, vx, vz, om), controls (u1, u2) = rotor thrusts in [0, u_max]:

    x'  = vx                     vx' = -(u1 + u2) sin(th) / m      + sigma_v dW1
    z'  = vz                     vz' =  (u1 + u2) cos(th) / m - g  + sigma_v dW2
    th' = om                     om' =  arm (u1 - u2) / inertia    + sigma_om dW3

Stage cost w_pos (x^2 + z^2) + w_th th^2 + w_vel (vx^2 + vz^2) + w_om om^2
+ w_u ((u1 - hover)^2 + (u2 - hover)^2), hover = m g / 2; an exit through
the x or z faces costs ``exit_cost``; th and the velocities reflect.
Every function broadcasts over leading axes and keeps the dtype of x.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ABSORB, REFLECT = "absorb", "reflect"


@dataclasses.dataclass(frozen=True)
class Quadcopter:
    mass: float
    inertia: float
    arm: float
    gconst: float
    sigma_v: float
    sigma_om: float
    beta: float
    u_max: float
    pos_max: float
    th_max: float
    vel_max: float
    om_max: float
    w_pos: float
    w_th: float
    w_vel: float
    w_om: float
    w_u: float
    exit_cost: float

    dx = 6
    du = 2
    dw = 3

    @staticmethod
    def from_config(cfg: dict) -> "Quadcopter":
        return Quadcopter(**{f.name: float(cfg["problem"][f.name])
                             for f in dataclasses.fields(Quadcopter)})

    @property
    def hover(self) -> float:
        return 0.5 * self.mass * self.gconst

    @property
    def lb(self):
        return (-self.pos_max, -self.pos_max, -self.th_max, -self.vel_max, -self.vel_max,
                -self.om_max)

    @property
    def ub(self):
        return tuple(-b for b in self.lb)

    @property
    def boundary(self):
        return (ABSORB, ABSORB, REFLECT, REFLECT, REFLECT, REFLECT)

    @property
    def value_bounds(self):
        g_sup = (self.w_pos * 2 * self.pos_max ** 2 + self.w_th * self.th_max ** 2
                 + self.w_vel * 2 * self.vel_max ** 2 + self.w_om * self.om_max ** 2
                 + self.w_u * 2 * max(self.hover, self.u_max - self.hover) ** 2)
        return 0.0, max(self.exit_cost, g_sup / max(self.beta, 1e-6))

    def candidates(self, per_axis: int) -> np.ndarray:
        """The tensor-product candidate set [per_axis^2, 2], first control slowest."""
        axis = np.linspace(0.0, self.u_max, per_axis)
        a, b = np.meshgrid(axis, axis, indexing="ij")
        return np.stack([a.ravel(), b.ravel()], axis=-1)

    def drift(self, x, u):
        th, vx, vz, om = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
        thrust = u[..., 0] + u[..., 1]
        cols = torch.broadcast_tensors(
            vx, vz, om,
            -thrust * torch.sin(th) / self.mass,
            thrust * torch.cos(th) / self.mass - self.gconst,
            self.arm * (u[..., 0] - u[..., 1]) / self.inertia)
        return torch.stack(cols, dim=-1)

    def sigma2(self, x):
        """Diagonal of L L^T: [..., 6] (the diffusion does not depend on u)."""
        s2 = torch.tensor([0.0, 0.0, 0.0, self.sigma_v ** 2, self.sigma_v ** 2,
                           self.sigma_om ** 2], dtype=x.dtype, device=x.device)
        return s2.expand(x.shape)

    def noise_step(self, noise):
        """L dW for standard normal increments noise [..., 3]: [..., 6]."""
        z = torch.zeros_like(noise[..., 0])
        return torch.stack([z, z, z, self.sigma_v * noise[..., 0], self.sigma_v * noise[..., 1],
                            self.sigma_om * noise[..., 2]], dim=-1)

    def stage_cost(self, x, u):
        return (self.w_pos * (x[..., 0] ** 2 + x[..., 1] ** 2) + self.w_th * x[..., 2] ** 2
                + self.w_vel * (x[..., 3] ** 2 + x[..., 4] ** 2) + self.w_om * x[..., 5] ** 2
                + self.w_u * ((u[..., 0] - self.hover) ** 2 + (u[..., 1] - self.hover) ** 2))
