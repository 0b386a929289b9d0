"""Terminal basin controller: the exact discounted LQR around the goal
equilibrium, the second mode of a dual-mode receding-horizon deployment
(``receding_horizon_rollout(..., terminal_lqr=...)``).

Counterpart of ``c3sc_tpu/sim/terminal.py``. Inside a basin around the goal,
the problem is a discounted LQR: the linearised dynamics plus the quadratic
model of the stage cost, whose Riccati solution follows from the problem's
own callables and never reads a learned value field. Dual-mode MPC (Mayne et
al., "Constrained model predictive control: Stability and optimality",
Automatica 2000) hands each sample to that controller once it enters the
basin. It is off by default (``terminal_lqr=None``) in both packages: on the
flagship's 9^6 quadcopter it raised the deployment's cost against the dense
value in the JAX package's runs (``experiments/dualmode_sweep.log``).

The derivatives come from ``torch.func`` at float32 points on the CPU, as the
JAX package takes them at float32 points on its CPU backend; the callables
see a batch of one. The Riccati fixed point runs in float64 numpy, step for
step as in JAX. The gains are returned on the deployment's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, jacrev

from c3sc_tpu_torch.device import resolve_device
from c3sc_tpu_torch.models.base import ControlProblem
from c3sc_tpu_torch.sim.ilqr import _clip

__all__ = ["TerminalLQR", "find_equilibrium_control", "make_terminal_lqr", "terminal_control"]


class TerminalLQR(NamedTuple):
    """Gains and basin of the terminal mode (float32 tensors on one device):
    ``u(x) = clip(u_eq - K (x - x_eq))`` where ``|| (x - x_eq) / scale ||_2 <
    radius``."""

    x_eq: torch.Tensor    # [dx]
    u_eq: torch.Tensor    # [du]
    K: torch.Tensor       # [du, dx] feedback gains
    scale: torch.Tensor   # [dx] per-dim normalisation (the box's half-widths)
    radius: float


def _point(fn):
    """``fn`` of one point: the batched callable on a batch of one."""
    return lambda *args: fn(*(a[None] for a in args))[0]


def find_equilibrium_control(problem: ControlProblem, x_eq) -> np.ndarray:
    """Least-squares u_eq with drift(x_eq, u_eq) ~ 0, clipped to the control
    box (float64 numpy [du]).

    Control-affine problems solve G(x_eq) u = -f0(x_eq) directly; otherwise
    up to 20 Gauss-Newton steps on ||drift||^2 from the box's midpoint.
    """
    x = torch.as_tensor(np.asarray(x_eq, np.float32))
    ulb = np.asarray(problem.ulb, np.float64)
    uub = np.asarray(problem.uub, np.float64)
    with torch.no_grad():
        if problem.drift_f0 is not None and problem.drift_G is not None:
            G = problem.drift_G(x[None])[0].double().numpy()
            f0 = problem.drift_f0(x[None])[0].double().numpy()
            u, *_ = np.linalg.lstsq(G, -f0, rcond=None)
            return np.clip(u, ulb, uub)
    drift = _point(problem.drift)
    jac = jacrev(drift, argnums=1)
    u = 0.5 * (ulb + uub)
    for _ in range(20):
        uf = torch.as_tensor(u, dtype=torch.float32)
        r = drift(x, uf).detach().double().numpy()
        J = jac(x, uf).detach().double().numpy()
        du, *_ = np.linalg.lstsq(J, -r, rcond=None)
        u = np.clip(u + du, ulb, uub)
        if np.linalg.norm(du) < 1e-12:
            break
    return u


def make_terminal_lqr(problem: ControlProblem, dt: float, x_eq=None, u_eq=None,
                      radius: float = 0.35, n_iters: int = 5000, tol: float = 1e-12,
                      device=None) -> TerminalLQR:
    """Discounted discrete-time LQR gains at the goal equilibrium, on
    ``device`` (None: the default CUDA device).

    Linearises the drift at (x_eq, u_eq) (x_eq defaults to the origin, u_eq
    to ``find_equilibrium_control``), discretises it as the plant integrates
    (A_d = I + dt A, B_d = dt B), takes the stage cost's Hessian blocks
    (Q, R and the cross term S), and iterates the Riccati recursion with the
    per-step discount exp(-beta dt) to its fixed point in float64.
    """
    if x_eq is None:
        x_eq = np.zeros(problem.dx)
    x_eq = np.asarray(x_eq, np.float64)
    if u_eq is None:
        u_eq = find_equilibrium_control(problem, x_eq)
    u_eq = np.asarray(u_eq, np.float64)

    xf = torch.as_tensor(x_eq, dtype=torch.float32)
    uf = torch.as_tensor(u_eq, dtype=torch.float32)
    drift, cost = _point(problem.drift), _point(problem.stage_cost)

    def f64(t):
        return t.detach().double().numpy()

    A = f64(jacrev(drift, argnums=0)(xf, uf))
    B = f64(jacrev(drift, argnums=1)(xf, uf))
    # the stage cost's quadratic model: g ~ g0 + 0.5 [dx du] H [dx; du]
    Qxx = f64(hessian(cost, argnums=0)(xf, uf))
    Ruu = f64(hessian(cost, argnums=1)(xf, uf))
    Sxu = f64(jacrev(grad(cost, argnums=0), argnums=1)(xf, uf))

    dx = problem.dx
    Ad = np.eye(dx) + dt * A
    Bd = dt * B
    Qd = 0.5 * Qxx * dt
    Rd = 0.5 * Ruu * dt + 1e-10 * np.eye(problem.du)
    Sd = 0.5 * Sxu * dt
    gam = float(np.exp(-problem.beta * dt))

    P = Qd.copy()
    K = np.zeros((problem.du, dx))
    for _ in range(n_iters):
        BtP = Bd.T @ (gam * P)
        Huu = Rd + BtP @ Bd
        Hux = BtP @ Ad + Sd.T
        K_new = np.linalg.solve(Huu, Hux)
        P_new = Qd + gam * Ad.T @ P @ Ad - K_new.T @ Huu @ K_new
        P_new = 0.5 * (P_new + P_new.T)
        if np.max(np.abs(P_new - P)) < tol * max(1.0, np.max(np.abs(P))):
            P, K = P_new, K_new
            break
        P, K = P_new, K_new

    scale = 0.5 * (np.asarray(problem.ub, np.float64) - np.asarray(problem.lb, np.float64))
    dev = resolve_device(device)

    def out(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return TerminalLQR(x_eq=out(x_eq), u_eq=out(u_eq), K=out(K), scale=out(scale),
                       radius=float(radius))


def terminal_control(tlqr: TerminalLQR, x, ulb, uub):
    """The terminal mode's action and basin membership of a batch:
    x [B, dx] -> (u [B, du], in_basin [B] bool), on x's device with no host
    read; ``ulb``, ``uub`` are tensors of the control box."""
    dxs = x - tlqr.x_eq[None, :]
    z = dxs / tlqr.scale[None, :]
    r = torch.sqrt(torch.sum(z * z, dim=-1))
    u = _clip(tlqr.u_eq[None, :] - dxs @ tlqr.K.T, ulb, uub)
    return u, r < tlqr.radius
