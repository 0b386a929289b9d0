"""Builder-style top-level API mirroring the reference's ``c3control_*`` —
port of ``c3sc_tpu/control.py``.

Reference: ``c3sc/src/c3sc.c`` ``struct C3Control`` —
``c3control_create / add_drift / add_diff / add_stagecost / add_boundcost /
add_obscost / set_external_boundary / add_obstacle / init_value /
vi_solve / pi_solve`` (line n/a, empty mount; SURVEY.md §2.1).

The dataclass ``ControlProblem`` + functional solvers are the idiomatic
surface; this builder exists for users migrating from the C API: every
reference call has a named equivalent here. The callables follow the port's
contract: batched tensors whose leading axes broadcast (``x [..., dx]``,
``u [..., du]``), where the JAX builder takes one point and vmaps.

    ctrl = (C3Control(dx=2, du=1, dw=1, lb=[-2,-2], ub=[2,2], beta=1.0)
            .add_drift(f).add_diff(L).add_stagecost(g).add_boundcost(psi)
            .set_external_boundary(0, "reflect")
            .add_obstacle(lb=[...], ub=[...], cost=100.0))
    sol = ctrl.vi_solve(ngrid=41, rmax=16)
    u = ctrl.implicit_policy(sol)(x)

The solves run on ``device`` (a keyword the drivers pass on; None: the
default CUDA device), seeded by ``seed`` (an int, the JAX builder's
``jax.random.key(seed)``). A callable that needs a constant array takes it
from ``c3sc_tpu_torch.device.const_tensor`` (uploaded once): a copy from
the host inside the callable fails under ``vi_solve(cuda_graph=True)``,
whose captured iteration calls it, and makes the host wait elsewhere.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from c3sc_tpu_torch.models.base import Boundary, ControlProblem, Obstacle

_BOUNDARY_NAMES = {
    "absorb": Boundary.ABSORB,
    "reflect": Boundary.REFLECT,
    "periodic": Boundary.PERIODIC,
}


def _zero_exit_cost(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


class C3Control:
    """Mutable problem builder with reference-named methods."""

    def __init__(self, dx: int, du: int, dw: int,
                 lb: Sequence[float], ub: Sequence[float], beta: float = 0.0,
                 ulb: Sequence[float] | None = None,
                 uub: Sequence[float] | None = None,
                 name: str = "c3control"):
        self.dx, self.du, self.dw = dx, du, dw
        self.lb, self.ub = tuple(map(float, lb)), tuple(map(float, ub))
        self.beta = beta
        self.ulb = tuple(map(float, ulb)) if ulb is not None else (-1.0,) * du
        self.uub = tuple(map(float, uub)) if uub is not None else (1.0,) * du
        self.name = name
        self._drift = None
        self._diff = None
        self._stage = None
        self._bound = _zero_exit_cost
        self._boundary = [Boundary.ABSORB] * dx
        self._obstacles: list[Obstacle] = []
        self._value_bounds = None

    # ----- reference-named registration methods (chainable) -----

    def add_drift(self, f: Callable):
        """f(x [..., dx], u [..., du]) -> [..., dx] (gradients come from
        torch.autograd: no hand-coded Jacobian argument, unlike the
        reference)."""
        self._drift = f
        return self

    def add_diff(self, L: Callable):
        """L(x, u) -> [..., dx, dw]."""
        self._diff = L
        return self

    def add_stagecost(self, g: Callable):
        """g(x, u) -> [...]."""
        self._stage = g
        return self

    def add_boundcost(self, psi: Callable):
        """psi(x) -> [...], the exit cost."""
        self._bound = psi
        return self

    def add_obscost(self, cost: float, lb: Sequence[float], ub: Sequence[float]):
        """Obstacle with its own absorption cost (the reference splits
        add_obstacle/add_obscost; here one call does both)."""
        return self.add_obstacle(lb, ub, cost)

    def set_external_boundary(self, dim: int, kind: str):
        self._boundary[dim] = _BOUNDARY_NAMES[kind.lower()]
        return self

    def add_obstacle(self, lb: Sequence[float], ub: Sequence[float], cost: float = 0.0):
        o_lb = list(map(float, lb))
        o_ub = list(map(float, ub))
        if len(o_lb) != self.dx:
            raise ValueError("obstacle bounds must have dx entries")
        self._obstacles.append(Obstacle(tuple(o_lb), tuple(o_ub), cost))
        return self

    def set_value_bounds(self, lo: float, hi: float):
        self._value_bounds = (lo, hi)
        return self

    # ----- finalize -----

    def problem(self) -> ControlProblem:
        if self._drift is None or self._diff is None or self._stage is None:
            raise ValueError("drift, diff and stagecost must be registered")
        return ControlProblem(
            dx=self.dx, du=self.du, dw=self.dw,
            lb=self.lb, ub=self.ub, boundary=tuple(self._boundary),
            ulb=self.ulb, uub=self.uub,
            drift=self._drift, diff=self._diff,
            stage_cost=self._stage, boundary_cost=self._bound,
            beta=self.beta, obstacles=tuple(self._obstacles),
            name=self.name, value_bounds=self._value_bounds,
        )

    # ----- solve drivers (reference: c3control_vi_solve / pi_solve) -----

    def vi_solve(self, ngrid: int | tuple = 41, rmax: int = 16, n_controls: int = 9, **kwargs):
        """``fused_tt_vi`` on the default grid of ``ngrid`` nodes a dim
        (``seed``, ``device`` and the solver's other keywords pass on); the
        solution carries its ``grid``."""
        from c3sc_tpu_torch.solvers.fused import fused_tt_vi

        prob = self.problem()
        grid = prob.default_grid(ngrid)
        sol = fused_tt_vi(prob, grid, n_controls=n_controls, rmax=rmax, **kwargs)
        sol.grid = grid  # convenience attachment
        return sol

    def pi_solve(self, ngrid: int | tuple = 41, rmax: int = 16, n_controls: int = 9, **kwargs):
        """``tt_pi`` on the default grid, as ``vi_solve``."""
        from c3sc_tpu_torch.solvers.ttpi import tt_pi

        prob = self.problem()
        grid = prob.default_grid(ngrid)
        sol = tt_pi(prob, grid, n_controls=n_controls, rmax=rmax, **kwargs)
        sol.grid = grid
        return sol

    def init_value(self, ngrid: int | tuple, guess: Callable, rmax: int = 16, seed=0,
                   **kwargs):
        """Cross-fit an initial value guess (reference: c3control_init_value
        -> cost_approx, SURVEY.md §3.4). guess: x [..., d] -> [...]."""
        from c3sc_tpu_torch.ops.cross import tt_cross

        grid = self.problem().default_grid(ngrid)
        return tt_cross(lambda idx: guess(grid.index_to_state(idx)), grid.shape, rmax=rmax,
                        seed=seed, **kwargs).tt

    def implicit_policy(self, sol, refine_steps: int = 0, n_controls: int = 9,
                        basis: str = "linelm"):
        """Feedback policy from a solved value function.

        ``basis``: 'linelm' (multilinear lerp, the reference c3sc default)
        or 'poly' (the nodal TT upgraded to a smooth orthonormal-Legendre
        function train: smoother off-grid values and well-defined gradients,
        which drive the refinement's continuous HJB Hamiltonian)."""
        from c3sc_tpu_torch.sim.policy import make_implicit_policy

        prob = self.problem()
        grid = sol.grid
        value_grad_fn = None
        if basis == "poly":
            from c3sc_tpu_torch.ops.ft import ft_eval, ft_from_tt, ft_grad_eval

            ft = ft_from_tt(sol.v, grid)
            value_fn = lambda p: ft_eval(ft, p)  # noqa: E731
            value_grad_fn = lambda p: ft_grad_eval(ft, p)  # noqa: E731
        else:
            from c3sc_tpu_torch.ops.tt import tt_lerp_eval

            value_fn = lambda p: tt_lerp_eval(sol.v, grid, p)  # noqa: E731
        return make_implicit_policy(prob, grid, value_fn, prob.control_candidates(n_controls),
                                    refine_steps=refine_steps, value_grad_fn=value_grad_fn)
