"""Shared pieces of the port's tests (``tests/test_torch_*.py``).

Importing this module pins torch to ONE intra-op thread. The suite runs
under pytest-xdist with several workers; torch's default of one thread per
core in every worker oversubscribes the machine, and a solve that takes
seconds alone then takes minutes. Every port test file imports this module
first, so the pin holds before any tensor work.

Only torch, numpy and the standard library are imported here: the
card-only tests run on a machine without JAX, and the ranks ``Ranks``
spawns import this module.
"""

import contextlib
import multiprocessing
import os
import pickle
import socket
import time
import traceback
from multiprocessing.connection import wait

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "experiments", "artifacts")
V5 = os.path.join(ART, "quad_dense_v5.npz")
QUAD = dict(sigma_v=0.15, sigma_om=0.15)   # the dense oracle's quadcopter
TIE = 1e-5  # argmins may differ only where the two best rhs are this close (relative)


def to_numpy(a):
    """A torch tensor, a JAX array or a numpy array as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(got, want, rtol, atol):
    """assert_allclose on whatever array types the two packages return."""
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=rtol, atol=atol)


def within_range(got, want, frac=1e-4):
    """max |got - want| <= frac x (range of want)."""
    got, want = to_numpy(got), to_numpy(want)
    assert np.abs(got - want).max() <= frac * (want.max() - want.min())


def random_v(shape, seed=0):
    """A random value table in [0, 5) as float32 numpy."""
    return np.random.default_rng(seed).uniform(0, 5, shape).astype(np.float32)


def port_grid(jg):
    """The port's Grid from a JAX Grid's static fields."""
    from c3sc_tpu_torch.convert import grid_from_numpy

    return grid_from_numpy(jg.lb, jg.ub, jg.shape, jg.periodic, jg.nodes_override)


def random_tt_numpy(shape, ranks, rmax, seed=0):
    """Padded random TT cores [rmax, n_k, rmax] and ranks [d+1] as numpy;
    ``ranks`` are the d-1 interior bond ranks."""
    rng = np.random.default_rng(seed)
    rk = [1] + [min(int(r), rmax) for r in ranks] + [1]
    assert len(rk) == len(shape) + 1
    cores = []
    for k, n in enumerate(shape):
        c = np.zeros((rmax, n, rmax), np.float32)
        c[:rk[k], :, :rk[k + 1]] = rng.standard_normal((rk[k], n, rk[k + 1])) / np.sqrt(rmax)
        cores.append(c)
    return cores, np.asarray(rk, np.int32)


def tanh_nodes(lb, ub, n, sharp=1.5):
    """tests/test_nonuniform.py's nodes: n of them on [lb, ub], denser near
    the centre."""
    t = np.tanh(sharp * np.linspace(-1, 1, n)) / np.tanh(sharp)
    return lb + (t + 1) * 0.5 * (ub - lb)


def tanh_node_sets(lb, ub, shape, periodic):
    """Per-dim node arrays: tanh_nodes on bounded dims, the uniform periodic
    nodes lb + i (ub - lb) / n on periodic ones."""
    return [lo + np.arange(n) * ((hi - lo) / n) if p else tanh_nodes(lo, hi, n)
            for lo, hi, n, p in zip(lb, ub, shape, periodic)]


# ---- K1's wide problems: five controls, nine states ---------------------------------

WIDE_SIGMA = 0.3   # the diffusion of both problems, on every state


def _wide_diff(x, u):
    """WIDE_SIGMA I [..., d, d] over the broadcast batch of x and u."""
    batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    return torch.diag_embed(x.new_full((*batch, x.shape[-1]), WIDE_SIGMA))


def double_integrator_du5(declared=False):
    """The port's double integrator driven by five inputs, built with
    ``C3Control(dx=2, du=5, ...)``: x0' = x1, x1' = u0 + ... + u4, noise 0.3
    on both states, cost |x|^2 + 0.1 |u|^2, reflecting faces, controls in
    [-0.4, 0.4]. It has no structure declarations, so it takes K1's general
    entries; ``declared`` adds all five, which a structured kernel (du <= 4)
    cannot take either."""
    import dataclasses

    from c3sc_tpu_torch.control import C3Control

    ctrl = (C3Control(dx=2, du=5, dw=2, lb=[-2.0, -2.0], ub=[2.0, 2.0], beta=0.5,
                      ulb=[-0.4] * 5, uub=[0.4] * 5, name="double_integrator_du5")
            .add_drift(lambda x, u: torch.stack(torch.broadcast_tensors(x[..., 1], u.sum(-1)),
                                                -1))
            .add_diff(_wide_diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + 0.1 * (u * u).sum(-1))
            .set_external_boundary(0, "reflect").set_external_boundary(1, "reflect")
            .set_value_bounds(0.0, 50.0))
    prob = ctrl.problem()
    if not declared:
        return prob
    return dataclasses.replace(
        prob,
        drift_f0=lambda x: torch.stack([x[..., 1], torch.zeros_like(x[..., 0])], -1),
        drift_G=lambda x: torch.stack([torch.zeros_like(x[..., :1]).expand(*x.shape[:-1], 5),
                                       torch.ones_like(x[..., :1]).expand(*x.shape[:-1], 5)],
                                      -2),
        sigma2_x=lambda x: torch.full_like(x, WIDE_SIGMA ** 2),
        cost_q=lambda x: (x * x).sum(-1),
        cost_r=lambda u: 0.1 * (u * u).sum(-1))


def nine_states():
    """The port's problem of nine states, built with ``C3Control(dx=9,
    du=1, ...)``: x_j' = -x_j + u [j = 0], noise 0.3 on every state, cost
    |x|^2 + 0.1 u^2, reflecting faces on [-1, 1]^9, u in [-1, 1]. K1 runs it
    in the general entries' run-time-d form."""
    return many_states(9, "nine_states")


def many_states(d, name=None):
    """``nine_states`` on ``d`` states (named ``states<d>`` unless ``name``
    is given)."""
    from c3sc_tpu_torch.control import C3Control

    ctrl = (C3Control(dx=d, du=1, dw=d, lb=[-1.0] * d, ub=[1.0] * d, beta=0.5,
                      name=name or f"states{d}")
            .add_drift(lambda x, u: torch.nn.functional.pad(u[..., :1], (0, d - 1)) - x)
            .add_diff(_wide_diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + 0.1 * (u * u).sum(-1))
            .set_value_bounds(0.0, 50.0))
    for j in range(d):
        ctrl.set_external_boundary(j, "reflect")
    return ctrl.problem()


# ---- ranks of a torch.distributed group, each a spawned process ---------------------

RANK_TIMEOUT_S = 120.0   # a hung rank fails its test after this, instead of stalling the suite


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, job, kwargs, out_path):
    """One rank: join the gloo group, run ``job(rank, **kwargs)``, and write
    ("ok", result) or ("error", traceback) to ``out_path``."""
    try:
        from c3sc_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        result = ("ok", job(rank, **kwargs))
    except BaseException:  # noqa: BLE001 - reported to the parent, which re-raises
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


class Ranks:
    """``world`` spawned processes joined in one gloo group, each running
    ``job(rank, **kwargs)`` (a module-level function of this module: the
    children import torch and numpy, never JAX). They start at once;
    ``results()`` waits for all of them."""

    def __init__(self, job, world, out_dir, **kwargs):
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        os.makedirs(out_dir, exist_ok=True)
        self.paths = [os.path.join(str(out_dir), f"rank{r}.pkl") for r in range(world)]
        self.procs = [ctx.Process(target=_rank_entry, args=(r, world, port, job, kwargs, path),
                                  daemon=True)
                      for r, path in enumerate(self.paths)]
        self.started = time.monotonic()
        for p in self.procs:
            p.start()

    def _result(self, r):
        if not os.path.exists(self.paths[r]):
            raise RuntimeError(f"rank {r} exited with code {self.procs[r].exitcode} "
                               f"and left no result")
        with open(self.paths[r], "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        return value

    def results(self, timeout=RANK_TIMEOUT_S):
        """Every rank's result, in rank order. A rank's exception is raised
        here; a rank still running ``timeout`` s after the start fails; every
        rank still alive is killed on the way out."""
        try:
            pending = dict(enumerate(self.procs))
            while pending:
                left = self.started + timeout - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(pending)} still running after {timeout} s")
                for s in wait([p.sentinel for p in pending.values()], timeout=left):
                    r = next(r for r, p in pending.items() if p.sentinel == s)
                    pending.pop(r).join()
                    self._result(r)          # a failed rank raises at once
            return [self._result(r) for r in range(len(self.procs))]
        finally:
            self.kill()

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(5)


def stuck_job(rank, fail_rank=None):
    """A rank that raises (rank ``fail_rank``) or never returns: what
    ``Ranks.results`` must turn into a prompt failure."""
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    time.sleep(3600)


@contextlib.contextmanager
def no_process_group():
    """No process group and no torchrun environment in this process while
    the block runs, and none after it: a world of one that a test starts
    here is torn down, so later tests in the same worker start clean."""
    import torch.distributed as dist

    saved = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
             if k in os.environ}
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        os.environ.update(saved)


def _gloo_mesh(shape, axes=("fibers", "ctrl")):
    from c3sc_tpu_torch.parallel import make_mesh

    return make_mesh(axes=axes, shape=shape)


def _carry_fields(c):
    """The fields of a fused carry that the parallel tests compare, as numpy."""
    return dict(ranks=to_numpy(c.ranks), rl=to_numpy(c.rl), rr=to_numpy(c.rr),
                it=to_numpy(c.it), rows_l=to_numpy(c.rows_l), rows_r=to_numpy(c.rows_r),
                v_sample=to_numpy(c.v_sample), residual=to_numpy(c.residual),
                cores=[to_numpy(x) for x in c.cores])


def fused_stepper(name, n, per_dim, rmax, mesh=None, **kw):
    """(init_fn, step_fn) of the fused solver on the CPU, on ``mesh`` or
    unsharded; ``kw``: more of its options."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.solvers import make_fused_vi

    prob = make_problem(name)
    _, init, step, _ = make_fused_vi(prob, prob.default_grid(n), prob.control_candidates(per_dim),
                                     rmax=rmax, tol=0.0, max_iters=10**9, mesh=mesh,
                                     device="cpu", **kw)
    return init, step


def fused_step_case(iters, seed, **case):
    """``iters`` step_fn iterations of the fused solver from ``init_fn(seed)``
    on the CPU (``fused_stepper``'s arguments); the carry's fields as numpy."""
    init, step = fused_stepper(**case)
    return _carry_fields(step(init(seed), iters))


def write_for_ranks(path, obj):
    """Hand ``obj`` to ranks waiting in ``wait_for``: pickled, then renamed
    into place, so a rank never reads half a file."""
    with open(f"{path}.part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(f"{path}.part", path)


def wait_for(path):
    """What ``write_for_ranks`` wrote to ``path``, once it is there (a rank
    that waits for ever is ended by ``Ranks.results``' time limit)."""
    while not os.path.exists(path):
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def parallel_rank_job(rank, backup, fused, padded, rollout, total, jax_carries):
    """tests/test_torch_parallel.py's work on one of 4 ranks (see there);
    last, one sharded step from each of JAX's carries, which the parent
    writes to ``jax_carries`` while the ranks do the rest."""
    import torch.distributed as dist

    from c3sc_tpu_torch.convert import fused_carry_from_numpy, tt_from_numpy
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.ops.interp import multilinear_interp
    from c3sc_tpu_torch.parallel import make_sharded_bellman, make_sharded_rollout
    from c3sc_tpu_torch.parallel.distributed import global_mesh
    from c3sc_tpu_torch.parallel.mesh import axis_index
    from c3sc_tpu_torch.sim import make_implicit_policy

    out = {}
    mesh = _gloo_mesh((2, 2))
    out["coords"] = (axis_index(mesh, "fibers"), axis_index(mesh, "ctrl"))
    # the sharded backup on the (2, 2) mesh, and its divisibility checks
    quad = make_problem("quadcopter")
    qgrid = quad.default_grid(backup["n"])
    v = tt_from_numpy(backup["cores"], backup["ranks"], "cpu")
    sb = make_sharded_bellman(quad, qgrid, mesh)
    out["backup"] = to_numpy(sb(v, backup["idx"], backup["controls"]))
    for key, idx, uc in (("odd_B", backup["idx"][:-1], backup["controls"]),
                         ("odd_C", backup["idx"], backup["controls"][:-1])):
        try:
            sb(v, idx, uc)
            out[key] = "no error"
        except ValueError as e:
            out[key] = str(e)
    # the fused step on the (2, 2) mesh; the padded meshes
    out["fused"] = fused_step_case(**fused, mesh=mesh)
    for shape in ((4, 1), (1, 4)):
        out[f"padded{shape}"] = fused_step_case(**padded, mesh=_gloo_mesh(shape))
    out["refined"] = fused_step_case(**padded, mesh=mesh, refine_steps=2)
    # sharded rollouts: under common noise, and from per-block seeds
    pend = make_problem("pendulum")
    pgrid = pend.default_grid(rollout["n"])
    vt = torch.as_tensor(rollout["v"])
    pol = make_implicit_policy(pend, pgrid, lambda p: multilinear_interp(pgrid, vt, p),
                               torch.as_tensor(pend.control_candidates(rollout["nc"])))
    roll = make_sharded_rollout(pend, pgrid, mesh, pol, rollout["dt"], rollout["steps"])
    x0 = torch.as_tensor(rollout["x0"])
    for key, kw in (("roll_noise", dict(noise=torch.as_tensor(rollout["noise"]))),
                    ("roll_seeds", dict(seeds=rollout["seeds"]))):
        t = roll(x0, **kw)
        out[key] = {f: to_numpy(getattr(t, f)) for f in t._fields}
    # global_mesh over the 4 ranks and a cross-rank sum of a sharded backup
    gm = global_mesh(axes=("fibers",))
    out["global_shape"] = (tuple(gm.shape), tuple(global_mesh(ctrl=2).shape))
    try:
        global_mesh(ctrl=3)
        out["ctrl3"] = "no error"
    except ValueError as e:
        out["ctrl3"] = str(e)
    tv = tt_from_numpy(total["cores"], total["ranks"], "cpu")
    vals = make_sharded_bellman(pend, pend.default_grid(total["n"]), gm)(
        tv, total["idx"], total["controls"])
    lo = axis_index(gm, "fibers") * (vals.shape[0] // 4)
    s = vals[lo:lo + vals.shape[0] // 4].sum()
    dist.all_reduce(s, group=gm.get_group("fibers"))
    out["total"] = float(s)
    _, step = fused_stepper(**{k: fused[k] for k in ("name", "n", "per_dim", "rmax")}, mesh=mesh)
    out["jax_forced"] = [_carry_fields(step(fused_carry_from_numpy(c, "cpu"), 1))
                         for c in wait_for(jax_carries)]
    return out


def multi_solve_rank_job(rank, lq, seeds, solve_kw, sharded):
    """tests/test_torch_multi_solve.py's solve_batch: over the mesh (2,) of a
    2-rank group, with this rank's instances also solved alone
    (``sharded``), or unsharded in a group of one."""
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.parallel.mesh import block
    from c3sc_tpu_torch.parallel.multi_solve import solve_batch
    from c3sc_tpu_torch.solvers import make_fused_vi

    prob = make_problem("lq", **lq["problem"])
    grid = prob.default_grid(lq["n"])
    controls = prob.control_candidates(lq["nc"])
    if not sharded:
        out = solve_batch(prob, grid, controls, seeds, rmax=lq["rmax"], device="cpu", **solve_kw)
        return dict(batch=_carry_fields(out))
    mesh = _gloo_mesh((2,), axes=("fibers",))
    out = solve_batch(prob, grid, controls, seeds, rmax=lq["rmax"], mesh=mesh, **solve_kw)
    solve, init, _, _ = make_fused_vi(prob, grid, controls, rmax=lq["rmax"], device="cpu",
                                      **solve_kw)
    lo, hi = block(mesh, "fibers", len(seeds), "instances")
    alone = {s: _carry_fields(solve(init(s))) for s in seeds[lo:hi]}
    return dict(batch=_carry_fields(out), alone=alone)
