"""Command-line driver: per-system solve + closed-loop simulation — port of
``c3sc_tpu/cli.py``, with its flags, its files and its summary's keys.

Reference analogue: the per-example ``main()`` binaries with getopt flags
(``c3sc/examples/<system>/*.c``; SURVEY.md §2.1). One registry CLI covers
every system:

    python -m c3sc_tpu_torch.cli pendulum --n 41 --solver tt --rmax 16 \\
        --rollouts 256 --steps 700 --outdir /tmp/pendulum

It runs on the CUDA device (without a card torch raises); ``--cpu`` puts
every tensor on the CPU instead. Writes: the value function (``vf.npz``,
and ``vf.c3tt`` with ``--save-format c3tt``), the fused solver's resumable
state (``solver_state.npz``), solver metrics (``metrics.jsonl``, strict
JSON), rollout trajectories (``traj.npz``) and optional plots; the files
are the JAX CLI's, and ``--load`` reads those of either package.

On the card the fused solver replays one CUDA graph an iteration when
there is no probe (``--probe 0``), as ``dense_vi`` picks graphs there; the
graph and the eager loop compute the same iterates bit for bit. Rollout
noise comes from a ``torch.Generator`` seeded with ``seed + 1`` (the JAX CLI
uses ``jax.random.key(seed + 1)``), so mean costs agree in distribution, not
bit for bit; the initial states are the JAX CLI's draws.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="c3sc_tpu_torch", description=__doc__)
    p.add_argument("system", choices=["lq", "pendulum", "dubins", "glider", "quadcopter",
                                      "quadcopter7"])
    p.add_argument("--n", type=int, default=41, help="grid nodes per dim")
    p.add_argument("--solver", choices=["dense", "tt", "pi", "fused"], default="fused")
    p.add_argument("--n-controls", type=int, default=9, help="candidates per control dim")
    p.add_argument("--rmax", type=int, default=16, help="TT rank cap")
    p.add_argument("--rmax-max", type=int, default=None,
                   help="fused solver: grow the rank cap up to this on a "
                        "saturated stall (C3 kick-rank semantics)")
    p.add_argument("--tol", type=float, default=1e-4, help="VI residual tolerance")
    p.add_argument("--cross-tol", type=float, default=1e-4)
    p.add_argument("--cross-method", choices=["cross", "dmrg"], default="cross",
                   help="tt solver: single-site kick-rank cross or two-site DMRG")
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--rollouts", type=int, default=0, help="closed-loop rollout count")
    p.add_argument("--steps", type=int, default=500, help="rollout steps")
    p.add_argument("--dt", type=float, default=0.01, help="simulation step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--load", type=str, default=None, help="load saved value fn / checkpoint")
    p.add_argument("--save-every", type=int, default=100, help="checkpoint cadence")
    p.add_argument("--save-format", choices=["npz", "c3tt"], default="npz",
                   help="value-function format: npz (padded cores) or the "
                        "compact active-rank c3tt binary (native/ "
                        "serializer, C3 function_train_save parity)")
    p.add_argument("--policy-basis", choices=["linelm", "poly"], default="linelm",
                   help="rollout policy value basis: grid linelm (default)"
                        " or an orthonormal-polynomial FT re-expansion "
                        "(C3 polynomials.c class; ops/ft.py)")
    p.add_argument("--probe", type=int, default=0,
                   help="fused solver: closed-loop probe rollouts for best-iterate harvesting")
    p.add_argument("--plot", action="store_true", help="write value/trajectory plots")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def _load_value(path: str, rmax: int, device):
    """--load for the fused solver: (resume_from, v0) from a fused
    checkpoint, a plain value file (vf.npz) or a .c3tt file."""
    from c3sc_tpu_torch.utils.checkpoint import is_fused_checkpoint, load_solver_state

    if path.endswith(".c3tt"):
        from c3sc_tpu_torch.native import tt_from_active, tt_load_binary

        return None, tt_from_active(tt_load_binary(path), rmax=rmax, device=device)
    if is_fused_checkpoint(path):
        return path, None
    return None, load_solver_state(path, device)["v"]


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from c3sc_tpu_torch.device import resolve_device, synchronize
    from c3sc_tpu_torch.models import make_problem
    from c3sc_tpu_torch.utils import MetricsLogger, save_solver_state

    device = resolve_device("cpu" if args.cpu else None)
    outdir = args.outdir or f"./out_{args.system}"
    os.makedirs(outdir, exist_ok=True)
    metrics = MetricsLogger(os.path.join(outdir, "metrics.jsonl"), echo=args.verbose >= 2)

    prob = make_problem(args.system)
    grid = prob.default_grid(args.n)
    controls = prob.control_candidates(args.n_controls)
    t0 = time.time()

    if args.solver == "dense":
        from c3sc_tpu_torch.ops.interp import multilinear_interp
        from c3sc_tpu_torch.solvers import dense_vi

        if prob.dx > 3:
            raise SystemExit("dense solver supports dx <= 3; use --solver tt")
        sol = dense_vi(prob, grid, controls=controls, tol=args.tol, verbose=args.verbose >= 1,
                       device=device)
        np.savez(os.path.join(outdir, "vf.npz"), v=sol.v.cpu().numpy())
        value_fn = lambda pts: multilinear_interp(grid, sol.v, pts)  # noqa: E731
        summary = dict(solver="dense", residual=float(sol.residual), sweeps=sol.sweeps)
    else:
        from c3sc_tpu_torch.ops.tt import tt_lerp_eval

        ckpt = os.path.join(outdir, "vf.npz")
        common = dict(controls=controls, rmax=args.rmax, seed=args.seed, tol=args.tol,
                      metrics=metrics, device=device)
        if args.solver == "fused":
            from c3sc_tpu_torch.solvers.fused import fused_tt_vi

            # --load takes a fused checkpoint (solver_state.npz: resume
            # mid-VI), a plain value file (vf.npz) or a .c3tt file (warm v0)
            resume_from, v0 = (None, None) if not args.load else _load_value(
                args.load, args.rmax, device)
            sol = fused_tt_vi(prob, grid, max_iters=args.max_iters, rmax_max=args.rmax_max,
                              probe_rollouts=args.probe, probe_dt=args.dt,
                              checkpoint_path=os.path.join(outdir, "solver_state.npz"),
                              checkpoint_every=args.save_every, resume_from=resume_from, v0=v0,
                              cuda_graph=device.type == "cuda" and args.probe == 0, **common)
            save_solver_state(ckpt, sol.v, None, sol.iterations)
            summary = dict(solver="fused", residual=float(sol.residual),
                           iterations=sol.iterations,
                           ranks=[int(r) for r in sol.v.ranks.tolist()],
                           wall=round(sol.wall_time, 2))
        elif args.solver == "tt":
            from c3sc_tpu_torch.solvers.ttvi import tt_vi

            sol = tt_vi(prob, grid, max_iters=args.max_iters, checkpoint_path=ckpt,
                        checkpoint_every=args.save_every, resume_from=args.load,
                        cross_method=args.cross_method, cross_tol=args.cross_tol,
                        verbose=args.verbose >= 1, **common)
            summary = dict(solver="tt", residual=float(sol.residual),
                           iterations=sol.iterations, evals=sol.n_evals,
                           ranks=sol.ranks[-1], wall=round(sol.wall_time, 2))
        else:
            from c3sc_tpu_torch.solvers.ttpi import tt_pi

            sol = tt_pi(prob, grid, outer_iters=args.max_iters, cross_tol=args.cross_tol,
                        verbose=args.verbose >= 1, **common)
            save_solver_state(ckpt, sol.v, None, sol.outer_iters)
            summary = dict(solver="pi", residual=float(sol.residual),
                           outer_iters=sol.outer_iters, evals=sol.n_evals,
                           wall=round(sol.wall_time, 2))
        if args.save_format == "c3tt":
            from c3sc_tpu_torch.native import tt_save_binary, tt_to_active

            tt_path = os.path.join(outdir, "vf.c3tt")
            route = tt_save_binary(tt_path, tt_to_active(sol.v))
            summary["c3tt_file"] = tt_path
            summary["c3tt_native"] = route == "native"
        if args.policy_basis == "poly":
            from c3sc_tpu_torch.ops.ft import ft_eval, ft_from_tt

            ft = ft_from_tt(sol.v, grid)
            value_fn = lambda pts: ft_eval(ft, pts)  # noqa: E731
        else:
            value_fn = lambda pts: tt_lerp_eval(sol.v, grid, pts)  # noqa: E731

    summary["solve_wall_s"] = round(time.time() - t0, 2)

    if args.rollouts > 0:
        from c3sc_tpu_torch.sim import make_implicit_policy, rollout

        policy = make_implicit_policy(prob, grid, value_fn, controls)
        rng = np.random.default_rng(args.seed)
        lb, ub = np.asarray(prob.lb), np.asarray(prob.ub)
        mid, span = (lb + ub) / 2, (ub - lb) / 2
        x0 = torch.as_tensor(mid + 0.5 * span * rng.uniform(-1, 1, (args.rollouts, prob.dx)),
                             dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        synchronize(device)
        t1 = time.time()
        with torch.no_grad():
            traj = rollout(prob, grid, policy, x0, args.dt, args.steps, generator=gen)
        synchronize(device)
        rollout_wall = time.time() - t1
        np.savez(os.path.join(outdir, "traj.npz"), xs=traj.xs.cpu().numpy(),
                 us=traj.us.cpu().numpy(), cost=traj.cost.cpu().numpy(),
                 exit_time=traj.exit_time.cpu().numpy())
        summary.update(rollouts=args.rollouts, mean_cost=float(traj.cost.mean()),
                       rollout_wall_s=round(rollout_wall, 2))

    if args.plot:
        _plot(outdir, prob, grid, value_fn, device)

    metrics.log("summary", **summary)
    metrics.close()
    print(json.dumps({"system": args.system, **summary}))
    return summary


def _plot(outdir, prob, grid, value_fn, device):
    """Value-slice heatmap + trajectory overlay (reference: per-example
    Python matplotlib scripts, SURVEY.md §2.1)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import torch

    n0, n1 = grid.shape[0], grid.shape[1]
    A, Bm = np.meshgrid(grid.nodes(0), grid.nodes(1), indexing="ij")
    mid = [(lo + hi) / 2 for lo, hi in zip(prob.lb, prob.ub)]
    pts = np.tile(np.asarray(mid), (n0 * n1, 1))
    pts[:, 0] = A.ravel()
    pts[:, 1] = Bm.ravel()
    with torch.no_grad():
        v = value_fn(torch.as_tensor(pts, dtype=torch.float32, device=device))
    v = v.cpu().numpy().reshape(n0, n1)
    fig, ax = plt.subplots(figsize=(6, 5))
    pc = ax.pcolormesh(A, Bm, v, shading="auto")
    fig.colorbar(pc, ax=ax, label="value")
    ax.set_xlabel("x0")
    ax.set_ylabel("x1")
    ax.set_title(f"{prob.name}: value slice (dims 0,1)")
    tpath = os.path.join(outdir, "traj.npz")
    if os.path.exists(tpath):
        xs = np.load(tpath)["xs"]
        for b in range(min(16, xs.shape[1])):
            ax.plot(xs[:, b, 0], xs[:, b, 1], lw=0.7, alpha=0.7, c="w")
    fig.savefig(os.path.join(outdir, "value.png"), dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
