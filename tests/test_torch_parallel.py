"""The port's device meshes and sharded paths (c3sc_tpu_torch.parallel and
make_fused_vi(mesh=)) on the CPU, against the JAX package and against the
port's unsharded paths.

The multi-rank part is ONE spawn of 4 gloo ranks for the whole module
(``torch_port_testing.Ranks``, the children import no JAX); a rank that
fails raises here, and ranks still running 120 s after the start fail the
test and are killed. The (2, 2) mesh puts ranks (0, 1) and (2, 3) on the
two 'fibers' blocks and each pair on the two 'ctrl' blocks.

Bars, each stated at its test:
  the sharded backup against JAX's make_bellman_kernel: rtol 1e-4, atol 1e-5
      (tests/test_parallel.py's); against the port's unsharded kernel: equal;
  the sharded fused step against JAX's unsharded one at tests/test_parallel.py's
      configuration, one sharded step from each of JAX's 8 carries:
      tests/test_parallel.py's bars (ranks equal exactly, v_sample and the
      TT within 1e-3 x scale, residual rtol 1e-3);
  the sharded fused step against the port's unsharded one, 8 (or 3) chained
      iterations: every field of the carry equal on every rank, bit for bit
      (the gap measured on 4 gloo ranks is 0: MIN and gathers are exact);
  sharded rollouts: equal to rollout's, bit for bit;
  a world of one (this process): every sharded path equal to the unsharded
      one bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_testing as tpt
from torch_port_testing import close, port_grid, random_v, to_numpy

import jax
import jax.numpy as jnp

from c3sc_tpu import models as jm
from c3sc_tpu.ops.tt import TT as JTT
from c3sc_tpu.ops.tt import tt_random as j_tt_random
from c3sc_tpu.solvers import fused as jf
from c3sc_tpu.solvers.ttvi import make_bellman_kernel as j_bellman_kernel
from c3sc_tpu_torch import models as tm
from c3sc_tpu_torch.convert import tt_from_numpy
from c3sc_tpu_torch.ops.interp import multilinear_interp
from c3sc_tpu_torch.parallel import make_mesh, make_sharded_bellman, make_sharded_rollout
from c3sc_tpu_torch.parallel.distributed import global_mesh, initialize_distributed
from c3sc_tpu_torch.sim import make_implicit_policy, rollout
from c3sc_tpu_torch.solvers import make_fused_vi
from c3sc_tpu_torch.solvers.ttvi import bellman_backup, make_bellman_kernel

FUSED = dict(name="quadcopter", n=7, per_dim=(8, 2), rmax=4, iters=8, seed=2)  # C = 16
# a block of 5 x 21 x 5 = 525 rows pads on 4 'fibers' ranks; 9 candidates pad
# on 4 (and, refined, on 2) 'ctrl' ranks
PADDED = dict(name="pendulum", n=21, per_dim=9, rmax=5, iters=3, seed=0)


def _pendulum_rollout(ro):
    tp = tm.make_pendulum_problem()
    grid = tp.default_grid(ro["n"])
    v = torch.as_tensor(ro["v"])
    pol = make_implicit_policy(tp, grid, lambda p: multilinear_interp(grid, v, p),
                               torch.as_tensor(tp.control_candidates(ro["nc"])))
    return tp, grid, pol


@pytest.fixture(scope="module")
def inputs():
    jq = jm.make_quadcopter_problem()
    jv = j_tt_random(jax.random.key(0), jq.default_grid(9).shape, (1, 3, 4, 4, 4, 3, 1), rmax=6)
    rng = np.random.default_rng(2)
    qidx = np.stack([rng.integers(0, 9, size=64) for _ in range(6)], -1).astype(np.int32)
    tp = tm.make_pendulum_problem()
    pcores, pranks = tpt.random_tt_numpy((21, 21), (4,), 6)
    rng = np.random.default_rng(0)
    lb, ub = np.asarray(tp.lb), np.asarray(tp.ub)
    steps = 50
    return dict(
        backup=dict(n=9, cores=[np.asarray(c) for c in jv.cores], ranks=np.asarray(jv.ranks),
                    idx=qidx, controls=np.asarray(jq.control_candidates((8, 2)), np.float32)),
        fused=FUSED, padded=PADDED,
        rollout=dict(n=21, nc=5, dt=0.01, steps=steps, v=random_v((21, 21), 3),
                     x0=(lb + (ub - lb) * rng.uniform(0.2, 0.8, (64, 2))).astype(np.float32),
                     noise=rng.standard_normal((steps, 64, tp.dw)).astype(np.float32),
                     seeds=list(range(100, 164))),
        total=dict(n=21, cores=pcores, ranks=pranks,
                   idx=np.stack([rng.integers(0, 21, 64) for _ in range(2)], -1),
                   controls=np.asarray(tp.control_candidates(5), np.float32)))


@pytest.fixture(scope="module")
def guard_ranks(tmp_path_factory):
    """test_a_failed_or_hung_rank_fails_the_test's ranks: a group of 2 whose
    rank 0 fails, and a rank that never returns. They start with the
    module's ranks, so that their start-up overlaps the references."""
    runs = (tpt.Ranks(tpt.stuck_job, 2, tmp_path_factory.mktemp("fail"), fail_rank=0),
            tpt.Ranks(tpt.stuck_job, 1, tmp_path_factory.mktemp("hang")))
    yield runs
    for run in runs:
        run.kill()


@pytest.fixture(scope="module")
def started(inputs, guard_ranks, tmp_path_factory):
    """The 4 ranks, started once for the module; they run while ``refs``
    computes the references here, and wait last for JAX's carries."""
    out_dir = tmp_path_factory.mktemp("ranks")
    run = tpt.Ranks(tpt.parallel_rank_job, 4, out_dir, jax_carries=str(out_dir / "jax.pkl"),
                    **inputs)
    run.jax_carries = str(out_dir / "jax.pkl")
    yield run
    run.kill()


def _jax_fused_chain(hand_to):
    """JAX's unsharded fused solver at FUSED's configuration (the one
    tests/test_parallel.py shards): its carries after 0..8 single steps
    from init_fn(key(2)), as numpy fields; those after 0..7 are handed to
    the ranks at ``hand_to``."""
    jq = jm.make_quadcopter_problem()
    s = jf.make_fused_vi(jq, jq.default_grid(FUSED["n"]), jq.control_candidates(FUSED["per_dim"]),
                         rmax=FUSED["rmax"], tol=0.0, max_iters=10**9)
    chain = [s.init_fn(jax.random.key(FUSED["seed"]))]
    for _ in range(FUSED["iters"]):
        chain.append(s.step_fn(chain[-1], 1))
    chain = [{k: ([np.asarray(c) for c in v] if isinstance(v, tuple) else np.asarray(v))
              for k, v in c._asdict().items()} for c in chain]
    tpt.write_for_ranks(hand_to, chain[:-1])
    return chain


@pytest.fixture(scope="module")
def refs(inputs, started):
    """The references in this process: JAX's fused carries (handed to the
    ranks first) and backup kernel, and the port's unsharded backup, fused
    steps, rollouts and sum."""
    # JAX's compile of the fused step takes most of this file's time: it runs
    # in a thread while the rest is computed here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        chain = pool.submit(_jax_fused_chain, started.jax_carries)
        out = _other_refs(inputs)
        out["jax_chain"] = chain.result()
    return out


def _other_refs(inputs):
    """Every reference but JAX's fused carries."""
    out = {}
    b, ro, t = inputs["backup"], inputs["rollout"], inputs["total"]
    jq = jm.make_quadcopter_problem()
    jgrid = jq.default_grid(b["n"])
    jv = JTT(tuple(jnp.asarray(c) for c in b["cores"]), jnp.asarray(b["ranks"]))
    out["jax_backup"] = np.asarray(j_bellman_kernel(jq, jgrid, b["controls"], chunk=64)(
        jv, jnp.asarray(b["idx"])))
    out["backup"] = to_numpy(make_bellman_kernel(tm.make_quadcopter_problem(), port_grid(jgrid),
                                                 b["controls"], chunk=64)(
        tt_from_numpy(b["cores"], b["ranks"], "cpu"), b["idx"]))
    out["fused"] = tpt.fused_step_case(**FUSED)
    out["padded(4, 1)"] = out["padded(1, 4)"] = tpt.fused_step_case(**PADDED)
    out["refined"] = tpt.fused_step_case(**PADDED, refine_steps=2)
    tp, grid, pol = _pendulum_rollout(ro)
    x0 = torch.as_tensor(ro["x0"])
    out["roll_noise"] = rollout(tp, grid, pol, x0, ro["dt"], ro["steps"],
                                noise=torch.as_tensor(ro["noise"]))
    out["roll_seeds"] = [rollout(tp, grid, pol, x0[lo:lo + 32], ro["dt"], ro["steps"],
                                 generator=torch.Generator().manual_seed(ro["seeds"][lo]))
                         for lo in (0, 32)]
    out["total"] = float(bellman_backup(tp, tp.default_grid(t["n"]), torch.as_tensor(t["controls"]),
                                        tt_from_numpy(t["cores"], t["ranks"], "cpu"),
                                        torch.as_tensor(t["idx"], dtype=torch.int64)).sum())
    return out


@pytest.fixture(scope="module")
def ranks(refs, started):
    """Every rank's results, in rank order (a failed or hung rank raises)."""
    return started.results()


def test_sharded_backup_matches_jax_and_unsharded(refs, ranks):
    """quadcopter 9^6, C = 16, B = 64 on the (2, 2) mesh."""
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        close(r["backup"], refs["jax_backup"], rtol=1e-4, atol=1e-5)
        # the min of a row's candidate-block minima is the row's min: equal
        np.testing.assert_array_equal(r["backup"], refs["backup"])
        assert "does not divide" in r["odd_B"] and "does not divide" in r["odd_C"]


def _tt_full(cores, ranks):
    """The full tensor of a TT from its padded cores."""
    t = cores[0][:ranks[0]]
    for c in cores[1:]:
        t = np.tensordot(t, c, axes=([-1], [0]))
    return t[..., :ranks[-1]].squeeze(0).squeeze(-1)


def test_sharded_fused_steps_match_jax(refs, ranks):
    """quadcopter 7^6, C = 16, rmax 4 on the (2, 2) mesh: one sharded step
    from each of JAX's carries after 0..7 steps from init_fn(key(2)) against
    JAX's next carry, at tests/test_parallel.py's bars. The TT is held as its
    full 7^6 tensor rather than core by core: a maxvol tie that the two
    packages break differently changes a core's basis and not the TT
    (measured, unsharded: the TT within 1.8e-5 x scale at every step, a core
    off by 7.5e-2 x scale after the first). Chained steps drift apart
    through such ties (4.3e-2 x scale after 8), so each step starts from
    JAX's carry."""
    for r in ranks:
        assert len(r["jax_forced"]) == FUSED["iters"]
        for got, want in zip(r["jax_forced"], refs["jax_chain"][1:]):
            for key in ("ranks", "rl", "rr", "it"):
                np.testing.assert_array_equal(got[key], want[key])
            scale = float(np.abs(want["v_sample"]).max()) or 1.0
            close(got["v_sample"], want["v_sample"], rtol=0, atol=1e-3 * scale)
            close(got["residual"], want["residual"], rtol=1e-3, atol=1e-6)
            full = _tt_full(want["cores"], want["ranks"])
            close(_tt_full(got["cores"], got["ranks"]), full, rtol=0,
                  atol=1e-3 * (float(np.abs(full).max()) or 1.0))


@pytest.mark.parametrize("case", ["fused", "padded(4, 1)", "padded(1, 4)", "refined"])
def test_sharded_fused_step_matches_unsharded(refs, ranks, case):
    """fused: 8 step_fn iterations, quadcopter 7^6, C = 16, rmax 4, seed 2,
    on the (2, 2) mesh. The pendulum 21^2 (rmax 5, 9 candidates, 3
    iterations) with its 525-row blocks padded on the (4, 1) mesh, its
    candidates on (1, 4), and refined (refine_steps=2: the RHS gathered over
    'ctrl') on (2, 2). Each against the unsharded solver: every field of the
    carry (ranks, index sets, pivot rows, it, v_sample, residual, cores)
    equal on every rank, bit for bit."""
    want = refs[case]
    for r in ranks:
        got = r[case]
        assert got.keys() == want.keys()
        for key in want:
            for a, b in zip(*((x[key] if key == "cores" else [x[key]]) for x in (got, want))):
                np.testing.assert_array_equal(a, b)


def test_sharded_rollout_matches_rollout(refs, ranks):
    """64 pendulum scenarios over 2 'fibers' blocks: under common noise equal
    to the unsharded rollout; from seeds, each block equal to rollout from a
    generator seeded with the block's first seed."""
    want = refs["roll_noise"]
    for r in ranks:
        for f in want._fields:
            np.testing.assert_array_equal(r["roll_noise"][f], to_numpy(getattr(want, f)))
    for blk, part in enumerate(refs["roll_seeds"]):
        lo, hi = 32 * blk, 32 * (blk + 1)
        for f in part._fields:
            got = ranks[0]["roll_seeds"][f]
            got = got[lo:hi] if f in ("cost", "exit_time") else got[:, lo:hi]
            np.testing.assert_array_equal(got, to_numpy(getattr(part, f)))


def test_global_mesh_and_cross_rank_sum(refs, ranks):
    """tests/test_distributed.py's check without ``slow``: a sharded backup
    over global_mesh(('fibers',)) and a SUM over the 4 ranks agree on every
    rank (and with the unsharded sum)."""
    totals = [r["total"] for r in ranks]
    assert np.all(np.isfinite(totals)) and len(set(totals)) == 1
    assert totals[0] == pytest.approx(refs["total"], rel=1e-5)
    for r in ranks:
        assert r["global_shape"] == ((4,), (2, 2))
        assert "does not divide" in r["ctrl3"]


def test_a_failed_or_hung_rank_fails_the_test(guard_ranks):
    """The guard of the multi-rank tests: a rank's exception is raised at
    once while its peer still runs, ranks that never return fail after the
    time limit, and no rank outlives ``results()``."""
    failing, hung = guard_ranks
    with pytest.raises(RuntimeError, match="rank 0 failed(.|\n)*fails on purpose"):
        failing.results()
    with pytest.raises(TimeoutError, match="still running after 1 s"):
        hung.results(timeout=1)
    assert not any(p.is_alive() for p in failing.procs + hung.procs)


@pytest.fixture
def world_of_one():
    """No process group in this process, and no torchrun environment; the
    group the test starts is destroyed after it."""
    with tpt.no_process_group():
        yield


def test_world_of_one_equals_unsharded(world_of_one):
    """make_mesh() with no group starts a world of one (gloo on the CPU);
    on it the sharded backup, rollout and fused step equal the unsharded
    ones bit for bit. initialize_distributed without arguments does nothing."""
    initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("fibers", "ctrl")
    initialize_distributed("127.0.0.1:1", 2, 0, device="cpu")    # a group exists: nothing
    tp = tm.make_quadcopter_problem()
    grid = tp.default_grid(5)
    cores, rk = tpt.random_tt_numpy(grid.shape, (3, 4, 4, 4, 3), 6, seed=1)
    v = tt_from_numpy(cores, rk, "cpu")
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(np.stack([rng.integers(0, n, 48) for n in grid.shape], -1))
    uc = torch.as_tensor(tp.control_candidates((4, 2)), dtype=torch.float32)
    assert torch.equal(make_sharded_bellman(tp, grid, mesh)(v, idx, uc),
                       bellman_backup(tp, grid, uc, v, idx))
    ro = dict(n=21, nc=5, v=random_v((21, 21), 4))
    pend, pgrid, pol = _pendulum_rollout(ro)
    x0 = torch.as_tensor(np.random.default_rng(6).uniform(-1, 1, (16, 2)), dtype=torch.float32)
    noise = torch.as_tensor(np.random.default_rng(7).standard_normal((20, 16, pend.dw)),
                            dtype=torch.float32)
    got = make_sharded_rollout(pend, pgrid, mesh, pol, 0.01, 20)(x0, noise=noise)
    want = rollout(pend, pgrid, pol, x0, 0.01, 20, noise=noise)
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in want._fields)
    lq = tm.make_problem("lq")
    lgrid = lq.default_grid(11)
    runs = [make_fused_vi(lq, lgrid, lq.control_candidates(5), rmax=4, tol=0.0, max_iters=10**9,
                          device="cpu", mesh=m) for m in (None, mesh)]
    a, b = (s.step_fn(s.init_fn(1), 3) for s in runs)
    for x, y in zip(a, b):
        for p, q in zip(x, y) if isinstance(x, tuple) else ((x, y),):
            assert torch.equal(p, q)


def test_mesh_shapes_and_devices_raise(world_of_one):
    """A shape that is not the world's, or does not name the axes, raises; a
    gloo group cannot run a CUDA mesh; and with no group, a CUDA mesh on a
    machine without a card raises and leaves no group behind (nothing falls
    back to gloo). On a machine with a card make_mesh() starts NCCL: that is
    chip_smoke.py's phase L."""
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            make_mesh()                       # the default device is the card
        assert not dist.is_initialized()
    make_mesh(device="cpu")
    with pytest.raises(ValueError, match="#devices 1"):
        make_mesh(shape=(2, 2))
    with pytest.raises(ValueError, match="does not name"):
        make_mesh(axes=("fibers", "ctrl"), shape=(1,))
    with pytest.raises(ValueError, match="cannot run a mesh of cuda"):
        make_mesh(device="cuda")
    dist.destroy_process_group()
    with pytest.raises(ValueError, match="needs num_processes"):
        initialize_distributed("127.0.0.1:1", device="cpu")
    with pytest.raises(ValueError, match="need a coordinator_address"):
        initialize_distributed(num_processes=2, process_id=0, device="cpu")
    assert not dist.is_initialized()
    make_mesh(device="cpu")
    assert tuple(global_mesh().shape) == (1, 1)
