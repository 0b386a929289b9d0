"""Shared pieces of the port's tests (``tests/test_torch_*.py``).

Importing this module pins torch to ONE intra-op thread. The suite runs
under pytest-xdist with several workers; torch's default of one thread per
core in every worker oversubscribes the machine, and a solve that takes
seconds alone then takes minutes. Every port test file imports this module
first, so the pin holds before any tensor work.

Only torch and numpy are imported here: the card-only tests run on a
machine without JAX.
"""

import os

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
