"""Operations and bytes of kernel K1's structured sweeps (the dense improve
over every candidate, and the evaluate under a fixed policy) on a uniform
grid, from the configuration's shapes alone: N nodes, d dims, du controls,
C candidates and the count of nodes on absorbing faces, where the evaluate
only copies the pinned value.

Bytes count each input once and each output once: per node the drift's
x-only part f0 [d], its control matrix G [d, du], the variances s2 [d], the
state cost q, the terminal flag (1 byte) and value, and v (4 bytes each);
the improve writes the new value and the argmin (8 bytes), the evaluate the
new value and reads the policy (8 bytes); per candidate its controls and
cost r. Operations count the factored form of the sweep (a node's f0/h,
G/h, a, Q0, A0 once; per candidate fh, Q, S, then dt, exp and the sum).
"""

from __future__ import annotations

from benchmark.roofline.peaks import bound_s


def terminal_nodes(n: int, d: int, absorbing_dims: int) -> int:
    """Nodes of an n^d grid on a face of any of ``absorbing_dims`` dims."""
    return n ** d - (n - 2) ** absorbing_dims * n ** (d - absorbing_dims)


def sweep_work(N: int, d: int, du: int, C: int, n_term: int) -> dict:
    """{entry: (bytes, float32 operations)} of one improve and one evaluate."""
    node_in = 4 * (d + d * du + d + 1) + 1 + 4 + 4
    cand = 4 * C * (du + 1)
    per_node = d * (7 + du) + 1
    per_cand = d * (2 * du + 3) + 8
    return {
        "dense_backup": (N * (node_in + 8) + cand, N * (per_node + C * per_cand)),
        "dense_evaluate": ((N - n_term) * (node_in + 8) + n_term * 9 + cand,
                           (N - n_term) * (per_node + per_cand)),
    }


def sweep_bounds_s(N: int, d: int, du: int, C: int, n_term: int) -> dict:
    """{entry: least seconds a sweep could take on the card}."""
    return {name: bound_s(b, f) for name, (b, f) in sweep_work(N, d, du, C, n_term).items()}


def config_bounds_s(cfg: dict) -> dict:
    """``sweep_bounds_s`` at a configuration's grid and candidates, on the
    shape of its model (``benchmark/models/<model>.py``)."""
    from benchmark.reference.bellman import ABSORB
    from benchmark.run import module

    model = module("models", cfg["model"]).reference(cfg)
    n, d, du = cfg["grid_n"], model.dx, model.du
    absorbing = sum(kind == ABSORB for kind in model.boundary)
    return sweep_bounds_s(n ** d, d, du, cfg["candidates_per_axis"] ** du,
                          terminal_nodes(n, d, absorbing))
