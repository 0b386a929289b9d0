"""Each cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
same configuration and traffic files with smaller grids, ranks and batches."""

import copy

import torch

from benchmark.run import load_cell

CPU = torch.device("cpu")
SMALL_CFG = {"fused": dict(grid_n=5, rmax=4, cuda_graph=False), "dense": dict(grid_n=5)}
SMALL_MIX = {"vi": dict(warm_iterations=20, iterations_per_call=2, trace_calls=2,
                        trace_iterations_per_call=2),
             "mpc": dict(cold_iterations=20, scenarios=16, steps_per_segment=5, max_cycles=400,
                         trace_cycles=2, checked_cycles=3),
             "rollout": dict(scenarios=64, steps=20, warm_steps=2, checked_scenarios=16)}


def small(name: str):
    """(configuration, traffic mix) of cell ``name`` at the CPU's size."""
    _, _, cfg, mix, _ = load_cell(name)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg.update(SMALL_CFG[cfg["solver"]])
    mix.update(SMALL_MIX[mix["kind"]])
    return cfg, mix
