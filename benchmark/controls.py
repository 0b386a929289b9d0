"""The controls of the checks: what each cell's numbers read when the timed
path runs one precision below the configuration's float32. A limit stands
between the readings of sound runs and these.

    python benchmark/controls.py --workload <cell> --seeds 11,12,13 [--seconds 10]

on a CUDA card, from the root of a checkout. Each cell's runner says what
its control is (its ``control`` method). For a fused cell the program runs
its window as the cell runs it, and then the plain reference in float32
with TF32 products (inputs rounded to 10-bit mantissas) takes the program's
place in the iterations and segments the check reads, from the program's
own state before them. (The program run with PyTorch's TF32 switch on read
as the sound program does on one of two seeds: the switch does not reach
every product.) For a dense cell the program's place is taken by the plain
reference in bfloat16: the whole dense solve (as many outer sweeps as the
program's solve took), and for rollouts the closed loops of the checked
scenarios on the program's value rounded to bfloat16. Prints one JSON line
a seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control(cfg: dict, mix: dict, seed: int, seconds: float, dev):
    """(the numbers of the control of a cell of this configuration and mix on
    ``seed``, what its runner put on the info line)."""
    from benchmark.runners import make_runner

    return make_runner(cfg, mix, seed, dev).control(seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import cache_dirs, load_cell

    cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("the controls run on a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    _, _, cfg, mix, limits = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, info = control(cfg, mix, seed, args.seconds, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "limits": limits, "info": info}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
