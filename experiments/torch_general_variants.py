"""K1's compiled general improve and structured non-uniform sweeps in several
source variants, side by side on one card.

The companion of ``experiments/torch_wide_variants.py``, whose helpers it
uses: each variant is a copy of ``c3sc_tpu_torch/`` (with ``chip_smoke.py``
and ``tests/``) under ``.chip_scratch/general_variants/<name>/``, its
``csrc/dense_backup.cuh`` changed by the textual patches below (joined by
``+`` in its name), all built at once (one ``nvcc`` process each). The
script prints the ptxas lines (registers, stack frame, spills) of the
compiled general improve and of the structured non-uniform kernels. Then, in
each variant of ``--order`` in turn (``parent`` first and last; repeated
names measure the spread), it times as CUDA graphs of 100 launches, against
their byte bounds (``chip_smoke.py``'s): the compiled general improve with
the policy's epilogue (``dense_vi``'s call) at the rule's lanes, and where
the tree has the ``_lanes`` switch at forced lane counts, beside the
run-time-d kernel of the same grid (``_runtime_d``), on the glider's (15,
11, 11, 11) (uniform and tanh, 9 candidates), the du = 5 double integrator
at 201^2 (243 candidates, without and with its declarations), eight states
at 6^8 (3 candidates, both grids) and the glider at 41^4; and the
structured improve and evaluate on the quadcopter at 11^6 and quadcopter7
at 9^7 (25 candidates, tanh and uniform grids). Timing only: ``--pytest
NAME:EXPR`` runs ``tests/test_torch_kernels.py -k EXPR`` in a variant,
``--smoke NAME:PHASE`` its ``chip_smoke.py --phases PHASE``,
``--same-sass A,B`` compares the SASS of every kernel the two variants'
libraries share and lists those that differ (two of them in full), ``--sass NAME:PATTERN`` writes
the SASS of the kernels whose mangled name matches. Logs, the times as JSON
and ``summary.txt`` go to ``general_variants/`` beside the wide script's
output directory.

Variants: ``parent`` (an unpacked checkout given by ``--parent``, as it
is), ``new`` (this tree) and this tree patched: ``nupipe`` (the
non-uniform general improve pipelined too), ``nopipe`` (no pipelining),
``rtl`` (the uniform general improve takes its lane count at run time at
every count), ``nulb4`` (the structured non-uniform improve's launch bounds
ask for 4 blocks an SM), ``evown`` (the structured non-uniform evaluate
issues the node's own loads before the decode's), ``impdec`` (the
structured non-uniform improve issues the decode's before its own),
``evlb5`` (the structured non-uniform evaluate's launch bounds ask for 5
blocks an SM), ``ld32`` (the structured non-uniform sweeps load f0, G and
s2 with 32-bit offsets), ``nuun1`` and ``nuun2``
(the structured non-uniform improve's candidate loop unrolled once or
twice instead of 4 times).

    python3 experiments/torch_general_variants.py --parent DIR \\
        --order parent,new,rtl,new,parent --same-sass parent,new \\
        --pytest "new:lanes or runtime_d or nonuniform"

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_wide_variants as tw  # noqa: E402

REPO = tw.REPO
ROOT = REPO / ".chip_scratch" / "general_variants"
OUT = tw.OUT.parent / "general_variants"   # beside the wide script's output
# the kernels whose ptxas lines the summary shows: the compiled general
# improve, and the structured kernels' non-uniform form at (d, du) = (6, 2),
# (6, 4) and (7, 2)
PTXAS = (r"(?<=\d)dense_backup_general_kernel"
         r"|(?<=\d)dense_(?:backup|evaluate)_kernel(?=ILi(?:6ELi[24]|7ELi2)ELi1E)")


def patch_nupipe(s):
    """The non-uniform general improve pipelined as the uniform one is."""
    return tw._replace(s, "constexpr bool kGeneralPipelined = NU == kUniform;",
                       "constexpr bool kGeneralPipelined = true;")


def patch_nopipe(s):
    """No pipelining of the general improve's candidate loop."""
    return tw._replace(s, "constexpr bool kGeneralPipelined = NU == kUniform;",
                       "constexpr bool kGeneralPipelined = false;")


def patch_rtl(s):
    """The uniform improve at every lane count takes it at run time too."""
    return tw._replace(s, "if (NU == kNonuniform || (1 << c.lane_bits) > kCompiledLanes)",
                       "if (true)")


def patch_nulb4(s):
    """The structured non-uniform improve held to 4 blocks of 256 threads an
    SM (64 registers a thread) by its launch bounds."""
    return tw._replace(s, "template <int D, int DU, int NU, typename Idx>\n"
                          "__global__ void __launch_bounds__(kBlock)\ndense_backup_kernel(",
                       "template <int D, int DU, int NU, typename Idx>\n"
                       "__global__ void __launch_bounds__(kBlock, NU == kNonuniform ? 4 : 1)\n"
                       "dense_backup_kernel(")


def patch_evown(s):
    """The structured non-uniform evaluate issues the node's own loads before
    the decode's."""
    return tw._replace(s, "load_node_nonuniform<D, DU, Idx, false>(n, N, v, op, g, 0,",
                       "load_node_nonuniform<D, DU, Idx, true>(n, N, v, op, g, 0,")


def patch_ld32(s):
    """The structured non-uniform sweeps load f0, G and s2 with 32-bit
    offsets (Idx) where N < 2^31."""
    s = tw._replace(s, "t.f0h[j] = op.f0[j * N + n];", "t.f0h[j] = op.f0[(Idx)j * (Idx)N + n];")
    s = tw._replace(s, "t.Gh[j][m] = op.G[(j * DU + m) * N + n];",
                    "t.Gh[j][m] = op.G[(Idx)(j * DU + m) * (Idx)N + n];")
    return tw._replace(s, "s2[j] = op.s2[j * N + n];", "s2[j] = op.s2[(Idx)j * (Idx)N + n];")


def patch_impdec(s):
    """The structured non-uniform improve issues the decode's loads first."""
    return tw._replace(s, "load_node_nonuniform<D, DU, Idx, true>(n, N, v, op, g, clip,",
                       "load_node_nonuniform<D, DU, Idx, false>(n, N, v, op, g, clip,")


def patch_evlb5(s):
    """The structured non-uniform evaluate held to 5 blocks of 256 threads an
    SM (48 registers a thread) by its launch bounds."""
    return tw._replace(s, "template <int D, int DU, int NU, typename Idx>\n"
                          "__global__ void __launch_bounds__(kBlock)\ndense_evaluate_kernel(",
                       "template <int D, int DU, int NU, typename Idx>\n"
                       "__global__ void __launch_bounds__(kBlock, NU == kNonuniform ? 5 : 1)\n"
                       "dense_evaluate_kernel(")


def _nu_unroll(k):
    def patch(s):
        loop = "\n      for (int c = 0; c < cn; ++c) {"
        return tw._replace(s, "#pragma unroll 4" + loop,
                           f"#pragma unroll(NU == kNonuniform ? {k} : 4)" + loop)
    patch.__doc__ = f"""The structured non-uniform improve's candidate loop unrolled {k} times
    (the uniform one 4)."""
    return patch


PATCHES = {"nupipe": patch_nupipe, "nopipe": patch_nopipe, "rtl": patch_rtl, "nulb4": patch_nulb4,
           "evown": patch_evown, "impdec": patch_impdec, "evlb5": patch_evlb5, "ld32": patch_ld32,
           "nuun1": _nu_unroll(1), "nuun2": _nu_unroll(2)}


def time_here(out_path):
    """In a variant's directory: ms a sweep (CUDA graph of 100 launches) of
    the compiled general improve with the policy's epilogue at the rule's
    lanes and at forced ones, of the run-time-d improve on the same grid,
    and of the structured improve and evaluate on non-uniform and uniform
    grids, each with its byte bound (the spacing tables counted)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from c3sc_tpu_torch import models as tm
    from c3sc_tpu_torch.ops import dense_backup as db

    card = cs.phase_a_environment()
    rec = {"card": card}

    def value(shape):
        return torch.as_tensor(np.random.default_rng(0).uniform(0, 5, shape),
                               dtype=torch.float32, device=cs.DEVICE)

    def table(grid):
        return 0 if grid.uniform else 4 * 5 * sum(grid.shape)

    glider = tm.make_problem("glider")
    general = [("glider 15x11x11x11", glider, (15, 11, 11, 11), 9, False, (1, 2, 4, 8)),
               ("glider 15x11x11x11 tanh", glider, (15, 11, 11, 11), 9, True, (1, 2, 4, 8)),
               ("du5 201^2", cs.double_integrator_du5(), (201, 201), 3, False, (1, 4, 8, 16, 32)),
               ("du5 declared 201^2", cs.double_integrator_du5(True), (201, 201), 3, False,
                (1, 4, 8, 16, 32)),
               ("states8 6^8", cs.nine_states(8), (6,) * 8, 3, False, ()),
               ("states8 6^8 tanh", cs.nine_states(8), (6,) * 8, 3, True, ()),
               ("glider 41^4", glider, (41,) * 4, 9, False, ())]
    for label, prob, shape, per, tanh, forced in general:
        grid = cs.tanh_grid(prob, shape) if tanh else prob.default_grid(shape)
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(per), cs.DEVICE)
        v = value(grid.shape)
        bound = cs.general_sweep_bounds(ops)["dense_backup_general"]
        b = bound["bound_ms"] + 1e3 * table(grid) / cs.HBM_BYTES_PER_S
        lanes = getattr(db, "general_lanes", None)
        rule = lanes(ops.x.shape[0], ops.uc.shape[0], db._sm_count(0)) if lanes else 1
        forms = {f"rule L={rule}": {}, "runtime_d": {"_runtime_d": True}}
        if lanes:
            forms.update({f"L={n}": {"_lanes": n} for n in forced if n != rule})
        row = {"bound_ms": b, "lanes": rule}
        for name, kw in forms.items():
            ms = cs.graph_ms(lambda: db.dense_backup_general(ops, v, with_policy=True, **kw))
            row[name] = ms
            print(f"{label}: improve {name} {ms:.4f} ms ({100 * b / ms:.1f} % of {b:.4f})",
                  flush=True)
        rec[label] = row
        del ops, v
        torch.cuda.empty_cache()
    structured = [("quadcopter 11^6", tm.make_problem("quadcopter", **cs.QUAD), (11,) * 6),
                  ("quadcopter7 9^7", tm.make_problem("quadcopter7", **cs.QUAD), (9,) * 7)]
    for label, prob, shape in structured:
        for form in ("tanh", "uniform"):
            grid = cs.tanh_grid(prob, shape) if form == "tanh" else prob.default_grid(shape)
            ops = db.make_dense_operands(prob, grid, prob.control_candidates(5), cs.DEVICE)
            v = value(grid.shape)
            _, best = db.dense_backup(ops, v)
            bounds = cs.sweep_bounds(ops)
            row = {}
            for entry, fn in (("dense_backup", lambda: db.dense_backup(ops, v)),
                              ("dense_evaluate", lambda: db.dense_evaluate(ops, v, best))):
                b = bounds[entry]["bound_ms"] + 1e3 * table(grid) / cs.HBM_BYTES_PER_S
                ms = cs.graph_ms(fn)
                row[entry] = {"ms": ms, "bound_ms": b}
                print(f"{label} {form}: {entry} {ms:.4f} ms ({100 * b / ms:.1f} % of {b:.4f})",
                      flush=True)
            rec[f"{label} {form}"] = row
            del ops, v, best
            torch.cuda.empty_cache()
    pathlib.Path(out_path).write_text(json.dumps(rec, indent=1))


def _sass_by_function(d):
    """{kernel: its instructions} of a variant's library (one cuobjdump),
    keyed by the mangled name from the kernel's own name on (the namespace
    differs between trees: nvcc's name of an anonymous one holds a hash of
    the source); only the instruction lines count, not the headers of the
    library's cubins (one a translation unit) around them."""
    lib = next((d / "c3sc_tpu_torch" / "_build").glob("*/*.so"))
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        m = re.search(r"\d((?:wide_)?dense_\w+?kernel.*)", name)
        code = [" ".join(line.split()) for line in body.splitlines()   # cuobjdump pads columns
                if re.match(r"\s*/\*[0-9a-f]{4}\*/", line)]
        out[m.group(1) if m else name] = "\n".join(code)
    return out


def same_sass(a, da, b, db_):
    """Summary lines: how many kernels the two libraries share, and which differ."""
    sa, sb = _sass_by_function(da), _sass_by_function(db_)
    shared = sorted(set(sa) & set(sb))
    differ = [f for f in shared if sa[f] != sb[f]]
    (OUT / f"sass_differ_{a}_{b}.txt").write_text("\n".join(differ) + "\n")
    for i, f in enumerate(differ[-2:]):   # two of them in full, to read the difference
        (OUT / f"sass_differ_{a}_{b}_{i}.txt").write_text(f"{f}\n{sa[f]}\n=====\n{sb[f]}\n")
    kinds = {}
    for f in differ:
        m = re.match(r"((?:wide_)?dense_\w+?kernel)I((?:Li\d+E)+)", f)
        if m is None:
            kinds[f] = 1
            continue
        args = re.findall(r"Li(\d+)E", m.group(2))   # (D, DU, NU) or (D or DCAP, NU)
        nu = args[2 if m.group(1) in ("dense_backup_kernel", "dense_evaluate_kernel") else 1]
        key = m.group(1) + (" nu" if nu == "1" else "")
        kinds[key] = kinds.get(key, 0) + 1
    return [f"[sass] {a} against {b}: {len(shared)} kernels in both, {len(differ)} differ "
            f"({kinds}); only in {a}: {len(set(sa) - set(sb))}, only in {b}: "
            f"{len(set(sb) - set(sa))}"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--order", default="", help="variants to time, in turn")
    ap.add_argument("--pytest", action="append", default=[], help="NAME:EXPR")
    ap.add_argument("--smoke", action="append", default=[], help="NAME:PHASE")
    ap.add_argument("--same-sass", action="append", default=[], help="A,B")
    ap.add_argument("--sass", action="append", default=[], help="NAME:mangled-name pattern")
    ap.add_argument("--time-here", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_here:
        time_here(args.time_here)
        return 0
    order = [n for n in args.order.split(",") if n]
    tests = [t.split(":", 1) for t in args.pytest]
    smokes = [t.split(":", 1) for t in args.smoke]
    pairs = [t.split(",", 1) for t in args.same_sass]
    dumps = [t.split(":", 1) for t in args.sass]
    names = list(dict.fromkeys(order + [n for n, _ in tests + smokes + dumps]
                               + [n for pair in pairs for n in pair]))
    OUT.mkdir(parents=True, exist_ok=True)
    dirs = {n: tw.make_variant(n, args.parent, ROOT, PATCHES) for n in names}
    summary = []
    for name, sec in tw.build_all(dirs).items():
        summary.append(f"[build] {name}: done after {sec:.1f} s (all variants built at once)")
        summary += [f"   {line}" for line in tw.ptxas_lines(dirs[name], PTXAS)]
    print("\n".join(summary), flush=True)
    for a, b in pairs:
        lines = same_sass(a, dirs[a], b, dirs[b])
        print("\n".join(lines), flush=True)
        summary += lines
    rc = 0
    me = str(pathlib.Path(__file__).resolve())
    for i, name in enumerate(order):
        code, lines = tw.run(name, dirs[name], [sys.executable, me, "--time-here",
                                                str(OUT / f"time_{i}_{name}.json")],
                             f"time_{i}_{name}.log", out=OUT)
        rc |= code
        summary += lines
    for name, expr in tests:
        code, lines = tw.run(name, dirs[name], [sys.executable, "-m", "pytest", "--noconftest",
                                                "tests/test_torch_kernels.py", "-q", "-k", expr,
                                                "-p", "no:cacheprovider"],
                             f"{name}_pytest.log",
                             lambda line: "passed" in line or "failed" in line or "FAILED" in line,
                             out=OUT)
        rc |= code
        summary += lines
    for name, phase in smokes:
        code, lines = tw.run(name, dirs[name], [sys.executable, "chip_smoke.py", "--phases", phase],
                             f"{name}_smoke_{phase}.log",
                             lambda line: line.startswith(("[B]", f"[{phase}", "[timing]")),
                             out=OUT)
        rc |= code
        summary += lines
    for i, (name, pattern) in enumerate(dumps):
        tw.sass(dirs[name], pattern, f"{name}_sass_{i}.txt", OUT)
    (OUT / "summary.txt").write_text("\n".join(summary) + "\n")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
