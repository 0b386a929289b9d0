"""K1's run-time-d kernels in several source variants, side by side on one card.

Each variant is a copy of ``c3sc_tpu_torch/`` (with ``chip_smoke.py`` and
``tests/``) under ``.chip_scratch/wide_variants/<name>/``, whose
``csrc/dense_backup.cu`` may be changed by the textual patches below, joined
by ``+`` in its name. The script builds every variant's library at once (one
``nvcc`` process each) and collects the ptxas lines (registers, stack frame,
spills) of their run-time-d kernels. Then, in each variant of ``--order`` in
turn (repeated names measure the spread), it times the general improve (with
the policy's epilogue) and evaluate as CUDA graphs of 100 launches against
their byte bounds: the nine-state problem of ``chip_smoke.py`` at 5^9 with 3
candidates on the uniform and a tanh grid, twelve states at 4^12, eight at
6^8 (both grids) and the glider at 41^4, the last three also through the
``_runtime_d`` switch where the tree has it. Timing only: ``--m2`` runs ``chip_smoke.py``'s
phase M.2 in a variant (the kernels against the plain version), ``--smoke``
its ``--phases M``, ``--pytest NAME:EXPR`` ``tests/test_torch_kernels.py -k
EXPR`` there, and ``--sass NAME:PATTERN`` writes cuobjdump's SASS of the
kernels whose mangled name matches. Logs, the times as JSON and
``summary.txt`` go to ``chiprun_out/wide_variants/``.

Variants: ``parent`` (an unpacked checkout given by ``--parent``, as it is),
``new`` (this tree) and this tree patched: ``b128`` (the uniform improve in
blocks of 128 threads), ``nopipe`` (no pipelined candidate loop),
``fold`` (the non-uniform evaluate keeps only the spacing and neighbour
value its drift's sign picks), ``cap16`` (no capacity 12), ``scal`` (the Spacing tables read as
scalars), ``tsm`` (the tables copied into shared memory first), ``fwd`` (all
coordinates decoded before any neighbour is read), ``nov`` (a
diagnostic with wrong values: no neighbour loads) and ``parent_kernels``
(the parent's ``dense_backup.cu`` given the ``runtime_d`` argument of this
tree's C interface).

    python3 experiments/torch_wide_variants.py --parent DIR \\
        --order parent,new,fold,new,parent --m2 new --smoke new \\
        --pytest "new:wide or runtime_d" --sass new:wide_dense_evaluate_general_kernelILi12

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOT = REPO / ".chip_scratch" / "wide_variants"
OUT = REPO / "chiprun_out" / "wide_variants"
KERNEL = pathlib.Path("c3sc_tpu_torch") / "csrc" / "dense_backup.cu"


def _replace(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"the patch's anchor occurs {text.count(old)} times: {old[:80]!r}")
    return text.replace(old, new)


def patch_b128(s):
    """The uniform improve in blocks of 128 threads too."""
    return _replace(s, "constexpr int kWideImproveBlock = kWidePipelined<DCAP, NU> ? 256 : kWideBlock;",
                    "constexpr int kWideImproveBlock = kWideBlock;")


def patch_nopipe(s):
    """No software pipelining of the improve's candidate loop."""
    return _replace(s, "constexpr bool kWidePipelined = !kWideShared<DCAP> && NU == kUniform;",
                    "constexpr bool kWidePipelined = false;")


def patch_fold(s):
    """The non-uniform evaluate keeps, after the decode, only the 1/h and the
    neighbour value that the sign of its drift picks (in both of each pair's
    slots, so that the rhs selects the same values)."""
    fold = """template <int DCAP, int NU, typename Idx>
C3SC_FN void wide_fold(const float (&f)[DCAP], const WideGridDesc<Idx>& g, WideNode<DCAP, NU>& w) {
  if (NU != kNonuniform) return;
#pragma unroll
  for (int j = 0; j < DCAP; ++j) {
    if (j < g.d) {
      const float ih = f[j] > 0.0f ? w.ihp(j) : w.ihm(j);
      const float vs = __fmul_rn(f[j], ih) > 0.0f ? w.vp(j) : w.vm(j);
      w.ihp(j) = ih;
      w.ihm(j) = ih;
      w.vp(j) = vs;
      w.vm(j) = vs;
    }
  }
}

"""
    s = _replace(s, "// x[at + j N] for j < d: the d component planes", fold + "// x[at + j N] for j < d: the d component planes")
    return _replace(s, "0, 0.0f, 0.0f, 0, w);\n", "0, 0.0f, 0.0f, 0, w);\n  wide_fold<DCAP, NU, Idx>(f, g, w);\n")


def patch_cap16(s):
    """Two capacities, 16 and 32, as first planned (no capacity 12)."""
    return _replace(s, "constexpr int kWideCapSmall = 12;", "constexpr int kWideCapSmall = 16;")


def patch_nov(s):
    """Diagnostic, wrong values: every neighbour value read at the node itself."""
    return _replace(s, "      float a = v[up], b = v[dn];\n      if (clip) {\n        a = fminf",
                    "      float a = v[n], b = v[n];\n      if (clip) {\n        a = fminf")


def patch_scal(s):
    """Non-uniform grids: each Spacing-table entry read as five 4-byte loads."""
    return _replace(s, "        const float4 t = __ldg(reinterpret_cast<const float4*>(e));\n        w.ihp(j)",
                    "        const float4 t = make_float4(__ldg(e), __ldg(e + 1), __ldg(e + 2), "
                    "__ldg(e + 3));\n        w.ihp(j)")


def patch_tsm(s):
    """Non-uniform grids: the block copies the Spacing tables (up to 8 KB)
    into shared memory first, and the decode reads them there."""
    s = _replace(s, "float lo, float hi, int pin, WideNode<DCAP, NU>& w) {",
                 "float lo, float hi, int pin, WideNode<DCAP, NU>& w,\n"
                 "                                   const float* tab) {")
    s = _replace(s, "        const float* e = g.nu + (long long)(g.toff[j] + (int)i) * kSpacingStride;\n"
                    "        const float4 t = __ldg(reinterpret_cast<const float4*>(e));",
                 "        const float* e = tab + (long long)(g.toff[j] + (int)i) * kSpacingStride;\n"
                 "        const float4 t = *reinterpret_cast<const float4*>(e);")
    s = _replace(s, "cm[NU == kNonuniform ? j : 0] = __ldg(e + 4);",
                 "cm[NU == kNonuniform ? j : 0] = e[4];")
    stage = """  __shared__ float4 tab_sh[512];
  const float* tab = g.nu;
  if (NU == kNonuniform && !kWideShared<DCAP>) {
    const int rows = g.toff[g.d - 1] + (int)g.shape[g.d - 1];
    if (rows * kSpacingStride <= 2048) {
      for (int k = threadIdx.x; k < rows * kSpacingStride / 4; k += blockDim.x)
        tab_sh[k] = reinterpret_cast<const float4*>(g.nu)[k];
      __syncthreads();
      tab = reinterpret_cast<const float*>(tab_sh);
    }
  }
"""
    for kind in ("wide_dense_backup_general_kernel(", "wide_dense_evaluate_general_kernel("):
        a = s.index(kind)
        b = s.index("  if (n >= (Idx)N) return;\n", a)
        s = s[:b] + stage + s[b:]
    s = _replace(s, "lo, hi, pin, w);", "lo, hi, pin, w, tab);")
    return _replace(s, "0, 0.0f, 0.0f, 0, w);", "0, 0.0f, 0.0f, 0, w, tab);")


def patch_fwd(s):
    """The decode first finds every coordinate (in reverse, as the division
    chain needs), then reads the neighbours and the tables dim by dim forward."""
    old = """      Idx i = rem;  // the outermost index is what is left
      if (j > 0) {
        const Idx quot = quotient(rem, g, j);
        i = rem - quot * len;
        rem = quot;
      }
      const Idx up"""
    new = """      Idx i = rem;  // the outermost index is what is left
      if (j > 0) {
        const Idx quot = quotient(rem, g, j);
        i = rem - quot * len;
        rem = quot;
      }
      ci[j] = i;
    }
  }
#pragma unroll
  for (int j = 0; j < DCAP; ++j) {
    if (j < g.d) {
      const Idx len = g.shape[j];
      const Idx s = g.stride[j];
      const Idx i = ci[j];
      const Idx up"""
    s = _replace(s, old, new)
    return _replace(s, "  Idx rem = n;\n#pragma unroll\n  for (int j = DCAP - 1; j >= 0; --j) {",
                    "  Idx ci[DCAP];\n  Idx rem = n;\n#pragma unroll\n  for (int j = DCAP - 1; j >= 0; --j) {")


def patch_parent_kernels(parent):
    """The parent's dense_backup.cu with the runtime_d argument of this tree's C interface."""
    def patch(_):
        s = (parent / KERNEL).read_text()
        s = _replace(s, "  int wide;\n  cudaStream_t stream;\n  int preload;\n};\n\ntemplate <int D, int NU",
                     "  int wide;\n  int runtime_d;\n  cudaStream_t stream;\n  int preload;\n};\n\n"
                     "template <int D, int NU")
        s = _replace(s, "  switch (c.d) {\n    case 1: return run_general<1>(c, N);",
                     "  if (c.runtime_d) return run_general_wide(c, N);\n"
                     "  switch (c.d) {\n    case 1: return run_general<1>(c, N);")
        s = _replace(s, "float lo, float hi, int pin_input, int wide, void* stream) {\n"
                        "  const GeneralCall c{v, nullptr,",
                     "float lo, float hi, int pin_input, int wide, int runtime_d,\n"
                     "                              void* stream) {\n  const GeneralCall c{v, nullptr,")
        s = _replace(s, "                      pin_input, wide, (cudaStream_t)stream, 0};",
                     "                      pin_input, wide, runtime_d, (cudaStream_t)stream, 0};")
        s = _replace(s, "const float* nu, float beta, int wide, void* stream) {\n"
                        "  if (best == nullptr) return (int)cudaErrorInvalidValue;\n"
                        "  const GeneralCall c{v, best,",
                     "const float* nu, float beta, int wide, int runtime_d,\n"
                     "                                void* stream) {\n"
                     "  if (best == nullptr) return (int)cudaErrorInvalidValue;\n"
                     "  const GeneralCall c{v, best,")
        return _replace(s, "0, 0.0f, 0.0f, 0, wide,\n                      (cudaStream_t)stream, 0};",
                        "0, 0.0f, 0.0f, 0, wide,\n                      runtime_d, "
                        "(cudaStream_t)stream, 0};")
    return patch


PATCHES = {"b128": patch_b128, "nopipe": patch_nopipe, "fold": patch_fold, "cap16": patch_cap16,
           "nov": patch_nov, "scal": patch_scal, "tsm": patch_tsm, "fwd": patch_fwd}


def make_variant(name, parent):
    """Copy the variant's tree under ROOT and patch its kernel source."""
    dst = ROOT / name
    shutil.rmtree(dst, ignore_errors=True)
    src = parent if name == "parent" else REPO
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(src / "c3sc_tpu_torch", dst / "c3sc_tpu_torch", ignore=ignore)
    shutil.copytree(src / "tests", dst / "tests", ignore=ignore)
    shutil.copy(src / "chip_smoke.py", dst / "chip_smoke.py")
    parts = [p for p in name.split("+") if p not in ("new", "parent")]
    for part in parts:
        if part == "parent_kernels":
            patch = patch_parent_kernels(parent)
        elif part in PATCHES:
            patch = PATCHES[part]
        else:
            raise ValueError(f"unknown variant {part}")
        (dst / KERNEL).write_text(patch((dst / KERNEL).read_text()))
    return dst


def build_all(dirs):
    """Build every variant's library at once; returns {name: seconds}."""
    code = "from c3sc_tpu_torch import _ext; _ext.load()"
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, "-c", code], cwd=d, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n, d in dirs.items()}
    took = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            print(f"[build] {name} failed:\n{out[-4000:]}", flush=True)
    return took


def ptxas_lines(d):
    """The ptxas resource lines of the run-time-d kernels in a variant's build.log."""
    logs = list((d / "c3sc_tpu_torch" / "_build").glob("*/build.log"))
    if not logs:
        return ["no build.log"]
    text, out = logs[0].read_text(), []
    for m in re.finditer(r"Compiling entry function '(_Z\w*wide_dense_\w+?kernel(I\w+?E)E\w*)'"
                         r".*?(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads.*?Used (\d+) registers", text, re.S):
        kind = re.search(r"wide_dense_(backup|evaluate)", m.group(1)).group(1)
        out.append(f"{kind}{m.group(2)}: registers {m.group(6)}, stack frame {m.group(3)} B, "
                   f"spill stores {m.group(4)} B, spill loads {m.group(5)} B")
    return out


M2 = ("import chip_smoke as cs; cs.phase_a_environment(); "
      "errs, record = cs.phase_m2_nine_states(); print(errs); print(record)")


def _states(d):
    """chip_smoke.py's nine-state problem on d states (every tree has C3Control)."""
    import torch

    from c3sc_tpu_torch.control import C3Control

    def diff(x, u):
        batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        return torch.diag_embed(x.new_full((*batch, x.shape[-1]), 0.3))

    ctrl = (C3Control(dx=d, du=1, dw=d, lb=[-1.0] * d, ub=[1.0] * d, beta=0.5, name=f"states{d}")
            .add_drift(lambda x, u: torch.nn.functional.pad(u[..., :1], (0, d - 1)) - x)
            .add_diff(diff)
            .add_stagecost(lambda x, u: (x * x).sum(-1) + 0.1 * (u * u).sum(-1))
            .set_value_bounds(0.0, 50.0))
    for j in range(d):
        ctrl.set_external_boundary(j, "reflect")
    return ctrl.problem()


def time_here(out_path):
    """In a variant's directory: ms a sweep (CUDA graph of 100 launches) of
    the general improve (with the policy's epilogue) and evaluate, with the
    byte bounds, on 5^9 (uniform, tanh), 4^12 (uniform), 6^8 (uniform,
    tanh) and the glider's 41^4; at d <= 8 also through the _runtime_d switch where the
    tree has it. Timing only: M.2 and the card tests check the values."""
    sys.path.insert(0, os.getcwd())
    import json

    import numpy as np
    import torch

    import chip_smoke as cs
    from c3sc_tpu_torch import models as tm
    from c3sc_tpu_torch.ops import dense_backup as db

    card = cs.phase_a_environment()
    cases = [("5^9", _states(9), 5, False), ("5^9 tanh", _states(9), 5, True),
             ("4^12", _states(12), 4, False), ("6^8", _states(8), 6, False),
             ("6^8 tanh", _states(8), 6, True),
             ("glider 41^4", tm.make_problem("glider"), 41, False)]
    rec = {"card": card}
    for label, prob, n, tanh in cases:
        grid = cs.tanh_grid(prob, (n,) * prob.dx) if tanh else prob.default_grid(n)
        per = 9 if prob.name == "glider" else 3
        ops = db.make_dense_operands(prob, grid, prob.control_candidates(per), cs.DEVICE)
        v = torch.as_tensor(np.random.default_rng(0).uniform(0, 5, grid.shape),
                            dtype=torch.float32, device=cs.DEVICE)
        bounds = cs.general_sweep_bounds(ops)
        forms = {"": {}}
        if grid.ndim <= 8:
            forms[" runtime_d"] = {"_runtime_d": True}
        for suffix, kw in forms.items():
            try:
                _, pol = db.dense_backup_general(ops, v, with_policy=True, **kw)
            except TypeError:   # a tree without the switch
                continue
            imp = cs.graph_ms(lambda: db.dense_backup_general(ops, v, with_policy=True, **kw))
            ev = cs.graph_ms(lambda: db.dense_evaluate_general(ops, v, pol, **kw))
            rec[label + suffix] = {
                "improve_ms": imp, "evaluate_ms": ev,
                "improve_share": bounds["dense_backup_general"]["bound_ms"] / imp,
                "evaluate_share": bounds["dense_evaluate_general"]["bound_ms"] / ev}
            print(f"{label}{suffix}: improve {imp:.4f} ms "
                  f"({100 * rec[label + suffix]['improve_share']:.1f} %), evaluate {ev:.4f} ms "
                  f"({100 * rec[label + suffix]['evaluate_share']:.1f} %)", flush=True)
            del pol
        del ops, v
        torch.cuda.empty_cache()
    pathlib.Path(out_path).write_text(json.dumps(rec, indent=1))


def run(name, d, argv, log_name, keep=lambda line: True):
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=d, capture_output=True, text=True)
    (OUT / log_name).write_text(proc.stdout + proc.stderr)
    lines = [f"== {name}: {' '.join(argv[1:])[:80]} -> rc {proc.returncode} in "
             f"{time.perf_counter() - t0:.1f} s"]
    lines += [f"   {line}" for line in proc.stdout.splitlines() if keep(line)]
    if proc.returncode != 0:
        lines.append(proc.stderr[-1500:])
    print("\n".join(lines), flush=True)
    return proc.returncode, lines


def sass(d, pattern, log_name):
    """cuobjdump's SASS of the variant's kernels whose mangled name matches."""
    lib = next((d / "c3sc_tpu_torch" / "_build").glob("*/*.so"))
    text = next((d / "c3sc_tpu_torch" / "_build").glob("*/build.log")).read_text()
    names = sorted(set(re.findall(r"Compiling entry function '(_Z\w*" + pattern + r"\w*)'", text)))
    out = []
    for fn in names:
        proc = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", "-fun", fn, str(lib)],
                              capture_output=True, text=True)
        out.append(proc.stdout + proc.stderr)
    (OUT / log_name).write_text("\n".join(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--order", default="", help="variants to time, in turn")
    ap.add_argument("--m2", action="append", default=[], help="variants to run M.2 in")
    ap.add_argument("--pytest", action="append", default=[])
    ap.add_argument("--smoke", action="append", default=[])
    ap.add_argument("--sass", action="append", default=[], help="NAME:mangled-name pattern")
    ap.add_argument("--time-here", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_here:
        time_here(args.time_here)
        return 0
    order = [n for n in args.order.split(",") if n]
    tests = [t.split(":", 1) for t in args.pytest]
    dumps = [t.split(":", 1) for t in args.sass]
    names = list(dict.fromkeys(order + args.m2 + [n for n, _ in tests + dumps] + args.smoke))
    OUT.mkdir(parents=True, exist_ok=True)
    dirs = {n: make_variant(n, args.parent) for n in names}
    summary = []
    for name, sec in build_all(dirs).items():
        summary.append(f"[build] {name}: done after {sec:.1f} s (all variants built at once)")
        summary += [f"   {line}" for line in ptxas_lines(dirs[name])]
    print("\n".join(summary), flush=True)
    rc = 0
    me = str(pathlib.Path(__file__).resolve())
    for i, name in enumerate(order):
        code, lines = run(name, dirs[name], [sys.executable, me, "--time-here",
                                             str(OUT / f"time_{i}_{name}.json")],
                          f"time_{i}_{name}.log")
        rc |= code
        summary += lines
    for name in args.m2:
        code, lines = run(name, dirs[name], [sys.executable, "-c", M2], f"{name}_m2.log",
                          lambda line: line.startswith("[M.2]") and "%" in line)
        rc |= code
        summary += lines
    for name in args.smoke:
        code, lines = run(name, dirs[name], [sys.executable, "chip_smoke.py", "--phases", "M"],
                          f"{name}_smoke.log",
                          lambda line: line.startswith(("[B]", "[M]", "[timing]")))
        rc |= code
        summary += lines
    for name, expr in tests:
        code, lines = run(name, dirs[name], [sys.executable, "-m", "pytest", "--noconftest",
                                             "tests/test_torch_kernels.py", "-q", "-k", expr,
                                             "-p", "no:cacheprovider"],
                          f"{name}_pytest.log",
                          lambda line: "passed" in line or "failed" in line or "FAILED" in line)
        rc |= code
        summary += lines
    for i, (name, pattern) in enumerate(dumps):
        sass(dirs[name], pattern, f"{name}_sass_{i}.txt")
    (OUT / "summary.txt").write_text("\n".join(summary) + "\n")
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
