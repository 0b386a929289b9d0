// Whole-grid dense Bellman sweep for Hopper (sm_90a) — kernel K1 of the port.
//
// Replaces the Pallas TPU kernel c3sc_tpu/ops/pallas_dense.py
// (make_pallas_dense_backup, its inner `kernel`, and _neighbor_tables), and
// carries the fixed-policy `evaluate` sweep of c3sc_tpu/solvers/dense.py
// (make_dense_step.evaluate) as a second entry point. Two general entries
// (dense_backup_general, dense_evaluate_general, below) take problems
// without the structure declarations from per-candidate operands.
//
// What it computes, per grid node n (row-major multi-index; the structured
// entries take d <= 8 and du <= 4, the general ones any d <= 32):
//   v_in = v, optionally clipped to [lo, hi] and with terminal nodes pinned
//          to their exit value (the Pallas semantics; JAX's dense_vi
//          `improve` does neither);
//   for each control candidate c (strict `<` running min, so ties keep the
//   first index, as jnp.argmin does):
//     f_j  = f0_j(x) + sum_m G_jm(x) u_cm          (control-affine drift)
//     Q    = sum_j (s2_j/h_j^2 + |f_j|/h_j) + 1e-10, dt = 1/Q
//     p+_j = (s2_j/(2h_j^2) + max(f_j,0)/h_j)/Q, p-_j likewise with max(-f_j,0)
//     rhs  = (q(x) + r(u_c)) dt + exp(-beta dt) sum_j (p+_j v_in(n+e_j) + p-_j v_in(n-e_j))
//   vnew = min_c rhs (clipped again when clipping), pinned on terminal nodes;
//   best = argmin_c rhs.
// Neighbours wrap on periodic dims and clamp on bounded ones. `evaluate`
// computes the same rhs for the one candidate best[n] and pins terminals.
// On a non-uniform grid h_j is h+_j up and h-_j down (the node's own gaps):
//     Q    = sum_j (s2_j/(h+_j h-_j) + max(f_j,0)/h+_j + max(-f_j,0)/h-_j) + 1e-10,
//     p+_j = (s2_j/(h+_j (h+_j + h-_j)) + max(f_j,0)/h+_j)/Q, p-_j likewise,
// the stencil of c3sc_tpu/ops/mca.py::_stencil_nonuniform.
//
// The arithmetic, factored so that a candidate costs no division but one.
// With a_j = s2_j/(2 h_j^2) and ih_j = 1/h_j (ih_j and 1/(2 h_j^2) are
// per-launch constants, worked out on the host):
//   once a node:  f0h_j = f0_j ih_j, Gh_jm = G_jm ih_j,
//                 Q0 = sum_j 2 a_j + 1e-10, A0 = sum_j a_j (v+_j + v-_j);
//   a candidate:  fh_j = f0h_j + sum_m Gh_jm u_cm,  Q = Q0 + sum_j |fh_j|,
//                 S = sum_j |fh_j| (fh_j > 0 ? v+_j : v-_j),  dt = 1/Q,
//                 rhs = dt ((r_c + q) + exp(-beta dt) (A0 + S)).
// It is the same function, since sum_j (p+_j v+_j + p-_j v-_j) = (A0 + S) dt:
// d (du + 3) multiply-add class operations, one reciprocal and one
// exponential a candidate, where the direct form took 31 IEEE divisions at
// d = 6. Every step is an explicit round-to-nearest intrinsic (fmaf,
// __fadd_rn, __fmul_rn, __frcp_rn), so the compiler contracts and reorders
// nothing, and improve and evaluate, which inline the same candidate_rhs,
// give bit-equal values for the same v and candidate. The rounding differs
// from the JAX term order by a few ulp. The reciprocal and the exponential
// are the exact ones (__frcp_rn, expf): the special-function unit's
// approximations were measured and moved the whole solve by 4 %.
//
// Design, against what bounds it on this card. The TPU kernel held the whole
// grid in VMEM (d <= 3) and traced the user callables into its body. Here the
// callables are replaced by the x-only tensors of the problem's structure
// declarations, precomputed once per problem and grid, plus r [C] and
// uc [C,du]. One thread owns one node and keeps every candidate-independent
// term in registers, so the [C,N,d] stencil of the XLA form never exists.
//   - Layout. The per-node operands are structure-of-arrays, f0 [d,N],
//     G [d,du,N], s2 [d,N]: a warp's load of one component is one 128-byte
//     line. In the node-major [N,d] form a warp load touched 24 or 48
//     sectors for 128 useful bytes. The copy is the only one on the device
//     (the [N,d] forms are transposed views of it), so it costs no memory;
//     the alternative, a bulk asynchronous copy of node-major slabs into
//     padded shared memory, would add a barrier and 25 KB of shared memory
//     a block for the same bytes.
//   - Candidates. A block stages uc and r into shared memory once (a
//     float4 or two a candidate, read back as a broadcast), in tiles of
//     kCandTile, and the candidate loop is unrolled four times, which also
//     gives four independent dependency chains. C stays a run-time value.
//   - Index decode. When N < 2^31, indices are 32 bits and the row-major
//     decode divides by the per-launch shape through multiply-high by magic
//     numbers from the host (set_magic); the outermost dim needs no
//     division. Larger grids take the same templates with 64-bit indices
//     and plain division.
// What bounds it now, measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// and experiments/torch_k1_profile.py; PERF.md keeps the runs). At 11^6 with
// 25 candidates a node moves 117 bytes once: 0.062 ms at 3.35 TB/s, against
// 0.035 ms for its float32 operations at 67 TFLOP/s, so the bound is bytes.
// Improve takes 0.137 ms (1.92 ms in the direct form): 0.074 ms at one
// candidate, 84 % of the memory rate, plus 0.0026 ms a candidate, which is
// instruction rate (about 50 operations a candidate, fewer than half of
// them fused multiply-adds, at some 34 TFLOP/s); the two parts add, they do
// not overlap. Evaluate takes 0.057 ms
// against 0.043 ms of bytes (terminal nodes only copy their value), and it
// is now four fifths of dense_vi's device time: the next lever is there
// (several evaluate sweeps a launch), not in this arithmetic. 64 and 32
// registers a thread, no spills.
//
// Non-uniform grids. On a tensor-product grid h+-_j depend on the node's
// coordinate i_j alone, which the index decode yields anyway, so each dim
// has a table indexed by i_j of the five reciprocals the stencil uses,
// worked out on the host in float64 and rounded to float32: 1/h+, 1/h-,
// 1/(h+ h-), 1/(h+ (h+ + h-)), 1/(h- (h+ + h-)) (Spacing, below; sum_k n_k
// entries of 32 bytes, read through the read-only cache). The node-only
// terms become Q0 = sum_j s2_j/(h+ h-) + 1e-10 and A0 = sum_j s2_j (v+_j/(h+
// (h+ + h-)) + v-_j/(h- (h+ + h-))), and a candidate scales its drift f_j
// by 1/h+_j or 1/h-_j once its sign is known, so the node keeps f0 and G
// unscaled plus the two reciprocals a dim (2 d registers more than the
// uniform form, not four scaled copies of f0 and G). The sweep stays free
// of divisions. Which form a kernel computes is a template argument
// (kUniform, kNonuniform): the uniform instantiations compile to the code
// they compiled to before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define C3SC_FN __device__ __forceinline__

namespace {

constexpr int kMaxD = 8;       // the compiled-d forms (a template argument D <= 8)
constexpr int kMaxDU = 4;      // the structured entries' controls
constexpr int kMaxDWide = 32;  // the general entries' run-time-d form, 8 < d <= 32
constexpr int kBlock = 256;
constexpr int kCandTile = 512;  // candidates staged in shared memory at a time
constexpr int kSpacingStride = 8;  // floats a Spacing table entry takes (5 used)

// The stencil's form, a template argument of every kernel.
constexpr int kUniform = 0;
constexpr int kNonuniform = 1;

// One grid, with the per-launch constants of the stencil. Idx is uint32_t
// when N < 2^31 and long long above.
template <typename Idx>
struct GridDesc {
  Idx shape[kMaxD];
  Idx stride[kMaxD];
  Idx wrap[kMaxD];         // (shape - 1) * stride on periodic dims, else 0
  uint32_t magic[kMaxD];   // rem / shape = umulhi(rem, magic) >> shift  (32-bit decode)
  int shift[kMaxD];
  float ih[kMaxD];         // 1 / h
  float a_scale[kMaxD];    // 1 / (2 h^2)
  const float* nu;         // non-uniform: the Spacing tables, entry (toff[j] + i_j); else null
  int toff[kMaxD];         // first table entry of each dim
};

// The reciprocal spacings of one node, dim by dim (non-uniform grids).
template <int D>
struct Spacing {
  float ihp[D];  // 1 / h+
  float ihm[D];  // 1 / h-
  float cpm[D];  // 1 / (h+ h-)
  float cp[D];   // 1 / (h+ (h+ + h-))
  float cm[D];   // 1 / (h- (h+ + h-))
};

template <int D, typename Idx>
C3SC_FN void load_spacing(const GridDesc<Idx>& g, const Idx (&coord)[D], Spacing<D>& sp) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float* e = g.nu + (long long)(g.toff[j] + (int)coord[j]) * kSpacingStride;
    const float4 a = __ldg(reinterpret_cast<const float4*>(e));
    sp.ihp[j] = a.x;
    sp.ihm[j] = a.y;
    sp.cpm[j] = a.z;
    sp.cp[j] = a.w;
    sp.cm[j] = __ldg(e + 4);
  }
}

// The x-only and candidate tensors of one problem on one grid.
struct Operands {
  const float* f0;        // [d, N]
  const float* G;         // [d, du, N]
  const float* s2;        // [d, N]
  const float* q;         // [N]
  const float* r;         // [C]
  const float* uc;        // [C, du]
  const uint8_t* t_mask;  // [N]
  const float* t_val;     // [N]
  int C;
  float beta;
};

// rem / g.shape[j]. 32 bits: for rem < 2^31 and 2^(l-1) < len <= 2^l,
// magic = ceil(2^(31+l) / len) < 2^32 gives the exact quotient as
// (rem * magic) >> (31 + l) (Granlund and Montgomery), which is the high word
// shifted by l - 1. 64 bits: plain division.
C3SC_FN uint32_t quotient(uint32_t rem, const GridDesc<uint32_t>& g, int j) {
  return g.shape[j] == 1 ? rem : __umulhi(rem, g.magic[j]) >> g.shift[j];
}
C3SC_FN long long quotient(long long rem, const GridDesc<long long>& g, int j) {
  return rem / g.shape[j];
}

// +-1 neighbours of flat node n along every dim: wrap on periodic dims,
// clamp on bounded ones (the node itself at the face); coord gets the node's
// multi-index.
template <int D, typename Idx>
C3SC_FN void neighbour_offsets(Idx n, const GridDesc<Idx>& g, Idx (&up)[D], Idx (&dn)[D],
                               Idx (&coord)[D]) {
  Idx rem = n;
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    const Idx len = g.shape[j];
    const Idx s = g.stride[j];
    Idx i = rem;  // the outermost index is what is left
    if (j > 0) {
      const Idx quot = quotient(rem, g, j);
      i = rem - quot * len;
      rem = quot;
    }
    up[j] = (i + 1 < len) ? n + s : n - g.wrap[j];
    dn[j] = (i > 0) ? n - s : n + g.wrap[j];
    coord[j] = i;
  }
}

// Node-local, candidate-independent part of the factored stencil.
template <int D, int DU>
struct NodeTerms {
  float f0h[D];     // f0 / h (non-uniform: f0)
  float Gh[D][DU];  // G / h (non-uniform: G)
  float ihp[D];     // non-uniform: 1 / h+
  float ihm[D];     // non-uniform: 1 / h-
  float vp[D];      // v at the +1 neighbours
  float vm[D];      // v at the -1 neighbours
  float Q0;         // sum_j s2_j / h_j^2 + 1e-10
  float A0;         // sum_j a_j (v+_j + v-_j)
  float q;
};

// The diffusion part of the factored stencil from the node's variances s2[d]:
// Q0 = sum_j 2 a_j + 1e-10 and A0 = sum_j a_j (v+_j + v-_j); non-uniform,
// Q0 = sum_j s2_j cpm_j + 1e-10 and A0 = sum_j s2_j (cp_j v+_j + cm_j v-_j).
template <int D, typename Idx>
C3SC_FN void diffusion_terms(const float (&s2)[D], const GridDesc<Idx>& g, bool nu,
                             const Spacing<D>& sp, const float (&vp)[D], const float (&vm)[D],
                             float& Q0, float& A0) {
  float q0 = 0.0f, a0 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (nu) {
      q0 = fmaf(s2[j], sp.cpm[j], q0);
      a0 = fmaf(s2[j], fmaf(sp.cp[j], vp[j], __fmul_rn(sp.cm[j], vm[j])), a0);
    } else {
      const float a = __fmul_rn(s2[j], g.a_scale[j]);
      q0 = fmaf(2.0f, a, q0);
      a0 = fmaf(a, __fadd_rn(vp[j], vm[j]), a0);
    }
  }
  Q0 = __fadd_rn(q0, 1e-10f);
  A0 = a0;
}

// x[j * stride + at] for j < D: one component plane after another of a
// structure-of-arrays operand.
template <int D, typename Idx>
C3SC_FN void load_planes(const float* x, Idx at, Idx stride, float (&out)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = x[at + (Idx)j * stride];
}

// Fills the rest of t from the node's operands, from t.vp, t.vm and, on a
// non-uniform grid, from the node's spacings sp.
template <int D, int DU, typename Idx>
C3SC_FN void load_node(Idx n, long long N, const Operands& op, const GridDesc<Idx>& g, bool nu,
                       const Spacing<D>& sp, NodeTerms<D, DU>& t) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (nu) {  // scaled per candidate, once the sign of its drift is known
      t.f0h[j] = op.f0[j * N + n];
#pragma unroll
      for (int m = 0; m < DU; ++m) t.Gh[j][m] = op.G[(j * DU + m) * N + n];
      t.ihp[j] = sp.ihp[j];
      t.ihm[j] = sp.ihm[j];
    } else {
      const float ih = g.ih[j];
      t.f0h[j] = __fmul_rn(op.f0[j * N + n], ih);
#pragma unroll
      for (int m = 0; m < DU; ++m) t.Gh[j][m] = __fmul_rn(op.G[(j * DU + m) * N + n], ih);
    }
  }
  float s2[D];
  load_planes<D, Idx>(op.s2, n, (Idx)N, s2);
  diffusion_terms<D, Idx>(s2, g, nu, sp, t.vp, t.vm, t.Q0, t.A0);
  t.q = op.q[n];
}

// Bellman right-hand side of the candidate (u, r) at one node, factored form.
template <int D, int DU>
C3SC_FN float candidate_rhs(const NodeTerms<D, DU>& t, bool nu, const float (&u)[DU], float r,
                            float beta) {
  float Q = t.Q0;
  float S = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float fh = t.f0h[j];
#pragma unroll
    for (int m = 0; m < DU; ++m) fh = fmaf(t.Gh[j][m], u[m], fh);
    if (nu) fh = __fmul_rn(fh, fh > 0.0f ? t.ihp[j] : t.ihm[j]);
    const float af = fabsf(fh);
    Q = __fadd_rn(Q, af);
    S = fmaf(af, fh > 0.0f ? t.vp[j] : t.vm[j], S);
  }
  const float dt = __frcp_rn(Q);
  const float e = expf(__fmul_rn(-beta, dt));
  return __fmul_rn(dt, fmaf(e, __fadd_rn(t.A0, S), __fadd_rn(r, t.q)));
}

// Floats a staged candidate takes in shared memory: u[DU], r, padding to a
// whole number of float4.
template <int DU>
constexpr int kCandStride = DU + 1 <= 4 ? 4 : 8;

template <int DU>
C3SC_FN void read_candidate(const float4* cand, int c, float (&u)[DU], float& r) {
  constexpr int kVecs = kCandStride<DU> / 4;
  float w[4 * kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const float4 x = cand[c * kVecs + k];
    w[4 * k] = x.x;
    w[4 * k + 1] = x.y;
    w[4 * k + 2] = x.z;
    w[4 * k + 3] = x.w;
  }
#pragma unroll
  for (int m = 0; m < DU; ++m) u[m] = w[m];
  r = w[DU];
}

// v at the +-1 neighbours of node n, as the sweep reads it, and the node's
// multi-index.
template <int D, typename Idx>
C3SC_FN void neighbour_values(Idx n, const float* v, const uint8_t* t_mask, const float* t_val,
                              const GridDesc<Idx>& g, int clip, float lo, float hi, int pin,
                              float (&vp)[D], float (&vm)[D], Idx (&coord)[D]) {
  Idx up[D], dn[D];
  neighbour_offsets<D, Idx>(n, g, up, dn, coord);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    vp[j] = v[up[j]];
    vm[j] = v[dn[j]];
    if (clip) {
      vp[j] = fminf(fmaxf(vp[j], lo), hi);
      vm[j] = fminf(fmaxf(vm[j], lo), hi);
    }
    if (pin) {
      if (t_mask[up[j]]) vp[j] = t_val[up[j]];
      if (t_mask[dn[j]]) vm[j] = t_val[dn[j]];
    }
  }
}

// The improve sweep: one thread a node, the block's candidates in shared memory.
template <int D, int DU, int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
dense_backup_kernel(const float* __restrict__ v, Operands op, GridDesc<Idx> g, long long N,
                    int clip, float lo, float hi, int pin, float* __restrict__ vnew,
                    int32_t* __restrict__ best) {
  constexpr int kStride = kCandStride<DU>;
  __shared__ float4 cand4[kCandTile * kStride / 4];
  float* cand = reinterpret_cast<float*>(cand4);
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  const bool active = n < (Idx)N;
  constexpr bool nu = NU == kNonuniform;
  NodeTerms<D, DU> t;
  if (active) {
    Idx coord[D];
    Spacing<D> sp;
    neighbour_values<D, Idx>(n, v, op.t_mask, op.t_val, g, clip, lo, hi, pin, t.vp, t.vm, coord);
    if (nu) load_spacing<D, Idx>(g, coord, sp);
    load_node<D, DU, Idx>(n, N, op, g, nu, sp, t);
  }
  float best_v = 3.4e38f;
  int best_c = 0;
  for (int c0 = 0; c0 < op.C; c0 += kCandTile) {
    const int cn = min(kCandTile, op.C - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the tile before
    for (int c = threadIdx.x; c < cn; c += kBlock) {
#pragma unroll
      for (int m = 0; m < DU; ++m) cand[c * kStride + m] = op.uc[(c0 + c) * DU + m];
      cand[c * kStride + DU] = op.r[c0 + c];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int c = 0; c < cn; ++c) {
        float u[DU], r;
        read_candidate<DU>(cand4, c, u, r);
        const float rhs = candidate_rhs<D, DU>(t, nu, u, r, op.beta);
        if (rhs < best_v) {
          best_v = rhs;
          best_c = c0 + c;
        }
      }
    }
  }
  if (active) {
    if (clip) best_v = fminf(fmaxf(best_v, lo), hi);
    vnew[n] = op.t_mask[n] ? op.t_val[n] : best_v;
    best[n] = best_c;
  }
}

// The fixed-policy evaluate sweep: the rhs of candidate best[n] alone.
template <int D, int DU, int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
dense_evaluate_kernel(const float* __restrict__ v, const int32_t* __restrict__ best, Operands op,
                      GridDesc<Idx> g, long long N, float* __restrict__ vnew) {
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  if (n >= (Idx)N) return;
  if (op.t_mask[n]) {
    vnew[n] = op.t_val[n];
    return;
  }
  const int c = best[n];
  if (c < 0 || c >= op.C) {  // make a bad policy index visible, never read past uc
    vnew[n] = nanf("");
    return;
  }
  constexpr bool nu = NU == kNonuniform;
  NodeTerms<D, DU> t;
  Idx coord[D];
  Spacing<D> sp;
  neighbour_values<D, Idx>(n, v, op.t_mask, op.t_val, g, 0, 0.0f, 0.0f, 0, t.vp, t.vm, coord);
  if (nu) load_spacing<D, Idx>(g, coord, sp);
  load_node<D, DU, Idx>(n, N, op, g, nu, sp, t);
  float u[DU];
#pragma unroll
  for (int m = 0; m < DU; ++m) u[m] = op.uc[c * DU + m];
  vnew[n] = candidate_rhs<D, DU>(t, nu, u, op.r[c], op.beta);
}

// ---- the general entries: any problem, from per-candidate operands ------------------
//
// The counterpart of the Pallas kernel's any-callable contract (it traced the
// problem's callables into its body) and of the XLA sweeps of
// c3sc_tpu/solvers/dense.py (_precompute's [C, N, d] stencil). A problem
// without the control-affine declarations (the glider: its drift is
// nonlinear in the angle of attack) gives its drift at every (candidate,
// node), evaluated once per problem and grid by its own callables:
//   fc [C, d, N]   candidate-major, so a warp's load of one (c, j) is a line;
//   s2 [d, N]      the declared control-independent variances, or else
//   s2c [C, d, N]  diag(L L^T) of each candidate;
//   q [N], r [C]   the declared separable cost, or else gc [C, N].
// The arithmetic is the structured entry's factored form with f0h + Gh u
// replaced by fc ih, so a candidate still costs one reciprocal and one
// exponential. What bounds it is bytes: each candidate reads d floats of fc
// a node (and d more of s2c, one of gc, where those are per candidate), so
// at the glider's 41^4 with 9 candidates fc alone is 407 MB a sweep. Offsets
// c d N + j N + n are 32-bit when C d N < 2^31, else 64-bit (the Idx switch).
//
// The policy. dense_vi runs ten evaluate sweeps under each improve's argmin,
// and an evaluate that read fc[best[n], j, n] scattered its loads across the
// candidate planes: a warp's 32 nodes touched up to C lines a component, so
// each useful 4-byte read cost a 32-byte sector, and it ran at a third of its
// byte bound (0.128 ms against 0.041 ms at 41^4, H100 80GB HBM3, 700 W). The
// JAX package gathers the policy's stencil once per improve (gather_policy in
// c3sc_tpu/solvers/dense.py); here the improve's epilogue writes the winning
// candidate's operands beside vnew and best, as structure-of-arrays
// fpol [d, N], s2pol [d, N], gpol [N], and every operand of the evaluate is
// then one line a warp. The epilogue reads the winner's fc (s2c, gc) again:
// its warp read those very lines in the candidate loop, so they come from
// L1 or L2, not from device memory, and the improve moves 4d (+ 4d, + 4)
// more bytes a node, all of them coalesced writes. Keeping the running
// winner's operands in registers instead (up to 17 floats) was tried on the
// H100: at the glider's d = 4 it raises the improve's registers a thread,
// and the memory-bound loop, with fewer warps in flight, ran slower; only
// at the stripped pendulum's d = 2 did it run faster.
struct GeneralOperands {
  const float* fc;        // [C, d, N]
  const float* s2;        // [d, N] or null
  const float* s2c;       // [C, d, N] where s2 is null
  const float* q;         // [N] or null
  const float* r;         // [C] or null
  const float* gc;        // [C, N] where q, r are null
  const uint8_t* t_mask;  // [N]
  const float* t_val;     // [N]
  int C;
  float beta;
};

// The operands of one candidate per node (the policy): written by the improve
// sweep's epilogue, read by the evaluate sweep. s2 exists where the
// operands' s2c does, g where their gc does; all null in an improve that
// keeps no policy.
struct PolicyOperands {
  float* f;   // [d, N]
  float* s2;  // [d, N] or null
  float* g;   // [N] or null
};

// Bellman right-hand side of one candidate at one node from its drift f and
// its cost gcost; Q0 and A0 are the diffusion terms of its variances. On a
// non-uniform grid f_j is scaled by 1/h+_j where positive, 1/h-_j where not.
template <int D, typename Idx>
C3SC_FN float general_rhs(const float (&f)[D], const GridDesc<Idx>& g, bool nu,
                          const Spacing<D>& sp, const float (&vp)[D], const float (&vm)[D],
                          float Q0, float A0, float gcost, float beta) {
  float Q = Q0;
  float S = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float fh = __fmul_rn(f[j], nu ? (f[j] > 0.0f ? sp.ihp[j] : sp.ihm[j]) : g.ih[j]);
    const float af = fabsf(fh);
    Q = __fadd_rn(Q, af);
    S = fmaf(af, fh > 0.0f ? vp[j] : vm[j], S);
  }
  const float dt = __frcp_rn(Q);
  const float e = expf(__fmul_rn(-beta, dt));
  return __fmul_rn(dt, fmaf(e, __fadd_rn(A0, S), gcost));
}

// The improve sweep of the general form: one thread a node, strict `<`
// running min over the candidates (first index on ties); the winner's
// operands go to `pol` where its pointers are not null (a bad or NaN rhs
// everywhere leaves candidate 0, whose operands are then written).
template <int D, int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
dense_backup_general_kernel(const float* __restrict__ v, GeneralOperands op, PolicyOperands pol,
                            GridDesc<Idx> g, long long N, int clip, float lo, float hi, int pin,
                            float* __restrict__ vnew, int32_t* __restrict__ best) {
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  if (n >= (Idx)N) return;
  constexpr bool nu = NU == kNonuniform;
  float vp[D], vm[D], s[D];
  Idx coord[D];
  Spacing<D> sp;
  neighbour_values<D, Idx>(n, v, op.t_mask, op.t_val, g, clip, lo, hi, pin, vp, vm, coord);
  if (nu) load_spacing<D, Idx>(g, coord, sp);
  float Q0n = 0.0f, A0n = 0.0f, q = 0.0f;
  if (op.s2 != nullptr) {
    load_planes<D, Idx>(op.s2, n, (Idx)N, s);
    diffusion_terms<D, Idx>(s, g, nu, sp, vp, vm, Q0n, A0n);
  }
  if (op.q != nullptr) q = op.q[n];
  float best_v = 3.4e38f;
  int best_c = 0;
  for (int c = 0; c < op.C; ++c) {
    const Idx at = (Idx)c * (Idx)D * (Idx)N + n;
    float f[D];
    load_planes<D, Idx>(op.fc, at, (Idx)N, f);
    float Q0 = Q0n, A0 = A0n;
    if (op.s2c != nullptr) {
      load_planes<D, Idx>(op.s2c, at, (Idx)N, s);
      diffusion_terms<D, Idx>(s, g, nu, sp, vp, vm, Q0, A0);
    }
    const float gcost = op.gc != nullptr ? op.gc[(Idx)c * (Idx)N + n] : __fadd_rn(op.r[c], q);
    const float rhs = general_rhs<D, Idx>(f, g, nu, sp, vp, vm, Q0, A0, gcost, op.beta);
    if (rhs < best_v) {
      best_v = rhs;
      best_c = c;
    }
  }
  if (clip) best_v = fminf(fmaxf(best_v, lo), hi);
  vnew[n] = op.t_mask[n] ? op.t_val[n] : best_v;
  best[n] = best_c;
  if (pol.f != nullptr) {  // the warp read the winner's lines in the loop: L1 or L2 hits
    const Idx at = (Idx)best_c * (Idx)D * (Idx)N + n;
#pragma unroll
    for (int j = 0; j < D; ++j) pol.f[(Idx)j * (Idx)N + n] = op.fc[at + (Idx)j * (Idx)N];
    if (pol.s2 != nullptr) {
#pragma unroll
      for (int j = 0; j < D; ++j) pol.s2[(Idx)j * (Idx)N + n] = op.s2c[at + (Idx)j * (Idx)N];
    }
    if (pol.g != nullptr) pol.g[n] = op.gc[(Idx)best_c * (Idx)N + n];
  }
}

// The fixed-policy sweep of the general form, from the policy's operands:
// every load is one line a warp (fpol, s2 or s2pol, q or gpol, t_mask,
// t_val, best, and v's neighbours); r[best[n]] comes from a table of C
// floats that stays in the L1 cache. The arithmetic is the improve's, so
// under the improve's own policy it repeats the improve's value bit for bit.
template <int D, int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
dense_evaluate_general_kernel(const float* __restrict__ v, const int32_t* __restrict__ best,
                              GeneralOperands op, PolicyOperands pol, GridDesc<Idx> g,
                              long long N, float* __restrict__ vnew) {
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  if (n >= (Idx)N) return;
  if (op.t_mask[n]) {
    vnew[n] = op.t_val[n];
    return;
  }
  const int c = best[n];
  if (c < 0 || c >= op.C) {  // make a bad policy index visible, never read past r
    vnew[n] = nanf("");
    return;
  }
  constexpr bool nu = NU == kNonuniform;
  float vp[D], vm[D], s[D], f[D], Q0, A0;
  Idx coord[D];
  Spacing<D> sp;
  neighbour_values<D, Idx>(n, v, op.t_mask, op.t_val, g, 0, 0.0f, 0.0f, 0, vp, vm, coord);
  if (nu) load_spacing<D, Idx>(g, coord, sp);
  load_planes<D, Idx>(pol.s2 != nullptr ? pol.s2 : op.s2, n, (Idx)N, s);
  diffusion_terms<D, Idx>(s, g, nu, sp, vp, vm, Q0, A0);
  load_planes<D, Idx>(pol.f, n, (Idx)N, f);
  const float gcost = pol.g != nullptr ? pol.g[n] : __fadd_rn(__ldg(op.r + c), op.q[n]);
  vnew[n] = general_rhs<D, Idx>(f, g, nu, sp, vp, vm, Q0, A0, gcost, op.beta);
}

// ---- the general entries' run-time-d form: kMaxD < d <= kMaxDWide -------------------
//
// Replaces, for grids of more than kMaxD dims, the XLA improve and evaluate
// sweeps of c3sc_tpu/solvers/dense.py:106 and :122 and the any-callable
// contract of the Pallas kernel (c3sc_tpu/ops/pallas_dense.py:66-86): JAX's
// dense_vi takes any d. The arithmetic is the compiled forms', step for step
// (the same intrinsics in the same order, the first index on ties), so at
// the same d the two give the same bits; the wrappers' _runtime_d switch
// sends a grid of d <= kMaxD here, and the card tests hold the two to it.
//
// What bounds it on this card is bytes. On the nine-state problem at 5^9
// with 3 candidates (no declarations, so fc, s2c and gc are per candidate)
// the improve reads 237 B a node (76 B a candidate, then v, t_mask, t_val)
// and writes 84 B (vnew, best and the policy's 76 B): 321 B, 0.187 ms at
// 3.35 TB/s, where its float32 operations take 0.02 ms. The evaluate moves
// 93 B a node, 0.054 ms.
//
// The design. Two things keep such a kernel far from that bound: per-dim
// state indexed at run time, which the compiler puts in local memory and a
// candidate reads again from L2, and round trips to device memory that a
// thread makes one after another. Measured on an H100 80GB HBM3 at 700 W
// (experiments/torch_wide_variants.py, PERF.md):
//   - State in registers. One thread a node, as in the compiled forms. The
//     kernels are templates on a capacity DCAP with d <= DCAP a run-time
//     value: every per-dim loop runs over j < DCAP, unrolled, with its body
//     under j < d, so each array and each entry of the grid descriptor is
//     indexed by a constant. Three capacities: 12 and 16 in registers (12
//     because each register array is as long as the capacity: at d = 9 the
//     capacity 16 took more registers a thread, fewer warps an SM, and 10-45 %
//     more time), and kMaxDWide, whose state would spill from registers and
//     lives in the block's shared memory instead.
//   - Loads in flight. A node's own loads (t_mask, t_val, s2 or the policy's
//     operands) are issued before the decode of its neighbours; the evaluate
//     picks its result at the end instead of branching on t_mask and best
//     first. The improve loads a candidate's 2 d + 1 operands before using
//     any, and on a uniform grid candidate c + 1's while it computes c.
//   - The epilogue loads all of the winner's lines before its first store:
//     pol and op are not __restrict__, so a store may alias the next load,
//     and store after load took 2 d + 1 round trips to L2 in a row. This
//     alone took the pipelined improve from 0.33 to 0.27 ms at 5^9.
//   - Non-uniform grids. The node's Spacing-table entries are read once a
//     node, in the decode, and each dim keeps 1/h+, 1/h-, 1/(h+ h-) and
//     cp v+ + cm v-, formed after the decode has issued every dim's loads
//     (formed inside it, each dim waited for its own loads: the evaluate
//     took 0.124 ms at 5^9 on a tanh grid against 0.086).
// The grid descriptor is WideGridDesc, whose arrays have kMaxDWide entries,
// passed as a __grid_constant__ parameter: indexed by constants, its entries
// are operands of the instructions. The compiled forms keep GridDesc.
constexpr int kWideCapSmall = 12;  // the run-time-d form's capacities: d <= 12,
constexpr int kWideCapMid = 16;    // d <= 16 (both in registers), and kMaxDWide
constexpr int kWideBlock = 128;    // threads a block of the run-time-d kernels (but kWideImproveBlock)

template <typename Idx>
struct WideGridDesc {
  int d;
  Idx shape[kMaxDWide];
  Idx stride[kMaxDWide];
  Idx wrap[kMaxDWide];
  uint32_t magic[kMaxDWide];
  int shift[kMaxDWide];
  float ih[kMaxDWide];
  float a_scale[kMaxDWide];
  const float* nu;
  int toff[kMaxDWide];
};

C3SC_FN uint32_t quotient(uint32_t rem, const WideGridDesc<uint32_t>& g, int j) {
  return g.shape[j] == 1 ? rem : __umulhi(rem, g.magic[j]) >> g.shift[j];
}
C3SC_FN long long quotient(long long rem, const WideGridDesc<long long>& g, int j) {
  return rem / g.shape[j];
}

// The per-dim state of one node: v at the +-1 neighbours, as the sweep reads
// it, and on a non-uniform grid what a candidate reads of the node's entry of
// each dim's Spacing table: 1/h+, 1/h-, 1/(h+ h-) and w = cp v+ + cm v- (the
// weight of s2 in A0, rounded as diffusion_terms rounds it). Up to
// kWideCapMid it lives in registers (every index a constant once the loops
// are unrolled); at kMaxDWide, where registers would spill, in the block's
// dynamic shared memory, kWideState arrays of d x kWideBlock floats, each
// thread a column (no bank conflicts).
template <int DCAP>
constexpr bool kWideShared = DCAP > kWideCapMid;
template <int NU>
constexpr int kWideState = NU == kNonuniform ? 6 : 2;  // arrays of per-dim state
// The uniform improve of the register capacities loads candidate c + 1's
// operands while it computes candidate c, and runs in blocks of 256 threads
// (measured on the H100 at 5^9 with 3 candidates: 0.247 ms against 0.273 in
// blocks of 128 and 0.363 without the pipelining). On a non-uniform grid the
// improve's own state leaves no room for a second candidate's operands:
// without the pipelining it ran 0.299 ms against 0.345.
template <int DCAP, int NU>
constexpr bool kWidePipelined = !kWideShared<DCAP> && NU == kUniform;
template <int DCAP, int NU>
constexpr int kWideImproveBlock = kWidePipelined<DCAP, NU> ? 256 : kWideBlock;

template <int DCAP, int NU, bool SHARED = kWideShared<DCAP>>
struct WideNode {
  static constexpr int kNu = NU == kNonuniform ? DCAP : 1;
  float vp_[DCAP], vm_[DCAP], ihp_[kNu], ihm_[kNu], cpm_[kNu], w_[kNu];
  C3SC_FN explicit WideNode(int) {}
  C3SC_FN float& vp(int j) { return vp_[j]; }
  C3SC_FN float& vm(int j) { return vm_[j]; }
  // the non-uniform terms (the uniform form's 1-entry arrays are never read)
  C3SC_FN float& ihp(int j) { return ihp_[NU == kNonuniform ? j : 0]; }
  C3SC_FN float& ihm(int j) { return ihm_[NU == kNonuniform ? j : 0]; }
  C3SC_FN float& cpm(int j) { return cpm_[NU == kNonuniform ? j : 0]; }
  C3SC_FN float& w(int j) { return w_[NU == kNonuniform ? j : 0]; }
};

C3SC_FN float* wide_shared_state() {
  extern __shared__ float wide_state[];
  return wide_state;
}

template <int DCAP, int NU>
struct WideNode<DCAP, NU, true> {
  float* col;  // this thread's column: array k, dim j at col[(k d + j) kWideBlock]
  int plane;   // d kWideBlock
  C3SC_FN explicit WideNode(int d)
      : col(wide_shared_state() + threadIdx.x), plane(d * kWideBlock) {}
  C3SC_FN float& at(int k, int j) { return col[k * plane + j * kWideBlock]; }
  C3SC_FN float& vp(int j) { return at(0, j); }
  C3SC_FN float& vm(int j) { return at(1, j); }
  C3SC_FN float& ihp(int j) { return at(2, j); }
  C3SC_FN float& ihm(int j) { return at(3, j); }
  C3SC_FN float& cpm(int j) { return at(4, j); }
  C3SC_FN float& w(int j) { return at(5, j); }
};

// v at the neighbours of node n (and the node's spacing terms) into w. The
// decode loop only issues loads: a use of a loaded value there (the body is
// a branch on j < d) would wait for that dim's loads before the next dim's
// are issued, so the non-uniform terms are formed in a second loop.
template <int DCAP, int NU, typename Idx>
C3SC_FN void wide_neighbour_values(Idx n, const float* v, const uint8_t* t_mask,
                                   const float* t_val, const WideGridDesc<Idx>& g, int clip,
                                   float lo, float hi, int pin, WideNode<DCAP, NU>& w) {
  float cm[NU == kNonuniform ? DCAP : 1];  // 1/(h- (h+ + h-)) until w is formed
  Idx rem = n;
#pragma unroll
  for (int j = DCAP - 1; j >= 0; --j) {
    if (j < g.d) {
      const Idx len = g.shape[j];
      const Idx s = g.stride[j];
      Idx i = rem;  // the outermost index is what is left
      if (j > 0) {
        const Idx quot = quotient(rem, g, j);
        i = rem - quot * len;
        rem = quot;
      }
      const Idx up = (i + 1 < len) ? n + s : n - g.wrap[j];
      const Idx dn = (i > 0) ? n - s : n + g.wrap[j];
      float a = v[up], b = v[dn];
      if (clip) {
        a = fminf(fmaxf(a, lo), hi);
        b = fminf(fmaxf(b, lo), hi);
      }
      if (pin) {
        if (t_mask[up]) a = t_val[up];
        if (t_mask[dn]) b = t_val[dn];
      }
      w.vp(j) = a;
      w.vm(j) = b;
      if (NU == kNonuniform) {
        const float* e = g.nu + (long long)(g.toff[j] + (int)i) * kSpacingStride;
        const float4 t = __ldg(reinterpret_cast<const float4*>(e));
        w.ihp(j) = t.x;
        w.ihm(j) = t.y;
        w.cpm(j) = t.z;
        w.w(j) = t.w;  // 1/(h+ (h+ + h-)) until w is formed
        cm[NU == kNonuniform ? j : 0] = __ldg(e + 4);
      }
    }
  }
  if (NU != kNonuniform) return;
#pragma unroll
  for (int j = 0; j < DCAP; ++j) {
    if (j < g.d) {
      w.w(j) = fmaf(w.w(j), w.vp(j), __fmul_rn(cm[NU == kNonuniform ? j : 0], w.vm(j)));
    }
  }
}

// x[at + j N] for j < d: the d component planes of a structure-of-arrays
// operand, all loads issued before any value is used.
template <int DCAP, typename Idx>
C3SC_FN void wide_load_planes(const float* x, Idx at, Idx N, int d, float (&out)[DCAP]) {
#pragma unroll
  for (int j = 0; j < DCAP; ++j) out[j] = j < d ? x[at + (Idx)j * N] : 0.0f;
}

// diffusion_terms over the node's d dims from its variances s.
template <int DCAP, int NU, typename Idx>
C3SC_FN void wide_diffusion_terms(const float (&s)[DCAP], const WideGridDesc<Idx>& g,
                                  WideNode<DCAP, NU>& w, float& Q0, float& A0) {
  float q0 = 0.0f, a0 = 0.0f;
#pragma unroll
  for (int j = 0; j < DCAP; ++j) {
    if (j < g.d) {
      if (NU == kNonuniform) {
        q0 = fmaf(s[j], w.cpm(j), q0);
        a0 = fmaf(s[j], w.w(j), a0);
      } else {
        const float a = __fmul_rn(s[j], g.a_scale[j]);
        q0 = fmaf(2.0f, a, q0);
        a0 = fmaf(a, __fadd_rn(w.vp(j), w.vm(j)), a0);
      }
    }
  }
  Q0 = __fadd_rn(q0, 1e-10f);
  A0 = a0;
}

// general_rhs over the node's d dims from the drift f.
template <int DCAP, int NU, typename Idx>
C3SC_FN float wide_general_rhs(const float (&f)[DCAP], const WideGridDesc<Idx>& g,
                               WideNode<DCAP, NU>& w, float Q0, float A0, float gcost,
                               float beta) {
  float Q = Q0;
  float S = 0.0f;
#pragma unroll
  for (int j = 0; j < DCAP; ++j) {
    if (j < g.d) {
      const float ih = NU == kNonuniform ? (f[j] > 0.0f ? w.ihp(j) : w.ihm(j)) : g.ih[j];
      const float fh = __fmul_rn(f[j], ih);
      const float af = fabsf(fh);
      Q = __fadd_rn(Q, af);
      S = fmaf(af, fh > 0.0f ? w.vp(j) : w.vm(j), S);
    }
  }
  const float dt = __frcp_rn(Q);
  const float e = expf(__fmul_rn(-beta, dt));
  return __fmul_rn(dt, fmaf(e, __fadd_rn(A0, S), gcost));
}

// dense_backup_general_kernel with a run-time d <= DCAP. The node's own
// loads (t_mask, t_val, q, s2) are issued before the neighbours' decode.
template <int DCAP, int NU, typename Idx>
__global__ void __launch_bounds__(kWideImproveBlock<DCAP, NU>)
wide_dense_backup_general_kernel(const float* __restrict__ v, GeneralOperands op,
                                 PolicyOperands pol, const __grid_constant__ WideGridDesc<Idx> g,
                                 long long N, int clip, float lo, float hi, int pin,
                                 float* __restrict__ vnew, int32_t* __restrict__ best) {
  const Idx n = (Idx)blockIdx.x * kWideImproveBlock<DCAP, NU> + threadIdx.x;
  if (n >= (Idx)N) return;
  const int d = g.d;
  const Idx nn = (Idx)N;
  const Idx plane = (Idx)d * nn;  // floats of one candidate's [d, N] operands
  const bool term = op.t_mask[n] != 0;
  const float tval = op.t_val[n];
  float s[DCAP], f[DCAP], gc = 0.0f;
  float Q0n = 0.0f, A0n = 0.0f, q = 0.0f;
  if (op.s2 != nullptr) wide_load_planes<DCAP, Idx>(op.s2, n, nn, d, s);
  if (op.q != nullptr) q = op.q[n];
  WideNode<DCAP, NU> w(d);
  wide_neighbour_values<DCAP, NU, Idx>(n, v, op.t_mask, op.t_val, g, clip, lo, hi, pin, w);
  if (op.s2 != nullptr) wide_diffusion_terms<DCAP, NU, Idx>(s, g, w, Q0n, A0n);
  float best_v = 3.4e38f;
  int best_c = 0;
  // candidate c's operands into (fc, s2c, g)
  auto load = [&](int c, float (&fc)[DCAP], float (&s2c)[DCAP], float& gcc) {
    const Idx at = (Idx)c * plane + n;
    wide_load_planes<DCAP, Idx>(op.fc, at, nn, d, fc);
    if (op.s2c != nullptr) wide_load_planes<DCAP, Idx>(op.s2c, at, nn, d, s2c);
    if (op.gc != nullptr) gcc = op.gc[(Idx)c * nn + n];
  };
  auto consider = [&](int c) {  // candidate c from f, s, gc
    float Q0 = Q0n, A0 = A0n;
    if (op.s2c != nullptr) wide_diffusion_terms<DCAP, NU, Idx>(s, g, w, Q0, A0);
    const float gcost = op.gc != nullptr ? gc : __fadd_rn(op.r[c], q);
    const float rhs = wide_general_rhs<DCAP, NU, Idx>(f, g, w, Q0, A0, gcost, op.beta);
    if (rhs < best_v) {
      best_v = rhs;
      best_c = c;
    }
  };
  if constexpr (!kWidePipelined<DCAP, NU>) {
    for (int c = 0; c < op.C; ++c) {
      load(c, f, s, gc);
      consider(c);
    }
  } else {
    float fn[DCAP], sn[DCAP], gn = 0.0f;  // the next candidate's operands, in flight
    load(0, fn, sn, gn);
    for (int c = 0; c < op.C; ++c) {
#pragma unroll
      for (int j = 0; j < DCAP; ++j) {
        f[j] = fn[j];
        if (op.s2c != nullptr) s[j] = sn[j];
      }
      gc = gn;
      if (c + 1 < op.C) load(c + 1, fn, sn, gn);
      consider(c);
    }
  }
  if (clip) best_v = fminf(fmaxf(best_v, lo), hi);
  vnew[n] = term ? tval : best_v;
  best[n] = best_c;
  if (pol.f != nullptr) {
    // The warp read the winner's lines in the loop: L1 or L2 hits. All of
    // them are loaded before the first store, which the compiler may not
    // move a load across (pol and op are not __restrict__).
    load(best_c, f, s, gc);
#pragma unroll
    for (int j = 0; j < DCAP; ++j)
      if (j < d) pol.f[(Idx)j * nn + n] = f[j];
    if (pol.s2 != nullptr) {
#pragma unroll
      for (int j = 0; j < DCAP; ++j)
        if (j < d) pol.s2[(Idx)j * nn + n] = s[j];
    }
    if (pol.g != nullptr) pol.g[n] = gc;
  }
}

// dense_evaluate_general_kernel with a run-time d <= DCAP. Every load of
// the node's own operands is issued first, whether or not the node is
// terminal or its policy index valid, and the result is picked at the end:
// one round trip to device memory a node instead of three in a row.
template <int DCAP, int NU, typename Idx>
__global__ void __launch_bounds__(kWideBlock)
wide_dense_evaluate_general_kernel(const float* __restrict__ v, const int32_t* __restrict__ best,
                                   GeneralOperands op, PolicyOperands pol,
                                   const __grid_constant__ WideGridDesc<Idx> g, long long N,
                                   float* __restrict__ vnew) {
  const Idx n = (Idx)blockIdx.x * kWideBlock + threadIdx.x;
  if (n >= (Idx)N) return;
  const int d = g.d;
  const Idx nn = (Idx)N;
  const bool term = op.t_mask[n] != 0;
  const float tval = op.t_val[n];
  const int c = best[n];
  float s[DCAP], f[DCAP], Q0, A0;
  wide_load_planes<DCAP, Idx>(pol.s2 != nullptr ? pol.s2 : op.s2, n, nn, d, s);
  wide_load_planes<DCAP, Idx>(pol.f, n, nn, d, f);
  const float gn = pol.g != nullptr ? pol.g[n] : op.q[n];
  WideNode<DCAP, NU> w(d);
  wide_neighbour_values<DCAP, NU, Idx>(n, v, op.t_mask, op.t_val, g, 0, 0.0f, 0.0f, 0, w);
  const bool bad = c < 0 || c >= op.C;  // make a bad policy index visible, never read past r
  wide_diffusion_terms<DCAP, NU, Idx>(s, g, w, Q0, A0);
  const float gcost = pol.g != nullptr ? gn : __fadd_rn(__ldg(op.r + (bad ? 0 : c)), gn);
  const float rhs = wide_general_rhs<DCAP, NU, Idx>(f, g, w, Q0, A0, gcost, op.beta);
  vnew[n] = term ? tval : bad ? nanf("") : rhs;
}

// ---- host side ---------------------------------------------------------------------

// Desc is GridDesc or WideGridDesc.
template <template <typename> class Desc>
inline void set_magic(Desc<uint32_t>* g, int j, long long len) {
  int l = 0;
  while ((1LL << l) < len) ++l;
  g->magic[j] = len == 1 ? 0u : (uint32_t)(((1ULL << (31 + l)) + len - 1) / len);
  g->shift[j] = len == 1 ? 0 : l - 1;
}
template <template <typename> class Desc>
inline void set_magic(Desc<long long>* g, int j, long long) {
  g->magic[j] = 0u;
  g->shift[j] = 0;
}

template <template <typename> class Desc, typename Idx>
void make_desc(int d, const long long* shape, const float* h, const int* periodic,
               const float* nu, Desc<Idx>* g) {
  g->nu = nu;
  int off = 0;
  for (int j = 0; j < d; ++j) {
    g->toff[j] = off;
    off += (int)shape[j];
  }
  long long total = 1;
  for (int j = d - 1; j >= 0; --j) {
    g->shape[j] = (Idx)shape[j];
    g->stride[j] = (Idx)total;
    g->wrap[j] = periodic[j] ? (Idx)((shape[j] - 1) * total) : (Idx)0;
    g->ih[j] = 1.0f / h[j];
    g->a_scale[j] = 0.5f / (h[j] * h[j]);
    set_magic(g, j, shape[j]);
    total *= shape[j];
  }
}

// One call of either entry point, as the C interface receives it.
struct Call {
  const float* v;
  const int32_t* best_in;  // the policy of an evaluate sweep; null for improve
  Operands op;
  float* vnew;
  int32_t* best_out;
  int d, du;
  const long long* shape;
  const float* h;
  const int* periodic;
  const float* nu;  // the Spacing tables of a non-uniform grid on the device, else null
  int clip;
  float lo, hi;
  int pin;
  int wide;  // force 64-bit indices (a test's switch; large grids take them anyway)
  cudaStream_t stream;
  int preload;  // load both sweeps' kernels of this instantiation, launch nothing
};

// Loads the kernels a later launch (or a CUDA graph's capture of one) will
// run: with lazy module loading a kernel is otherwise loaded at its first
// launch, which a stream capture cannot do.
template <typename K1, typename K2>
cudaError_t preload_kernels(K1 improve, K2 evaluate) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, improve);
  return err != cudaSuccess ? err : cudaFuncGetAttributes(&attr, evaluate);
}

template <int D, int DU, int NU, typename Idx>
cudaError_t launch(const Call& c, long long N) {
  if (c.preload)
    return preload_kernels(dense_backup_kernel<D, DU, NU, Idx>,
                           dense_evaluate_kernel<D, DU, NU, Idx>);
  GridDesc<Idx> g;
  make_desc(c.d, c.shape, c.h, c.periodic, c.nu, &g);
  const unsigned blocks = (unsigned)((N + kBlock - 1) / kBlock);
  if (c.best_in == nullptr) {
    dense_backup_kernel<D, DU, NU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.op, g, N, c.clip, c.lo, c.hi, c.pin, c.vnew, c.best_out);
  } else {
    dense_evaluate_kernel<D, DU, NU, Idx><<<blocks, kBlock, 0, c.stream>>>(c.v, c.best_in, c.op,
                                                                           g, N, c.vnew);
  }
  return cudaGetLastError();
}

// The stencil's form of one launch: non-uniform where the grid has tables.
template <int D, int DU, typename Idx>
cudaError_t run_form(const Call& c, long long N) {
  if (c.nu != nullptr) return launch<D, DU, kNonuniform, Idx>(c, N);
  return launch<D, DU, kUniform, Idx>(c, N);
}

template <int D, int DU>
cudaError_t run(const Call& c, long long N) {
  if (c.wide || N >= (1LL << 31)) return run_form<D, DU, long long>(c, N);
  return run_form<D, DU, uint32_t>(c, N);
}

// Instantiate for every (d, du) in [1, 8] x [1, 4].
#define C3SC_DISPATCH_DU(D)                      \
  switch (c.du) {                                \
    case 1: return run<D, 1>(c, N);              \
    case 2: return run<D, 2>(c, N);              \
    case 3: return run<D, 3>(c, N);              \
    case 4: return run<D, 4>(c, N);              \
    default: return cudaErrorInvalidValue;       \
  }

// Nodes of a valid grid of d <= kMaxDWide dims, or -1.
long long grid_nodes(int d, const long long* shape, const float* h) {
  if (d < 1 || d > kMaxDWide) return -1;
  long long N = 1;
  for (int j = 0; j < d; ++j) {
    if (shape[j] < 1 || !(h[j] > 0.0f)) return -1;
    N *= shape[j];
  }
  return (N + kBlock - 1) / kBlock > 0x7fffffffLL ? -1 : N;
}

cudaError_t dispatch(const Call& c) {
  const long long N = grid_nodes(c.d, c.shape, c.h);
  if (N < 0 || c.op.C < 1) return cudaErrorInvalidValue;
  switch (c.d) {
    case 1: C3SC_DISPATCH_DU(1)
    case 2: C3SC_DISPATCH_DU(2)
    case 3: C3SC_DISPATCH_DU(3)
    case 4: C3SC_DISPATCH_DU(4)
    case 5: C3SC_DISPATCH_DU(5)
    case 6: C3SC_DISPATCH_DU(6)
    case 7: C3SC_DISPATCH_DU(7)
    case 8: C3SC_DISPATCH_DU(8)
    default: return cudaErrorInvalidValue;
  }
}

// One call of either general entry.
struct GeneralCall {
  const float* v;
  const int32_t* best_in;  // the policy of an evaluate sweep; null for improve
  GeneralOperands op;
  PolicyOperands pol;      // written by improve (where not null), read by evaluate
  float* vnew;
  int32_t* best_out;
  int d;
  const long long* shape;
  const float* h;
  const int* periodic;
  const float* nu;
  int clip;
  float lo, hi;
  int pin;
  int wide;
  int runtime_d;  // run the run-time-d form at any d (a test's switch; d > kMaxD takes it anyway)
  cudaStream_t stream;
  int preload;
};

template <int D, int NU, typename Idx>
cudaError_t launch_general(const GeneralCall& c, long long N) {
  if (c.preload)
    return preload_kernels(dense_backup_general_kernel<D, NU, Idx>,
                           dense_evaluate_general_kernel<D, NU, Idx>);
  GridDesc<Idx> g;
  make_desc(c.d, c.shape, c.h, c.periodic, c.nu, &g);
  const unsigned blocks = (unsigned)((N + kBlock - 1) / kBlock);
  if (c.best_in == nullptr) {
    dense_backup_general_kernel<D, NU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.op, c.pol, g, N, c.clip, c.lo, c.hi, c.pin, c.vnew, c.best_out);
  } else {
    dense_evaluate_general_kernel<D, NU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.best_in, c.op, c.pol, g, N, c.vnew);
  }
  return cudaGetLastError();
}

template <int D, typename Idx>
cudaError_t run_general_form(const GeneralCall& c, long long N) {
  if (c.nu != nullptr) return launch_general<D, kNonuniform, Idx>(c, N);
  return launch_general<D, kUniform, Idx>(c, N);
}

template <int D>
cudaError_t run_general(const GeneralCall& c, long long N) {
  // the largest offset is that of the [C, d, N] operands
  if (c.wide || (long long)c.op.C * D * N >= (1LL << 31))
    return run_general_form<D, long long>(c, N);
  return run_general_form<D, uint32_t>(c, N);
}

// Bytes of dynamic shared memory a block of the run-time-d kernels takes.
template <int DCAP, int NU>
int wide_shared_bytes(int d) {
  return kWideShared<DCAP> ? kWideState<NU> * d * kWideBlock * (int)sizeof(float) : 0;
}

// Lets the shared-memory capacity's kernels take their state at every
// d <= kMaxDWide (above 48 KB a block). Outside a stream capture only: the
// preload before a capture sets it.
template <typename K>
cudaError_t allow_wide_shared(K kernel, int bytes, cudaStream_t stream) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  if (stream != nullptr) cudaStreamIsCapturing(stream, &capturing);
  if (capturing != cudaStreamCaptureStatusNone) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DCAP, int NU, typename Idx>
cudaError_t launch_general_wide(const GeneralCall& c, long long N) {
  auto improve = wide_dense_backup_general_kernel<DCAP, NU, Idx>;
  auto evaluate = wide_dense_evaluate_general_kernel<DCAP, NU, Idx>;
  const int smem = wide_shared_bytes<DCAP, NU>(c.preload ? kMaxDWide : c.d);
  cudaError_t err = allow_wide_shared(improve, smem, c.stream);
  if (err == cudaSuccess) err = allow_wide_shared(evaluate, smem, c.stream);
  if (err != cudaSuccess) return err;
  if (c.preload) return preload_kernels(improve, evaluate);
  WideGridDesc<Idx> g;
  make_desc(c.d, c.shape, c.h, c.periodic, c.nu, &g);
  g.d = c.d;
  if (c.best_in == nullptr) {
    constexpr int block = kWideImproveBlock<DCAP, NU>;
    improve<<<(unsigned)((N + block - 1) / block), block, smem, c.stream>>>(
        c.v, c.op, c.pol, g, N, c.clip, c.lo, c.hi, c.pin, c.vnew, c.best_out);
  } else {
    evaluate<<<(unsigned)((N + kWideBlock - 1) / kWideBlock), kWideBlock, smem, c.stream>>>(
        c.v, c.best_in, c.op, c.pol, g, N, c.vnew);
  }
  return cudaGetLastError();
}

template <int DCAP>
cudaError_t run_general_wide_cap(const GeneralCall& c, long long N) {
  const bool wide = c.wide || (long long)c.op.C * c.d * N >= (1LL << 31);
  if (c.nu != nullptr)
    return wide ? launch_general_wide<DCAP, kNonuniform, long long>(c, N)
                : launch_general_wide<DCAP, kNonuniform, uint32_t>(c, N);
  return wide ? launch_general_wide<DCAP, kUniform, long long>(c, N)
              : launch_general_wide<DCAP, kUniform, uint32_t>(c, N);
}

// The run-time-d form (kMaxD < d <= kMaxDWide, or any d under runtime_d):
// the smallest capacity that holds d; the index width and the stencil's
// form as in run_general.
cudaError_t run_general_wide(const GeneralCall& c, long long N) {
  if (c.d <= kWideCapSmall) return run_general_wide_cap<kWideCapSmall>(c, N);
  if (c.d <= kWideCapMid) return run_general_wide_cap<kWideCapMid>(c, N);
  if (c.d <= kMaxDWide) return run_general_wide_cap<kMaxDWide>(c, N);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_general(const GeneralCall& c) {
  const long long N = grid_nodes(c.d, c.shape, c.h);
  const GeneralOperands& op = c.op;
  const PolicyOperands& pol = c.pol;
  if (N < 0 || op.C < 1) return cudaErrorInvalidValue;
  if (!c.preload) {
    if (op.fc == nullptr || (op.s2 == nullptr) == (op.s2c == nullptr) ||
        ((op.q != nullptr && op.r != nullptr) == (op.gc != nullptr)))
      return cudaErrorInvalidValue;
    // an evaluate reads, and a policy-keeping improve writes, every policy
    // operand that is per candidate
    const bool keeps = c.best_in != nullptr || pol.f != nullptr;
    if (keeps && (pol.f == nullptr || (pol.s2 == nullptr) != (op.s2c == nullptr) ||
                  (pol.g == nullptr) != (op.gc == nullptr)))
      return cudaErrorInvalidValue;
  }
  if (c.runtime_d) return run_general_wide(c, N);
  switch (c.d) {
    case 1: return run_general<1>(c, N);
    case 2: return run_general<2>(c, N);
    case 3: return run_general<3>(c, N);
    case 4: return run_general<4>(c, N);
    case 5: return run_general<5>(c, N);
    case 6: return run_general<6>(c, N);
    case 7: return run_general<7>(c, N);
    case 8: return run_general<8>(c, N);
    default: return run_general_wide(c, N);  // grid_nodes took 8 < d <= kMaxDWide
  }
}

}  // namespace

extern "C" {

// One improve sweep. f0, G and s2 are structure-of-arrays ([d,N], [d,du,N],
// [d,N]); nu is null on a uniform grid, else the Spacing tables of a
// non-uniform one on the device (sum_k n_k entries of kSpacingStride
// floats: 1/h+, 1/h-, 1/(h+ h-), 1/(h+ (h+ + h-)), 1/(h- (h+ + h-)) for
// coordinate i of dim k in entry n_0 + ... + n_{k-1} + i). Returns
// cudaGetLastError() after the launch (0 = ok).
int c3sc_dense_backup(const float* v, const float* f0, const float* G, const float* s2,
                      const float* q, const float* r, const float* uc,
                      const uint8_t* t_mask, const float* t_val, float* vnew, int32_t* best,
                      int d, int du, int C, const long long* shape, const float* h,
                      const int* periodic, const float* nu, float beta, int clip, float lo,
                      float hi, int pin_input, int wide, void* stream) {
  const Call c{v,     nullptr, {f0, G, s2, q, r, uc, t_mask, t_val, C, beta}, vnew, best, d, du,
               shape, h,       periodic, nu, clip, lo, hi, pin_input, wide,
               (cudaStream_t)stream, 0};
  return (int)dispatch(c);
}

// One fixed-policy evaluate sweep under the candidate indices `best`.
int c3sc_dense_evaluate(const float* v, const int32_t* best, const float* f0, const float* G,
                        const float* s2, const float* q, const float* r, const float* uc,
                        const uint8_t* t_mask, const float* t_val, float* vnew, int d, int du,
                        int C, const long long* shape, const float* h, const int* periodic,
                        const float* nu, float beta, int wide, void* stream) {
  if (best == nullptr) return (int)cudaErrorInvalidValue;
  const Call c{v,     best, {f0, G, s2, q, r, uc, t_mask, t_val, C, beta}, vnew, nullptr, d, du,
               shape, h,    periodic, nu, 0, 0.0f, 0.0f, 0, wide, (cudaStream_t)stream, 0};
  return (int)dispatch(c);
}

// One improve sweep of the general form: fc [C,d,N]; s2 [d,N] or s2c [C,d,N];
// q [N] with r [C], or gc [C,N]; the absent ones null. Where fpol is not null
// the winner's operands go to fpol [d,N], s2pol [d,N] (where s2c is given)
// and gpol [N] (where gc is). nu as in c3sc_dense_backup. runtime_d runs the
// run-time-d form also at d <= kMaxD.
int c3sc_dense_backup_general(const float* v, const float* fc, const float* s2,
                              const float* s2c, const float* q, const float* r,
                              const float* gc, const uint8_t* t_mask, const float* t_val,
                              float* vnew, int32_t* best, float* fpol, float* s2pol, float* gpol,
                              int d, int C, const long long* shape, const float* h,
                              const int* periodic, const float* nu, float beta, int clip,
                              float lo, float hi, int pin_input, int wide, int runtime_d,
                              void* stream) {
  const GeneralCall c{v, nullptr, {fc, s2, s2c, q, r, gc, t_mask, t_val, C, beta},
                      {fpol, s2pol, gpol}, vnew, best, d, shape, h, periodic, nu, clip, lo, hi,
                      pin_input, wide, runtime_d, (cudaStream_t)stream, 0};
  return (int)dispatch_general(c);
}

// One fixed-policy sweep of the general form under the policy (best, fpol,
// s2pol, gpol) that an improve sweep's epilogue wrote, or a gather of it;
// runtime_d as in c3sc_dense_backup_general.
int c3sc_dense_evaluate_general(const float* v, const int32_t* best, const float* fpol,
                                const float* s2pol, const float* gpol, const float* fc,
                                const float* s2, const float* s2c, const float* q,
                                const float* r, const float* gc, const uint8_t* t_mask,
                                const float* t_val, float* vnew, int d, int C,
                                const long long* shape, const float* h, const int* periodic,
                                const float* nu, float beta, int wide, int runtime_d,
                                void* stream) {
  if (best == nullptr) return (int)cudaErrorInvalidValue;
  const GeneralCall c{v, best, {fc, s2, s2c, q, r, gc, t_mask, t_val, C, beta},
                      {const_cast<float*>(fpol), const_cast<float*>(s2pol),
                       const_cast<float*>(gpol)},
                      vnew, nullptr, d, shape, h, periodic, nu, 0, 0.0f, 0.0f, 0, wide,
                      runtime_d, (cudaStream_t)stream, 0};
  return (int)dispatch_general(c);
}

// Load the improve and evaluate kernels that a launch on this grid would run
// (the structured ones for du >= 1, the general ones for du = 0, in their
// run-time-d form where d > kMaxD; the non-uniform ones where nu is not
// null), launching nothing: a CUDA graph's capture can then record their
// launches.
int c3sc_dense_preload(int d, int du, int C, const long long* shape, const float* h,
                       const int* periodic, const float* nu) {
  if (du == 0) {
    GeneralCall c{};
    c.op.C = C;
    c.d = d;
    c.shape = shape;
    c.h = h;
    c.periodic = periodic;
    c.nu = nu;
    c.preload = 1;
    return (int)dispatch_general(c);
  }
  Call c{};
  c.op.C = C;
  c.d = d;
  c.du = du;
  c.shape = shape;
  c.h = h;
  c.periodic = periodic;
  c.nu = nu;
  c.preload = 1;
  return (int)dispatch(c);
}

}  // extern "C"
