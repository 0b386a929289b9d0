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

// ---- the general entries' run-time-d form: 8 < d <= kMaxDWide ----------------------
//
// A problem of more than eight states (and any structured problem beyond the
// structured entries' d <= 8, du <= 4) takes the general entries; above
// kMaxD they run these two kernels, whose d is a run-time value, rather than
// more template instantiations: each D would add four kernels to a build that
// already takes about a minute. The arithmetic is the compiled forms', step
// for step (the same intrinsics in the same order), so a dim's terms round as
// they do there. What changes is where the per-dim state lives: the neighbour
// values v+-_j and the node's spacing-table entries are arrays of capacity
// kMaxDWide indexed at run time, so they sit in local memory (each thread's
// own, interleaved so that a warp's access of one j is one line, cached in
// L1), and the operands fc, s2c, s2 are read dim by dim inside the loops
// that use them, never held. At d >= 9 a candidate reads 4 d bytes of fc a
// node, so the sweep is bound by device memory; the local arrays add L1
// traffic, not device-memory traffic, while they stay in the cache. The grid
// descriptor is WideGridDesc, whose arrays have kMaxDWide entries; it is
// passed as a __grid_constant__ parameter, so that indexing it at run time
// reads the parameter in place instead of copying it to every thread's
// local memory. GridDesc and the compiled forms are unchanged.
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
// it, and (non-uniform grids) the node's entry of each dim's Spacing table.
struct WideNode {
  float vp[kMaxDWide];
  float vm[kMaxDWide];
  int row[kMaxDWide];
};

template <typename Idx>
C3SC_FN void wide_neighbour_values(Idx n, const float* v, const uint8_t* t_mask,
                                   const float* t_val, const WideGridDesc<Idx>& g, int clip,
                                   float lo, float hi, int pin, WideNode& w) {
  Idx rem = n;
  for (int j = g.d - 1; j >= 0; --j) {
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
    w.vp[j] = a;
    w.vm[j] = b;
    w.row[j] = g.toff[j] + (int)i;
  }
}

// The node's Spacing-table entry of dim j: 1/h+, 1/h-, 1/(h+ h-),
// 1/(h+ (h+ + h-)), 1/(h- (h+ + h-)).
template <typename Idx>
C3SC_FN const float* wide_spacing(const WideGridDesc<Idx>& g, const WideNode& w, int j) {
  return g.nu + (long long)w.row[j] * kSpacingStride;
}

// diffusion_terms from the variances s2[at + j N], read dim by dim.
template <typename Idx>
C3SC_FN void wide_diffusion_terms(const float* s2, Idx at, Idx N, const WideGridDesc<Idx>& g,
                                  bool nu, const WideNode& w, float& Q0, float& A0) {
  float q0 = 0.0f, a0 = 0.0f;
  for (int j = 0; j < g.d; ++j) {
    const float s = s2[at + (Idx)j * N];
    if (nu) {
      const float* e = wide_spacing(g, w, j);
      q0 = fmaf(s, __ldg(e + 2), q0);
      a0 = fmaf(s, fmaf(__ldg(e + 3), w.vp[j], __fmul_rn(__ldg(e + 4), w.vm[j])), a0);
    } else {
      const float a = __fmul_rn(s, g.a_scale[j]);
      q0 = fmaf(2.0f, a, q0);
      a0 = fmaf(a, __fadd_rn(w.vp[j], w.vm[j]), a0);
    }
  }
  Q0 = __fadd_rn(q0, 1e-10f);
  A0 = a0;
}

// general_rhs from the drift f[at + j N], read dim by dim.
template <typename Idx>
C3SC_FN float wide_general_rhs(const float* f, Idx at, Idx N, const WideGridDesc<Idx>& g,
                               bool nu, const WideNode& w, float Q0, float A0, float gcost,
                               float beta) {
  float Q = Q0;
  float S = 0.0f;
  for (int j = 0; j < g.d; ++j) {
    const float fj = f[at + (Idx)j * N];
    const float fh = __fmul_rn(
        fj, nu ? __ldg(wide_spacing(g, w, j) + (fj > 0.0f ? 0 : 1)) : g.ih[j]);
    const float af = fabsf(fh);
    Q = __fadd_rn(Q, af);
    S = fmaf(af, fh > 0.0f ? w.vp[j] : w.vm[j], S);
  }
  const float dt = __frcp_rn(Q);
  const float e = expf(__fmul_rn(-beta, dt));
  return __fmul_rn(dt, fmaf(e, __fadd_rn(A0, S), gcost));
}

// dense_backup_general_kernel with a run-time d.
template <int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
wide_dense_backup_general_kernel(const float* __restrict__ v, GeneralOperands op,
                                 PolicyOperands pol, const __grid_constant__ WideGridDesc<Idx> g,
                                 long long N, int clip, float lo, float hi, int pin,
                                 float* __restrict__ vnew, int32_t* __restrict__ best) {
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  if (n >= (Idx)N) return;
  constexpr bool nu = NU == kNonuniform;
  const Idx nn = (Idx)N;
  const Idx plane = (Idx)g.d * nn;  // floats of one candidate's [d, N] operands
  WideNode w;
  wide_neighbour_values<Idx>(n, v, op.t_mask, op.t_val, g, clip, lo, hi, pin, w);
  float Q0n = 0.0f, A0n = 0.0f, q = 0.0f;
  if (op.s2 != nullptr) wide_diffusion_terms<Idx>(op.s2, n, nn, g, nu, w, Q0n, A0n);
  if (op.q != nullptr) q = op.q[n];
  float best_v = 3.4e38f;
  int best_c = 0;
  for (int c = 0; c < op.C; ++c) {
    const Idx at = (Idx)c * plane + n;
    float Q0 = Q0n, A0 = A0n;
    if (op.s2c != nullptr) wide_diffusion_terms<Idx>(op.s2c, at, nn, g, nu, w, Q0, A0);
    const float gcost = op.gc != nullptr ? op.gc[(Idx)c * nn + n] : __fadd_rn(op.r[c], q);
    const float rhs = wide_general_rhs<Idx>(op.fc, at, nn, g, nu, w, Q0, A0, gcost, op.beta);
    if (rhs < best_v) {
      best_v = rhs;
      best_c = c;
    }
  }
  if (clip) best_v = fminf(fmaxf(best_v, lo), hi);
  vnew[n] = op.t_mask[n] ? op.t_val[n] : best_v;
  best[n] = best_c;
  if (pol.f != nullptr) {  // the warp read the winner's lines in the loop: L1 or L2 hits
    const Idx at = (Idx)best_c * plane + n;
    for (int j = 0; j < g.d; ++j) pol.f[(Idx)j * nn + n] = op.fc[at + (Idx)j * nn];
    if (pol.s2 != nullptr) {
      for (int j = 0; j < g.d; ++j) pol.s2[(Idx)j * nn + n] = op.s2c[at + (Idx)j * nn];
    }
    if (pol.g != nullptr) pol.g[n] = op.gc[(Idx)best_c * nn + n];
  }
}

// dense_evaluate_general_kernel with a run-time d.
template <int NU, typename Idx>
__global__ void __launch_bounds__(kBlock)
wide_dense_evaluate_general_kernel(const float* __restrict__ v, const int32_t* __restrict__ best,
                                   GeneralOperands op, PolicyOperands pol,
                                   const __grid_constant__ WideGridDesc<Idx> g, long long N,
                                   float* __restrict__ vnew) {
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
  const Idx nn = (Idx)N;
  float Q0, A0;
  WideNode w;
  wide_neighbour_values<Idx>(n, v, op.t_mask, op.t_val, g, 0, 0.0f, 0.0f, 0, w);
  wide_diffusion_terms<Idx>(pol.s2 != nullptr ? pol.s2 : op.s2, n, nn, g, nu, w, Q0, A0);
  const float gcost = pol.g != nullptr ? pol.g[n] : __fadd_rn(__ldg(op.r + c), op.q[n]);
  vnew[n] = wide_general_rhs<Idx>(pol.f, n, nn, g, nu, w, Q0, A0, gcost, op.beta);
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

template <int NU, typename Idx>
cudaError_t launch_general_wide(const GeneralCall& c, long long N) {
  if (c.preload)
    return preload_kernels(wide_dense_backup_general_kernel<NU, Idx>,
                           wide_dense_evaluate_general_kernel<NU, Idx>);
  WideGridDesc<Idx> g;
  make_desc(c.d, c.shape, c.h, c.periodic, c.nu, &g);
  g.d = c.d;
  const unsigned blocks = (unsigned)((N + kBlock - 1) / kBlock);
  if (c.best_in == nullptr) {
    wide_dense_backup_general_kernel<NU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.op, c.pol, g, N, c.clip, c.lo, c.hi, c.pin, c.vnew, c.best_out);
  } else {
    wide_dense_evaluate_general_kernel<NU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.best_in, c.op, c.pol, g, N, c.vnew);
  }
  return cudaGetLastError();
}

// The run-time-d form (kMaxD < d <= kMaxDWide): the index width and the
// stencil's form as in run_general.
cudaError_t run_general_wide(const GeneralCall& c, long long N) {
  const bool wide = c.wide || (long long)c.op.C * c.d * N >= (1LL << 31);
  if (c.nu != nullptr)
    return wide ? launch_general_wide<kNonuniform, long long>(c, N)
                : launch_general_wide<kNonuniform, uint32_t>(c, N);
  return wide ? launch_general_wide<kUniform, long long>(c, N)
              : launch_general_wide<kUniform, uint32_t>(c, N);
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
// and gpol [N] (where gc is). nu as in c3sc_dense_backup.
int c3sc_dense_backup_general(const float* v, const float* fc, const float* s2,
                              const float* s2c, const float* q, const float* r,
                              const float* gc, const uint8_t* t_mask, const float* t_val,
                              float* vnew, int32_t* best, float* fpol, float* s2pol, float* gpol,
                              int d, int C, const long long* shape, const float* h,
                              const int* periodic, const float* nu, float beta, int clip,
                              float lo, float hi, int pin_input, int wide, void* stream) {
  const GeneralCall c{v, nullptr, {fc, s2, s2c, q, r, gc, t_mask, t_val, C, beta},
                      {fpol, s2pol, gpol}, vnew, best, d, shape, h, periodic, nu, clip, lo, hi,
                      pin_input, wide, (cudaStream_t)stream, 0};
  return (int)dispatch_general(c);
}

// One fixed-policy sweep of the general form under the policy (best, fpol,
// s2pol, gpol) that an improve sweep's epilogue wrote, or a gather of it.
int c3sc_dense_evaluate_general(const float* v, const int32_t* best, const float* fpol,
                                const float* s2pol, const float* gpol, const float* fc,
                                const float* s2, const float* s2c, const float* q,
                                const float* r, const float* gc, const uint8_t* t_mask,
                                const float* t_val, float* vnew, int d, int C,
                                const long long* shape, const float* h, const int* periodic,
                                const float* nu, float beta, int wide, void* stream) {
  if (best == nullptr) return (int)cudaErrorInvalidValue;
  const GeneralCall c{v, best, {fc, s2, s2c, q, r, gc, t_mask, t_val, C, beta},
                      {const_cast<float*>(fpol), const_cast<float*>(s2pol),
                       const_cast<float*>(gpol)},
                      vnew, nullptr, d, shape, h, periodic, nu, 0, 0.0f, 0.0f, 0, wide,
                      (cudaStream_t)stream, 0};
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
