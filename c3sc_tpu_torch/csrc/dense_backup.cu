// Whole-grid dense Bellman sweep for Hopper (sm_90a) — kernel K1 of the port.
//
// Replaces the Pallas TPU kernel c3sc_tpu/ops/pallas_dense.py
// (make_pallas_dense_backup, its inner `kernel`, and _neighbor_tables), and
// carries the fixed-policy `evaluate` sweep of c3sc_tpu/solvers/dense.py
// (make_dense_step.evaluate) as a second entry point.
//
// What it computes, per grid node n (row-major multi-index, any d <= 8):
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define C3SC_FN __device__ __forceinline__

namespace {

constexpr int kMaxD = 8;
constexpr int kMaxDU = 4;
constexpr int kBlock = 256;
constexpr int kCandTile = 512;  // candidates staged in shared memory at a time

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
};

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
// clamp on bounded ones (the node itself at the face).
template <int D, typename Idx>
C3SC_FN void neighbour_offsets(Idx n, const GridDesc<Idx>& g, Idx (&up)[D], Idx (&dn)[D]) {
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
  }
}

// Node-local, candidate-independent part of the factored stencil.
template <int D, int DU>
struct NodeTerms {
  float f0h[D];     // f0 / h
  float Gh[D][DU];  // G / h
  float vp[D];      // v at the +1 neighbours
  float vm[D];      // v at the -1 neighbours
  float Q0;         // sum_j s2_j / h_j^2 + 1e-10
  float A0;         // sum_j a_j (v+_j + v-_j)
  float q;
};

// Fills the rest of t from the node's operands and from t.vp, t.vm.
template <int D, int DU, typename Idx>
C3SC_FN void load_node(Idx n, long long N, const Operands& op, const GridDesc<Idx>& g,
                       NodeTerms<D, DU>& t) {
  float Q0 = 0.0f, A0 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float ih = g.ih[j];
    const float a = __fmul_rn(op.s2[j * N + n], g.a_scale[j]);
    t.f0h[j] = __fmul_rn(op.f0[j * N + n], ih);
#pragma unroll
    for (int m = 0; m < DU; ++m) t.Gh[j][m] = __fmul_rn(op.G[(j * DU + m) * N + n], ih);
    Q0 = fmaf(2.0f, a, Q0);
    A0 = fmaf(a, __fadd_rn(t.vp[j], t.vm[j]), A0);
  }
  t.Q0 = __fadd_rn(Q0, 1e-10f);
  t.A0 = A0;
  t.q = op.q[n];
}

// Bellman right-hand side of the candidate (u, r) at one node, factored form.
template <int D, int DU>
C3SC_FN float candidate_rhs(const NodeTerms<D, DU>& t, const float (&u)[DU], float r,
                            float beta) {
  float Q = t.Q0;
  float S = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float fh = t.f0h[j];
#pragma unroll
    for (int m = 0; m < DU; ++m) fh = fmaf(t.Gh[j][m], u[m], fh);
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

// v at the +-1 neighbours of node n, as the sweep reads it.
template <int D, typename Idx>
C3SC_FN void neighbour_values(Idx n, const float* v, const Operands& op, const GridDesc<Idx>& g,
                              int clip, float lo, float hi, int pin, float (&vp)[D],
                              float (&vm)[D]) {
  Idx up[D], dn[D];
  neighbour_offsets<D, Idx>(n, g, up, dn);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    vp[j] = v[up[j]];
    vm[j] = v[dn[j]];
    if (clip) {
      vp[j] = fminf(fmaxf(vp[j], lo), hi);
      vm[j] = fminf(fmaxf(vm[j], lo), hi);
    }
    if (pin) {
      if (op.t_mask[up[j]]) vp[j] = op.t_val[up[j]];
      if (op.t_mask[dn[j]]) vm[j] = op.t_val[dn[j]];
    }
  }
}

// The improve sweep: one thread a node, the block's candidates in shared memory.
template <int D, int DU, typename Idx>
__global__ void __launch_bounds__(kBlock)
dense_backup_kernel(const float* __restrict__ v, Operands op, GridDesc<Idx> g, long long N,
                    int clip, float lo, float hi, int pin, float* __restrict__ vnew,
                    int32_t* __restrict__ best) {
  constexpr int kStride = kCandStride<DU>;
  __shared__ float4 cand4[kCandTile * kStride / 4];
  float* cand = reinterpret_cast<float*>(cand4);
  const Idx n = (Idx)blockIdx.x * kBlock + threadIdx.x;
  const bool active = n < (Idx)N;
  NodeTerms<D, DU> t;
  if (active) {
    neighbour_values<D, Idx>(n, v, op, g, clip, lo, hi, pin, t.vp, t.vm);
    load_node<D, DU, Idx>(n, N, op, g, t);
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
        const float rhs = candidate_rhs<D, DU>(t, u, r, op.beta);
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
template <int D, int DU, typename Idx>
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
  NodeTerms<D, DU> t;
  neighbour_values<D, Idx>(n, v, op, g, 0, 0.0f, 0.0f, 0, t.vp, t.vm);
  load_node<D, DU, Idx>(n, N, op, g, t);
  float u[DU];
#pragma unroll
  for (int m = 0; m < DU; ++m) u[m] = op.uc[c * DU + m];
  vnew[n] = candidate_rhs<D, DU>(t, u, op.r[c], op.beta);
}

// ---- host side ---------------------------------------------------------------------

inline void set_magic(GridDesc<uint32_t>* g, int j, long long len) {
  int l = 0;
  while ((1LL << l) < len) ++l;
  g->magic[j] = len == 1 ? 0u : (uint32_t)(((1ULL << (31 + l)) + len - 1) / len);
  g->shift[j] = len == 1 ? 0 : l - 1;
}
inline void set_magic(GridDesc<long long>* g, int j, long long) {
  g->magic[j] = 0u;
  g->shift[j] = 0;
}

template <typename Idx>
void make_desc(int d, const long long* shape, const float* h, const int* periodic,
               GridDesc<Idx>* g) {
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
  int clip;
  float lo, hi;
  int pin;
  int wide;  // force 64-bit indices (a test's switch; large grids take them anyway)
  cudaStream_t stream;
};

template <int D, int DU, typename Idx>
cudaError_t launch(const Call& c, long long N) {
  GridDesc<Idx> g;
  make_desc<Idx>(c.d, c.shape, c.h, c.periodic, &g);
  const unsigned blocks = (unsigned)((N + kBlock - 1) / kBlock);
  if (c.best_in == nullptr) {
    dense_backup_kernel<D, DU, Idx><<<blocks, kBlock, 0, c.stream>>>(
        c.v, c.op, g, N, c.clip, c.lo, c.hi, c.pin, c.vnew, c.best_out);
  } else {
    dense_evaluate_kernel<D, DU, Idx><<<blocks, kBlock, 0, c.stream>>>(c.v, c.best_in, c.op, g,
                                                                       N, c.vnew);
  }
  return cudaGetLastError();
}

template <int D, int DU>
cudaError_t run(const Call& c, long long N) {
  if (c.wide || N >= (1LL << 31)) return launch<D, DU, long long>(c, N);
  return launch<D, DU, uint32_t>(c, N);
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

cudaError_t dispatch(const Call& c) {
  if (c.d < 1 || c.d > kMaxD || c.op.C < 1) return cudaErrorInvalidValue;
  long long N = 1;
  for (int j = 0; j < c.d; ++j) {
    if (c.shape[j] < 1 || !(c.h[j] > 0.0f)) return cudaErrorInvalidValue;
    N *= c.shape[j];
  }
  if ((N + kBlock - 1) / kBlock > 0x7fffffffLL) return cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// One improve sweep. f0, G and s2 are structure-of-arrays ([d,N], [d,du,N],
// [d,N]). Returns cudaGetLastError() after the launch (0 = ok).
int c3sc_dense_backup(const float* v, const float* f0, const float* G, const float* s2,
                      const float* q, const float* r, const float* uc,
                      const uint8_t* t_mask, const float* t_val, float* vnew, int32_t* best,
                      int d, int du, int C, const long long* shape, const float* h,
                      const int* periodic, float beta, int clip, float lo, float hi,
                      int pin_input, int wide, void* stream) {
  const Call c{v,  nullptr, {f0, G, s2, q, r, uc, t_mask, t_val, C, beta}, vnew, best, d, du, shape,
               h,  periodic, clip, lo, hi, pin_input, wide, (cudaStream_t)stream};
  return (int)dispatch(c);
}

// One fixed-policy evaluate sweep under the candidate indices `best`.
int c3sc_dense_evaluate(const float* v, const int32_t* best, const float* f0, const float* G,
                        const float* s2, const float* q, const float* r, const float* uc,
                        const uint8_t* t_mask, const float* t_val, float* vnew, int d, int du,
                        int C, const long long* shape, const float* h, const int* periodic,
                        float beta, int wide, void* stream) {
  if (best == nullptr) return (int)cudaErrorInvalidValue;
  const Call c{v,  best, {f0, G, s2, q, r, uc, t_mask, t_val, C, beta}, vnew, nullptr, d, du, shape,
               h,  periodic, 0, 0.0f, 0.0f, 0, wide, (cudaStream_t)stream};
  return (int)dispatch(c);
}

}  // extern "C"
