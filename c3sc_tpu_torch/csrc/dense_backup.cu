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
// Design, against what bounds it on this card. The TPU kernel held the whole
// grid in VMEM (d <= 3) and traced the user callables into its body. Here the
// callables are replaced by the x-only tensors of the problem's structure
// declarations, precomputed once per problem and grid: f0 [N,d], G [N,d,du],
// s2 [N,d], q [N], plus r [C], uc [C,du]. One thread owns one node: it reads
// those once (N*(d + d*du + d + 1)*4 bytes a sweep, 100 B a node for the 6D
// quadcopter, plus the 2d neighbour reads of v, which neighbouring threads
// share through L1/L2), keeps every candidate-independent term in registers,
// and recomputes each candidate's stencil there, so the [C,N,d] stencil is
// never written to or streamed from device memory (about 2.5 GB at 11^6 in
// the XLA form, against about 0.2 GB of inputs here). At 11^6 with 25
// candidates the memory floor is about 0.06 ms a sweep at 3.35 TB/s. The
// arithmetic is heavier: per candidate and dim four IEEE divisions, per
// candidate one expf, no fast math, so results stay within float rounding
// of the JAX package. Measured on an H100 80GB HBM3 at 700 W: 1.91 ms a
// sweep at 11^6 with 25 candidates, about 0.07 ms more per candidate on a
// 0.19 ms base, some 30x the memory floor. The sweep is bound by its
// arithmetic, not by bytes; trading the divisions for reciprocals is the
// first lever. The evaluate sweep (one candidate) runs in about 0.16 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define C3SC_FN __device__ __forceinline__

namespace {

constexpr int kMaxD = 8;
constexpr int kMaxDU = 4;

struct GridDesc {
  long long shape[kMaxD];
  long long stride[kMaxD];
  float h[kMaxD];
  int periodic[kMaxD];
};

// The x-only and candidate tensors of one problem on one grid.
struct Operands {
  const float* f0;        // [N, d]
  const float* G;         // [N, d, du]
  const float* s2;        // [N, d]
  const float* q;         // [N]
  const float* r;         // [C]
  const float* uc;        // [C, du]
  const uint8_t* t_mask;  // [N]
  const float* t_val;     // [N]
  int C;
  float beta;
};

// +-1 neighbours of flat node n along every dim: wrap on periodic dims,
// clamp on bounded ones (the node itself at the face).
template <int D>
C3SC_FN void neighbour_offsets(long long n, const GridDesc& g, long long (&up)[D],
                               long long (&dn)[D]) {
  long long rem = n;
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    const long long len = g.shape[j];
    const long long s = g.stride[j];
    const long long i = rem % len;
    rem /= len;
    up[j] = (i + 1 < len) ? n + s : (g.periodic[j] ? n - i * s : n);
    dn[j] = (i > 0) ? n - s : (g.periodic[j] ? n + (len - 1) * s : n);
  }
}

// Node-local, candidate-independent part of the stencil.
template <int D, int DU>
struct NodeTerms {
  float f0[D];
  float G[D][DU];
  float diffpart[D];  // s2 / (2 h^2)
  float q;
};

template <int D, int DU>
C3SC_FN void load_node(long long n, const Operands& op, const GridDesc& g,
                       NodeTerms<D, DU>& t) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    t.f0[j] = op.f0[n * D + j];
    t.diffpart[j] = 0.5f * op.s2[n * D + j] / (g.h[j] * g.h[j]);
#pragma unroll
    for (int m = 0; m < DU; ++m) t.G[j][m] = op.G[(n * D + j) * DU + m];
  }
  t.q = op.q[n];
}

// Bellman right-hand side of candidate c at one node, in the term order of
// c3sc_tpu/ops/mca.py::_stencil_from_fs2 and of the Pallas kernel.
template <int D, int DU>
C3SC_FN float candidate_rhs(const NodeTerms<D, DU>& t, const float (&vp)[D],
                            const float (&vm)[D], const Operands& op, int c,
                            const GridDesc& g) {
  float f[D];
  float Q = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float gu = 0.0f;
#pragma unroll
    for (int m = 0; m < DU; ++m) gu += t.G[j][m] * op.uc[c * DU + m];
    f[j] = t.f0[j] + gu;
    Q += 2.0f * t.diffpart[j] + fabsf(f[j]) / g.h[j];
  }
  Q += 1e-10f;
  const float dt = 1.0f / Q;
  float expect = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float pp = (t.diffpart[j] + fmaxf(f[j], 0.0f) / g.h[j]) / Q;
    const float pm = (t.diffpart[j] + fmaxf(-f[j], 0.0f) / g.h[j]) / Q;
    expect += pp * vp[j] + pm * vm[j];
  }
  return (op.r[c] + t.q) * dt + expf(-op.beta * dt) * expect;
}

// One node of the improve sweep.
template <int D, int DU>
C3SC_FN void backup_node(long long n, const float* v, const Operands& op, const GridDesc& g,
                         int clip, float lo, float hi, int pin, float* vnew, int32_t* best) {
  long long up[D], dn[D];
  neighbour_offsets<D>(n, g, up, dn);
  float vp[D], vm[D];
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
  NodeTerms<D, DU> t;
  load_node<D, DU>(n, op, g, t);
  float best_v = 3.4e38f;
  int best_c = 0;
  for (int c = 0; c < op.C; ++c) {
    const float rhs = candidate_rhs<D, DU>(t, vp, vm, op, c, g);
    if (rhs < best_v) {
      best_v = rhs;
      best_c = c;
    }
  }
  if (clip) best_v = fminf(fmaxf(best_v, lo), hi);
  vnew[n] = op.t_mask[n] ? op.t_val[n] : best_v;
  best[n] = best_c;
}

// One node of the fixed-policy evaluate sweep.
template <int D, int DU>
C3SC_FN void evaluate_node(long long n, const float* v, const int32_t* best,
                           const Operands& op, const GridDesc& g, float* vnew) {
  if (op.t_mask[n]) {
    vnew[n] = op.t_val[n];
    return;
  }
  const int c = best[n];
  if (c < 0 || c >= op.C) {  // make a bad policy index visible, never read past uc
    vnew[n] = nanf("");
    return;
  }
  long long up[D], dn[D];
  neighbour_offsets<D>(n, g, up, dn);
  float vp[D], vm[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    vp[j] = v[up[j]];
    vm[j] = v[dn[j]];
  }
  NodeTerms<D, DU> t;
  load_node<D, DU>(n, op, g, t);
  vnew[n] = candidate_rhs<D, DU>(t, vp, vm, op, c, g);
}

inline bool make_desc(int d, int du, int C, const long long* shape, const float* h,
                      const int* periodic, GridDesc* g, long long* N) {
  if (d < 1 || d > kMaxD || du < 1 || du > kMaxDU || C < 1) return false;
  long long total = 1;
  for (int j = d - 1; j >= 0; --j) {
    if (shape[j] < 1) return false;
    g->shape[j] = shape[j];
    g->stride[j] = total;
    g->h[j] = h[j];
    g->periodic[j] = periodic[j];
    total *= shape[j];
  }
  *N = total;
  return true;
}

constexpr int kBlock = 256;

template <int D, int DU>
__global__ void __launch_bounds__(kBlock)
dense_backup_kernel(const float* __restrict__ v, Operands op, GridDesc g, long long N, int clip,
                    float lo, float hi, int pin, float* __restrict__ vnew,
                    int32_t* __restrict__ best) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n < N) backup_node<D, DU>(n, v, op, g, clip, lo, hi, pin, vnew, best);
}

template <int D, int DU>
__global__ void __launch_bounds__(kBlock)
dense_evaluate_kernel(const float* __restrict__ v, const int32_t* __restrict__ best,
                      Operands op, GridDesc g, long long N, float* __restrict__ vnew) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n < N) evaluate_node<D, DU>(n, v, best, op, g, vnew);
}

inline unsigned n_blocks(long long N) { return (unsigned)((N + kBlock - 1) / kBlock); }

template <int D, int DU>
cudaError_t launch_backup(const float* v, const Operands& op, const GridDesc& g, long long N,
                          int clip, float lo, float hi, int pin, float* vnew, int32_t* best,
                          cudaStream_t s) {
  dense_backup_kernel<D, DU><<<n_blocks(N), kBlock, 0, s>>>(v, op, g, N, clip, lo, hi, pin,
                                                             vnew, best);
  return cudaGetLastError();
}

template <int D, int DU>
cudaError_t launch_evaluate(const float* v, const int32_t* best, const Operands& op,
                            const GridDesc& g, long long N, float* vnew, cudaStream_t s) {
  dense_evaluate_kernel<D, DU><<<n_blocks(N), kBlock, 0, s>>>(v, best, op, g, N, vnew);
  return cudaGetLastError();
}

// Instantiate for every (d, du) in [1, 8] x [1, 4] and return FN<d, du>(args...).
#define C3SC_DISPATCH_DU(D, FN, ...)             \
  switch (du) {                                  \
    case 1: return FN<D, 1>(__VA_ARGS__);        \
    case 2: return FN<D, 2>(__VA_ARGS__);        \
    case 3: return FN<D, 3>(__VA_ARGS__);        \
    case 4: return FN<D, 4>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;       \
  }
#define C3SC_DISPATCH(FN, ...)                   \
  switch (d) {                                   \
    case 1: C3SC_DISPATCH_DU(1, FN, __VA_ARGS__) \
    case 2: C3SC_DISPATCH_DU(2, FN, __VA_ARGS__) \
    case 3: C3SC_DISPATCH_DU(3, FN, __VA_ARGS__) \
    case 4: C3SC_DISPATCH_DU(4, FN, __VA_ARGS__) \
    case 5: C3SC_DISPATCH_DU(5, FN, __VA_ARGS__) \
    case 6: C3SC_DISPATCH_DU(6, FN, __VA_ARGS__) \
    case 7: C3SC_DISPATCH_DU(7, FN, __VA_ARGS__) \
    case 8: C3SC_DISPATCH_DU(8, FN, __VA_ARGS__) \
    default: return cudaErrorInvalidValue;       \
  }

cudaError_t dispatch_backup(int d, int du, const float* v, const Operands& op,
                            const GridDesc& g, long long N, int clip, float lo, float hi,
                            int pin, float* vnew, int32_t* best, cudaStream_t s) {
  C3SC_DISPATCH(launch_backup, v, op, g, N, clip, lo, hi, pin, vnew, best, s)
}

cudaError_t dispatch_evaluate(int d, int du, const float* v, const int32_t* best,
                              const Operands& op, const GridDesc& g, long long N, float* vnew,
                              cudaStream_t s) {
  C3SC_DISPATCH(launch_evaluate, v, best, op, g, N, vnew, s)
}

bool grid_fits(long long N) { return (N + kBlock - 1) / kBlock <= 0x7fffffffLL; }

}  // namespace

extern "C" {

// One improve sweep. Returns cudaGetLastError() after the launch (0 = ok).
int c3sc_dense_backup(const float* v, const float* f0, const float* G, const float* s2,
                      const float* q, const float* r, const float* uc,
                      const uint8_t* t_mask, const float* t_val, float* vnew, int32_t* best,
                      int d, int du, int C, const long long* shape, const float* h,
                      const int* periodic, float beta, int clip, float lo, float hi,
                      int pin_input, void* stream) {
  GridDesc g;
  long long N = 0;
  if (!make_desc(d, du, C, shape, h, periodic, &g, &N) || !grid_fits(N))
    return (int)cudaErrorInvalidValue;
  const Operands op{f0, G, s2, q, r, uc, t_mask, t_val, C, beta};
  return (int)dispatch_backup(d, du, v, op, g, N, clip, lo, hi, pin_input, vnew, best,
                              (cudaStream_t)stream);
}

// One fixed-policy evaluate sweep under the candidate indices `best`.
int c3sc_dense_evaluate(const float* v, const int32_t* best, const float* f0, const float* G,
                        const float* s2, const float* q, const float* r, const float* uc,
                        const uint8_t* t_mask, const float* t_val, float* vnew, int d, int du,
                        int C, const long long* shape, const float* h, const int* periodic,
                        float beta, void* stream) {
  GridDesc g;
  long long N = 0;
  if (!make_desc(d, du, C, shape, h, periodic, &g, &N) || !grid_fits(N))
    return (int)cudaErrorInvalidValue;
  const Operands op{f0, G, s2, q, r, uc, t_mask, t_val, C, beta};
  return (int)dispatch_evaluate(d, du, v, best, op, g, N, vnew, (cudaStream_t)stream);
}

}  // extern "C"
