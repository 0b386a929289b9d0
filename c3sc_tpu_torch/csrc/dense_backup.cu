// K1's C interface (kernel K1 of the port; the kernels, their design notes
// and their launchers are in dense_backup.cuh): argument checks, and
// dispatch by d to the translation units that instantiate the kernels.

#include "dense_backup.cuh"

namespace c3sc {

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
    case 1: return run_d<1>(c, N);
    case 2: return run_d<2>(c, N);
    case 3: return run_d<3>(c, N);
    case 4: return run_d<4>(c, N);
    case 5: return run_d<5>(c, N);
    case 6: return run_d<6>(c, N);
    case 7: return run_d<7>(c, N);
    case 8: return run_d<8>(c, N);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_general(const GeneralCall& c) {
  const long long N = grid_nodes(c.d, c.shape, c.h);
  const GeneralOperands& op = c.op;
  const PolicyOperands& pol = c.pol;
  if (N < 0 || op.C < 1 || c.lane_bits < 0 || (1 << c.lane_bits) > kMaxLanes)
    return cudaErrorInvalidValue;
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

}  // namespace c3sc

using namespace c3sc;

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
// run-time-d form also at d <= kMaxD. lanes (1, 2, 4, ..., kMaxLanes) is the
// compiled form's lanes a node (the run-time-d form ignores it).
int c3sc_dense_backup_general(const float* v, const float* fc, const float* s2,
                              const float* s2c, const float* q, const float* r,
                              const float* gc, const uint8_t* t_mask, const float* t_val,
                              float* vnew, int32_t* best, float* fpol, float* s2pol, float* gpol,
                              int d, int C, const long long* shape, const float* h,
                              const int* periodic, const float* nu, float beta, int clip,
                              float lo, float hi, int pin_input, int wide, int runtime_d,
                              int lanes, void* stream) {
  int lane_bits = 0;
  while (lane_bits < 6 && (1 << lane_bits) < lanes) ++lane_bits;
  if (lanes != (1 << lane_bits)) return (int)cudaErrorInvalidValue;
  const GeneralCall c{v, nullptr, {fc, s2, s2c, q, r, gc, t_mask, t_val, C, beta},
                      {fpol, s2pol, gpol}, vnew, best, d, shape, h, periodic, nu, clip, lo, hi,
                      pin_input, wide, runtime_d, lane_bits, (cudaStream_t)stream, 0};
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
                      runtime_d, 0, (cudaStream_t)stream, 0};
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
