// The general entries' run-time-d kernels.
// One of K1's translation units, compiled in parallel with the others
// (dense_backup.cuh, "The build").

#include "dense_backup.cuh"

namespace c3sc {

cudaError_t run_general_wide(const GeneralCall& c, long long N) {
  if (c.d <= kWideCapSmall) return run_general_wide_cap<kWideCapSmall>(c, N);
  if (c.d <= kWideCapMid) return run_general_wide_cap<kWideCapMid>(c, N);
  if (c.d <= kMaxDWide) return run_general_wide_cap<kMaxDWide>(c, N);
  return cudaErrorInvalidValue;
}

}  // namespace c3sc
