// The structured entries' kernels at d = 5 and 6.
// One of K1's translation units, compiled in parallel with the others
// (dense_backup.cuh, "The build").

#include "dense_backup.cuh"

namespace c3sc {

template cudaError_t run_d<5>(const Call&, long long);
template cudaError_t run_d<6>(const Call&, long long);

}  // namespace c3sc
