// The general entries' compiled kernels at d = 1 to 4.
// One of K1's translation units, compiled in parallel with the others
// (dense_backup.cuh, "The build").

#include "dense_backup.cuh"

namespace c3sc {

template cudaError_t run_general<1>(const GeneralCall&, long long);
template cudaError_t run_general<2>(const GeneralCall&, long long);
template cudaError_t run_general<3>(const GeneralCall&, long long);
template cudaError_t run_general<4>(const GeneralCall&, long long);

}  // namespace c3sc
