// The general entries' compiled kernels at d = 5 to 8.
// One of K1's translation units, compiled in parallel with the others
// (dense_backup.cuh, "The build").

#include "dense_backup.cuh"

namespace c3sc {

template cudaError_t run_general<5>(const GeneralCall&, long long);
template cudaError_t run_general<6>(const GeneralCall&, long long);
template cudaError_t run_general<7>(const GeneralCall&, long long);
template cudaError_t run_general<8>(const GeneralCall&, long long);

}  // namespace c3sc
