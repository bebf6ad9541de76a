// The int8 conv kernel's halo-path __half instances (see int8_conv.cu).
#include "int8_conv.cuh"

namespace octave {
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const __half*) {
  return launch_halo<__half>(p, stream);
}
cudaError_t init_f16() { return init_dtype<__half>(); }
}  // namespace octave
