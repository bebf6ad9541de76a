// The int8 conv kernel's halo-path float instances (see int8_conv.cu).
#include "int8_conv.cuh"

namespace octave {
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const float*) {
  return launch_halo<float>(p, stream);
}
cudaError_t init_f32() { return init_dtype<float>(); }
}  // namespace octave
