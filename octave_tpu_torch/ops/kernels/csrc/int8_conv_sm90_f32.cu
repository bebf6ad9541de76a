// The int8 conv kernel's wide-halo-path (wgmma) float instances (see int8_conv.cu).
#include "int8_conv_sm90.cuh"

namespace octave {
cudaError_t launch_sm90_of(const Params& p, const Sm90Plan& plan, cudaStream_t stream,
                           const float*) {
  return launch_sm90<float>(p, plan, stream);
}
cudaError_t init_sm90_f32() { return init_sm90<float>(); }
}  // namespace octave
