// The int8 conv kernel's wide-halo-path (wgmma) __half instances (see int8_conv.cu).
#include "int8_conv_sm90.cuh"

namespace octave {
cudaError_t launch_sm90_of(const Params& p, const Sm90Plan& plan, cudaStream_t stream,
                           const __half*) {
  return launch_sm90<__half>(p, plan, stream);
}
cudaError_t init_sm90_f16() { return init_sm90<__half>(); }
}  // namespace octave
