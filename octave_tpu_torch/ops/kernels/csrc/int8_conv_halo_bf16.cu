// The int8 conv kernel's halo-path __nv_bfloat16 instances (see int8_conv.cu).
#include "int8_conv.cuh"

namespace octave {
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const __nv_bfloat16*) {
  return launch_halo<__nv_bfloat16>(p, stream);
}
cudaError_t init_bf16() { return init_dtype<__nv_bfloat16>(); }
}  // namespace octave
