// The int8 conv kernel's per-tap __nv_bfloat16 instances and their dispatch (see
// int8_conv.cu).
#include "int8_conv.cuh"

namespace octave {
cudaError_t launch_bf16(const Params& p, bool vec, int force, int* path,
                        cudaStream_t stream) {
  return launch_dtype<__nv_bfloat16>(p, vec, force, path, stream);
}
}  // namespace octave
