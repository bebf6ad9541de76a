// The int8 conv kernel's per-tap __half instances and their dispatch (see
// int8_conv.cu).
#include "int8_conv.cuh"

namespace octave {
cudaError_t launch_f16(const Params& p, bool vec, int force, int* path,
                        cudaStream_t stream) {
  return launch_dtype<__half>(p, vec, force, path, stream);
}
}  // namespace octave
