// The int8 convolution of the int8 serving path, as one implicit GEMM.
//
// Replaces `octave_tpu/ops/quant.py::int8_conv` and
// `int8_conv_transpose_2x2` (:118-203): XLA ops there, not a Pallas kernel.
// The JAX design quantises the activation on its way in (a static scale),
// runs one int8 x int8 -> int32 conv and dequantises with the bias in its
// epilogue. This kernel does all of it in one pass over an NHWC activation:
//
//   out[m, n] = cast(float(sum_k q(A[m, k]) * W[n, k]) * (sx * ws[n]) + bias[n])
//
// with M = B*Ho*Wo rows, N output channels and K = kh*kw*C_in in the packed
// weight's (kh, kw, C_in) order (`ops/quant.py::pack_weight`; a grouped conv
// is block-diagonal there). A is never written: each block gathers its tile
// of A from the activation with the implicit-im2col index (stride, padding,
// dilation; zeros outside the image) and quantises it as it loads it,
// q = clamp(rint(x / sx), -127, 127) with a true division, as
// `quantize_activation` and the JAX package compute it. The products run on
// the tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), exact in int32. The
// epilogue dequantises in float32 (__fmul_rn, __fadd_rn: no contraction,
// built with -fmad=false too), rounds once to the output dtype and stores
// NHWC. Two store modes: the 2x2 stride-2 ConvTranspose (column (i, j, o)
// of row (b, h, w) goes to out[b, 2h+i, 2w+j, o]) and the decoder's pair
// (a second activation over its own packed weight and scales; each sum is
// dequantised and rounded to the output dtype, then the two are added in
// float and rounded again, the plain path's order, so the result is the
// same bit for bit).
//
// What bounds it on an H100: the decoder's 3x3 convs do 150-2,600 int8
// operations per byte of bf16 activation they read, above the card's ridge
// (1,979 TOP/s over 3.35 TB/s, ~590), so the deep ones are bound by the
// tensor cores and the shallow ones (C_in 64) near the memory. What the
// design does about it: no im2col, int32 or float32 intermediate reaches
// device memory (the plain route wrote all three), and the quantisation,
// which costs ALU work per loaded element, is kept off the products' way:
//   * 3x3 stride-1 convs with C_in % 32 == 0 (every decoder 3x3) take the
//     halo path (int8_conv.cuh, HaloConv): a tile of output pixels loads
//     its input halo once per 32-channel chunk, quantises each element
//     once into shared memory, and all nine taps read it from there
//     (ldmatrix), beside the chunk's weights of every tap (cp.async);
//   * every other conv (1x1, strided, the stem's C_in = 3) and the
//     ConvTranspose take the per-tap path (Conv): the A tile is gathered
//     and quantised per K step into shared memory, the next step's global
//     loads in flight while the tensor cores work on the current one;
//   * the quantisation is a multiply by 1 / sx with the true division only
//     near a rounding tie, and no float-to-int conversion (quant1).
// What it leaves: mma.sync reaches only part of Hopper's int8 rate, and
// the halo path waits for each chunk's loads behind a barrier (the SM's
// second block fills that time); wgmma, TMA and a deeper pipeline are the
// next step.
//
// The pair parks its first sum, rounded to the output dtype, in the output
// and reads it back after the second (each thread its own elements), so
// no second set of accumulators stays live.
//
// Launch hygiene: no allocation, no synchronisation; the attributes are set
// once per device by octave_int8_conv_init, never during a launch or a
// capture; each launch returns cudaGetLastError().
#include "int8_conv.cuh"

// The C entry point (bound with ctypes by `ops/kernels/int8_conv.py`).
// dtype: 0 float32, 1 bfloat16, 2 float16 (activations, output and a bias
// that is not float32). The second source (xb ... ldb_rows) is read when
// nsrc == 2. vec: every source has C_in % 8 == 0 and 16-byte aligned rows.
extern "C" int octave_int8_conv(
    const void* xa, const void* wa, const void* wsa, const void* sxa, int ca, int ka, int lda,
    int rows_a, const void* xb, const void* wb, const void* wsb, const void* sxb, int cb, int kb,
    int ldb, int rows_b, int nsrc, const void* bias, int bias_f32, void* out, int dtype, int vec,
    int b, int h, int w, int ho, int wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
    int dw, int n, int cout, int transpose, int store2, void* stream) {
  using namespace octave;
  Params p;
  p.src[0] = Source{xa, static_cast<const int8_t*>(wa), static_cast<const float*>(wsa),
                    static_cast<const float*>(sxa), ca, ka, lda, rows_a};
  p.src[1] = Source{xb, static_cast<const int8_t*>(wb), static_cast<const float*>(wsb),
                    static_cast<const float*>(sxb), cb, kb, ldb, rows_b};
  p.nsrc = nsrc;
  p.bias = bias;
  p.bias_f32 = bias_f32;
  p.out = out;
  p.h = h; p.w = w; p.ho = ho; p.wo = wo;
  p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.n = n; p.cout = cout; p.transpose = transpose; p.store2 = store2;
  p.m = static_cast<long long>(b) * ho * wo;
  p.tr = p.tc = p.row_tiles = p.col_tiles = 0;  // set where the halo path applies
  if (p.m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(p, vec != 0, s);
    case 1: return launch_bf16(p, vec != 0, s);
    case 2: return launch_f16(p, vec != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Set what the kernels need once per device (the halo kernels' dynamic
// shared memory) on the current device; call at load time, outside any
// CUDA-graph capture. Returns the first error, or 0.
extern "C" int octave_int8_conv_init() {
  cudaError_t e = octave::init_f32();
  if (e == cudaSuccess) e = octave::init_bf16();
  if (e == cudaSuccess) e = octave::init_f16();
  return static_cast<int>(e);
}

// cudaGetErrorString of an entry point's return value
extern "C" const char* octave_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
