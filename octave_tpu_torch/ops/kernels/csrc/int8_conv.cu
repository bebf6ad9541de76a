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
// the tensor cores (s8 x s8 -> s32: wgmma on the wide halo path, mma.sync
// elsewhere), exact in int32. The
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
// (1,979 TOP/s over 3.35 TB/s, ~590), so the deep ones (depths 2-4, about
// 2,300 operations a byte) are bound by the tensor cores and the shallow
// ones (C_in 64) near the memory. What the design does about it: no
// im2col, int32 or float32 intermediate reaches device memory (the plain
// route wrote all three), and the quantisation, which costs ALU work per
// loaded element, is kept off the products' way. Three paths, chosen by
// the call's shape alone (int8_conv.cuh, launch_dtype):
//   * the wide halo path (int8_conv_sm90.cuh, HaloConvSm90): 3x3 stride-1
//     padding-1 convs with C_in % 32 == 0 and N >= 128, a multiple of 8
//     (every decoder 3x3 of depths 1-4, at any batch). Hopper's own
//     pipeline: a persistent block of three warpgroups. In the producer
//     warpgroup, warps 0-2 bring each 32-channel stage's raw halo one stage
//     ahead (a TMA box per grid row, 64- or 128-byte swizzle) and quantise
//     it (quant1's arithmetic, its exact branch out of line) into a ring of
//     four halo stages, and warp 3 brings the stage's weights of all nine
//     taps (TMA, one box of 32 bytes x BN rows a tap, 32-byte swizzle) into
//     a ring of two to four, each
//     completion counted on its stage's full mbarrier; two consumer
//     warpgroups run wgmma m64nBNk32 s8 (BN 256, or 128 where N is not a
//     multiple of 256) from shared memory, nine taps per stage, with int32
//     sums in registers, and hand each stage back on its empty mbarriers.
//     No block-wide barrier in the K loop: while the consumers run stage s
//     the producers fill the next ones, the quantisation up to four ahead,
//     and during a tile's epilogue the next tile's first stages. setmaxnreg
//     gives the consumers 200 registers and the producer 104. A, the
//     quantised halo, is read through a descriptor, without a swizzle, not
//     loaded with ldmatrix: a tile is 128 positions of a grid that lays rows
//     end to end with a zero between neighbours (a pad column after each
//     row, a pad row after each image; images wider than 20 columns cut into
//     strips of ~19 columns with their own halo columns), so every tap is
//     the same shift of the halo for every row of the tile and costs only
//     a descriptor's start address, where ldmatrix would need registers the
//     consumers' 128 int32 sums leave no room for (a core matrix is 8
//     consecutive halo positions x 16 channels; the halo is stored by
//     16-channel slices, the leading byte offset is the slice pitch, the
//     stride byte offset 128 bytes). Each element is quantised ~1.5 x
//     (C_out / 256) times; grid positions in the pad row and columns are
//     computed and not stored (10-12% of the grid). The epilogue stages
//     each warp's rows in shared memory and stores whole 16-byte pieces;
//   * the halo path (int8_conv.cuh, HaloConv): the other 3x3 stride-1
//     convs with C_in % 32 == 0 (depth 0's and depth 1's first, N < 128):
//     a tile of output pixels loads its input halo once per 32-channel
//     chunk, quantises each element once into shared memory, and all nine
//     taps read it from there (ldmatrix, mma.sync), beside the chunk's
//     weights of every tap (cp.async);
//   * every other conv (1x1, strided, the stem's C_in = 3) and the
//     ConvTranspose take the per-tap path (Conv): the A tile is gathered
//     and quantised per K step into shared memory, the next step's global
//     loads in flight while the tensor cores work on the current one;
//   * the quantisation is a multiply by 1 / sx with the true division only
//     near a rounding tie, and no float-to-int conversion (quant1).
// Int32 sums are exact in any order, and every path's epilogue does the
// same float32 arithmetic, so the three give the same bits. What it
// leaves: the per-tap path's 1x1
// shortcuts (mma.sync, the A tile quantised per K step); the halo path's
// 32- and 64-wide tiles at depths 0-1 (mma.sync behind two barriers per
// chunk); the dense-lowered grouped convs (`conv.3.conv` at depths 2-4
// runs its block-diagonal weight whole, three quarters of its K zeros);
// the wide path's own limit: its two-stage ring at BN 256 is bound by
// latency (the producer's quantise and the weights' TMA against the
// products: ~35% of the int8 rate at depths 2-4), and every tile reads its
// weights from L2 (256 operations a weight byte), not multicast across a
// cluster.
//
// The pair parks its first sum, rounded to the output dtype, in the output
// and reads it back after the second (each thread its own elements), so
// no second set of accumulators stays live.
//
// Launch hygiene: no allocation, no synchronisation; the attributes are set
// once per device by octave_int8_conv_init, never during a launch or a
// capture; the wide path's TMA maps are built on the host at each launch
// and passed by value (__grid_constant__), so a CUDA graph captures them;
// each launch returns cudaGetLastError().
#include "int8_conv.cuh"

// The C entry point (bound with ctypes by `ops/kernels/int8_conv.py`).
// dtype: 0 float32, 1 bfloat16, 2 float16 (activations, output and a bias
// that is not float32). The second source (xb ... ldb_rows) is read when
// nsrc == 2. vec: every source has C_in % 8 == 0 and 16-byte aligned rows.
// force: -1 the path the shape selects, else that path (0 per-tap, 1 halo,
// 2 wide halo; an error where it does not apply); *path: the path taken.
extern "C" int octave_int8_conv(
    const void* xa, const void* wa, const void* wsa, const void* sxa, int ca, int ka, int lda,
    int rows_a, const void* xb, const void* wb, const void* wsb, const void* sxb, int cb, int kb,
    int ldb, int rows_b, int nsrc, const void* bias, int bias_f32, void* out, int dtype, int vec,
    int b, int h, int w, int ho, int wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
    int dw, int n, int cout, int transpose, int store2, void* stream, int force, int* path) {
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
  *path = -1;
  if (p.m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(p, vec != 0, force, path, s);
    case 1: return launch_bf16(p, vec != 0, force, path, s);
    case 2: return launch_f16(p, vec != 0, force, path, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace octave {
namespace {
void* g_encode = nullptr;  // cuTensorMapEncodeTiled
}
void* tensor_map_encoder() { return g_encode; }
}  // namespace octave

// Set what the kernels need once per device (the halo kernels' dynamic
// shared memory; CUDA's TMA map encoder) on the current device; call
// at load time, outside any CUDA-graph capture. Returns the first error, or 0.
extern "C" int octave_int8_conv_init() {
  cudaError_t e = octave::init_f32();
  if (e == cudaSuccess) e = octave::init_bf16();
  if (e == cudaSuccess) e = octave::init_f16();
  if (e == cudaSuccess) e = octave::init_sm90_f32();
  if (e == cudaSuccess) e = octave::init_sm90_bf16();
  if (e == cudaSuccess) e = octave::init_sm90_f16();
  if (e == cudaSuccess && octave::g_encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &octave::g_encode, 12000,
                                         cudaEnableDefault, &found);
#else
    e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &octave::g_encode, cudaEnableDefault,
                                &found);
#endif
    if (e == cudaSuccess && found != cudaDriverEntryPointSuccess) {
      octave::g_encode = nullptr;
      e = cudaErrorNotSupported;
    }
  }
  return static_cast<int>(e);
}

// cudaGetErrorString of an entry point's return value
extern "C" const char* octave_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
