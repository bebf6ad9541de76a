// The int8 conv's wide halo path on Hopper (sm_90a): see int8_conv.cu for
// what it computes and why, int8_conv.cuh for the shared pieces and the
// plan (Sm90Plan) a launch follows.
#pragma once
#include <cuda.h>
#include "int8_conv.cuh"

namespace octave {

// Warp specialisation: warpgroup 0 produces (its warps 0-2 load the raw
// halo by TMA and quantise it into the halo ring, its warp 3 loads the
// weights by TMA into the weights' ring), warpgroups 1 and 2 consume
// (wgmma on 64 grid rows each, then the epilogue). The two rings let the
// quantisation run up to kSm90AStages stages ahead of the weights, whose
// larger stages fit only two to four at a time. A persistent block walks
// tiles blockIdx.x, + gridDim.x, ...; the rings run on across tiles, so the
// producers fill the next tile's first stages during this tile's
// epilogue. setmaxnreg moves registers from the producers to the
// consumers' BN / 2 int32 sums a thread.
constexpr int kSm90Threads = 384;
constexpr int kSm90ProducerRegs = 104;  // 128 x 104 + 256 x 200 = 64,512 of 65,536
constexpr int kSm90ConsumerRegs = 200;

// What a launch of the wide halo path carries: the TMA maps of each
// source's activation and weight (in the kernel's parameters, so a CUDA
// graph keeps them), the conv and the grid. The grid: for each strip of
// columns, every image's rows and one pad row after each, flattened with
// row pitch `pitch`; a grid row holds the strip's columns x0 .. x0 + wc - 1
// with a halo column on either side (pitch wc + 2, lead 1), or, for one
// strip, the image's columns and one pad column after them (pitch W + 1,
// lead 0: that pad is also the next row's left halo). A pad row is the
// one before the next image: one shared zero row between neighbours. Grid
// position g's tap (r, q) reads position g + (r - 1) * pitch + (q - 1), a
// shift that is the same for every row, so the nine taps of a tile's 128
// rows read one halo of 128 + 2 * pitch + 2 positions at nine offsets. A
// grid row is one TMA box of the activation (image b, row i, columns
// x0 - lead ...), its halo or pad columns and pad row the box's zeros
// outside the image.
struct Sm90Args {
  CUtensorMap xmap[2];  // each source's activation (C, W, H, B), boxes of (32, pitch, 1, 1)
  CUtensorMap wmap[2];  // each source's packed weight, boxes of 32 bytes x BN rows
  Params p;
  int batch;
  int strips, wc, lead, pitch;  // the grid (Sm90Plan)
  int halo;             // halo positions of a stage, 128 + 2 * pitch + 2 rounded up to 8
  int rows;             // grid rows a stage's raw halo loads
  int row_bytes;        // their pitch in shared memory
  int stages;           // of the weights' ring
  int n_tiles;
  int tiles;            // grid tiles x N tiles
};

// The 64-bit matrix descriptor of wgmma: start address, leading and stride
// byte offsets (>> 4), layout (0: no swizzle, 3: 32-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// a box of a weight's map, (n .. n + BN) x (k .. k + 32) bytes, onto `dst`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int n,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(bar)
      : "memory");
}
// a box of an activation's map: channels c .. c + 32 of a grid row's
// columns x .. x + pitch - 1 of row i of image b (zeros where that lies
// outside), onto `dst`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c, int x,
                                            int i, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(i), "r"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void quantiser_sync() {  // the quantising warps' own barrier
  asm volatile("bar.sync 1, 96;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {  // the consumer warpgroups' own barrier
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
// two output values as they lie in memory (8 bytes of float, 4 of 16-bit)
__device__ __forceinline__ void sts_pair(uint32_t addr, float a, float b, const float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
template <typename T>
__device__ __forceinline__ void sts_pair(uint32_t addr, float a, float b, const T*) {
  const uint32_t v = to_bits(Ty<T>::from_f(a)) | (to_bits(Ty<T>::from_f(b)) << 16);
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 16 bytes of T each: cast(float(old) + float(add)), element by element
__device__ __forceinline__ uint4 add16(uint4 old, uint4 add, const float*) {
  return make_uint4(__float_as_uint(__fadd_rn(__uint_as_float(old.x), __uint_as_float(add.x))),
                    __float_as_uint(__fadd_rn(__uint_as_float(old.y), __uint_as_float(add.y))),
                    __float_as_uint(__fadd_rn(__uint_as_float(old.z), __uint_as_float(add.z))),
                    __float_as_uint(__fadd_rn(__uint_as_float(old.w), __uint_as_float(add.w))));
}
template <typename T>
__device__ __forceinline__ uint32_t add2(uint32_t o, uint32_t a) {
  const T* t = nullptr;
  const float lo = __fadd_rn(from_bits(o & 0xffffu, t), from_bits(a & 0xffffu, t));
  const float hi = __fadd_rn(from_bits(o >> 16, t), from_bits(a >> 16, t));
  return to_bits(Ty<T>::from_f(lo)) | (to_bits(Ty<T>::from_f(hi)) << 16);
}
template <typename T>
__device__ __forceinline__ uint4 add16(uint4 old, uint4 add, const T*) {
  return make_uint4(add2<T>(old.x, add.x), add2<T>(old.y, add.y), add2<T>(old.z, add.z),
                    add2<T>(old.w, add.w));
}

// quant1's exact branch for one value, out of line: a call the compiler
// cannot predicate into every element's path (quant1 inline costs the
// division on every element: the wide path's depths 2-4 1.5x slower)
static __device__ __noinline__ uint32_t quant1_tie(float v, float sx) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f), 12582912.0f));
}

// Eight channels quantised as quant4 does, two words: the multiply by
// 1 / sx for all eight, and quant1's exact branch only for an element that
// lies near a rounding tie (rare with calibrated scales; 1.5% of a site's
// bf16 activations where the scale is a power of two)
template <typename T>
__device__ __forceinline__ uint2 quant8(const Stage<T, true>& st, float sx, float rsx) {
  const float kMagic = 12582912.0f;
  uint32_t q[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = fminf(fmaxf(__fmul_rn(st.get(e), rsx), -127.0f), 127.0f);
    const float y = __fadd_rn(t, kMagic);
    near |= fabsf(__fsub_rn(t, __fsub_rn(y, kMagic))) >= 0.49993896484375f;
    q[e] = __float_as_uint(y);
  }
  if (near) {  // which ones: tested again here, to keep the common path as short
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = fminf(fmaxf(__fmul_rn(st.get(e), rsx), -127.0f), 127.0f);
      if (fabsf(__fsub_rn(t, __fsub_rn(__fadd_rn(t, kMagic), kMagic))) >= 0.49993896484375f)
        q[e] = quant1_tie(st.get(e), sx);
    }
  }
  return make_uint2(
      __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(q[4], q[5], 0x0040), __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

template <int BN> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[16][4], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[32][4], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
        "%123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
          "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
          "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
          "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
          "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
          "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
          "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
          "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
          "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
          "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
          "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
          "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
          "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
          "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
          "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
          "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
          "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// A launch's scalars, copied out of the kernel's parameters into registers
// once: nothing is read back through a pointer inside the loops.
struct Sm90Geom {
  int batch, h, w, strips, wc, lead, pitch, halo, rows, row_bytes, stages, n_tiles, tiles, chunks,
      c0, c1, nsrc;
  __device__ __forceinline__ int tile_of(int k) const {
    return static_cast<int>(blockIdx.x + k * gridDim.x);
  }
  // stage j of this block: the tile's index k, the source, its first channel
  __device__ __forceinline__ void chunk(int j, int& k, int& src, int& c) const {
    k = j / chunks;
    c = (j - k * chunks) * kSm90CK;
    src = c < c0 ? 0 : 1;
    if (src) c -= c0;
  }
  // the grid row of the first row a tile's raw halo loads: the floor of
  // (g0 - pitch - 1) / pitch, g0 >= 0
  __device__ __forceinline__ int first_row(int g0) const { return (g0 + pitch - 1) / pitch - 2; }
  // grid row R as (strip, image, row), R >= 0
  __device__ __forceinline__ void place(int row, int& s, int& b, int& i) const {
    const int per_strip = batch * (h + 1);
    s = row / per_strip;
    const int r = row - s * per_strip;
    b = r / (h + 1);
    i = r - b * (h + 1);
  }
};

// the GEMM row of a local row of the tile: grid position g0 + r, or -1 where
// that is a halo, pad row or pad column, or lies past the last strip
struct GridRows {
  const Sm90Geom& g;
  int g0;
  __device__ __forceinline__ long long operator()(int r) const {
    const int pos = g0 + r, row = pos / g.pitch, j = pos - row * g.pitch - g.lead;
    int s, b, i;
    g.place(row, s, b, i);
    const int x = s * g.wc + j;
    if (s >= g.strips || i >= g.h || j < 0 || j >= g.wc || x >= g.w) return -1;
    return (static_cast<long long>(b) * g.h + i) * g.w + x;
  }
};

// Shared memory of a block: 32-bit shared addresses of its regions and of
// its barrier arrays (8 bytes apart): each ring's full and empty, the raw
// halos' full
struct Sm90Smem {
  uint32_t b, raw, a, scale, bias, out, b_full, b_empty, a_full, a_empty, raw_full;
};

// One consumer warp's 16 rows of a 64-row wgmma tile of one source: the
// arithmetic of `epilogue` (scale sx * ws[n] and bias from shared memory,
// where the consumers put them for this tile), the values staged in the
// warp's shared rows 64 bytes of columns at a time, then stored as whole
// 16-byte pieces of rows, a warp's store covering eight rows' 64 bytes.
// `part` as in `epilogue`; the pair's second reads its parked first the
// same way, adds in float and rounds once. N % 8 == 0 (the plan's).
template <typename T, int NT>
__device__ __forceinline__ void store_tile(const Params& p, int part, int n0,
                                           const int (&acc)[NT][4], const GridRows& rows,
                                           const Sm90Smem& sm, int warp, int lane) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  constexpr int CC = 64 / kElem;  // columns staged at a time
  constexpr int NTC = CC / 8;
  const int gid = lane / 4, tig = lane % 4;
  const bool bias = part == 0 && p.bias != nullptr;
  const uint32_t staged = sm.out + warp * 16 * kSm90OutPitch;
  long long mrow[2];  // the rows this lane stores: lane / 4 and lane / 4 + 8 of the warp's 16
#pragma unroll
  for (int i = 0; i < 2; ++i) mrow[i] = rows(16 * warp + lane / 4 + 8 * i);
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int chunk = 0; chunk < NT / NTC; ++chunk) {
#pragma unroll
    for (int t4 = 0; t4 < NTC; ++t4) {
      const int nt = chunk * NTC + t4, col = nt * 8 + tig * 2;  // of the tile
      const float s0 = lds_f32(sm.scale + col * 4), s1 = lds_f32(sm.scale + col * 4 + 4);
      const float b0 = lds_f32(sm.bias + col * 4), b1 = lds_f32(sm.bias + col * 4 + 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = __fmul_rn(__int2float_rn(acc[nt][half * 2]), s0);
        float v1 = __fmul_rn(__int2float_rn(acc[nt][half * 2 + 1]), s1);
        if (bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        sts_pair(staged + (gid + 8 * half) * kSm90OutPitch + (t4 * 8 + tig * 2) * kElem, v0, v1,
                 static_cast<const T*>(nullptr));
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i, piece = lane % 4;
      const int n = n0 + chunk * CC + piece * (16 / kElem);
      if (mrow[i] >= 0 && n < p.n) {
        uint4 v = lds128(staged + r * kSm90OutPitch + piece * 16);
        uint4* dst = reinterpret_cast<uint4*>(out + mrow[i] * p.n + n);
        if (part == 2) v = add16(*dst, v, static_cast<const T*>(nullptr));
        *dst = v;
      }
    }
    __syncwarp();
  }
}

template <typename T, int BN>
struct HaloConvSm90 {
  static constexpr int NT = BN / 8;
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kPieces = kSm90CK * kElem / 16;  // 16-byte pieces of a position's chunk

  // producer, lane 0 of warp w < 3: its share (every third grid row) of
  // stage j's raw halo into raw[j % 2], the arrival carrying their bytes
  static __device__ __forceinline__ void load_raw(const Sm90Args& a, const Sm90Geom& g,
                                                  const Sm90Smem& sm, int j, int warp) {
    int k, src, c;
    g.chunk(j, k, src, c);
    const int r0 = g.first_row((g.tile_of(k) / g.n_tiles) * kSm90BM);
    const CUtensorMap* map = src ? &a.xmap[1] : &a.xmap[0];
    const uint32_t dst = sm.raw + (j & 1) * g.rows * g.row_bytes;
    const uint32_t bar = sm.raw_full + (j & 1) * 8;
    mbar_arrive_tx(bar, ((g.rows - warp + 2) / 3) * g.pitch * kSm90CK * kElem);
    for (int r = warp; r < g.rows; r += 3) {
      int s = 0, b = -1, i = 0;  // rows before the grid's first: a box outside the images
      if (r0 + r >= 0) g.place(r0 + r, s, b, i);
      if (s >= g.strips) b = g.batch;  // past the last strip: outside too
      tma_load_4d(dst + r * g.row_bytes, map, c, s * g.wc - g.lead, i, b, bar);
    }
  }

  // producer: raw[j % 2] quantised into the A stage, 16 channels of a halo
  // position (one slice) an item. Halo position u lies in raw row
  // (cf + u) / pitch, column (cf + u) % pitch, cf the first position's
  // column (a multiply by 1 / pitch: cf + u < 1,024); its 16-byte pieces
  // where TMA's 64-byte (float: 128-byte) swizzle puts them, piece ^ (bits
  // 7.. of the offset in the row).
  static __device__ __forceinline__ void quantise(const Sm90Geom& g, const Sm90Smem& sm, int j,
                                                  int slot, int g0, float sx, float rsx) {
    const uint32_t from = sm.raw + (j & 1) * g.rows * g.row_bytes;
    const uint32_t to = sm.a + slot * 2 * g.halo * 16;
    const int cf = g0 - g.pitch - 1 - g.first_row(g0) * g.pitch;
    const float rpitch = 1.0f / g.pitch;
    constexpr int kW = Stage<T, true>::kWords;
    constexpr int kHalf = kPieces / 2;  // pieces of 16 channels
    for (int item = threadIdx.x; item < 2 * g.halo; item += 96) {
      const int u = item >> 1, slice = item & 1, local = cf + u;
      const int row = static_cast<int>((local + 0.5f) * rpitch), col = local - row * g.pitch;
      const uint32_t at = from + row * g.row_bytes + col * kSm90CK * kElem;
      const int swz = (col * kSm90CK * kElem >> 7) & (kPieces - 1);
      Stage<T, true> st[2];  // channels 16 slice + 8 i .. + 7
#pragma unroll
      for (int piece = 0; piece < kHalf; ++piece)
        st[piece / kW].raw[piece % kW] = lds128(at + (((slice * kHalf + piece) ^ swz) << 4));
      const uint2 q0 = quant8(st[0], sx, rsx), q1 = quant8(st[1], sx, rsx);
      sts128(to + slice * g.halo * 16 + u * 16, make_uint4(q0.x, q0.y, q1.x, q1.y));
    }
  }

  // producer warps 0-2: the raw halo one stage ahead, quantised into the
  // halo ring as soon as its slot is free
  static __device__ __forceinline__ void quantise_loop(const Sm90Args& a, const Sm90Geom g,
                                                       const Sm90Smem sm, int total) {
    const int warp = threadIdx.x / 32;
    const bool lead = threadIdx.x % 32 == 0;  // each warp's TMA issuer
    if (total > 0 && lead) load_raw(a, g, sm, 0, warp);
    int slot = 0, phase = 0;
    for (int j = 0; j < total; ++j) {
      int k, src, c;
      g.chunk(j, k, src, c);
      if (lead && j + 1 < total) {  // its raw buffer's last readers passed the barrier below
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_raw(a, g, sm, j + 1, warp);
      }
      mbar_wait(sm.a_empty + slot * 8, phase ^ 1);
      const float sx = *(src ? a.p.src[1].sx : a.p.src[0].sx);
      mbar_wait(sm.raw_full + (j & 1) * 8, (j >> 1) & 1);
      quantise(g, sm, j, slot, (g.tile_of(k) / g.n_tiles) * kSm90BM, sx, __frcp_rn(sx));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      mbar_arrive(sm.a_full + slot * 8);
      quantiser_sync();  // raw[j % 2] read by all
      if (++slot == kSm90AStages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }

  // producer warp 3, one thread: each stage's weights, nine taps of (BN
  // rows x 32 channels), as soon as the weights' ring has room
  static __device__ __forceinline__ void weights_loop(const Sm90Args& a, const Sm90Geom g,
                                                      const Sm90Smem sm, int total) {
    int stage = 0, phase = 0;
    for (int j = 0; j < total; ++j) {
      int k, src, c;
      g.chunk(j, k, src, c);
      const int n0 = (g.tile_of(k) % g.n_tiles) * BN;
      const int ch = src ? g.c1 : g.c0;
      const CUtensorMap* map = src ? &a.wmap[1] : &a.wmap[0];
      const uint32_t bar = sm.b_full + stage * 8;
      const uint32_t dst = sm.b + stage * sm90_b_stage(BN);
      mbar_wait(sm.b_empty + stage * 8, phase ^ 1);
      mbar_arrive_tx(bar, sm90_b_stage(BN));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        tma_load_2d(dst + tap * BN * kSm90CK, map, tap * ch + c, n0, bar);
      if (++stage == g.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  // consumers: the tile's dequantisation per column into shared memory
  // (scale sx * ws[n]; bias, where this part adds one), between the last
  // epilogue's readers and this one's
  static __device__ __forceinline__ void fill_columns(const Params& p, const Source& s, int part,
                                                      int n0, const Sm90Smem& sm, int tid) {
    consumer_sync();
    const float sx = *s.sx;
    for (int col = tid; col < BN; col += 256) {
      const int n = n0 + col < p.n ? n0 + col : p.n - 1;
      sts_f32(sm.scale + col * 4, __fmul_rn(sx, __ldg(s.ws + n)));
      float b = 0.0f;
      if (part == 0 && p.bias != nullptr)
        b = p.bias_f32 ? __ldg(static_cast<const float*>(p.bias) + n)
                       : Ty<T>::to_f(static_cast<const T*>(p.bias)[n]);
      sts_f32(sm.bias + col * 4, b);
    }
    consumer_sync();
  }

  static __device__ __forceinline__ void consume(const Sm90Args& a, const Sm90Geom g,
                                                 const Sm90Smem sm, int total) {
    const Params p = a.p;  // a copy: the epilogue's stores alias nothing of it
    const int tid = threadIdx.x - 128, cw = tid / 128;  // consumer warpgroup 0 or 1
    const int a_bytes = 2 * g.halo * 16;
    int acc[NT][4];
    int stage = 0, phase = 0, slot = 0, a_phase = 0, j = 0;  // the weights' and halo rings
    for (int k = 0; j < total; ++k) {
      const int t = g.tile_of(k);
      const int n0 = (t % g.n_tiles) * BN, g0 = (t / g.n_tiles) * kSm90BM;
#pragma unroll
      for (int src = 0; src < 2; ++src) {
        if (src == g.nsrc) break;
        const int chunks = (src ? g.c1 : g.c0) / kSm90CK;
        int prev = 0, prev_slot = 0;
        for (int c = 0; c < chunks; ++c, ++j) {
          mbar_wait(sm.a_full + slot * 8, a_phase);
          mbar_wait(sm.b_full + stage * 8, phase);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          const uint32_t a0 = sm.a + slot * a_bytes + cw * 64 * 16;
          const uint32_t b0 = sm.b + stage * sm90_b_stage(BN);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const uint32_t shift = ((tap / 3) * g.pitch + tap % 3) * 16;
            Wgmma<BN>::mma(acc, gmma_desc(a0 + shift, g.halo * 16, 128, 0),
                           gmma_desc(b0 + tap * BN * kSm90CK, 16, 256, 3), c > 0 || tap > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          if (c > 0) {  // the stage before is read: hand it back
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            if (tid % 32 == 0) {
              mbar_arrive(sm.b_empty + prev * 8);
              mbar_arrive(sm.a_empty + prev_slot * 8);
            }
          }
          prev = stage;
          prev_slot = slot;
          if (++stage == g.stages) {
            stage = 0;
            phase ^= 1;
          }
          if (++slot == kSm90AStages) {
            slot = 0;
            a_phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (tid % 32 == 0) {
          mbar_arrive(sm.b_empty + prev * 8);
          mbar_arrive(sm.a_empty + prev_slot * 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)  // no read of the sums above the wait
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[nt][e])::"memory");
        const int part = p.nsrc == 2 ? src + 1 : 0;
        fill_columns(p, p.src[src], part, n0, sm, tid);
        // warp w's rows: 64 x cw + 16 x (w % 4) + ... = 16 x w + ...
        const GridRows rows{g, g0};
        store_tile<T, NT>(p, part, n0, acc, rows, sm, tid / 32, tid % 32);
      }
    }
  }
};

// The kernel's name contains int8_conv_halo_kernel, as the other halo
// kernels' do: the benchmark finds the int8 conv's launches by name.
template <typename T, int BN>
__global__ void __launch_bounds__(kSm90Threads, 1)
    int8_conv_halo_kernel_sm90(const __grid_constant__ Sm90Args a) {
  using Conv = HaloConvSm90<T, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Sm90Geom g;
  g.batch = a.batch;
  g.h = a.p.h;
  g.w = a.p.w;
  g.strips = a.strips;
  g.wc = a.wc;
  g.lead = a.lead;
  g.pitch = a.pitch;
  g.halo = a.halo;
  g.rows = a.rows;
  g.row_bytes = a.row_bytes;
  g.stages = a.stages;
  g.n_tiles = a.n_tiles;
  g.tiles = a.tiles;
  g.nsrc = a.p.nsrc;
  g.c0 = a.p.src[0].c;
  g.c1 = g.nsrc == 2 ? a.p.src[1].c : 0;
  g.chunks = (g.c0 + g.c1) / kSm90CK;
  Sm90Smem sm;  // the weights and raw halos 1024-aligned: TMA's swizzles are periodic in that
  sm.b = (smem_addr(smem_raw) + 1023) & ~1023u;
  sm.raw = sm.b + g.stages * sm90_b_stage(BN);
  sm.a = sm.raw + 2 * g.rows * g.row_bytes;
  sm.scale = sm.a + kSm90AStages * 2 * g.halo * 16;
  sm.bias = sm.scale + 256 * 4;
  sm.out = sm.bias + 256 * 4;
  sm.b_full = sm.out + 8 * 16 * kSm90OutPitch;
  sm.b_empty = sm.b_full + g.stages * 8;
  sm.a_full = sm.b_empty + g.stages * 8;
  sm.a_empty = sm.a_full + kSm90AStages * 8;
  sm.raw_full = sm.a_empty + kSm90AStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(sm.b_full + s * 8, 1);   // warp 3's arrival with the weights' bytes
      mbar_init(sm.b_empty + s * 8, 8);  // one thread of each consumer warp
    }
    for (int s = 0; s < kSm90AStages; ++s) {
      mbar_init(sm.a_full + s * 8, 96);  // the quantising threads
      mbar_init(sm.a_empty + s * 8, 8);
    }
    for (int s = 0; s < 2; ++s) mbar_init(sm.raw_full + s * 8, 3);  // 3 warps' halo rows
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int blocks = static_cast<int>(gridDim.x);
  const int total = (g.tiles - static_cast<int>(blockIdx.x) + blocks - 1) / blocks * g.chunks;
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kSm90ProducerRegs));
    if (threadIdx.x < 96)
      Conv::quantise_loop(a, g, sm, total);
    else if (threadIdx.x == 96)
      Conv::weights_loop(a, g, sm, total);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kSm90ConsumerRegs));
    Conv::consume(a, g, sm, total);
  }
}

// The host side, per dtype (int8_conv_sm90_{f32,bf16,f16}.cu).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename T> struct TmaType;
template <> struct TmaType<float> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};

template <typename T>
cudaError_t launch_sm90(const Params& p, const Sm90Plan& plan, cudaStream_t stream) {
  Sm90Args a;
  a.p = p;
  a.batch = static_cast<int>(p.m / (static_cast<long long>(p.h) * p.w));
  a.strips = plan.strips;
  a.wc = plan.wc;
  a.lead = plan.lead;
  a.pitch = plan.pitch;
  a.halo = plan.halo;
  a.rows = plan.rows;
  a.row_bytes = plan.row_bytes;
  a.stages = plan.stages;
  a.n_tiles = (p.n + plan.bn - 1) / plan.bn;
  a.tiles = plan.tiles;
  EncodeTiled encode = reinterpret_cast<EncodeTiled>(tensor_map_encoder());
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 2; ++i) {
    const Source& s = p.src[i < p.nsrc ? i : 0];
    const cuuint64_t es = sizeof(T);
    const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(s.c), static_cast<cuuint64_t>(p.w),
                                 static_cast<cuuint64_t>(p.h), static_cast<cuuint64_t>(a.batch)};
    const cuuint64_t xstrides[3] = {s.c * es, s.c * es * p.w, s.c * es * p.w * p.h};
    const cuuint32_t xbox[4] = {kSm90CK, static_cast<cuuint32_t>(plan.pitch), 1, 1};
    CUresult r = encode(&a.xmap[i], TmaType<T>::kType, 4, const_cast<void*>(s.x), xdims, xstrides,
                        xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, TmaType<T>::kSwizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(s.ldw), static_cast<cuuint64_t>(s.n_rows)};
    const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(s.ldw)};
    const cuuint32_t wbox[2] = {kSm90CK, static_cast<cuuint32_t>(plan.bn)};
    r = encode(&a.wmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(s.w), wdims,
               wstrides, wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>(plan.tiles < plan.sms ? plan.tiles : plan.sms);
  const int smem = sm90_smem(plan.bn, plan.stages, plan.halo, plan.rows * plan.row_bytes);
  if (plan.bn == 256)
    int8_conv_halo_kernel_sm90<T, 256><<<blocks, kSm90Threads, smem, stream>>>(a);
  else
    int8_conv_halo_kernel_sm90<T, 128><<<blocks, kSm90Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t init_sm90() {
  cudaError_t e = cudaFuncSetAttribute(int8_conv_halo_kernel_sm90<T, 256>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSm90Smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_conv_halo_kernel_sm90<T, 128>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSm90Smem);
  return e;
}

}  // namespace octave
